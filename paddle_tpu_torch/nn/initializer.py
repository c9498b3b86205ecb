"""``paddle_tpu/nn/initializer``: the initializer classes and the
functions that fill a tensor in place.

The classes (``Initializer``, ``Constant``, ``Assign``, ``Normal``,
``TruncatedNormal``, ``Uniform``, ``XavierNormal``, ``XavierUniform``,
``KaimingNormal``, ``KaimingUniform``, ``Orthogonal``, ``Dirac``,
``Bilinear``; ``constant_init``, ``normal_init``, ``uniform_init``) are
callables ``(shape, dtype=float32, device=None) -> tensor``, as the JAX
package's ``(shape, dtype) -> array``; the random ones draw from the
port's global generator (``framework.random.next_key``, uniforms from the
Philox words of ``kernels.dropout.uniform_plain``; normals by the inverse
of the normal CDF), so a seed gives the same weights on the card and on
the CPU but not JAX's bits. ``ParamAttr(initializer=...)`` and
``set_global_initializer`` choose a layer's initializer as the JAX
package's ``_resolve_attr`` does: the attribute's, else the global one,
else the layer's own.

The functions (``xavier_uniform_``, ``xavier_normal_``, ``constant_``,
``uniform_``, ``kaiming_uniform_``) fill a tensor from an explicit
``torch.Generator``: the layers' default initializers. The draws differ
from the JAX package's (another generator); the distributions are the
same: Xavier fans of a 2-D ``[in, out]`` weight are its two dims, and a
caller may give them (the MoE expert banks do).

``ParamAttr`` and ``set_param_attr`` carry a parameter's name and learning
rate multiplier onto an ``nn.Parameter``, as the JAX package's
``_resolve_attr`` carries them onto the ``Parameter`` a layer creates.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..framework.random import next_key


def _fans(shape):
    if len(shape) < 2:
        return (shape[0] if shape else 1,) * 2
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def _xavier_sum(shape, fan_in, fan_out):
    """fan_in + fan_out of a weight of ``shape``, either given or its
    own."""
    fi, fo = _fans(tuple(shape))
    return (fi if fan_in is None else fan_in) + \
        (fo if fan_out is None else fan_out)


def _kaiming_gain(nonlinearity, negative_slope):
    """sqrt(2) for "relu", sqrt(2 / (1 + slope^2)) for "leaky_relu", else
    1."""
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        return math.sqrt(2.0 / (1 + negative_slope ** 2))
    return 1.0


@torch.no_grad()
def xavier_uniform_(t, generator, fan_in=None, fan_out=None, gain=1.0):
    limit = gain * math.sqrt(6.0 / _xavier_sum(t.shape, fan_in, fan_out))
    return t.uniform_(-limit, limit, generator=generator)


@torch.no_grad()
def xavier_normal_(t, generator, fan_in=None, fan_out=None, gain=1.0):
    std = gain * math.sqrt(2.0 / _xavier_sum(t.shape, fan_in, fan_out))
    return t.normal_(0.0, std, generator=generator)


@torch.no_grad()
def constant_(t, value=0.0):
    """``Constant(value)``."""
    return t.fill_(value)


@torch.no_grad()
def uniform_(t, generator, low=-1.0, high=1.0):
    """``Uniform(low, high)``."""
    return t.uniform_(low, high, generator=generator)


@torch.no_grad()
def kaiming_uniform_(t, generator, fan_in=None, negative_slope=0.0,
                     nonlinearity="leaky_relu"):
    """``KaimingUniform``: uniform in +-gain * sqrt(3 / fan_in), the gain
    sqrt(2) for "relu", sqrt(2 / (1 + slope^2)) for "leaky_relu" and 1
    otherwise; ``fan_in`` the weight's (``_fans``) unless given (a conv
    weight's is (in / groups) * kh * kw)."""
    fi = _fans(tuple(t.shape))[0] if fan_in is None else fan_in
    limit = _kaiming_gain(nonlinearity, negative_slope) * math.sqrt(3.0 / fi)
    return t.uniform_(-limit, limit, generator=generator)


# -- the initializer classes ----------------------------------------------------

def _dt(dtype):
    if dtype is None:
        return torch.float32
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _uniform01(shape, device):
    """Uniforms in (0, 1), fp32, of ``shape`` under ``next_key()``."""
    from ..kernels.dropout import uniform_plain
    return uniform_plain(tuple(int(s) for s in shape), next_key(),
                         torch.device("cpu" if device is None else device))


def _std_normal(shape, device):
    """Standard normals under ``next_key()``: the inverse normal CDF of
    uniforms (in float64), fp32."""
    u = _uniform01(shape, device).double()
    return (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).float()


class Initializer:
    """A callable ``(shape, dtype=float32, device=None)`` -> a tensor of
    ``shape`` in ``dtype`` on ``device`` (None = the CPU)."""

    def __call__(self, shape, dtype=None, device=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype=None, device=None):
        return torch.full(tuple(shape), self.value, dtype=_dt(dtype),
                          device=device)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=None, device=None):
        return (_std_normal(shape, device) * self.std + self.mean) \
            .to(_dt(dtype))


class TruncatedNormal(Initializer):
    """A normal truncated to ``[a, b]`` standard deviations (the JAX
    ``truncated_normal``), scaled by ``std`` and moved by ``mean``: the
    inverse normal CDF of uniforms between the bounds' CDFs."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype=None, device=None):
        def cdf(v):
            return 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))
        lo, hi = cdf(self.a), cdf(self.b)
        p = lo + (hi - lo) * _uniform01(shape, device).double()
        z = (math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)).clamp(self.a,
                                                                  self.b)
        return (z.float() * self.std + self.mean).to(_dt(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=None, device=None):
        u = _uniform01(shape, device)
        return (self.low + (self.high - self.low) * u).to(_dt(dtype))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=None, device=None):
        limit = self.gain * math.sqrt(
            6.0 / _xavier_sum(shape, self.fan_in, self.fan_out))
        return Uniform(-limit, limit)(shape, dtype, device)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=None, device=None):
        std = self.gain * math.sqrt(
            2.0 / _xavier_sum(shape, self.fan_in, self.fan_out))
        return Normal(0.0, std)(shape, dtype, device)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="leaky_relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _gain(self):
        return _kaiming_gain(self.nonlinearity, self.negative_slope)

    def _fan_in(self, shape):
        fi = _fans(tuple(shape))[0]
        return self.fan_in if self.fan_in is not None else fi

    def __call__(self, shape, dtype=None, device=None):
        limit = self._gain() * math.sqrt(3.0 / self._fan_in(shape))
        return Uniform(-limit, limit)(shape, dtype, device)


class KaimingNormal(KaimingUniform):
    def __call__(self, shape, dtype=None, device=None):
        std = self._gain() / math.sqrt(self._fan_in(shape))
        return Normal(0.0, std)(shape, dtype, device)


class Assign(Initializer):
    """The given values (a tensor, an array or a list), reshaped."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype=None, device=None):
        v = self.value
        v = v.detach().cpu() if torch.is_tensor(v) else \
            torch.from_numpy(np.array(v))
        return v.to(_dt(dtype)).reshape(tuple(shape)).to(device)


class Orthogonal(Initializer):
    """``gain`` times the Q of a normal matrix's QR (signs from R's
    diagonal), rows or columns orthonormal, as the JAX class."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype=None, device=None):
        rows = int(shape[0])
        cols = math.prod(int(s) for s in shape[1:])
        flat = _std_normal((max(rows, cols), min(rows, cols)), device)
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q[:rows, :cols]).reshape(tuple(shape)) \
            .to(_dt(dtype))


class Dirac(Initializer):
    """Identity convolution weights: 1 at each kernel's centre for the
    first min(out / groups, in) channels of each group."""

    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype=None, device=None):
        out = np.zeros(tuple(shape), np.float32)
        oc, ic = shape[0], shape[1]
        mins = min(oc // self.groups, ic)
        center = tuple(s // 2 for s in shape[2:])
        for g in range(self.groups):
            for i in range(mins):
                out[(g * (oc // self.groups) + i, i) + center] = 1.0
        return torch.from_numpy(out).to(device=device, dtype=_dt(dtype))


class Bilinear(Initializer):
    """The bilinear-upsampling kernel for a transposed convolution's
    ``[C_out, C_in, kh, kw]`` weight."""

    def __call__(self, shape, dtype=None, device=None):
        if len(shape) != 4:
            raise ValueError("Bilinear initializer expects a 4-D weight")
        kh, kw = int(shape[2]), int(shape[3])
        fh, fw = (kh + 1) // 2, (kw + 1) // 2
        ch = (2 * fh - 1 - fh % 2) / (2.0 * fh)
        cw = (2 * fw - 1 - fw % 2) / (2.0 * fw)
        yy, xx = np.meshgrid(np.arange(kh), np.arange(kw), indexing="ij")
        filt = ((1 - np.abs(yy / fh - ch))
                * (1 - np.abs(xx / fw - cw))).astype(np.float32)
        w = np.zeros(tuple(int(s) for s in shape), np.float32)
        w[:, :] = filt
        return torch.from_numpy(w).to(device=device, dtype=_dt(dtype))


constant_init = Constant
normal_init = Normal
uniform_init = Uniform


def calculate_gain(nonlinearity, param=None):
    """The recommended gain of ``nonlinearity`` (leaky_relu's slope
    ``param``, 0.01 by default)."""
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "conv1d_transpose": 1.0, "conv2d_transpose": 1.0,
        "conv3d_transpose": 1.0, "tanh": 5.0 / 3.0,
        "relu": math.sqrt(2.0),
        "selu": 3.0 / 4.0,
    }
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else float(param)
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity not in gains:
        raise ValueError(f"calculate_gain: unsupported nonlinearity "
                         f"{nonlinearity!r}")
    return gains[nonlinearity]


_GLOBAL_INIT = [None, None]  # (weight_init, bias_init)


def set_global_initializer(weight_init, bias_init=None):
    """Override every layer's default initializer for weights and (where
    given) biases; a parameter's own ``ParamAttr`` initializer still wins.
    None resets."""
    _GLOBAL_INIT[0] = weight_init
    _GLOBAL_INIT[1] = bias_init


# -- parameter attributes ---------------------------------------------------------

class ParamAttr:
    """A parameter's attributes, as ``paddle_tpu.nn.initializer.ParamAttr``
    holds them."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip


def _resolve_attr(attr, default_initializer=None, is_bias=False):
    """(initializer, learning rate, name) of an attribute spec: a
    ``ParamAttr``, a name, or an ``Initializer``. The initializer is the
    attribute's, else the global one of weights or biases
    (``set_global_initializer``), else ``default_initializer``. As in the
    JAX package, a ``ParamAttr``'s ``regularizer`` and ``need_clip`` are
    not carried: only attributes set on the parameter itself take
    effect."""
    if attr is False:
        raise ValueError("attr=False means no parameter; caller must handle it")
    init, lr, name = default_initializer, 1.0, None
    g = _GLOBAL_INIT[1 if is_bias else 0]
    if g is not None:
        init = g
    if isinstance(attr, ParamAttr):
        if attr.initializer is not None:
            init = attr.initializer
        lr = attr.learning_rate
        name = attr.name
    elif isinstance(attr, str):
        name = attr
    elif isinstance(attr, Initializer):
        init = attr
    return init, lr, name


class NamedParameter(torch.nn.Parameter):
    """An ``nn.Parameter`` whose ``name`` can be set: ``torch.Tensor.name``
    is a read-only property, and the optimizers read ``param.name`` as the
    JAX package's do (``apply_decay_param_fun``, ``state_dict`` keys)."""

    @property
    def name(self):
        return self.__dict__.get("_param_name")

    @name.setter
    def name(self, value):
        self.__dict__["_param_name"] = value


def set_param_attr(param, attr):
    """Give the ``nn.Parameter`` ``param`` the name and learning-rate
    multiplier of ``attr`` (see ``_resolve_attr``), as the JAX package's
    ``Layer.create_parameter`` gives them to the parameter it creates; the
    optimizers and the trainer read them (``name``, ``optimize_attr``).
    The parameter becomes a ``NamedParameter`` in place (the same tensor,
    in its module). Returns ``param``."""
    _, lr, name = _resolve_attr(attr)
    if not isinstance(param, NamedParameter):
        param.__class__ = NamedParameter
    param.name = name
    param.optimize_attr = {"learning_rate": lr}
    return param


__all__ = ["Initializer", "Constant", "Assign", "Normal", "TruncatedNormal",
           "Uniform", "XavierNormal", "XavierUniform", "KaimingNormal",
           "KaimingUniform", "Orthogonal", "Dirac", "Bilinear",
           "calculate_gain", "set_global_initializer", "constant_init",
           "normal_init", "uniform_init", "xavier_uniform_",
           "xavier_normal_", "constant_", "uniform_", "kaiming_uniform_",
           "ParamAttr", "NamedParameter", "set_param_attr"]
