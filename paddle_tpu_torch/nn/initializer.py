"""The initial distributions of ``paddle_tpu/nn/initializer`` (Xavier,
``Constant``, ``Uniform``, ``KaimingUniform``), drawn from an explicit
``torch.Generator``.

The draws differ from the JAX package's (another generator); the
distributions are the same: Xavier fans of a 2-D ``[in, out]`` weight are
its two dims, and a caller may give them (the MoE expert banks do).

``ParamAttr`` and ``set_param_attr`` carry a parameter's name and learning
rate multiplier onto an ``nn.Parameter``, as the JAX package's
``_resolve_attr`` carries them onto the ``Parameter`` a layer creates.
"""
from __future__ import annotations

import math

import torch


def _fans(shape):
    if len(shape) < 2:
        return (shape[0] if shape else 1,) * 2
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


@torch.no_grad()
def xavier_uniform_(t, generator, fan_in=None, fan_out=None, gain=1.0):
    fi, fo = _fans(tuple(t.shape))
    fi = fi if fan_in is None else fan_in
    fo = fo if fan_out is None else fan_out
    limit = gain * math.sqrt(6.0 / (fi + fo))
    return t.uniform_(-limit, limit, generator=generator)


@torch.no_grad()
def xavier_normal_(t, generator, fan_in=None, fan_out=None, gain=1.0):
    fi, fo = _fans(tuple(t.shape))
    fi = fi if fan_in is None else fan_in
    fo = fo if fan_out is None else fan_out
    return t.normal_(0.0, gain * math.sqrt(2.0 / (fi + fo)),
                     generator=generator)


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
    if nonlinearity == "relu":
        gain = math.sqrt(2.0)
    elif nonlinearity == "leaky_relu":
        gain = math.sqrt(2.0 / (1 + negative_slope ** 2))
    else:
        gain = 1.0
    limit = gain * math.sqrt(3.0 / fi)
    return t.uniform_(-limit, limit, generator=generator)


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


def _resolve_attr(attr, default_initializer=None):
    """(initializer, learning rate, name) of an attribute spec: a
    ``ParamAttr``, a name, or an initializer. As in the JAX package, a
    ``ParamAttr``'s ``regularizer`` and ``need_clip`` are not carried: only
    attributes set on the parameter itself take effect."""
    if attr is False:
        raise ValueError("attr=False means no parameter; caller must handle it")
    init, lr, name = default_initializer, 1.0, None
    if isinstance(attr, ParamAttr):
        if attr.initializer is not None:
            init = attr.initializer
        lr = attr.learning_rate
        name = attr.name
    elif isinstance(attr, str):
        name = attr
    elif callable(attr):
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


__all__ = ["xavier_uniform_", "xavier_normal_", "constant_", "uniform_",
           "kaiming_uniform_", "ParamAttr",
           "NamedParameter", "set_param_attr"]
