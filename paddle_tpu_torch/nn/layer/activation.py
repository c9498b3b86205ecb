"""The layers of ``paddle_tpu/nn/layer/activation.py`` as ``Layer``s
over the functionals: the twelve one-argument layers of its ``_simple``
family (``ReLU`` ... ``LogSigmoid``, ``:26-37``) and the sixteen classes
(``GELU``, ``LeakyReLU`` ... ``GLU``, ``:40-188``). ``PReLU`` holds its
weight (``init``, or a ``ParamAttr``'s initializer) on an explicit
``device`` (None = the GPU) in ``dtype`` (float32)."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer, make_parameter, placement


def _simple(name, fn_name):
    fn = getattr(F, fn_name)

    class _Act(Layer):
        def __init__(self, name=None):
            super().__init__()

        def forward(self, x):
            return fn(x)

    _Act.__name__ = _Act.__qualname__ = name
    return _Act


ReLU = _simple("ReLU", "relu")
ReLU6 = _simple("ReLU6", "relu6")
Sigmoid = _simple("Sigmoid", "sigmoid")
Tanh = _simple("Tanh", "tanh")
Silu = _simple("Silu", "silu")
Swish = _simple("Swish", "swish")
Mish = _simple("Mish", "mish")
Hardswish = _simple("Hardswish", "hardswish")
Hardsigmoid = _simple("Hardsigmoid", "hardsigmoid")
Softsign = _simple("Softsign", "softsign")
Tanhshrink = _simple("Tanhshrink", "tanhshrink")
LogSigmoid = _simple("LogSigmoid", "log_sigmoid")


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self._approximate = approximate

    def forward(self, x):
        return F.gelu(x, self._approximate)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self._negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self._negative_slope)


class ELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.elu(x, self._alpha)


class CELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.celu(x, self._alpha)


class SELU(Layer):
    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772,
                 name=None):
        super().__init__()
        self._scale = scale
        self._alpha = alpha

    def forward(self, x):
        return F.selu(x, self._scale, self._alpha)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None, dtype=None):
        super().__init__()
        dev, dt = placement(device, dtype)
        self._data_format = data_format
        self.weight = make_parameter((num_parameters,), weight_attr, dev, dt,
                                     lambda t: t.fill_(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class RReLU(Layer):
    def __init__(self, lower=0.125, upper=0.3333333333333333, name=None):
        super().__init__()
        self._lower = lower
        self._upper = upper

    def forward(self, x):
        return F.rrelu(x, self._lower, self._upper, self.training)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.hardshrink(x, self._threshold)


class Softshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.softshrink(x, self._threshold)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None):
        super().__init__()
        self._min, self._max = min, max

    def forward(self, x):
        return F.hardtanh(x, self._min, self._max)


class Softplus(Layer):
    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__()
        self._beta, self._threshold = beta, threshold

    def forward(self, x):
        return F.softplus(x, self._beta, self._threshold)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, value=0.0, name=None):
        super().__init__()
        self._threshold, self._value = threshold, value

    def forward(self, x):
        return F.thresholded_relu(x, self._threshold, self._value)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.softmax(x, self._axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.log_softmax(x, self._axis)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self._groups, self._axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self._groups, self._axis)


class GLU(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.glu(x, self._axis)


__all__ = ["ReLU", "ReLU6", "Sigmoid", "Tanh", "Silu", "Swish", "Mish",
           "Hardswish", "Hardsigmoid", "Softsign", "Tanhshrink",
           "LogSigmoid", "GELU", "LeakyReLU", "ELU", "CELU", "SELU", "PReLU",
           "RReLU", "Hardshrink", "Softshrink", "Hardtanh", "Softplus",
           "ThresholdedReLU", "Softmax", "LogSoftmax", "Maxout", "GLU"]
