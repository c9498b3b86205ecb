"""``Conv2D`` (``paddle_tpu/nn/layer/conv.py:19 _ConvNd``, ``:73``) as an
``Layer``: the JAX layer's arguments and parameter names, weight
``[out, in / groups, kh, kw]`` (torch's layout too) drawn from
``KaimingUniform(fan_in=(in / groups) * kh * kw)`` and bias from
``Uniform(+-1 / sqrt(fan_in))`` (left out with ``bias_attr=False``), on an
explicit ``device`` (None = the GPU) in ``dtype`` (float32) from
``generator``. Its forward is ``F.conv2d`` (cuDNN on the card).
``padding_mode`` is accepted and ignored, as the JAX layer ignores it:
every mode pads with zeros."""
from __future__ import annotations

import math

from .. import functional as F
from ..initializer import kaiming_uniform_, uniform_
from .layers import Layer, make_parameter, placement


class Conv2D(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        dev, dt = placement(device, dtype)
        self._in_channels = in_channels
        self._out_channels = out_channels
        k = [kernel_size] * 2 if isinstance(kernel_size, int) \
            else list(kernel_size)
        self._kernel_size = k
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        # stored and never read, as in JAX: every mode pads with zeros
        self._padding_mode = padding_mode
        fan_in = (in_channels // groups) * math.prod(k)
        self.weight = make_parameter(
            (out_channels, in_channels // groups, *k), weight_attr, dev, dt,
            lambda t: kaiming_uniform_(t, generator, fan_in=fan_in))
        bound = 1.0 / math.sqrt(fan_in)
        self.bias = make_parameter(
            (out_channels,), bias_attr, dev, dt,
            lambda t: uniform_(t, generator, -bound, bound), True)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}, "
                f"padding={self._padding}")


__all__ = ["Conv2D"]
