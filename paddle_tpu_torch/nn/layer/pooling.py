"""``MaxPool2D`` and ``AdaptiveAvgPool2D`` (``paddle_tpu/nn/layer/
pooling.py:32, :102``) as ``Layer``s over the functionals."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.return_mask = return_mask
        self.ceil_mode = ceil_mode
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.return_mask, self.ceil_mode,
                            self.data_format)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self._output_size = output_size
        self._data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self._output_size, self._data_format)


__all__ = ["MaxPool2D", "AdaptiveAvgPool2D"]
