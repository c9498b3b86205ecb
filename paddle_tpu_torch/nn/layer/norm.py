"""``LayerNorm``, ``GroupNorm`` and ``BatchNorm2D``
(``paddle_tpu/nn/layer/norm.py:90, :133, :15 / :59``) as ``nn.Module``s:
weight ones and bias zeros of the normalised shape or of the channels
(either left out with ``weight_attr=False`` / ``bias_attr=False``), on an
explicit ``device`` (None = the GPU) in ``dtype`` (float32). BatchNorm
keeps its running statistics as the float32 buffers ``_mean`` (zeros) and
``_variance`` (ones), the JAX names. ``F.layer_norm`` and ``F.group_norm``
run Triton kernels on CUDA tensors."""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F
from .layers import make_parameter, placement


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__()
        dev, dt = placement(device, dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        shape = tuple(self._normalized_shape)
        self.weight = make_parameter(shape, weight_attr, dev, dt,
                                     lambda t: t.fill_(1.0))
        self.bias = make_parameter(shape, bias_attr, dev, dt,
                                   torch.Tensor.zero_)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class GroupNorm(nn.Module):
    """``F.group_norm`` over ``num_groups`` groups of ``num_channels``;
    ``forward(x, then="silu")`` fuses the SiLU that follows (see
    ``F.group_norm``'s ``then``)."""

    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=None):
        super().__init__()
        dev, dt = placement(device, dtype)
        self._num_groups = num_groups
        self._num_channels = num_channels
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = make_parameter((num_channels,), weight_attr, dev, dt,
                                     lambda t: t.fill_(1.0))
        self.bias = make_parameter((num_channels,), bias_attr, dev, dt,
                                   torch.Tensor.zero_)

    def forward(self, x, then=None):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format, then=then)

    def extra_repr(self):
        return (f"num_groups={self._num_groups}, "
                f"num_channels={self._num_channels}")


class _BatchNormBase(nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None):
        super().__init__()
        dev, dt = placement(device, dtype)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = make_parameter((num_features,), weight_attr, dev, dt,
                                     lambda t: t.fill_(1.0))
        self.bias = make_parameter((num_features,), bias_attr, dev, dt,
                                   torch.Tensor.zero_)
        self.register_buffer("_mean", torch.zeros(num_features,
                                                  dtype=torch.float32,
                                                  device=dev))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     dtype=torch.float32,
                                                     device=dev))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm2D(_BatchNormBase):
    pass


__all__ = ["LayerNorm", "GroupNorm", "BatchNorm2D"]
