"""The layers of ``paddle_tpu/nn/layer/norm.py`` as ``Layer``s:
``LayerNorm``, ``GroupNorm``, the BatchNorms (``BatchNorm``,
``BatchNorm1D`` / ``2D`` / ``3D``, ``SyncBatchNorm`` at world size 1 with
``convert_sync_batchnorm``), ``RMSNorm``, ``InstanceNorm1D`` / ``2D`` /
``3D`` and ``LocalResponseNorm``: weight ones and bias zeros of the
normalised shape or of the channels (either left out with ``weight_attr=
False`` / ``bias_attr=False``; a ``ParamAttr``'s initializer or the global
one where set), on an explicit ``device`` (None = the GPU) in ``dtype``
(float32). BatchNorm keeps its running statistics as the float32 buffers
``_mean`` (zeros) and ``_variance`` (ones), the JAX names.
``F.layer_norm``, ``F.group_norm``, ``F.instance_norm``, ``F.batch_norm``
and ``F.rms_norm`` run Triton kernels on CUDA tensors."""
from __future__ import annotations

import torch

from .. import functional as F
from .layers import Layer, make_parameter, placement


def _ones(t):
    return t.fill_(1.0)


def _zeros(t):
    return t.zero_()


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__()
        dev, dt = placement(device, dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        shape = tuple(self._normalized_shape)
        self.weight = make_parameter(shape, weight_attr, dev, dt, _ones)
        self.bias = make_parameter(shape, bias_attr, dev, dt, _zeros, True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class GroupNorm(Layer):
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
                                     _ones)
        self.bias = make_parameter((num_channels,), bias_attr, dev, dt,
                                   _zeros, True)

    def forward(self, x, then=None):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format, then=then)

    def extra_repr(self):
        return (f"num_groups={self._num_groups}, "
                f"num_channels={self._num_channels}")


class _BatchNormBase(Layer):
    """``F.batch_norm`` over ``num_features`` channels;
    ``forward(x, residual=None, then=None)`` fuses the residual add and
    the ReLU that follow it (see ``F.batch_norm``)."""

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
                                     _ones)
        self.bias = make_parameter((num_features,), bias_attr, dev, dt,
                                   _zeros, True)
        self.register_buffer("_mean", torch.zeros(num_features,
                                                  dtype=torch.float32,
                                                  device=dev))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     dtype=torch.float32,
                                                     device=dev))

    def forward(self, x, residual=None, then=None):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats,
                            residual=residual, then=then)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """``paddle_tpu``'s ``SyncBatchNorm`` on one device: plain BatchNorm
    (the port has no process group to reduce the statistics over)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every BatchNorm in it (itself included) replaced
        by a ``SyncBatchNorm`` of its features, momentum, epsilon and
        format, on its device, holding copies of its weight, bias and
        running statistics, as the JAX classmethod (``norm.py:73-88``)."""
        if isinstance(layer, _BatchNormBase) \
                and not isinstance(layer, SyncBatchNorm):
            new = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon,
                                data_format=layer._data_format,
                                device=layer._mean.device)
            with torch.no_grad():
                for name in ("weight", "bias"):
                    src = getattr(layer, name)
                    if src is not None:
                        getattr(new, name).copy_(src)
                new._mean.copy_(layer._mean)
                new._variance.copy_(layer._variance)
            return new
        for name, sub in list(layer.named_children()):
            setattr(layer, name, cls.convert_sync_batchnorm(sub))
        return layer


class RMSNorm(Layer):
    """``F.rms_norm`` over the last axis with a weight of ones (the Triton
    kernel on CUDA tensors)."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None, dtype=None):
        super().__init__()
        dev, dt = placement(device, dtype)
        self._hidden_size = hidden_size
        self._epsilon = epsilon
        self.weight = make_parameter((hidden_size,), weight_attr, dev, dt,
                                     _ones)

    def forward(self, x):
        return F.rms_norm(x, self.weight, epsilon=self._epsilon)


class _InstanceNormBase(Layer):
    """``F.instance_norm`` (no running statistics) with a weight and bias
    of ``num_features``."""

    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=None):
        super().__init__()
        dev, dt = placement(device, dtype)
        self._num_features = num_features
        self._epsilon = epsilon
        self.weight = make_parameter((num_features,), weight_attr, dev, dt,
                                     _ones)
        self.bias = make_parameter((num_features,), bias_attr, dev, dt,
                                   _zeros, True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=0.0001, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


__all__ = ["LayerNorm", "GroupNorm", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "SyncBatchNorm", "RMSNorm",
           "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
           "LocalResponseNorm"]
