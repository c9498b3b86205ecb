"""``Identity``, ``Linear``, ``Embedding``, ``Dropout`` and ``Flatten``
(``paddle_tpu/nn/layer/common.py:12, :20, :47, :69, :115``) as
``nn.Module``s: the
JAX layers' arguments, parameter names, layouts and initial distributions
(``Linear``: weight ``[in, out]`` Xavier-normal, bias zeros;
``Embedding``: Normal(0, 1), the padding row zeros), drawn on an explicit
``device`` (None = the GPU) in ``dtype`` (float32) from ``generator``
(None = torch's default generator of the device)."""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F
from ..initializer import xavier_normal_
from .layers import make_parameter, placement


class Identity(nn.Module):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Linear(nn.Module):
    """y = xW + b, weight ``[in_features, out_features]``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        dev, dt = placement(device, dtype)
        self._in_features = in_features
        self._out_features = out_features
        self.weight = make_parameter(
            (in_features, out_features), weight_attr, dev, dt,
            lambda t: xavier_normal_(t, generator))
        self.bias = make_parameter((out_features,), bias_attr, dev, dt,
                                   torch.Tensor.zero_, True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        dev, dt = placement(device, dtype)
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._sparse = sparse
        self._padding_idx = (padding_idx if padding_idx is None
                             or padding_idx >= 0
                             else num_embeddings + padding_idx)

        def init(t):
            t.normal_(0.0, 1.0, generator=generator)
            if self._padding_idx is not None:
                t[self._padding_idx] = 0.0
        self.weight = make_parameter((num_embeddings, embedding_dim),
                                     weight_attr, dev, dt, init)

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx,
                           sparse=self._sparse)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(nn.Module):
    """``F.dropout`` with the module's ``training`` flag."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Flatten(nn.Module):
    """``torch.flatten`` of the axes ``start_axis`` to ``stop_axis``."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


__all__ = ["Identity", "Linear", "Embedding", "Dropout", "Flatten"]
