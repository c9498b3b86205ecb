"""``LayerNorm`` (``paddle_tpu/nn/layer/norm.py:90``) as an ``nn.Module``:
weight ones and bias zeros of ``normalized_shape`` (either left out with
``weight_attr=False`` / ``bias_attr=False``), on an explicit ``device``
(None = the GPU) in ``dtype`` (float32). Its forward is
``F.layer_norm``: the Triton kernel on CUDA tensors."""
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


__all__ = ["LayerNorm"]
