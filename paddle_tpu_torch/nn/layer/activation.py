"""``ReLU`` and ``GELU`` (``paddle_tpu/nn/layer/activation.py:26, :40``)
as ``nn.Module``s over the functionals."""
from __future__ import annotations

from torch import nn

from .. import functional as F


class ReLU(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class GELU(nn.Module):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self._approximate = approximate

    def forward(self, x):
        return F.gelu(x, self._approximate)


__all__ = ["ReLU", "GELU"]
