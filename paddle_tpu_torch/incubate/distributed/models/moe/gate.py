"""MoE gates: a linear router over the experts.

Mirrors ``paddle_tpu/incubate/distributed/models/moe/gate.py``:
``BaseGate`` (weight ``[d_model, tot_expert]`` Xavier-uniform, bias
zeros), ``NaiveGate`` (no aux loss), ``GShardGate`` (capacity factors,
random second expert) and ``SwitchGate`` (top-1). The gate scores tokens;
the ``MoELayer`` turns scores into routes and stashes the load-balance
loss on the gate (``set_loss``/``get_loss``). The capacity factors and
``second_policy`` are kept for the capacity path, which is not ported
yet: the dropless path reads neither.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..... import resolve_device
from .....nn import functional as F
from .....nn.initializer import xavier_uniform_
from .....nn.layer.layers import Layer


class BaseGate(Layer):
    """Linear router over experts: ``top_k`` choices per token;
    ``capacity_factor(train)`` bounds tokens per expert (None = no bound)."""

    top_k: int = 2
    second_policy: str = "all"
    use_aux_loss: bool = True  # load-balance loss added to the objective

    def __init__(self, d_model: int, num_expert: int, world_size: int = 1,
                 top_k: int = 2, gate_bias: bool = True, *, device=None,
                 dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        dt = dtype or torch.float32
        self.d_model = d_model
        self.num_expert = num_expert
        self.world_size = world_size
        self.tot_expert = num_expert * world_size
        self.top_k = top_k
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.weight = nn.Parameter(torch.empty(d_model, self.tot_expert,
                                               device=dev, dtype=dt))
        xavier_uniform_(self.weight, generator)
        self.bias = nn.Parameter(torch.zeros(self.tot_expert, device=dev,
                                             dtype=dt)) if gate_bias else None
        self.loss = None

    def capacity_factor(self, training: bool) -> Optional[float]:
        return None

    def forward(self, x):
        """x: [tokens, d_model] -> logits [tokens, tot_expert]."""
        return F.linear(x, self.weight, self.bias)

    def set_loss(self, loss):
        self.loss = loss

    def get_loss(self, clear: bool = True):
        loss = self.loss
        if clear:
            self.loss = None
        return loss


class NaiveGate(BaseGate):
    """Plain top-k routing, no capacity limit, no auxiliary loss."""

    use_aux_loss = False


class GShardGate(BaseGate):
    """Top-2, capacity-bounded, random second expert, load-balance loss."""

    def __init__(self, d_model, num_expert, world_size=1, top_k=2,
                 capacity=(1.2, 2.4), random_routing=True, group=None,
                 gate_bias=True, **kw):
        super().__init__(d_model, num_expert, world_size, top_k,
                         gate_bias=gate_bias, **kw)
        self.capacity = tuple(capacity)
        self.second_policy = "random" if random_routing else "all"

    def capacity_factor(self, training: bool) -> Optional[float]:
        return self.capacity[0] if training else self.capacity[1]


class SwitchGate(BaseGate):
    """Top-1 (Switch Transformer) with a capacity bound and the same
    load-balance loss."""

    def __init__(self, d_model, num_expert, world_size=1, top_k=1,
                 capacity=(1.2, 2.4), group=None, gate_bias=True, **kw):
        super().__init__(d_model, num_expert, world_size, top_k=1,
                         gate_bias=gate_bias, **kw)
        self.capacity = tuple(capacity)

    def capacity_factor(self, training: bool) -> Optional[float]:
        return self.capacity[0] if training else self.capacity[1]


__all__ = ["BaseGate", "NaiveGate", "GShardGate", "SwitchGate"]
