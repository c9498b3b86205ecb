"""Mixture-of-experts FFN layer: the dropless path.

Mirrors ``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``
``MoELayer``: the same constructor, the stacked expert banks ``w1 [e, d,
h]``, ``b1 [e, h]``, ``w2 [e, h, d]``, ``b2 [e, d]`` (per-expert Xavier
fans, zero biases) and the gate (``mlp.gate.weight``, ...), so a JAX
layer's state carries across name for name. With ``dropless`` set (at
construction or afterwards, as the JAX layer reads it at forward time)
the forward is ``kernels.gmm.moe_dropless_ffn``: grouped matmuls over
expert-sorted tokens, the gmm and tgmm kernels on CUDA tensors. After a
forward, ``l_aux`` (and the gate's loss) holds the load-balance loss when
the gate uses one.

Not ported yet (each raises ``NotImplementedError``; ROADMAP Queue 1):
the capacity path (``top_k_gating`` and the dense dispatch of
``moe_expert_ffn``), which runs no kernel, with GShard's random second
expert; and the ``experts=[...]`` list backend.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as TF
from torch import nn

from ..... import resolve_device
from .....kernels.gmm import gelu_tanh, moe_dropless_ffn
from .....nn.initializer import xavier_uniform_
from .....nn.layer.layers import Layer
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate

# jax.nn's activations by name; jax.nn.gelu defaults to the tanh form
_ACTS = {"gelu": gelu_tanh, "relu": TF.relu, "silu": TF.silu,
         "swish": TF.silu, "tanh": torch.tanh}


def _resolve_act(activation) -> Callable:
    if callable(activation):
        return _ACTS.get(getattr(activation, "__name__", ""), activation)
    return _ACTS[str(activation)]


def _unported(what):
    return NotImplementedError(
        f"MoELayer: {what} is not ported to paddle_tpu_torch yet (ROADMAP "
        f"Queue 1); set dropless=True for the grouped-matmul path")


class MoELayer(Layer):
    """Mixture-of-experts FFN block over stacked expert banks. Parameters
    on ``device`` (None = the GPU; raises without one) in ``dtype`` (None
    = float32), drawn from ``generator`` (None = a generator seeded with
    0)."""

    def __init__(self, d_model: int, d_hidden: Optional[int] = None,
                 num_expert: int = 8, top_k: int = 2,
                 capacity_factor: Optional[float] = 1.25,
                 gate: Union[str, BaseGate] = "gshard",
                 experts: Optional[Sequence[nn.Module]] = None,
                 activation="gelu", ep_axis: str = "ep",
                 moe_group=None, recompute_interval: int = 0,
                 dropless: bool = False, name=None, *, device=None,
                 dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if experts is not None:
            raise _unported("the experts=[...] list backend")
        dev = resolve_device(device)
        dt = dtype or torch.float32
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.dropless = dropless
        self.d_model = d_model
        self.d_hidden = d_hidden or 4 * d_model
        self._act = _resolve_act(activation)
        e, d, h = num_expert, d_model, self.d_hidden
        if isinstance(gate, BaseGate):
            e = gate.tot_expert
        self.num_expert = e
        self.w1 = nn.Parameter(torch.empty(e, d, h, device=dev, dtype=dt))
        self.b1 = nn.Parameter(torch.zeros(e, h, device=dev, dtype=dt))
        self.w2 = nn.Parameter(torch.empty(e, h, d, device=dev, dtype=dt))
        self.b2 = nn.Parameter(torch.zeros(e, d, device=dev, dtype=dt))
        xavier_uniform_(self.w1, generator, fan_in=d, fan_out=h)
        xavier_uniform_(self.w2, generator, fan_in=h, fan_out=d)
        if isinstance(gate, BaseGate):
            self.gate = gate
        else:
            kw = dict(device=dev, dtype=dt, generator=generator)
            cap = (capacity_factor, capacity_factor * 2 if capacity_factor
                   else None)
            if gate == "gshard":
                self.gate = GShardGate(d_model, num_expert, top_k=top_k,
                                       capacity=cap, **kw)
            elif gate == "switch":
                self.gate = SwitchGate(d_model, num_expert, capacity=cap,
                                       **kw)
            elif gate == "naive":
                self.gate = NaiveGate(d_model, num_expert, top_k=top_k, **kw)
            else:
                raise ValueError(f"unknown gate {gate!r}")
        self.l_aux = None
        # the capacity path's per-expert bound when set (None: the gate's
        # factor); generate() and the serving engine read it, as in the
        # JAX layer, to decide whether eval routing drops tokens
        self._capacity_override = None

    def forward(self, x):
        if not self.dropless:
            raise _unported("the capacity path (top_k_gating, "
                            "moe_expert_ffn)")
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        logits = self.gate(x2)
        out2, aux = moe_dropless_ffn(x2, logits, self.gate.top_k, self.w1,
                                     self.b1, self.w2, self.b2, act=self._act)
        if self.gate.use_aux_loss:
            self.l_aux = aux
            self.gate.set_loss(aux)
        else:
            self.l_aux = None
        return out2.reshape(shape)


__all__ = ["MoELayer"]
