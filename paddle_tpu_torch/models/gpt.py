"""GPT model family, dense and MoE: configuration, parameters, forward and
loss.

Mirrors ``paddle_tpu/models/gpt.py``: pre-LN GPT-2 blocks with learned
position embeddings, a GELU MLP (erf form) or, every ``moe_every`` blocks,
an ``MoELayer`` (whose experts use ``jax.nn.gelu``'s tanh form), causal
attention and a weight-tied head. The same configuration fields and
presets, the same parameter names (``transformer.h.{i}.attn.qkv_proj.
weight``, ``transformer.h.{i}.mlp.w1``, ``...mlp.gate.weight``, ...) and
Paddle's linear layout ``[in, out]``, so a state carried across from the
JAX model (``load_numpy_state``) fills this one name for name. The same
initial distributions: Xavier-normal projections, zero biases, unit
LayerNorm weights, ``wte`` normal with std 0.02, ``wpe`` standard normal.

Attention goes through ``nn.functional.scaled_dot_product_attention``
(the flash kernels on CUDA tensors), the MoE blocks through the gmm and
tgmm kernels; dense products go to ``torch.matmul``, as the JAX package
leaves them to XLA. The MoE blocks are built as the JAX model builds them,
without ``dropless``: set ``blk.mlp.dropless = True`` on each (the JAX
layer reads the flag at forward time too) to run the dropless path, the
only one ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from .. import resolve_device
from ..incubate.distributed.models.moe import MoELayer
from ..nn import functional as F
from ..nn.initializer import xavier_normal_
from ..nn.layer.layers import Layer
from .llama import load_numpy_state


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    intermediate_size: Optional[int] = None  # None = 4 * hidden
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 1024
    layer_norm_epsilon: float = 1e-5
    tie_word_embeddings: bool = True
    # MoE (num_experts == 0 -> dense GPT)
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_every: int = 2          # MoE FFN every N-th block (GShard style)
    moe_gate: str = "gshard"
    aux_loss_weight: float = 0.01
    dtype: str = "float32"

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    @staticmethod
    def gpt2_small():
        return GPTConfig()

    @staticmethod
    def gpt_moe(experts: int = 8, **kw):
        return GPTConfig(num_experts=experts, **kw)

    @staticmethod
    def tiny(vocab_size=256, hidden_size=64, layers=2, heads=4, seq=64,
             num_experts=0, **kw):
        return GPTConfig(vocab_size=vocab_size, hidden_size=hidden_size,
                         intermediate_size=hidden_size * 2,
                         num_hidden_layers=layers, num_attention_heads=heads,
                         max_position_embeddings=seq, num_experts=num_experts,
                         **kw)


class _Linear(Layer):
    """A linear layer with bias, weight in Paddle's ``[in, out]`` layout."""

    def __init__(self, n_in, n_out, device, dtype, generator, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_in, n_out, device=device,
                                               dtype=dtype))
        xavier_normal_(self.weight, generator)
        self.bias = nn.Parameter(torch.zeros(n_out, device=device,
                                             dtype=dtype)) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class _LayerNorm(Layer):
    def __init__(self, hidden, eps, device, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(hidden, device=device,
                                              dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(hidden, device=device,
                                             dtype=dtype))
        self.eps = eps

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1], self.weight, self.bias, self.eps)


class _Embedding(Layer):
    def __init__(self, n, hidden, std, device, dtype, generator):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, hidden, device=device,
                                               dtype=dtype))
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class GPTAttention(Layer):
    def __init__(self, config: GPTConfig, device, dtype, generator):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = h // self.num_heads
        self.qkv_proj = _Linear(h, 3 * h, device, dtype, generator)
        self.out_proj = _Linear(h, h, device, dtype, generator)

    def forward(self, x, attention_mask=None):
        b, s, h = x.shape
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.num_heads,
                                       self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out = F.scaled_dot_product_attention(q, k, v,
                                             attn_mask=attention_mask,
                                             is_causal=True)
        return self.out_proj(out.reshape(b, s, h))


class GPTMLP(Layer):
    def __init__(self, config: GPTConfig, device, dtype, generator):
        super().__init__()
        self.fc_in = _Linear(config.hidden_size, config.ffn_size, device,
                             dtype, generator)
        self.fc_out = _Linear(config.ffn_size, config.hidden_size, device,
                              dtype, generator)

    def forward(self, x):
        return self.fc_out(F.gelu(self.fc_in(x)))


class GPTBlock(Layer):
    def __init__(self, config: GPTConfig, layer_idx: int, device, dtype,
                 generator):
        super().__init__()
        eps = config.layer_norm_epsilon
        self.ln_1 = _LayerNorm(config.hidden_size, eps, device, dtype)
        self.attn = GPTAttention(config, device, dtype, generator)
        self.ln_2 = _LayerNorm(config.hidden_size, eps, device, dtype)
        use_moe = (config.num_experts > 0
                   and (layer_idx + 1) % max(1, config.moe_every) == 0)
        if use_moe:
            self.mlp = MoELayer(config.hidden_size, config.ffn_size,
                                num_expert=config.num_experts,
                                top_k=config.moe_top_k,
                                capacity_factor=config.moe_capacity_factor,
                                gate=config.moe_gate, device=device,
                                dtype=dtype, generator=generator)
        else:
            self.mlp = GPTMLP(config, device, dtype, generator)
        self.is_moe = use_moe

    def forward(self, x, attention_mask=None):
        x = x + self.attn(self.ln_1(x), attention_mask)
        return x + self.mlp(self.ln_2(x))


class GPTModel(Layer):
    def __init__(self, config: GPTConfig, device, dtype, generator):
        super().__init__()
        self.config = config
        self.wte = _Embedding(config.vocab_size, config.hidden_size, 0.02,
                              device, dtype, generator)
        self.wpe = _Embedding(config.max_position_embeddings,
                              config.hidden_size, 1.0, device, dtype,
                              generator)
        self.h = nn.ModuleList(GPTBlock(config, i, device, dtype, generator)
                               for i in range(config.num_hidden_layers))
        self.ln_f = _LayerNorm(config.hidden_size, config.layer_norm_epsilon,
                               device, dtype)

    def forward(self, input_ids, attention_mask=None):
        b, s = input_ids.shape
        if s > self.config.max_position_embeddings:
            raise ValueError(
                f"sequence length {s} exceeds max_position_embeddings "
                f"{self.config.max_position_embeddings}")
        pos = torch.arange(s, device=input_ids.device)
        x = self.wte(input_ids) + self.wpe(pos)
        for block in self.h:
            x = block(x, attention_mask)
        return self.ln_f(x)


class GPTForCausalLM(Layer):
    """GPT parameters on ``device`` (None = the GPU; raises without one),
    in ``dtype`` (None = ``config.dtype``), initialised from ``generator``
    (None = a generator seeded with 0)."""

    def __init__(self, config: GPTConfig, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        dt = dtype or getattr(torch, config.dtype)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.config = config
        self.transformer = GPTModel(config, dev, dt, generator)
        self.lm_head = None if config.tie_word_embeddings else \
            _Linear(config.hidden_size, config.vocab_size, dev, dt,
                    generator, bias=False)

    @property
    def device(self) -> torch.device:
        return self.transformer.ln_f.weight.device

    def generate(self, input_ids, attention_mask=None, **kwargs):
        """KV-cached autoregressive decoding (greedy / temperature / top-k
        / top-p, ``quant``; see generation.generate), on the model's
        device."""
        from ..generation import generate
        return generate(self, input_ids, attention_mask=attention_mask,
                        device=kwargs.pop("device", self.device), **kwargs)

    def forward(self, input_ids, attention_mask=None):
        """Logits [b, s, vocab] in the model's dtype."""
        h = self.transformer(input_ids, attention_mask)
        if self.lm_head is None:
            return h @ self.transformer.wte.weight.T
        return self.lm_head(h)

    def aux_loss(self):
        """Sum of the MoE load-balance losses of the last forward, times
        ``aux_loss_weight``; None without MoE blocks."""
        total = None
        for block in self.transformer.h:
            if getattr(block, "is_moe", False) and block.mlp.l_aux is not None:
                total = block.mlp.l_aux if total is None \
                    else total + block.mlp.l_aux
        if total is None:
            return None
        return total * self.config.aux_loss_weight

    def compute_loss(self, logits, labels):
        """Shifted next-token cross entropy plus the scaled aux loss."""
        b, s, v = logits.shape
        loss = F.cross_entropy(logits[:, :-1, :].reshape(b * (s - 1), v),
                               labels[:, 1:].reshape(b * (s - 1)))
        aux = self.aux_loss()
        return loss if aux is None else loss + aux

    def num_params(self):
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self, seq_len: int) -> float:
        """Training FLOPs/token; the MoE blocks count only the activated
        experts (top_k of them)."""
        c = self.config
        n_dense = sum(p.numel() for name, p in self.named_parameters()
                      if ".mlp.w" not in name and ".mlp.b" not in name)
        moe_blocks = sum(1 for blk in self.transformer.h
                         if getattr(blk, "is_moe", False))
        active_expert = (2 * c.hidden_size * c.ffn_size) * c.moe_top_k
        # causal attention matmuls: 12*L*h*s fwd+bwd, halved by causality
        attn = 6.0 * c.num_hidden_layers * c.hidden_size * seq_len
        return 6.0 * (n_dense + moe_blocks * active_expert) + attn


__all__ = ["GPTConfig", "GPTForCausalLM", "GPTModel", "GPTBlock",
           "GPTAttention", "GPTMLP", "load_numpy_state"]
