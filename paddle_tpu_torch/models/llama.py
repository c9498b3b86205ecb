"""Llama-2 model family: configuration and parameter holder.

Mirrors ``paddle_tpu/models/llama.py``: the same configuration fields and
presets, the same parameter names (``model.layers.{i}.self_attn.q_proj.
weight``, ...) and Paddle's linear layout ``[in, out]`` (computed as
``x @ w``), so a state carried across from the JAX model fills this one
name for name. Serving reads the parameters through
``generation._LlamaDecoder``; the dense ``forward`` needs the flash
attention kernel and comes with the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .. import resolve_device


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None  # GQA; None = MHA
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: str = "float32"

    @staticmethod
    def llama2_7b():
        return LlamaConfig()

    @staticmethod
    def tiny(vocab_size=256, hidden_size=64, layers=2, heads=4, kv_heads=2,
             seq=128):
        return LlamaConfig(vocab_size=vocab_size, hidden_size=hidden_size,
                           intermediate_size=hidden_size * 2,
                           num_hidden_layers=layers, num_attention_heads=heads,
                           num_key_value_heads=kv_heads,
                           max_position_embeddings=seq)


def build_rope_cache(seq_len: int, head_dim: int, theta: float = 10000.0,
                     device=None):
    """cos/sin tables [seq_len, head_dim / 2] in fp32: fp32 inverse
    frequencies, fp32 outer product, then cos and sin."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                             dtype=torch.float32,
                                             device=device) / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def _param(*shape, device, dtype):
    return nn.Parameter(torch.empty(*shape, device=device, dtype=dtype))


class _Linear(nn.Module):
    """A bias-free linear layer's weight in Paddle's ``[in, out]`` layout."""

    def __init__(self, n_in, n_out, device, dtype):
        super().__init__()
        self.weight = _param(n_in, n_out, device=device, dtype=dtype)


class _Norm(nn.Module):
    def __init__(self, hidden, device, dtype):
        super().__init__()
        self.weight = _param(hidden, device=device, dtype=dtype)


class _Embedding(nn.Module):
    def __init__(self, vocab, hidden, device, dtype):
        super().__init__()
        self.weight = _param(vocab, hidden, device=device, dtype=dtype)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device, dtype):
        super().__init__()
        heads = cfg.num_attention_heads
        kvh = cfg.num_key_value_heads or heads
        hd = cfg.hidden_size // heads
        h = cfg.hidden_size
        self.q_proj = _Linear(h, heads * hd, device, dtype)
        self.k_proj = _Linear(h, kvh * hd, device, dtype)
        self.v_proj = _Linear(h, kvh * hd, device, dtype)
        self.o_proj = _Linear(heads * hd, h, device, dtype)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device, dtype):
        super().__init__()
        h, i = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = _Linear(h, i, device, dtype)
        self.up_proj = _Linear(h, i, device, dtype)
        self.down_proj = _Linear(i, h, device, dtype)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device, dtype):
        super().__init__()
        self.self_attn = LlamaAttention(cfg, device, dtype)
        self.mlp = LlamaMLP(cfg, device, dtype)
        self.input_layernorm = _Norm(cfg.hidden_size, device, dtype)
        self.post_attention_layernorm = _Norm(cfg.hidden_size, device, dtype)


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, device, dtype):
        super().__init__()
        self.embed_tokens = _Embedding(cfg.vocab_size, cfg.hidden_size,
                                       device, dtype)
        self.layers = nn.ModuleList(
            LlamaDecoderLayer(cfg, device, dtype)
            for _ in range(cfg.num_hidden_layers))
        self.norm = _Norm(cfg.hidden_size, device, dtype)
        cos, sin = build_rope_cache(
            cfg.max_position_embeddings,
            cfg.hidden_size // cfg.num_attention_heads, cfg.rope_theta,
            device=device)
        # fp32 whatever the model's dtype, as in the JAX model
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)


class LlamaForCausalLM(nn.Module):
    """Llama parameters on ``device`` (None = the GPU; raises without one),
    in ``dtype`` (None = ``config.dtype``), initialised from ``generator``
    (None = a generator seeded with 0): matrices and embeddings normal
    with std 0.02, norm weights one."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        dt = dtype or getattr(torch, config.dtype)
        self.config = config
        self.model = LlamaModel(config, dev, dt)
        self.lm_head = None if config.tie_word_embeddings else \
            _Linear(config.hidden_size, config.vocab_size, dev, dt)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        with torch.no_grad():
            for p in self.parameters():
                if p.dim() == 1:
                    p.fill_(1.0)
                else:
                    p.normal_(0.0, 0.02, generator=generator)

    @property
    def device(self) -> torch.device:
        return self.model.norm.weight.device

    def forward(self, input_ids, attention_mask=None):
        raise NotImplementedError(
            "the dense forward needs the flash-attention kernel, which is "
            "ported with the training slice; serve through "
            "paddle_tpu_torch.serving.ServingEngine")


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":        # ml_dtypes' bfloat16, as JAX gives
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def load_numpy_state(model: nn.Module, state: Dict[str, np.ndarray]) -> None:
    """Fill ``model``'s parameters (and rope buffers, where given) from
    ``{name: array}``, such as the JAX model's
    ``{n: np.asarray(t._data) for n, t in model.named_state().items()}``.
    Every parameter must be given; an unknown name, or a shape or dtype
    that differs, raises before anything is written."""
    params = dict(model.named_parameters())
    targets = {**params, **dict(model.named_buffers())}
    missing = sorted(set(params) - set(state))
    unknown = sorted(set(state) - set(targets))
    if missing or unknown:
        raise KeyError(f"state does not match the model: missing "
                       f"{missing[:8]}, unknown {unknown[:8]}")
    loaded = {}
    for name, arr in state.items():
        src = _to_tensor(np.require(arr, requirements=["C", "W"]))
        dst = targets[name]
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)}, model has "
                             f"{tuple(dst.shape)}")
        if src.dtype != dst.dtype:
            raise TypeError(f"{name}: dtype {src.dtype}, model has "
                            f"{dst.dtype}")
        loaded[name] = src
    with torch.no_grad():
        for name, src in loaded.items():
            targets[name].copy_(src)


__all__ = ["LlamaConfig", "LlamaForCausalLM", "build_rope_cache",
           "load_numpy_state"]
