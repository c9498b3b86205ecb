"""The ragged serving step of a Llama model, over its weight tensors.

Mirrors ``paddle_tpu/generation.py``'s ``_LlamaDecoder.step_ragged``: one
packed batch of tokens from many sequences (prefill chunks and decode
tokens together) goes through every layer, writes its K/V into the paged
pools and attends over them. PyTorch runs it eagerly; the RMSNorms, the
rotary embedding and the attention go through the port's kernels on a
CUDA tensor and through their plain versions on a CPU tensor, and the
large matrix products go to ``torch.matmul``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernels import fused


def _rms(x, w, eps):
    return fused.rms_norm(x, w, eps)


def _add_rms(h, o, w, eps):
    """(h + o, RMSNorm(h + o)): the residual add and the next norm in one
    pass; equals ``h = h + o; _rms(h, w, eps)`` in float32 and in bf16
    (the norm reads the sum rounded to h's dtype)."""
    return fused.add_rms_norm(h, o, w, eps)


def _rope_rows(q, k, cos, sin):
    """Rotate pairs of q [B, S, H, D] and k [B, S, kvh, D] with PER-ROW
    tables cos/sin [B, S, D/2] (already gathered at each row's position)."""
    b, s, h, d = q.shape
    oq, ok = fused.fused_rope(q.reshape(1, b * s, h, d),
                              k.reshape(1, b * s, k.shape[2], d),
                              cos.reshape(b * s, d // 2),
                              sin.reshape(b * s, d // 2))
    return oq.reshape(q.shape), ok.reshape(k.shape)


def _head_logits(w, h, tied, embed_key):
    """The LM-head matmul: the tied embedding's transpose, or lm_head."""
    if tied:
        return h @ w[embed_key].T
    return h @ w["lm_head.weight"]


class _LlamaDecoder:
    """Functions over a LlamaForCausalLM's weights; holds only the static
    configuration."""

    def __init__(self, model):
        cfg = model.config
        self.cfg = cfg
        self.n_heads = cfg.num_attention_heads
        self.n_kv = cfg.num_key_value_heads or self.n_heads
        self.hd = cfg.hidden_size // self.n_heads
        self.eps = cfg.rms_norm_eps
        self.n_layers = cfg.num_hidden_layers
        self.tied = model.lm_head is None
        self.embed_key = "model.embed_tokens.weight"

    @staticmethod
    def weights(model):
        """{name: tensor}: parameters plus the rope tables, upcast to fp32
        (the RoPE kernel takes fp32 tables; after ``model.bfloat16()`` the
        buffers hold the JAX model's bf16-rounded values, which the upcast
        keeps exactly)."""
        w = {n: p.detach() for n, p in model.named_parameters()}
        w["__rope_cos"] = model.model.rope_cos.float()
        w["__rope_sin"] = model.model.rope_sin.float()
        return w

    @staticmethod
    def _lw(w, i, name):
        return w[f"model.layers.{i}.{name}"]

    def _qkv_proj(self, w, i, x, b, s):
        pre = f"model.layers.{i}.self_attn."
        q = (x @ w[pre + "q_proj.weight"]).reshape(b, s, self.n_heads,
                                                   self.hd)
        k = (x @ w[pre + "k_proj.weight"]).reshape(b, s, self.n_kv, self.hd)
        v = (x @ w[pre + "v_proj.weight"]).reshape(b, s, self.n_kv, self.hd)
        return q, k, v

    def _post_attn(self, w, i, h, att):
        """Residual + output projection + SwiGLU MLP; att: [B, S, H*D]."""
        pre = f"model.layers.{i}."
        h, x2 = _add_rms(h, att @ w[pre + "self_attn.o_proj.weight"],
                         self._lw(w, i, "post_attention_layernorm.weight"),
                         self.eps)
        gate = x2 @ w[pre + "mlp.gate_proj.weight"]
        up = x2 @ w[pre + "mlp.up_proj.weight"]
        swi = F.silu(gate.float()).to(up.dtype) * up
        return h + swi @ w[pre + "mlp.down_proj.weight"]

    def _layer_ragged(self, w, i, h, cos, sin, kp, vp, scatter, attend):
        """One layer over a packed [T, 1, ...] batch. kp/vp: [P, kvh, bs, D]
        pools of this layer, written IN PLACE (the JAX program donates
        them); scatter: (pages, offs, rows) — the kept rows' write
        targets; attend(q [T, H, D], kp, vp) -> [T, H, D]."""
        t, s, _ = h.shape
        x = _rms(h, self._lw(w, i, "input_layernorm.weight"), self.eps)
        q, k, v = self._qkv_proj(w, i, x, t, s)
        q, k = _rope_rows(q, k, cos, sin)
        pages, offs, rows = scatter
        kp[pages, :, offs, :] = k[rows, 0].to(kp.dtype)
        vp[pages, :, offs, :] = v[rows, 0].to(vp.dtype)
        att = attend(q[:, 0], kp, vp).reshape(t, 1, -1)
        return self._post_attn(w, i, h, att)

    def step_ragged(self, w, tokens, positions, k_pools, v_pools, scatter,
                    attend):
        """tokens/positions: [T] packed mixed-phase batch; k_pools/v_pools:
        [L, P, kvh, bs, D], updated in place; scatter: (pages [T], offs [T])
        per-token write targets, page index P meaning "write nowhere";
        attend as in _layer_ragged. Returns logits [T, V].

        The JAX program drops page-P rows in its scatter (mode="drop");
        indexing with P raises in PyTorch, so the rows are masked out once
        here, before any layer writes."""
        pages, offs = scatter
        rows = torch.nonzero(pages < k_pools.shape[1]).squeeze(1)
        scatter = (pages[rows], offs[rows], rows)
        h = w[self.embed_key][tokens][:, None]          # [T, 1, H*D]
        cos = w["__rope_cos"][positions][:, None]       # [T, 1, hd/2]
        sin = w["__rope_sin"][positions][:, None]
        for i in range(self.n_layers):
            h = self._layer_ragged(w, i, h, cos, sin, k_pools[i], v_pools[i],
                                   scatter, attend)
        return self._logits(w, h)[:, 0]

    def _logits(self, w, h):
        h = _rms(h, w["model.norm.weight"], self.eps)
        return _head_logits(w, h, self.tied, self.embed_key)


def _decoder_for(model):
    """The model's decoder, built once per model instance (Llama only)."""
    from .models.llama import LlamaForCausalLM
    if not isinstance(model, LlamaForCausalLM):
        raise NotImplementedError(
            f"the port serves Llama models only, not {type(model).__name__}")
    dec = model.__dict__.get("_decode_cache")
    if dec is None:
        dec = _LlamaDecoder(model)
        model.__dict__["_decode_cache"] = dec
    return dec


__all__ = ["_LlamaDecoder", "_decoder_for"]
