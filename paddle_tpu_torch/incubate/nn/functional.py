"""``paddle_tpu.incubate.nn.functional``'s
``fused_bias_dropout_residual_layer_norm``
(``paddle_tpu/incubate/nn/functional/fused_ops.py:636``):
``LayerNorm(residual + dropout(x + bias))`` over the last axis, through
``kernels.fused.dropout_add_layer_norm`` (one Triton kernel forward, one
backward, on CUDA tensors; the plain ops on CPU tensors); and
``fused_feedforward`` and ``fused_multi_head_attention`` (``:654``,
``:684``), the JAX compositions of the port's functionals: every
``F.layer_norm`` and ``F.dropout`` runs its Triton kernel on CUDA tensors,
the attention routes as ``F.scaled_dot_product_attention`` routes it
(``kernels/dense_attention.py`` with a mask or a dropout)."""
from __future__ import annotations

import torch

from ... import amp
from ...framework.random import next_key
from ...kernels import dropout as D
from ...kernels import fused
from ...nn import functional as F


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias=None, ln_scale=None, ln_bias=None,
        dropout_rate=0.5, ln_epsilon=1e-5, training=True,
        mode="upscale_in_train", name=None):
    """``LayerNorm(residual + dropout(x + bias))``, the JAX composition's
    ops and roundings, the mask drawn under ``next_key()`` when training
    with ``0 < dropout_rate < 1``. Where the composition is not one
    kernel call (eval under "downscale_in_infer", which scales by ``1 -
    p``; a rate of 1; ``amp`` casting or observing its ops, which the JAX
    composition's ``layer_norm`` makes float32) it runs the port's
    functionals one by one, as the JAX function does."""
    if mode not in D.MODES:
        raise ValueError(f"dropout mode must be one of {D.MODES}, got "
                         f"{mode!r}")
    p = float(dropout_rate) if training else 0.0
    plain = (p >= 1.0 or (not training and mode == "downscale_in_infer")
             or (amp._active() and not amp.amp_state.depth))
    if plain:
        h = x if bias is None else x + bias
        h = F.dropout(h, p=dropout_rate, training=training, mode=mode)
        return F.layer_norm(h + residual, h.shape[-1], weight=ln_scale,
                            bias=ln_bias, epsilon=ln_epsilon)
    key = next_key() if p > 0.0 else None
    return fused.dropout_add_layer_norm(x, ln_scale, ln_bias, ln_epsilon,
                                        residual, bias, p, key, mode)


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True,
                      mode="upscale_in_train", ring_id=-1,
                      add_residual=True, name=None):
    """``residual + dropout2(linear2(dropout1(act(linear1(ln1(x))))))``
    with the LayerNorm before (``pre_layer_norm``: ``ln1``) or after
    (``ln2`` of the sum), weights in Paddle's ``[in, out]`` layout."""
    d = int(x.shape[-1])
    h = x
    if pre_layer_norm:
        h = F.layer_norm(h, d, weight=ln1_scale, bias=ln1_bias,
                         epsilon=ln1_epsilon)
    h = F.linear(h, linear1_weight, linear1_bias)
    h = getattr(F, activation)(h)
    h = F.dropout(h, p=dropout1_rate, training=training, mode=mode)
    h = F.linear(h, linear2_weight, linear2_bias)
    h = F.dropout(h, p=dropout2_rate, training=training, mode=mode)
    if add_residual:
        h = x + h
    if not pre_layer_norm:
        h = F.layer_norm(h, d, weight=ln2_scale, bias=ln2_bias,
                         epsilon=ln2_epsilon)
    return h


@amp.op("fused_qkv_proj")
def _qkv_proj(h, w, b=None):
    """``h [B, S, E]`` by the packed weight ``[3, H, D, E]`` into ``[B, S,
    3, H, D]``, plus the bias ``[3, H, D]``."""
    out = torch.einsum("bse,thde->bsthd", h, w)
    return out if b is None else out + b


@amp.op("fused_mha_cache")
def _extend_cache(cache, k, v):
    """``cache_kv [2, B, H, T, D]`` with this call's k and v ``[B, S, H,
    D]`` appended along T."""
    return torch.cat([cache, torch.stack([k.transpose(1, 2),
                                          v.transpose(1, 2)])], dim=3)


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None,
                               ln_bias=None, pre_ln_epsilon=1e-5,
                               qkv_bias=None, linear_bias=None,
                               cache_kv=None, attn_mask=None,
                               dropout_rate=0.5, attn_dropout_rate=0.5,
                               ln_epsilon=1e-5, training=True,
                               mode="upscale_in_train", ring_id=-1,
                               add_residual=True, num_heads=None,
                               transpose_qkv_wb=False, name=None):
    """Multi-head self-attention of ``x [B, S, E]`` as the JAX function:
    the LayerNorm before (``pre_layer_norm``) or after the residual, one
    packed QKV projection (``qkv_weight [3, H, D, E]``, or ``[E, 3E]``
    with ``transpose_qkv_wb`` and ``num_heads``), ``cache_kv [2, B, H, T,
    D]`` extended with this call's keys and values (returned beside the
    output), ``F.scaled_dot_product_attention`` with
    ``attn_dropout_rate`` in training (0 in eval), the output projection,
    its dropout and the residual."""
    e = int(x.shape[-1])
    h = x
    if pre_layer_norm:
        h = F.layer_norm(h, e, weight=pre_ln_scale, bias=pre_ln_bias,
                         epsilon=pre_ln_epsilon)
    if transpose_qkv_wb:
        if num_heads is None:
            raise ValueError("transpose_qkv_wb=True requires num_heads")
        qkv = F.linear(h, qkv_weight, qkv_bias)
        qkv = qkv.reshape(qkv.shape[0], qkv.shape[1], 3, num_heads,
                          e // num_heads)
    else:
        qkv = _qkv_proj(h, qkv_weight, qkv_bias)
    b, s = qkv.shape[0], qkv.shape[1]
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    new_cache = None
    if cache_kv is not None:
        new_cache = _extend_cache(cache_kv, k, v)
        k = new_cache[0].transpose(1, 2)
        v = new_cache[1].transpose(1, 2)
    ctx = F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask,
        dropout_p=attn_dropout_rate if training else 0.0, is_causal=False,
        training=training)
    out = F.linear(ctx.reshape(b, s, e), linear_weight, linear_bias)
    out = F.dropout(out, p=dropout_rate, training=training, mode=mode)
    if add_residual:
        out = x + out
    if not pre_layer_norm:
        out = F.layer_norm(out, e, weight=ln_scale, bias=ln_bias,
                           epsilon=ln_epsilon)
    if new_cache is not None:
        return out, new_cache
    return out


__all__ = ["fused_bias_dropout_residual_layer_norm", "fused_feedforward",
           "fused_multi_head_attention"]
