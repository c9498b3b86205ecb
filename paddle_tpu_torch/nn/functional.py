"""The functionals the Llama and GPT models call, in the JAX package's
layouts.

Mirrors ``paddle_tpu/nn/functional``: ``scaled_dot_product_attention``
(``attention.py``), ``rms_norm`` and ``layer_norm`` (``norm.py``),
``cross_entropy`` (``loss.py``), ``gelu`` (``activation.py``), ``linear``
and ``embedding`` (``common.py``), each for the cases the training paths
use; anything else raises ``NotImplementedError``. ``layer_norm``,
``gelu``, ``linear`` and ``embedding`` are plain PyTorch: the JAX package
has no Pallas kernel for them either.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ..kernels import fused
from ..kernels.flash_attention import flash_attention_bshd


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Attention over ``[batch, seq, heads, head_dim]`` inputs (the JAX
    package's layout), differentiable. The flash kernels run on CUDA
    tensors and their plain versions on CPU tensors; there is no other
    path."""
    if attn_mask is not None:
        raise NotImplementedError(
            "scaled_dot_product_attention: attn_mask is not ported (the "
            "flash kernels take causal or no masking)")
    if dropout_p > 0.0 and training:
        raise NotImplementedError(
            "scaled_dot_product_attention: dropout is not ported")
    return flash_attention_bshd(query, key, value, causal=is_causal)


def rms_norm(x, weight, epsilon=1e-6):
    """RMSNorm over the last axis with a weight, in x's dtype (fp32 inside):
    the Triton kernel on CUDA tensors, the plain version on CPU tensors."""
    return fused.rms_norm(x, weight, epsilon)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    """LayerNorm over the trailing ``normalized_shape`` axes with the JAX
    formula: mean and (biased) variance of x in fp32, ``(x - mean) /
    sqrt(var + eps)``, times the weight and plus the bias in fp32, cast
    back to x's dtype."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    axes = tuple(range(x.dim() - len(tuple(normalized_shape)), x.dim()))
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    centered = xf - mean
    var = (centered * centered).mean(dim=axes, keepdim=True)
    out = centered / torch.sqrt(var + epsilon)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def gelu(x, approximate=False, name=None):
    """GELU in x's dtype: the erf form, or the tanh approximation with
    ``approximate=True``."""
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def linear(x, weight, bias=None, name=None):
    """``x @ W + b`` with W in Paddle's ``[in, out]`` layout."""
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the ids ``x``; the rows of ``padding_idx``
    ids come out as zeros."""
    if sparse:
        raise NotImplementedError("embedding: sparse gradients are not "
                                  "ported")
    out = TF.embedding(x.long(), weight)
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx)[..., None], 0.0)
    return out


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Hard-label cross entropy of ``input [N, C]`` logits in fp32; rows
    whose label is ``ignore_index`` count for nothing, and the mean is over
    the other rows (at least one)."""
    if weight is not None or soft_label or not use_softmax \
            or label_smoothing or reduction != "mean" \
            or axis not in (-1, input.dim() - 1):
        raise NotImplementedError(
            "cross_entropy is ported for hard labels, mean reduction, "
            "softmax over the last axis and no class weights")
    logp = torch.log_softmax(input.float(), dim=-1)
    lab = label.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    loss = -logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    return loss.sum() / valid.sum().float().clamp(min=1.0)


__all__ = ["scaled_dot_product_attention", "rms_norm", "layer_norm",
           "cross_entropy", "gelu", "linear", "embedding"]
