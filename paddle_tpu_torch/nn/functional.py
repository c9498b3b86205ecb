"""The functionals of ``paddle_tpu/nn/functional``, in the JAX package's
layouts.

Here: ``scaled_dot_product_attention``, ``flashmask_attention``,
``flash_attention``, ``flash_attn_unpadded``, the two qkv-packed forms and
``sdp_kernel`` (``attention.py``), ``rms_norm`` and ``layer_norm``
(``norm.py``), ``gelu`` and ``tanh``
(``activation.py``), ``linear``, ``embedding`` and ``dropout``
(``common.py``), each for the cases the training paths use, and
``swiglu`` (the Llama MLP's ``silu(gate) * up``); anything else raises
``NotImplementedError``. ``gelu``, ``tanh``, ``linear`` and ``embedding``
are plain PyTorch: the JAX package has no Pallas kernel for them either.
Attention with a dense ``attn_mask`` or a dropout (and shapes the flash
kernels do not take) is two ``torch.einsum`` products around the Triton
kernels of ``kernels/dense_attention.py`` on CUDA tensors (the scale,
masks, softmax and dropout XLA fuses). ``dropout`` and
``layer_norm`` run Triton kernels on CUDA tensors (``kernels/dropout.py``,
``kernels/fused.py``): the passes XLA fuses. Each is the JAX op of its
name for ``amp.auto_cast`` (``amp.op``). The convolutional models'
functionals (``conv2d``, ``silu``, ``relu``,
``group_norm``, ``batch_norm``, ``max_pool2d``, ``adaptive_avg_pool2d``)
are at the end; ``group_norm`` and ``instance_norm`` run the Triton
kernels of ``kernels/group_norm.py`` on CUDA tensors, ``batch_norm`` (with
the residual add and the ReLU after it fused) those of
``kernels/batch_norm.py``. The rest of ``norm.py`` (``rms_norm`` with the
JAX signature, ``local_response_norm``, ``normalize``) and of
``activation.py`` are plain PyTorch, as XLA-fused elementwise work.
Re-exported at the end: every function of ``loss.py``
(``functional_loss.py``: ``cross_entropy`` with every argument, CTC and
RNN-T on the CUDA kernels of ``kernels/seq_loss.py``) and the rest of
``common.py`` (``functional_common.py``: ``interpolate`` in every mode,
``pad``, the shuffles, ...) and ``sequence_mask`` and ``gather_tree``
(``ops/special.py``).
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as TF

from .. import amp
from ..framework.random import next_key
from ..kernels import LAUNCHES
from ..kernels import batch_norm as BN
from ..kernels import dense_attention as DA
from ..kernels import dropout as D
from ..kernels import flash_attention as FA
from ..kernels import fused
from ..kernels import group_norm as GN


def _sdpa_reference(q, k, v, mask=None, causal=False, dropout_p=0.0,
                    key=None, scale=None):
    """Attention over ``[batch, seq, heads, head_dim]`` inputs with a dense
    mask, as the JAX package's ``_sdpa_reference``: fp32 scores times
    ``scale`` (``1 / sqrt(head_dim)`` by default), causal (bottom-right)
    and a bool mask as -1e30, an additive mask added, fp32 softmax (a row
    that sees no key averages every value), with ``dropout_p`` > 0 the
    probabilities dropped under ``key``, out cast to q's dtype. The mask
    broadcasts to ``[b, h, sq, sk]``. The two products are
    ``torch.einsum`` (the JAX package leaves them to XLA); the middle is
    ``kernels.dense_attention.dense_softmax``: its Triton kernels on CUDA
    tensors, its plain version on CPU tensors."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float())
    probs = DA.dense_softmax(scores, mask, causal, s, dropout_p, key)
    return torch.einsum("bhst,bthd->bshd", probs, v.float()).to(q.dtype)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, allow_flash=True):
    """Attention over ``[batch, seq, heads, head_dim]`` inputs (the JAX
    package's layout), differentiable, routed as the JAX package routes it
    (``paddle_tpu/nn/functional/attention.py:57``). Without a mask and
    with ``dropout_p == 0``, a call the flash kernels take
    (``FA.flash_takes``) runs them on CUDA tensors and their plain versions
    on CPU tensors; any other (a head_dim outside ``FA.HEAD_DIMS``, causal
    with q_len > kv_len, where the leading rows average v) is the plain
    ``_sdpa_reference`` on either device, counted in
    ``LAUNCHES["sdpa_plain"]``, as the JAX package gates its kernel with
    ``is_available``. With ``attn_mask`` (bool, True = visible, or
    additive) or ``dropout_p != 0`` it is ``_sdpa_reference`` on any
    device, counted in ``LAUNCHES["sdpa_dense"]``, as the JAX package
    computes it in XLA outside any Pallas kernel; the probabilities are
    dropped only when ``training`` (a ``dropout_p`` with ``training=False``
    still takes this route, as in the JAX package). ``allow_flash=False``
    (the Llama config's ``use_flash_attention``) sends a call without a
    mask or a dropout there too, counted in ``sdpa_dense``, as the JAX
    package then takes its XLA path."""
    if attn_mask is None and dropout_p == 0.0 and allow_flash:
        if not FA.flash_takes(query, key, is_causal, value):
            LAUNCHES["sdpa_plain"] += 1
            return _sdpa_op(query, key, value, None, is_causal)
        return _flash_op(query, key, value, is_causal)
    p_drop = float(dropout_p) if training else 0.0
    rng = next_key() if p_drop > 0.0 else None
    LAUNCHES["sdpa_dense"] += 1
    return _sdpa_op(query, key, value, attn_mask, is_causal, p_drop, rng)


# the JAX ops: "sdpa" takes q, k, v and the mask, "flash_attention" q, k, v
_sdpa_op = amp.op("sdpa", 4)(_sdpa_reference)


@amp.op("flash_attention", 3)
def _flash_op(query, key, value, causal):
    return FA.flash_attention_bshd(query, key, value, causal=causal)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None):
    """``paddle.nn.functional.flash_attention`` as the JAX package's
    (``attention.py:106``): ``scaled_dot_product_attention(query, key,
    value, dropout_p=dropout, is_causal=causal, training=training)``,
    routed as that routes, returned as ``(out, None)``."""
    out = scaled_dot_product_attention(query, key, value, dropout_p=dropout,
                                       is_causal=causal, training=training)
    return out, None


def _segments(cu, total, device):
    """(segment of each packed position, its position in the segment) from
    ``cu_seqlens``: ``searchsorted(cu, arange(total), side="right")``, as
    the JAX function."""
    cu = cu.to(device=device, dtype=torch.int64)
    pos = torch.arange(total, dtype=torch.int64, device=device)
    seg = torch.searchsorted(cu, pos, right=True)
    return seg, pos - cu[seg - 1]


@amp.op("flash_attn_unpadded", 3)
def _unpadded_op(query, key, value, cu_q, cu_k, scale, causal):
    tq, tk = query.shape[0], key.shape[0]
    seg_q, pos_q = _segments(cu_q, tq, query.device)
    seg_k, pos_k = _segments(cu_k, tk, query.device)
    mask = seg_q[:, None] == seg_k[None, :]
    if causal:
        mask = mask & (pos_q[:, None] >= pos_k[None, :])
    scores = torch.einsum("shd,thd->hst", query.float(), key.float())
    probs = DA.dense_softmax(scores[None], mask, False, scale)[0]
    return torch.einsum("hst,thd->shd", probs,
                        value.float()).to(query.dtype)


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """Attention over packed sequences ``[total, heads, head_dim]`` as the
    JAX package's (``attention.py:286``): a bool mask keeps each query to
    its own segment of ``cu_seqlens`` (and, ``causal``, to the keys at or
    before its position in it), the scores times ``scale`` as given, the
    dense attention's middle over ``[1, heads, total_q, total_k]``
    (``kernels.dense_attention``: its Triton kernels on CUDA tensors),
    counted in ``LAUNCHES["sdpa_dense"]``. ``dropout`` is ignored and the
    return is ``(out, None)``, as in the JAX function."""
    LAUNCHES["sdpa_dense"] += 1
    return _unpadded_op(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        float(scale), bool(causal)), None


def sdp_kernel(*args, **kwargs):
    """A context that changes nothing, as the JAX package's (the routing
    is ``scaled_dot_product_attention``'s)."""
    return contextlib.nullcontext()


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False,
                         return_softmax=False, fixed_seed_offset=None,
                         rng_name="", training=True, name=None):
    """``flash_attention`` of ``qkv [batch, seq, 3, heads, head_dim]``
    unpacked, as the JAX package's (``attention.py:323``)."""
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"flash_attn_qkvpacked expects [b, s, 3, h, d], "
                         f"got {tuple(qkv.shape)}")
    return flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                           dropout=dropout, causal=causal,
                           return_softmax=return_softmax, training=training)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q, max_seqlen_k, scale,
                                dropout=0.0, causal=False,
                                return_softmax=False, fixed_seed_offset=None,
                                rng_name="", varlen_padded=True,
                                training=True, name=None):
    """``flash_attn_unpadded`` of ``qkv [total, 3, heads, head_dim]``
    unpacked, as the JAX package's (``attention.py:341``)."""
    if qkv.dim() != 4 or qkv.shape[1] != 3:
        raise ValueError(f"flash_attn_varlen_qkvpacked expects [total, 3, "
                         f"h, d], got {tuple(qkv.shape)}")
    return flash_attn_unpadded(qkv[:, 0], qkv[:, 1], qkv[:, 2], cu_seqlens_q,
                               cu_seqlens_k, max_seqlen_q, max_seqlen_k,
                               scale, dropout=dropout, causal=causal,
                               return_softmax=return_softmax,
                               training=training)


def _canonical_startend(se, sq, causal):
    """startend_row_indices [B, KH, Sk, C] to the canonical (LTS, LTE, UTS,
    UTE) [B, KH, Sk, 4] int32: C in {1, 2} causal (LTS; LTS, LTE), in {2,
    4} not causal (LTS, UTE; all four). Strict-lower rows [LTS, LTE) and
    strict-upper rows [UTS, UTE) are masked per key column."""
    se = se.to(torch.int32)
    c = se.shape[-1]
    zeros = torch.zeros_like(se[..., 0])
    full = torch.full_like(se[..., 0], sq)
    if causal:
        if c == 1:
            parts = (se[..., 0], full, zeros, zeros)
        elif c == 2:
            parts = (se[..., 0], se[..., 1], zeros, zeros)
        else:
            raise ValueError(
                f"causal flashmask expects startend_row_indices with last "
                f"dim 1 or 2, got {c}")
    else:
        if c == 2:
            parts = (se[..., 0], full, zeros, se[..., 1])
        elif c == 4:
            parts = (se[..., 0], se[..., 1], se[..., 2], se[..., 3])
        else:
            raise ValueError(
                f"non-causal flashmask expects startend_row_indices with "
                f"last dim 2 or 4, got {c}")
    return torch.stack(parts, dim=-1)


def _norm_window(window_size, causal):
    if window_size is None:
        return None
    if isinstance(window_size, int):
        wl = wr = int(window_size)
    else:
        wl, wr = (int(w) if w is not None else None for w in window_size)
    return (wl, None) if causal else (wl, wr)


class FlashMaskBounds(NamedTuple):
    """``startend_row_indices`` made ready for the kernels once, for every
    attention call that shares them (one a layer): canonical (LTS, LTE,
    UTS, UTE) ``bounds [b, hb, sk, 4]`` int32 with hb in {1, heads}, their
    tile ``summary`` on CUDA (``kernels.flash_attention.flashmask_summary``;
    None on the CPU), and the ``causal`` form they were read in."""
    bounds: torch.Tensor
    summary: Optional[torch.Tensor]
    causal: bool


def flashmask_kernels_take(q, k, v):
    """Whether the FlashMask kernels take a call on ``[batch, seq, heads,
    head_dim]`` inputs: q_len == kv_len, head_dim in ``HEAD_DIMS``, and
    q, k, v of one dtype the kernels take. The JAX package's ``use_pallas``
    (``nn/functional/attention.py``) less its TPU tiling conditions; the
    device plays no part."""
    return (q.shape[1] == k.shape[1] and q.shape[-1] in FA.HEAD_DIMS
            and q.dtype in (torch.float32, torch.bfloat16)
            and k.dtype == q.dtype and v.dtype == q.dtype)


def prepare_flashmask(startend_row_indices, q_len, num_heads, num_kv_heads,
                      causal=False, summarize=True):
    """``FlashMaskBounds`` of ``startend_row_indices [B, KH', Sk, C]`` for
    attention of ``q_len`` query rows and ``num_heads`` query heads over
    ``num_kv_heads`` kv heads: canonicalised, a KH' of kv_heads expanded to
    the query heads (1 stays broadcast, the kernels read it so) and, on
    CUDA unless ``summarize`` is False (a call routed to the plain
    versions), summarised by the pre-pass kernel."""
    se = startend_row_indices
    if se.dim() != 4:
        raise ValueError(f"startend_row_indices must be [batch, kv_heads, "
                         f"kv_len, C], got {tuple(se.shape)}")
    bounds = _canonical_startend(se, q_len, causal)
    kh, h = num_kv_heads, num_heads
    if bounds.shape[1] == kh and kh != h:          # GQA: one per query head
        bounds = bounds.repeat_interleave(h // kh, dim=1)
    elif bounds.shape[1] not in (1, h):
        raise ValueError(
            f"startend_row_indices kv_heads dim {bounds.shape[1]} must be "
            f"1, {kh}, or {h}")
    bounds = bounds.contiguous()
    summary = FA.flashmask_summary(bounds) \
        if bounds.is_cuda and summarize else None
    return FlashMaskBounds(bounds, summary, bool(causal))


@amp.op("flashmask_attention", 3)
def flashmask_attention(query, key, value, startend_row_indices=None, *,
                        dropout=0.0, causal=False, window_size=None,
                        return_softmax_lse=False, return_seed_offset=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """FlashMask attention over ``[batch, seq, heads, head_dim]`` inputs
    (paddle.nn.functional.flashmask_attention, arXiv 2410.01359), as the
    JAX package's: ``startend_row_indices [B, KH', Sk, {1, 2, 4}]`` column
    bounds with KH' in {1, kv_heads, heads} (or a ``FlashMaskBounds`` from
    ``prepare_flashmask``, made once for several calls), an optional
    sliding window, GQA k/v expanded to the query heads outside the kernel
    (autograd sums dk/dv over each group). On CUDA tensors the FlashMask
    kernels run (they read a KH' of 1 broadcast; kv_heads is expanded to
    the heads), on CPU tensors their plain versions.
    ``return_softmax_lse`` also returns the kernel's lse ``[b, heads,
    sq]``. A row that sees no key gives 0 (see
    ``kernels/flash_attention.py``). A call the kernels do not take
    (``flashmask_kernels_take``: q_len != kv_len, a head_dim outside
    ``HEAD_DIMS``, another dtype) runs the plain versions on either
    device, counted in ``LAUNCHES["sdpa_plain"]``, with the JAX dense
    path's top-left causal, as the JAX package sends what its kernel does
    not take to that path. With ``dropout`` in training, the call takes
    that dense path with the probabilities dropped (``_sdpa_reference``
    over the bounds' visibility, ``_flashmask_dropout``), counted in
    ``LAUNCHES["sdpa_dense"]``, as the JAX package's
    (``attention.py:242-273``); ``return_seed_offset`` raises, as in the
    JAX package."""
    if return_seed_offset:
        raise NotImplementedError(
            "return_seed_offset tracks the reference's CUDA dropout RNG "
            "state; randomness here comes from framework.random, which has "
            "no seed-offset notion")
    p_drop = float(dropout) if training else 0.0
    b, sq, h, _ = query.shape
    sk, kh = key.shape[1], key.shape[2]
    window = _norm_window(window_size, causal)
    mask = startend_row_indices
    if mask is None and window is None:
        if return_softmax_lse:
            raise NotImplementedError(
                "return_softmax_lse requires startend_row_indices")
        return scaled_dot_product_attention(query, key, value,
                                            dropout_p=dropout,
                                            is_causal=causal,
                                            training=training)
    takes = flashmask_kernels_take(query, key, value) and p_drop == 0.0
    if isinstance(mask, FlashMaskBounds):
        if mask.causal != bool(causal):
            raise ValueError(f"bounds prepared with causal={mask.causal}, "
                             f"used with causal={causal}")
    elif mask is not None:
        if mask.dim() != 4 or mask.shape[2] != sk:
            raise ValueError(
                f"startend_row_indices must be [batch, kv_heads, {sk}, C], "
                f"got {tuple(mask.shape)}")
        mask = prepare_flashmask(mask.to(query.device), sq, h, kh, causal,
                                 summarize=takes)
    else:
        # window-only: empty bands (nothing extra masked)
        mask = FlashMaskBounds(torch.tensor(
            [sq, sq, 0, 0], dtype=torch.int32,
            device=query.device).expand(b, 1, sk, 4), None, bool(causal))
    if p_drop > 0.0:
        return _flashmask_dropout(query, key, value, mask.bounds, causal,
                                  window, p_drop, return_softmax_lse)
    q = query.transpose(1, 2)
    k = key.transpose(1, 2)
    v = value.transpose(1, 2)
    if kh != h:                                    # GQA: expand kv
        k = k.repeat_interleave(h // kh, dim=1)
        v = v.repeat_interleave(h // kh, dim=1)
    if takes:
        # the kernels' lse is the function's, so return_softmax_lse stays
        # on them (the JAX package computes it on its dense path)
        out, lse = FA.flashmask_attention(q.contiguous(), k.contiguous(),
                                          v.contiguous(), mask.bounds,
                                          causal=causal, window=window,
                                          summary=mask.summary)
    else:
        LAUNCHES["sdpa_plain"] += 1
        out, lse = FA.flashmask_attention_plain(q, k, v, mask.bounds,
                                                causal=causal, window=window)
    out = out.transpose(1, 2)
    return (out, lse) if return_softmax_lse else out


def _flashmask_dropout(query, key, value, bounds, causal, window, p, lse):
    """The JAX package's dense FlashMask path with a dropout: the bounds'
    visibility (top-left causal, ``FA.flashmask_visible``) as the mask of
    ``_sdpa_reference``, GQA k/v expanded, the probabilities dropped; lse
    from the masked scores where asked."""
    b, sq, h, d = query.shape
    sk, kh = key.shape[1], key.shape[2]
    if kh != h:
        key = key.repeat_interleave(h // kh, dim=2)
        value = value.repeat_interleave(h // kh, dim=2)
    vis = FA.flashmask_visible(bounds, sq, sk, causal, window)
    LAUNCHES["sdpa_dense"] += 1
    out = _sdpa_reference(query, key, value, mask=vis, dropout_p=p,
                          key=next_key())
    if not lse:
        return out
    scores = torch.einsum("bshd,bthd->bhst", query.float(), key.float()) \
        / math.sqrt(d)
    return out, torch.logsumexp(scores.masked_fill(~vis, -1e30), dim=-1)


@amp.op("rms_norm")
def rms_norm(x, weight=None, bias=None, epsilon=1e-6, begin_norm_axis=-1,
             name=None):
    """RMSNorm over the axes from ``begin_norm_axis`` on, in x's dtype (fp32
    inside), routed as the JAX package routes it to Pallas
    (``paddle_tpu/nn/functional/norm.py:77-78``): over the last axis with
    a weight and no bias, the Triton kernel on CUDA tensors (its plain
    version on CPU tensors); anything else the JAX formula (``_oracle``:
    ``x * rsqrt(mean(x^2) + eps)``, times the weight, plus the bias, in
    fp32) on either device."""
    if begin_norm_axis in (-1, x.dim() - 1) and weight is not None \
            and bias is None:
        return fused.rms_norm(x, weight, epsilon)
    ax = begin_norm_axis if begin_norm_axis >= 0 \
        else x.dim() + begin_norm_axis
    x32 = x.float()
    ms = (x32 * x32).mean(dim=tuple(range(ax, x.dim())), keepdim=True)
    out = x32 * (1.0 / torch.sqrt(ms + epsilon))
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


@amp.op("layer_norm")
def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    """LayerNorm over the trailing ``normalized_shape`` axes with the JAX
    formula: mean and (biased) variance of x in fp32, ``(x - mean) /
    sqrt(var + eps)``, times the weight and plus the bias in fp32, cast
    back to x's dtype. On CUDA tensors the Triton kernel of
    ``fused.dropout_add_layer_norm`` (no dropout, no residual; the
    trailing axes as one), on CPU tensors ``fused.layer_norm_plain``."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    n_axes = len(tuple(normalized_shape))
    if x.device.type == "cpu":
        return fused.layer_norm_plain(x, weight, bias, epsilon, n_axes)
    n = math.prod(x.shape[x.dim() - n_axes:])
    flat = (lambda t: None if t is None else t.reshape(n))
    y = fused.dropout_add_layer_norm(x.reshape(*x.shape[:x.dim() - n_axes],
                                               n), flat(weight), flat(bias),
                                     epsilon)
    return y.reshape(x.shape)


@amp.op("dropout", 1)
def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Dropout as the JAX package's (``common.py:40-59``): in eval or at
    ``p = 0`` x itself ("downscale_in_infer" scales by ``1 - p`` in eval);
    at ``p = 1`` zeros; else the elements kept with probability ``1 - p``
    under ``next_key()`` ("upscale_in_train": divided by ``1 - p``),
    ``axis`` (an int or a list) naming the axes the mask spans, broadcast
    over the others. The mask is ``kernels.dropout``'s: the Triton kernel
    on CUDA tensors, its plain version on CPU tensors, the same bits."""
    if mode not in D.MODES:
        raise ValueError(f"dropout mode must be one of {D.MODES}, got "
                         f"{mode!r}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            # the factor in x's dtype, as JAX's weak-typed scalar
            return x * torch.full((), 1.0 - p, dtype=x.dtype,
                                  device=x.device)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    mask_shape = None
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        axes = [a % x.dim() for a in axes]
        mask_shape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
    return D.dropout(x, next_key(), p, mode, mask_shape)


@amp.op("gelu")
def gelu(x, approximate=False, name=None):
    """GELU in x's dtype: the erf form, or the tanh approximation with
    ``approximate=True``."""
    return TF.gelu(x, approximate="tanh" if approximate else "none")


@amp.op("tanh")
def tanh(x, name=None):
    """tanh in x's dtype."""
    return torch.tanh(x)


def swiglu(x, y, name=None):
    """``silu(x) * y`` (``paddle.incubate.nn.functional.swiglu`` with both
    halves given): the Llama MLP's JAX ops "silu" then "multiply", in one
    Triton kernel forward and one backward on CUDA tensors
    (``kernels.fused.swiglu``; XLA fuses the two ops), the plain ops on
    CPU tensors. As ops (``amp``), the two are cast, observed and checked
    in their order around the one kernel: silu's input is cast as silu
    casts (its output keeps its input's dtype), then both factors as
    multiply casts; ``amp.debugging``'s observers see "silu" with x and
    "multiply" with the cast x standing for silu's output (its dtype and
    shape; the kernel never writes it), and the checker sees the product,
    which is not finite wherever silu's output is not."""
    ops = amp.FusedOps()
    (dt,) = ops.op("silu", [x])
    x = x.to(dt)
    dx, dy = ops.op("multiply", [x, y])
    x, y = x.to(dx), y.to(dy)
    return ops.run(lambda: fused.swiglu(x, y))


@amp.op("linear")
def linear(x, weight, bias=None, name=None):
    """``x @ W + b`` with W in Paddle's ``[in, out]`` layout."""
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


@amp.op("embedding")
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


# -- the convolutional models' functionals ----------------------------------------
#
# The Stable Diffusion UNet's and ResNet's (``paddle_tpu/nn/functional/
# {conv,activation,common,norm,pooling}.py``), for the cases the two
# models use; other arguments raise NotImplementedError. The JAX package
# computes them in XLA outside any Pallas kernel: ``conv2d`` is cuDNN's
# (``torch.nn.functional.conv2d``), as a plain matmul is cuBLAS's; the
# rest are PyTorch ops but ``group_norm``, which runs the Triton kernels of
# ``kernels/group_norm.py`` on CUDA tensors (the pass XLA fuses).

def _pair(v, name):
    if isinstance(v, int):
        return (v, v)
    v = tuple(int(a) for a in v)
    if len(v) != 2:
        raise NotImplementedError(f"{name}: two spatial dims are ported, "
                                  f"got {v}")
    return v


def _conv_pads(padding, x_hw, k, stride, dilation):
    """((top, bottom), (left, right)) of ``padding`` in the JAX package's
    forms (``conv.py:21`` ``_norm_padding``): an int, [ph, pw], [top,
    bottom, left, right], [[0, 0], [0, 0], [t, b], [l, r]], or "SAME" /
    "VALID" as ``lax.conv_general_dilated`` reads them."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return ((0, 0), (0, 0))
        if mode != "SAME":
            raise ValueError(f"conv2d padding {padding!r}")
        pads = []
        for n, kk, s, d in zip(x_hw, k, stride, dilation):
            out = -(-n // s)
            total = max((out - 1) * s + (kk - 1) * d + 1 - n, 0)
            pads.append((total // 2, total - total // 2))
        return tuple(pads)
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    padding = list(padding)
    if len(padding) == 2 and all(isinstance(p, int) for p in padding):
        return tuple((p, p) for p in padding)
    if len(padding) == 4 and all(isinstance(p, int) for p in padding):
        return ((padding[0], padding[1]), (padding[2], padding[3]))
    pairs = [tuple(int(a) for a in p) for p in padding
             if not isinstance(p, int)]
    if len(pairs) == 4:
        pairs = pairs[2:]
    if len(pairs) != 2:
        raise ValueError(f"conv2d padding {padding!r}")
    return tuple(pairs)


@amp.op("conv2d")
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """2-D convolution as the JAX package's (``conv.py:39`` ``_conv_nd``):
    x NCHW, weight ``[out, in / groups, kh, kw]``, stride, dilation,
    groups and its padding forms; the product accumulated in fp32 and
    rounded once to x's dtype, then the bias added in that dtype (as the
    JAX op adds it after its ``astype``)."""
    if data_format != "NCHW" or x.dim() != 4:
        raise NotImplementedError(f"conv2d is ported for 4-D NCHW inputs, "
                                  f"got {data_format!r} {x.dim()}-D")
    stride, dilation = _pair(stride, "conv2d"), _pair(dilation, "conv2d")
    (pt, pb), (pl, pr) = _conv_pads(padding, x.shape[2:],
                                    tuple(weight.shape[2:]), stride,
                                    dilation)
    if pt == pb and pl == pr:
        sym = (pt, pl)
    else:
        x = TF.pad(x, (pl, pr, pt, pb))
        sym = (0, 0)
    out = TF.conv2d(x, weight, None, stride, sym, dilation, groups)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


@amp.op("silu")
def silu(x, name=None):
    """SiLU (``x * sigmoid(x)``) in x's dtype."""
    return TF.silu(x)


@amp.op("relu")
def relu(x, name=None):
    """ReLU in x's dtype."""
    return TF.relu(x)


# -- the rest of activation.py ------------------------------------------------------
#
# ``paddle_tpu/nn/functional/activation.py``'s formulas (jax.nn's where the
# JAX package calls it), each the JAX op of its name for ``amp``; plain
# PyTorch on either device, as XLA fuses them. ``jnp.clip``, ``maximum``
# and ``minimum`` split the gradient of a tie in half, as
# ``torch.maximum`` / ``torch.minimum`` do (``torch.clamp`` passes all
# of it): bf16 inputs meet the bounds exactly often enough to matter.

def _clip(x, lo, hi):
    """jnp.clip: ``minimum(maximum(x, lo), hi)``, ties' gradient halved."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))

def relu_(x, name=None):
    """ReLU in place: x takes ``relu(x)``'s values and is returned."""
    return x.copy_(relu(x))


@amp.op("relu6")
def relu6(x, name=None):
    """jax.nn.relu6: ``min(max(x, 0), 6)`` with gradient 1 strictly
    inside (0, 6) and 0 on the bounds."""
    inside = (x > 0) & (x < 6)
    return torch.where(inside, x, x.detach().clamp(0.0, 6.0))


@amp.op("sigmoid")
def sigmoid(x, name=None):
    return torch.sigmoid(x)


swish = silu


@amp.op("leaky_relu")
def leaky_relu(x, negative_slope=0.01, name=None):
    return torch.where(x >= 0, x, negative_slope * x)


@amp.op("elu")
def elu(x, alpha=1.0, name=None):
    """jax.nn.elu: ``where(x > 0, x, alpha * expm1(x))``, the expm1 of
    ``min(x, 0)`` so that its gradient stays finite."""
    return torch.where(x > 0, x, alpha * torch.expm1(
        torch.where(x > 0, torch.zeros_like(x), x)))


@amp.op("celu")
def celu(x, alpha=1.0, name=None):
    zero = x.new_zeros(())
    return torch.maximum(x, zero) + alpha * torch.expm1(
        torch.minimum(x, zero) / alpha)


@amp.op("selu")
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@amp.op("prelu")
def prelu(x, weight, data_format="NCHW", name=None):
    """``where(x > 0, x, w * x)``: one weight for every element, or one a
    channel (axis 1 for "NC..." formats, else the last)."""
    if weight.numel() == 1:
        return torch.where(x > 0, x, weight.reshape(()) * x)
    shape = [1] * x.dim()
    shape[1 if data_format.startswith("NC") else x.dim() - 1] = -1
    return torch.where(x > 0, x, weight.reshape(shape) * x)


@amp.op("rrelu")
def rrelu(x, lower=0.125, upper=0.3333333333333333, training=False,
          name=None):
    """In training the negative part times a slope drawn uniform in
    [lower, upper) for each element under ``next_key()`` (in x's dtype);
    in eval times their mean."""
    if training:
        u = D.uniform_plain(x.shape, next_key(), x.device)
        slope = (lower + (upper - lower) * u).to(x.dtype)
        return torch.where(x >= 0, x, slope * x)
    return torch.where(x >= 0, x, (lower + upper) / 2.0 * x)


@amp.op("hardshrink")
def hardshrink(x, threshold=0.5, name=None):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


@amp.op("softshrink")
def softshrink(x, threshold=0.5, name=None):
    return torch.where(x > threshold, x - threshold, torch.where(
        x < -threshold, x + threshold, torch.zeros_like(x)))


@amp.op("tanhshrink")
def tanhshrink(x, name=None):
    return x - torch.tanh(x)


@amp.op("hardtanh")
def hardtanh(x, min=-1.0, max=1.0, name=None):
    return _clip(x, min, max)


@amp.op("hardsigmoid")
def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    """``clip(x * slope + offset, 0, 1)`` with the JAX package's slope
    0.1666667 (not 1/6)."""
    return _clip(x * slope + offset, 0.0, 1.0)


@amp.op("hardswish")
def hardswish(x, name=None):
    return x * _clip(x + 3.0, 0.0, 6.0) / 6.0


def _softplus(x):
    """jax.nn.softplus: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


@amp.op("mish")
def mish(x, name=None):
    return x * torch.tanh(_softplus(x))


@amp.op("softplus")
def softplus(x, beta=1.0, threshold=20.0, name=None):
    scaled = beta * x
    return torch.where(scaled > threshold, x, _softplus(scaled) / beta)


@amp.op("softsign")
def softsign(x, name=None):
    return x / (1 + x.abs())


@amp.op("thresholded_relu")
def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return torch.where(x > threshold, x, torch.full_like(x, value))


@amp.op("log_sigmoid")
def log_sigmoid(x, name=None):
    """jax.nn.log_sigmoid: ``-softplus(-x)``."""
    return -_softplus(-x)


@amp.op("maxout")
def maxout(x, groups, axis=1, name=None):
    """The largest of each ``groups`` consecutive channels along ``axis``
    (its gradient shared among ties, as jnp.max's)."""
    ax = axis % x.dim()
    ch = x.shape[ax]
    shape = x.shape[:ax] + (ch // groups, groups) + x.shape[ax + 1:]
    return torch.amax(x.reshape(shape), dim=ax + 1)


def _inplace(fn, name):
    """The in-place form of ``fn``, as the JAX package's ``make_inplace``:
    x takes ``fn(x, ...)``'s values and is returned (``fn`` reads a copy,
    so what its backward saved is not overwritten)."""
    def inplace(x, *args, **kwargs):
        return x.copy_(fn(x.clone(), *args, **kwargs))
    inplace.__name__ = name
    inplace.__doc__ = f"``{fn.__name__}`` in place: x takes its values " \
        "and is returned."
    return inplace


elu_ = _inplace(elu, "elu_")
hardtanh_ = _inplace(hardtanh, "hardtanh_")
leaky_relu_ = _inplace(leaky_relu, "leaky_relu_")
tanh_ = _inplace(tanh, "tanh_")
thresholded_relu_ = _inplace(thresholded_relu, "thresholded_relu_")


def _dtype(dtype):
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


@amp.op("softmax")
def softmax(x, axis=-1, dtype=None, name=None):
    """Softmax along ``axis``, x first cast to ``dtype`` where given."""
    if dtype is not None:
        x = x.to(_dtype(dtype))
    return torch.softmax(x, dim=int(axis))


def softmax_(x, axis=-1, dtype=None, name=None):
    """Softmax in place: x takes ``softmax(x)``'s values and is
    returned."""
    return x.copy_(softmax(x, axis, dtype))


@amp.op("log_softmax")
def log_softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(_dtype(dtype))
    return torch.log_softmax(x, dim=int(axis))


@amp.op("gumbel_softmax")
def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """``softmax((x + g) / temperature)`` with Gumbel noise ``g = -log(-log
    u)`` (u uniform under ``next_key()``, g in x's dtype); ``hard`` the
    one-hot of its argmax with the soft values' gradient."""
    u = D.uniform_plain(x.shape, next_key(), x.device)
    g = (-torch.log(-torch.log(u))).to(x.dtype)
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        onehot = torch.zeros_like(y).scatter(
            axis, y.argmax(dim=axis, keepdim=True), 1.0)
        y = onehot + y - y.detach()
    return y


@amp.op("glu")
def glu(x, axis=-1, name=None):
    """The first half along ``axis`` times the sigmoid of the second."""
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def _meta(dtype, like):
    return torch.empty(like.shape, dtype=dtype, device="meta")


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None, *, then=None):
    """GroupNorm as the JAX package's (``norm.py:186``): mean and biased
    variance of each (sample, group) in fp32, ``(x - mean) / sqrt(var +
    eps)``, times the weight and plus the bias in fp32, in x's dtype; the
    channels at axis 1 (``data_format`` "NCHW") or last ("NHWC"). On CUDA
    tensors the Triton kernels of ``kernels.group_norm``, on CPU tensors
    its plain version.

    ``then`` names the JAX op that consumes the output, so that the one
    kernel does the work of the ops between: "silu" fuses the SiLU in;
    another op (a white-listed "conv2d") has the output written in the
    dtype that op's ``amp`` cast gives it. Under ``amp.auto_cast`` the
    op is "group_norm" (black-listed: it computes in fp32 and its output
    is fp32) and then ``then`` (which casts that output, at O2 to the low
    dtype); the kernel reads x and the parameters as they are (their fp32
    casts are exact) and writes what the casts would give, so the bits are
    the separate ops'. ``amp.debugging`` sees "group_norm" and then
    "silu", as the JAX package dispatches them."""
    if data_format not in ("NCHW", "NHWC", "NCL", "NLC", "NC"):
        raise NotImplementedError(f"group_norm data_format {data_format!r}")
    if then is not None and not isinstance(then, str):
        raise TypeError(f"group_norm: then names an op, got {then!r}")
    last = data_format in ("NHWC", "NLC")
    ops = amp.FusedOps()
    out_dtype = ops.op("group_norm", [t for t in (x, weight, bias)
                                      if t is not None])[0]
    if then == "silu":
        out_dtype = ops.op("silu", [_meta(out_dtype, x)])[0]
    elif then is not None:
        out_dtype = ops.cast(then, out_dtype)
    return ops.run(lambda: GN.group_norm(x, int(num_groups), weight, bias,
                                         epsilon, last, then == "silu",
                                         out_dtype))


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None, *,
               residual=None, then=None):
    """BatchNorm as the JAX package's (``norm.py:95``): in training (and
    not ``use_global_stats``) x normalised by the batch's mean and biased
    variance in fp32, and the running statistics updated in place,
    ``momentum * running + (1 - momentum) * batch`` (momentum weighs the
    old value; the variance is the biased one), so that a captured step's
    replay updates them too; in eval by the running statistics. The
    weight and bias apply in fp32; the output is in x's dtype. The
    channels are at axis 1, or last for a channel-last ``data_format``
    ("NHWC", "NLC", "NDHWC"); a 2-D input's at axis 1. On CUDA tensors the
    Triton kernels of ``kernels.batch_norm``, on CPU tensors its plain
    version. PyTorch's own ``F.batch_norm`` updates with the other
    convention (its momentum weighs the new value, its variance is
    unbiased) and is not used.

    ``residual`` and ``then="relu"`` fuse what ResNet's blocks do next:
    ``relu(batch_norm(x) + residual)`` in one kernel forward and one
    backward, with the bits of the ops one by one. Under ``amp.auto_cast``
    the ops are "batch_norm" (black-listed: fp32 output), "add" and "relu",
    each casting its inputs as the separate op would; the kernel reads x
    and the parameters as they are (their fp32 casts are exact) and writes
    the dtype the casts give. ``amp.debugging`` sees the three ops, the
    checker the last one's output."""
    if then not in (None, "relu"):
        raise NotImplementedError(f"batch_norm: then={then!r}; \"relu\" is "
                                  f"ported")
    last = data_format.endswith("C") and data_format != "NCHW" \
        and x.dim() > 2
    batch_stats = bool(training and not use_global_stats)
    ops = amp.FusedOps()
    ins = [x] if batch_stats else [x, running_mean, running_var]
    norm_dt = out_dt = ops.op("batch_norm", ins + [
        t for t in (weight, bias) if t is not None])[0]
    if residual is not None:
        add_dt = ops.op("add", [_meta(norm_dt, x), residual])
        out_dt = torch.promote_types(*add_dt)
        if add_dt[0] not in (norm_dt, out_dt):
            raise NotImplementedError(f"batch_norm: the add casts the "
                                      f"norm's {norm_dt} to {add_dt[0]}")
    if then == "relu":
        relu_dt = ops.op("relu", [_meta(out_dt, x)])[0]
        if residual is not None and relu_dt != out_dt:
            raise NotImplementedError(f"batch_norm: the relu casts the "
                                      f"sum's {out_dt} to {relu_dt}")
        out_dt = relu_dt
    if norm_dt not in (x.dtype, torch.float32):
        raise NotImplementedError(f"batch_norm: a {x.dtype} input written "
                                  f"in {norm_dt}")
    return ops.run(lambda: BN.batch_norm(
        x, running_mean, running_var, weight, bias, batch_stats, momentum,
        epsilon, last, residual, then == "relu", norm_dt == x.dtype, out_dt))


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    """InstanceNorm as the JAX package's (``norm.py:158``): each (sample,
    channel)'s mean and biased variance over axes 2 and up in fp32,
    whatever ``data_format`` says, times the weight and plus the bias (at
    axis 1) in fp32, in x's dtype; the running statistics are never read
    or written. It is GroupNorm with one channel a group: on CUDA tensors
    the Triton kernels of ``kernels.group_norm``, on CPU tensors its plain
    version. Under ``amp`` the op "instance_norm" (black-listed: fp32
    output; the kernel reads x as it is)."""
    ops = amp.FusedOps()
    out_dtype = ops.op("instance_norm", [t for t in (x, weight, bias)
                                         if t is not None])[0]
    return ops.run(lambda: GN.group_norm(x, x.shape[1], weight, bias, eps,
                                         False, False, out_dtype))


@amp.op("local_response_norm")
def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha * sum)^beta`` in fp32, the sum of x^2 over a window
    of ``size`` channels at axis 1 (whatever ``data_format`` says), zero
    padded (``size // 2`` before): the JAX package's sum
    (``norm.py:225-240``), not PyTorch's mean over the window."""
    sq = x.float() ** 2
    c, half = x.shape[1], size // 2
    padded = TF.pad(sq, [0, 0] * (x.dim() - 2) + [half, size - half - 1])
    acc = torch.zeros_like(sq)
    for i in range(size):
        acc = acc + padded.narrow(1, i, c)
    return (x.float() / (k + alpha * acc) ** beta).to(x.dtype)


@amp.op("normalize")
def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """x over its p-norm along ``axis`` (at least ``epsilon``), in x's
    dtype."""
    if p == 2:
        n = torch.sqrt((x * x).sum(dim=axis, keepdim=True))
    else:
        n = (x.abs() ** p).sum(dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp_min(n, epsilon)


def _pool_pads(padding, name):
    if isinstance(padding, int):
        return (padding, padding)
    padding = list(padding)
    if len(padding) == 2 and all(isinstance(p, int) for p in padding):
        return tuple(padding)
    if len(padding) == 4 and padding[0] == padding[1] \
            and padding[2] == padding[3]:
        return (padding[0], padding[2])
    raise NotImplementedError(f"{name}: symmetric padding is ported, got "
                              f"{padding!r}")


@amp.op("max_pool2d")
def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    """Max pooling of NCHW as the JAX package's (``pooling.py:117``,
    windows padded with -inf), for symmetric padding without ``ceil_mode``
    or a mask.
    PyTorch's CUDA backward of it gathers, for each input element, the
    gradients of the windows that chose it, in a fixed order: the same
    bits every run."""
    if return_mask or ceil_mode or data_format != "NCHW":
        raise NotImplementedError("max_pool2d is ported for NCHW without "
                                  "return_mask or ceil_mode")
    k = _pair(kernel_size, "max_pool2d")
    s = k if stride is None else _pair(stride, "max_pool2d")
    return TF.max_pool2d(x, k, s, _pool_pads(padding, "max_pool2d"))


@amp.op("adaptive_avg_pool2d")
def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Adaptive average pooling of NCHW (``pooling.py:473``) where each
    output cell averages an equal window (the size divides the input's:
    (1, 1) is the mean over H * W), in x's dtype. The mean's backward is a
    broadcast, where PyTorch's adaptive pooling backward is on its list of
    nondeterministic ops on the card."""
    b, c, h, w = x.shape
    oh, ow = _pair(output_size, "adaptive_avg_pool2d")
    oh, ow = oh or h, ow or w
    if data_format != "NCHW" or h % oh or w % ow:
        raise NotImplementedError("adaptive_avg_pool2d is ported for NCHW "
                                  "and output sizes that divide the input's")
    return x.reshape(b, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))


from . import functional_common as _common  # noqa: E402
from . import functional_loss as _loss  # noqa: E402
from .functional_common import *  # noqa: E402,F401,F403
from .functional_loss import *  # noqa: E402,F401,F403
from ..ops.special import gather_tree, sequence_mask  # noqa: E402,F401

__all__ = ["scaled_dot_product_attention", "flashmask_attention",
           "flash_attention", "flash_attn_unpadded", "sdp_kernel",
           "flash_attn_qkvpacked", "flash_attn_varlen_qkvpacked",
           "elu_", "hardtanh_", "leaky_relu_", "tanh_", "thresholded_relu_",
           "FlashMaskBounds", "prepare_flashmask", "flashmask_kernels_take",
           "rms_norm", "layer_norm", "dropout", "tanh",
           "gelu", "linear", "embedding", "swiglu",
           "conv2d", "silu", "relu", "group_norm",
           "batch_norm", "instance_norm", "local_response_norm", "normalize",
           "max_pool2d", "adaptive_avg_pool2d", "relu_", "relu6", "sigmoid",
           "swish", "leaky_relu", "elu", "celu", "selu", "prelu", "rrelu",
           "hardshrink", "softshrink", "tanhshrink", "hardtanh",
           "hardsigmoid", "hardswish", "mish", "softplus", "softsign",
           "thresholded_relu", "log_sigmoid", "maxout", "softmax",
           "softmax_", "log_softmax", "gumbel_softmax", "glu",
           "sequence_mask", "gather_tree"] \
    + list(_common.__all__) + list(_loss.__all__)
