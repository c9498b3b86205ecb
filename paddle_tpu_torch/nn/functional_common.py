"""The functionals of ``paddle_tpu/nn/functional/common.py`` past
``linear``, ``embedding`` and ``dropout``, part of ``nn.functional``
(which re-exports every name here): ``one_hot``, the channel dropouts and
alpha dropouts, ``pad`` in every mode, ``interpolate`` in every mode and
layout, ``unfold`` / ``fold``, the shuffles, ``cosine_similarity``,
``label_smooth``, ``bilinear``, ``class_center_sample`` and
``sparse_attention`` (CSR-masked attention in O(nnz), its reductions in a
fixed order).

Each is the JAX function's formula in PyTorch ops, in the JAX dtypes and
under the JAX op name (``amp.op``); XLA fuses them, so they are plain
PyTorch. The random ones draw from ``framework.random``: ``dropout2d`` /
``dropout3d`` through ``dropout(axis=)`` (the Triton dropout kernel on
CUDA tensors), the alpha dropouts and ``class_center_sample`` through the
plain Philox words of ``kernels.dropout``.

``interpolate`` copies ``jax.image.resize`` where the JAX function calls
it (every mode but nearest, without ``align_corners``), not
``torch.nn.functional.interpolate``: each resized axis is a product with
a weight matrix whose kernel (the triangle for linear, bilinear,
trilinear and "area"; Keys' cubic with a = -0.5 for bicubic) is widened
by the scale when the axis shrinks (antialiasing), its columns normalised
and zeroed where the sample falls outside the input. With
``align_corners`` it is the JAX function's own two-tap gather along each
axis in fp32 (for every mode but nearest); nearest is the JAX index rule
``floor(i * in / out)`` in fp32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from .. import amp
from ..framework.random import next_key
from ..kernels import dropout as D


@amp.op("one_hot")
def one_hot(x, num_classes, name=None):
    """fp32 one-hot rows; indices outside [0, num_classes) give rows of
    zeros, as ``jax.nn.one_hot``."""
    return (x.long()[..., None] == torch.arange(int(num_classes),
                                                device=x.device)).float()


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Whole channel maps dropped together: ``dropout`` with its mask over
    the batch and channel axes."""
    from .functional import dropout
    return dropout(x, p=p, axis=[0, 1] if data_format == "NCHW" else [0, 3],
                   training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    from .functional import dropout
    return dropout(x, p=p, axis=[0, 1] if data_format == "NCDHW" else [0, 4],
                   training=training)


_ALPHA_P = -1.6732632423543772 * 1.0507009873554805


def _alpha_dropout(x, p, mask_shape):
    """SELU's alpha dropout: kept values ``a x + b``, dropped ones ``a
    alpha' + b``, so a SELU layer's mean and variance stay, with the keep
    mask of ``mask_shape`` (rate p) under ``next_key()``."""
    keep = D.keep_mask_plain(tuple(mask_shape), p, next_key(), x.device)
    q = 1.0 - p
    a = (q + _ALPHA_P ** 2 * q * p) ** -0.5
    b = -a * _ALPHA_P * p
    alpha = torch.full((), _ALPHA_P, dtype=x.dtype, device=x.device)
    return (a * torch.where(keep, x, alpha) + b).to(x.dtype)


@amp.op("alpha_dropout")
def alpha_dropout(x, p=0.5, training=True, name=None):
    if not training or p == 0.0:
        return x
    return _alpha_dropout(x, p, x.shape)


@amp.op("feature_alpha_dropout")
def feature_alpha_dropout(x, p=0.5, training=True, name=None):
    """Alpha dropout of whole channel maps (axis 1)."""
    if not training or p == 0.0:
        return x
    return _alpha_dropout(x, p, tuple(x.shape[:2]) + (1,) * (x.dim() - 2))


def _pad_widths(nd, pad, data_format):
    """[(before, after)] for each axis, as the JAX ``pad`` reads ``pad``:
    2 * ndim values pad every axis from the first; fewer pad the spatial
    axes from the last (the channels at axis 1, or last for a ``data_format``
    ending in "C")."""
    if torch.is_tensor(pad):
        pad = pad.tolist()
    pad = [int(v) for v in pad]
    if len(pad) == 2 * nd:
        return [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    n_spatial = len(pad) // 2
    widths = [(0, 0)] * nd
    spatial = list(range(1, 1 + n_spatial)) if data_format \
        and data_format.endswith("C") else list(range(nd - n_spatial, nd))
    for i, ax in enumerate(reversed(spatial)):
        widths[ax] = (pad[2 * i], pad[2 * i + 1])
    return widths


_PAD_MODES = {"reflect": "reflect", "replicate": "edge", "circular": "wrap"}


@amp.op("pad")
def pad(x, pad, mode="constant", value=0.0, data_format=None,
        pad_from_left_axis=True, name=None):
    """``jnp.pad`` of x: "constant" with ``value``, "reflect",
    "replicate" (edge) or "circular" (wrap), on any axes (the non-constant
    modes gather each padded axis with ``np.pad``'s source indices).
    ``pad_from_left_axis`` is accepted and not read, as in the JAX
    function."""
    if mode != "constant" and mode not in _PAD_MODES:
        raise KeyError(mode)
    widths = _pad_widths(x.dim(), pad, data_format)
    if mode == "constant":
        flat = [v for lo_hi in reversed(widths) for v in lo_hi]
        return TF.pad(x, flat, mode="constant", value=value)
    out = x
    for ax, (lo, hi) in enumerate(widths):
        if lo or hi:
            idx = np.pad(np.arange(x.shape[ax]), (lo, hi),
                         mode=_PAD_MODES[mode])
            out = out.index_select(ax, torch.from_numpy(idx).to(x.device))
    return out


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


# -- interpolate --------------------------------------------------------------

def _nearest_index(n_in, n_out):
    """The JAX package's nearest source index of each output position,
    ``floor(i * (n_in / n_out))`` in fp32 (``common.py:157-166``)."""
    ratio = torch.tensor(n_in / n_out, dtype=torch.float32)
    return torch.floor(torch.arange(n_out, dtype=torch.float32) * ratio) \
        .to(torch.int64)


def _triangle(x):
    return torch.clamp_min(1 - torch.abs(x), 0)


def _keys_cubic(x):
    """Keys' cubic convolution kernel with a = -0.5 (``jax.image``'s)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(n_in, n_out, kernel):
    """``jax.image.scale.compute_weight_mat`` at translation 0 with
    antialiasing: fp32 ``[n_in, n_out]``."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale \
        - 0.5
    x = torch.abs(sample[None, :] - torch.arange(n_in, dtype=torch.float32)
                  [:, None]) / kernel_scale
    w = kernel(x)
    total = w.sum(0, keepdim=True)
    eps = float(np.finfo(np.float32).eps)
    w = torch.where(torch.abs(total) > 1000.0 * eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _repeat_axis(x, ax, r):
    """Each slice along ``ax`` repeated r times in place: a broadcast and a
    reshape, whose backward is a plain sum."""
    shape = list(x.shape)
    y = x.unsqueeze(ax + 1).expand(*shape[:ax + 1], r, *shape[ax + 1:])
    return y.reshape(*shape[:ax], shape[ax] * r, *shape[ax + 1:])


def _out_spatial(spatial, size, scale_factor):
    nd = len(spatial)
    if size is not None:
        if torch.is_tensor(size):
            size = size.tolist()
        size = [size] * nd if isinstance(size, (int, float)) else list(size)
        return tuple(int(s.item()) if torch.is_tensor(s) else int(s)
                     for s in size)
    if isinstance(scale_factor, (int, float)):
        scale_factor = [scale_factor] * nd
    return tuple(int(s * f) for s, f in zip(spatial, scale_factor))


_METHODS = {"nearest": "nearest", "bilinear": "linear", "linear": "linear",
            "trilinear": "linear", "bicubic": "cubic", "area": "linear"}


@amp.op("interpolate")
def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial axes of a 3-D to 5-D tensor (channels at axis 1,
    or last for a ``data_format`` ending in "C") to ``size`` or by
    ``scale_factor`` (``int(n * f)``), as the JAX function does (the
    module docstring). Nearest resizing at integer factors is a broadcast
    and a reshape, whose backward is a plain sum; otherwise a gather."""
    method = _METHODS[mode.lower()]
    last = data_format.endswith("C")
    nd = x.dim() - 2
    axes = list(range(1, 1 + nd)) if last else list(range(2, 2 + nd))
    spatial = [x.shape[a] for a in axes]
    out_sp = _out_spatial(spatial, size, scale_factor)
    if method == "nearest":
        out = x
        for ax, n, o in zip(axes, spatial, out_sp):
            idx = _nearest_index(n, o)
            r = o // n if o % n == 0 else 0
            if r and torch.equal(idx, torch.arange(o) // r):
                out = _repeat_axis(out, ax, r)
            else:
                out = out.index_select(ax, idx.to(x.device))
        return out
    if align_corners:
        out = x.float()
        for ax, n, o in zip(axes, spatial, out_sp):
            c = torch.zeros(1, dtype=torch.float32) if o == 1 else \
                torch.arange(o, dtype=torch.float32) * (n - 1) / (o - 1)
            lo = torch.floor(c).to(torch.int64)
            hi = torch.clamp_max(lo + 1, n - 1)
            shape = [1] * out.dim()
            shape[ax] = -1
            w = (c - lo).reshape(shape).to(x.device)
            out = out.index_select(ax, lo.to(x.device)) * (1 - w) \
                + out.index_select(ax, hi.to(x.device)) * w
        return out.to(x.dtype)
    kernel = _triangle if method == "linear" else _keys_cubic
    out = x
    for ax, n, o in zip(axes, spatial, out_sp):
        if n == o:
            continue
        w = _resize_weights(n, o, kernel).to(device=x.device, dtype=x.dtype)
        out = torch.matmul(out.movedim(ax, -1), w).movedim(-1, ax)
    return out.to(x.dtype)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


# -- unfold, fold, shuffles ---------------------------------------------------

def _two(v):
    return [v, v] if isinstance(v, int) else list(v)


@amp.op("unfold")
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col of NCHW: ``[N, C * kh * kw, L]``, channel-major (the JAX
    function's order)."""
    p = _two(paddings)
    return TF.unfold(x, _two(kernel_sizes), dilation=_two(dilations),
                     padding=(p[0], p[1]), stride=_two(strides))


@amp.op("fold")
def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im: overlapping patches summed."""
    p = _two(paddings)
    return TF.fold(x, _two(output_sizes), _two(kernel_sizes),
                   dilation=_two(dilations), padding=(p[0], p[1]),
                   stride=_two(strides))


@amp.op("cosine_similarity")
def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    """``sum(x1 x2) / max(|x1| |x2|, eps)`` along ``axis``: the norms'
    product floored, not each norm (PyTorch's)."""
    dot = (x1 * x2).sum(dim=axis)
    na = torch.sqrt((x1 * x1).sum(dim=axis))
    nb = torch.sqrt((x2 * x2).sum(dim=axis))
    return dot / torch.clamp_min(na * nb, eps)


@amp.op("pixel_shuffle")
def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = int(upscale_factor)
    if data_format == "NCHW":
        n, c, h, w = x.shape
        return x.reshape(n, c // (r * r), r, r, h, w) \
            .permute(0, 1, 4, 2, 5, 3).reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    return x.reshape(n, h, w, r, r, c // (r * r)) \
        .permute(0, 1, 3, 2, 4, 5).reshape(n, h * r, w * r, c // (r * r))


@amp.op("pixel_unshuffle")
def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = int(downscale_factor)
    if data_format == "NCHW":
        n, c, h, w = x.shape
        return x.reshape(n, c, h // r, r, w // r, r) \
            .permute(0, 1, 3, 5, 2, 4).reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = x.shape
    return x.reshape(n, h // r, r, w // r, r, c) \
        .permute(0, 1, 3, 2, 4, 5).reshape(n, h // r, w // r, c * r * r)


@amp.op("channel_shuffle")
def channel_shuffle(x, groups, data_format="NCHW", name=None):
    g = int(groups)
    if data_format == "NCHW":
        n, c, h, w = x.shape
        return x.reshape(n, g, c // g, h, w).transpose(1, 2) \
            .reshape(n, c, h, w)
    n, h, w, c = x.shape
    return x.reshape(n, h, w, g, c // g).transpose(3, 4).reshape(n, h, w, c)


@amp.op("label_smooth")
def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


@amp.op("bilinear")
def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[n, o] = x1[n] @ W[o] @ x2[n] (+ b)`` in fp32, in x1's
    dtype."""
    out = torch.einsum("ni,oij,nj->no", x1.float(), weight.float(),
                       x2.float())
    if bias is not None:
        out = out + bias.float()
    return out.to(x1.dtype)


def class_center_sample(label, num_classes, num_samples, group=None,
                        name=None):
    """PartialFC's class-center sampling, eagerly (the count depends on
    the labels): every positive class kept, negatives drawn uniformly
    (a uniform score a class under ``next_key()``, the lowest taken) up to
    ``num_samples`` in all; returns (each label's index in the sampled
    set, the sampled classes ascending), int64. ``group`` must be None."""
    if group is not None:
        raise NotImplementedError(
            "class_center_sample(group=...) distributed per-group sampling "
            "is not implemented; call it per-rank with group=None")
    lab = label.long()
    pos = torch.zeros(num_classes, dtype=torch.bool, device=lab.device)
    pos[lab.reshape(-1)] = True
    n_keep = max(int(num_samples), int(pos.sum()))
    u = D.uniform_plain((num_classes,), next_key(), lab.device)
    score = torch.where(pos, torch.full_like(u, -1.0), u)
    sampled = torch.sort(torch.argsort(score, stable=True)[:n_keep]).values
    return torch.searchsorted(sampled, lab), sampled


class _SegmentGather(torch.autograd.Function):
    """``x [n, S, D]`` gathered at ``idx [n, m]`` along dim 1, whose
    backward adds the gradient's rows back into x's by segments: the rows
    taken in ``order`` (None: idx is sorted already), then summed over the
    segments ``offsets [n, S + 1]`` with ``torch.segment_reduce`` (one
    segment after another in a fixed order; no atomics)."""

    @staticmethod
    def forward(ctx, x, idx, order, offsets):
        ctx.save_for_backward(order, offsets)
        return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))

    @staticmethod
    def backward(ctx, g):
        order, offsets = ctx.saved_tensors
        if order is not None:
            g = g.gather(1, order[..., None].expand(-1, -1, g.shape[-1]))
        return (torch.segment_reduce(g, "sum", offsets=offsets, axis=1,
                                     unsafe=True), None, None, None)


def _by_column(cols, s):
    """(order, offsets) that group the stored entries by their column:
    a stable sort of ``cols [n, m]`` and each column's range in it."""
    order = torch.argsort(cols, dim=1, stable=True)
    bounds = torch.arange(s + 1, dtype=cols.dtype, device=cols.device)
    offsets = torch.searchsorted(cols.gather(1, order).contiguous(),
                                 bounds.expand(cols.shape[0], -1)
                                 .contiguous())
    return order, offsets


@amp.op("sparse_attention", 3)
def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention of ``[B, H, S, D]`` queries each over its own keys, given
    in CSR form (``sparse_csr_offset [B, H, S + 1]``,
    ``sparse_csr_columns [B, H, nnz]``), as the JAX package's
    (``paddle_tpu/nn/functional/common.py:373``): O(nnz) work, a score per
    stored entry in fp32 times ``1 / sqrt(D)``, ``-inf`` where
    ``key_padding_mask [B, S]`` (its key) or ``attn_mask [S, S]`` (its
    pair) is 0 and past the head's ``offset[-1]``, each row's softmax over
    its entries (its max from a finite score, else 0; a row without a
    finite score gives 0), ``p * v`` summed a row, in q's dtype. The
    reductions run row by row over the contiguous CSR rows
    (``torch.segment_reduce``), and the gradients of k and v are summed
    column by column through a stable sort: no atomics, so two calls on
    the card give the same bits."""
    b, h, s, d = query.shape
    nnz = sparse_csr_columns.shape[-1]
    dev = query.device
    n = b * h
    off = sparse_csr_offset.reshape(n, s + 1).to(dev, torch.int64)
    cols = sparse_csr_columns.reshape(n, nnz).to(dev, torch.int64)
    pos = torch.arange(nnz, dtype=torch.int64, device=dev)
    rows = torch.searchsorted(off[:, 1:].contiguous(),
                              pos.expand(n, -1).contiguous(), right=True)
    rows = rows.clamp(0, s - 1)
    order, col_off = _by_column(cols, s)
    qf = query.reshape(n, s, d).float()
    kf = key.reshape(n, s, d).float()
    vf = value.reshape(n, s, d).float()
    qr = _SegmentGather.apply(qf, rows, None, off)
    kc = _SegmentGather.apply(kf, cols, order, col_off)
    vc = _SegmentGather.apply(vf, cols, order, col_off)
    scl = 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32,
                                        device=dev))
    scores = (qr * kc).sum(-1) * scl
    ninf = torch.full((), float("-inf"), dtype=torch.float32, device=dev)
    if key_padding_mask is not None:
        kpm = key_padding_mask.to(dev).repeat_interleave(h, dim=0)
        scores = torch.where(kpm.gather(1, cols) == 0, ninf, scores)
    if attn_mask is not None:
        am = attn_mask.to(dev).reshape(-1)
        scores = torch.where(am[rows * s + cols] == 0, ninf, scores)
    valid = pos[None, :] < off[:, -1:]
    scores = torch.where(valid, scores, ninf)
    rmax = torch.segment_reduce(scores.detach(), "max", offsets=off, axis=1,
                                unsafe=True)
    rmax = torch.where(torch.isfinite(rmax), rmax, torch.zeros_like(rmax))
    p = torch.where(valid, torch.exp(scores - rmax.gather(1, rows)),
                    torch.zeros((), dtype=torch.float32, device=dev))
    denom = torch.segment_reduce(p, "sum", offsets=off, axis=1, unsafe=True)
    num = torch.segment_reduce(p[..., None] * vc, "sum", offsets=off,
                               axis=1, unsafe=True)
    out = num / torch.clamp_min(denom, 1e-20)[..., None]
    return out.reshape(b, h, s, d).to(query.dtype)


__all__ = ["one_hot", "dropout2d", "dropout3d", "alpha_dropout",
           "feature_alpha_dropout", "pad", "zeropad2d", "interpolate",
           "upsample", "unfold", "fold", "cosine_similarity",
           "pixel_shuffle", "pixel_unshuffle", "channel_shuffle",
           "label_smooth", "bilinear", "class_center_sample",
           "sparse_attention"]
