"""RMSNorm (with and without a residual), rotary embedding and the passes
XLA fuses into the training step: Triton kernels and their plain PyTorch
versions.

Replaces ``paddle_tpu/kernels/fused_pallas.py``:
  * ``fused_rms_norm_pallas`` (``_rmsnorm_kernel`` -> ``rms_norm``, and
    with a residual, ``_rmsnorm_res_kernel`` -> ``add_rms_norm``), one
    Triton kernel for both;
  * ``fused_rope_pallas`` (``_rope_kernel``) -> ``fused_rope``.
For training, ``RMSNormFunction`` and ``RopeFunction`` put the kernels under
autograd: RMSNorm's backward is its own kernel (below), RoPE's is the same
kernel with -sin.

Two more passes are no TPU kernel: they are the elementwise work that XLA
fuses into the JAX package's compiled training step, and that PyTorch ran
as separate passes (a profile of the 1.1B Llama step put them first and
second among its elementwise work):
  * ``rms_norm_backward`` (``RMSNormFunction``'s backward): dx, and dw as
    per-program partial sums added up by a second pass (no atomics, so the
    sum is the same every run), for the vjp of the JAX oracle that
    ``fused_rms_norm_pallas``'s ``custom_vjp`` recomputes
    (``paddle_tpu/nn/functional/norm.py`` ``rms_norm``). The autograd of
    the fp32 formula made about twenty passes over [rows, hidden] fp32
    copies; the kernel reads x and dy once and writes dx once;
  * ``swiglu`` (``SwiGLUFunction``): ``silu(gate) * up`` of the Llama MLP
    (``paddle_tpu/models/llama.py`` ``LlamaMLP.forward``), forward in one
    pass and backward (dgate, dup) in one pass, where PyTorch ran silu, the
    product and, in the backward, two products and silu's backward. They
    round as the plain ops do: silu(gate) to the input dtype, then the
    product.
Both are bound by bytes on the H100 like the other kernels here.
One more of that kind:
  * ``dropout_add_layer_norm`` (``DropoutAddLayerNormFunction``):
    ``LayerNorm(residual + dropout(x + bias))`` over the last axis, the
    JAX ``fused_bias_dropout_residual_layer_norm``
    (``paddle_tpu/incubate/nn/functional/fused_ops.py:636``) and the Add&LN
    of ERNIE's post-LN blocks; with no dropout, residual or bias, plain
    LayerNorm, which every ``nn.functional.layer_norm`` on the card runs.
    One program a row as a [hidden / 4, 4] tile (a row of the tile is one
    Philox block of ``kernels/dropout.py``'s mask, drawn in registers);
    the sums and the dropout round to x's dtype where the separate ops
    round, the statistics are fp32. The backward reads the norm's input
    (kept by the forward) and draws the mask again: dx, the residual's
    gradient and per-block partials of the three vector gradients, summed
    in order by a column sum. ``layer_norm_backward_plan`` routes it: rows
    of a multiple of 8 values up to 1280, in fp32, bf16 or fp16 (every
    LayerNorm of the models), to ``csrc/layer_norm_bwd.cu`` (CUDA: a warp
    a row, rows in flight through a cp.async ring, a persistent grid);
    the rest (other widths, unaligned tensors) to the Triton kernel
    ``_dln_bwd_kernel`` and ``_col_sum_kernel``.

Bound on the H100: bytes, for both. RMSNorm does about 4 flops per element
it reads and writes, RoPE about 6; the card needs ~295 per byte before
compute is the limit. The design therefore makes one pass over device
memory: one program per row (RMSNorm) or per (token, block of 8 heads)
(RoPE) loads its tile once, reduces or rotates in fp32 registers, and
writes the result once.
``add_rms_norm`` also writes the residual sum, so the decoder's
``h = h + o; x = rms(h)`` reads h and o once instead of writing h and
reading it back.

Each kernel is also a ``torch.library`` op (``ptt::rms_norm``,
``ptt::add_rms_norm``, ``ptt::rope``) whose CPU implementation is the
plain version and whose CUDA implementation launches the kernel and
counts it: the wrappers and autograd functions below call the ops, and a
program exported by ``jit.save`` holds them.

Triton is imported, and the kernels compiled, at the first launch: the
functions below are plain Python until ``_jit`` wraps them, so importing
this module needs no Triton.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from . import LAUNCHES, sm_count
from . import dropout as D
from ._build import library

tl = None    # triton.language, bound by _jit() at the first launch
_mask_bits = None   # kernels/dropout.py's, bound by _jit()


def _rms_norm_kernel(x_ptr, r_ptr, w_ptr, y_ptr, s_ptr, n_cols, eps,
                     HAS_RES: tl.constexpr, BLOCK: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    offs = tl.arange(0, BLOCK)
    mask = offs < n_cols
    x = tl.load(x_ptr + row * n_cols + offs, mask=mask, other=0.0)
    x = x.to(tl.float32)
    if HAS_RES:
        r = tl.load(r_ptr + row * n_cols + offs, mask=mask, other=0.0)
        sx = (x + r.to(tl.float32)).to(s_ptr.dtype.element_ty)
        tl.store(s_ptr + row * n_cols + offs, sx, mask=mask)
        x = sx.to(tl.float32)       # the norm reads the sum as stored
    ms = tl.sum(x * x, axis=0) / n_cols
    w = tl.load(w_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    y = x * tl.rsqrt(ms + eps) * w
    tl.store(y_ptr + row * n_cols + offs, y.to(y_ptr.dtype.element_ty),
             mask=mask)


def _rope_kernel(q_ptr, k_ptr, cos_ptr, sin_ptr, oq_ptr, ok_ptr, seq, H, KVH,
                 n_qb, HALF: tl.constexpr, BLOCK_H: tl.constexpr,
                 BLOCK_P: tl.constexpr):
    """Program (token, head block): BLOCK_H heads of q (head blocks
    0 .. n_qb-1) or of k (the rest), read and written as contiguous
    [heads, pairs, 2] tiles and split into the pair halves in registers."""
    row = tl.program_id(0).to(tl.int64)         # one token of b * s
    hb = tl.program_id(1)
    if hb < n_qb:
        src, dst, nh, h0 = q_ptr, oq_ptr, H, hb * BLOCK_H
    else:
        src, dst, nh, h0 = k_ptr, ok_ptr, KVH, (hb - n_qb) * BLOCK_H
    pi = tl.arange(0, BLOCK_P)
    pm = pi < HALF
    trow = (row % seq) * HALF
    c = tl.load(cos_ptr + trow + pi, mask=pm, other=0.0)[None, :]
    s = tl.load(sin_ptr + trow + pi, mask=pm, other=0.0)[None, :]
    hh = h0 + tl.arange(0, BLOCK_H)
    off = (row * nh * 2 * HALF + hh[:, None, None] * (2 * HALF)
           + 2 * pi[None, :, None] + tl.arange(0, 2)[None, None, :])
    m = (hh < nh)[:, None, None] & pm[None, :, None]
    x = tl.load(src + off, mask=m, other=0.0).to(tl.float32)
    x1, x2 = tl.split(x)
    y = tl.join(x1 * c - x2 * s, x2 * c + x1 * s)
    tl.store(dst + off, y.to(dst.dtype.element_ty), mask=m)


def _rms_norm_bwd_kernel(x_ptr, w_ptr, dy_ptr, dx_ptr, part_ptr, n_rows,
                         n_cols, rows_per_prog, eps, BLOCK: tl.constexpr):
    """Program p: rows [p * rows_per_prog, ...) of dx, and its fp32 partial
    sum of dw over those rows into part[p]."""
    pid = tl.program_id(0)
    offs = tl.arange(0, BLOCK)
    cm = offs < n_cols
    w = tl.load(w_ptr + offs, mask=cm, other=0.0).to(tl.float32)
    dw = tl.zeros([BLOCK], dtype=tl.float32)
    for i in range(0, rows_per_prog):
        row = pid.to(tl.int64) * rows_per_prog + i
        m = cm & (row < n_rows)
        x = tl.load(x_ptr + row * n_cols + offs, mask=m, other=0.0)
        x = x.to(tl.float32)
        dy = tl.load(dy_ptr + row * n_cols + offs, mask=m,
                     other=0.0).to(tl.float32)
        r = tl.rsqrt(tl.sum(x * x, axis=0) / n_cols + eps)
        dw += dy * (x * r)
        da = dy * w
        # y = (x * r) * w, r = (mean(x^2) + eps)^-1/2
        dms = -0.5 * tl.sum(da * x, axis=0) * (r * r * r)
        dx = da * r + (2.0 * dms / n_cols) * x
        tl.store(dx_ptr + row * n_cols + offs,
                 dx.to(dx_ptr.dtype.element_ty), mask=m)
    tl.store(part_ptr + pid * n_cols + offs, dw, mask=cm)


def _col_sum_kernel(part_ptr, out_ptr, n_parts, n_cols,
                    BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
    """out[c] = sum over p of part[p, c] (fp32, in a fixed order), cast to
    out's dtype."""
    cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
    cm = cols < n_cols
    acc = tl.zeros([BLOCK_C], dtype=tl.float32)
    for p0 in range(0, n_parts, BLOCK_P):
        ps = p0 + tl.arange(0, BLOCK_P)
        tile = tl.load(part_ptr + ps[:, None] * n_cols + cols[None, :],
                       mask=(ps < n_parts)[:, None] & cm[None, :], other=0.0)
        acc += tl.sum(tile, axis=0)
    tl.store(out_ptr + cols, acc.to(out_ptr.dtype.element_ty), mask=cm)


def _swiglu_fwd_kernel(g_ptr, u_ptr, y_ptr, n, BLOCK: tl.constexpr):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    m = offs < n
    g = tl.load(g_ptr + offs, mask=m, other=0.0).to(tl.float32)
    u = tl.load(u_ptr + offs, mask=m, other=0.0).to(tl.float32)
    # silu rounded to gate's dtype, the product to the output's
    s = (g / (1.0 + tl.exp(-g))).to(g_ptr.dtype.element_ty).to(tl.float32)
    tl.store(y_ptr + offs, (s * u).to(y_ptr.dtype.element_ty), mask=m)


def _swiglu_bwd_kernel(g_ptr, u_ptr, dy_ptr, dg_ptr, du_ptr, n,
                       BLOCK: tl.constexpr):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    m = offs < n
    g = tl.load(g_ptr + offs, mask=m, other=0.0).to(tl.float32)
    u = tl.load(u_ptr + offs, mask=m, other=0.0).to(tl.float32)
    dy = tl.load(dy_ptr + offs, mask=m, other=0.0).to(tl.float32)
    tg = dg_ptr.dtype.element_ty          # each gradient in its input's
    sig = 1.0 / (1.0 + tl.exp(-g))
    s = (g / (1.0 + tl.exp(-g))).to(tg).to(tl.float32)
    tl.store(du_ptr + offs, (dy * s).to(du_ptr.dtype.element_ty), mask=m)
    ds = (dy * u).to(tg).to(tl.float32)
    tl.store(dg_ptr + offs, (ds * sig * (1.0 + g * (1.0 - sig))).to(tg),
             mask=m)


def _dln_fwd_kernel(x_ptr, b_ptr, r_ptr, w_ptr, nb_ptr, y_ptr, h_ptr,
                    key_ptr, n_cols, site, thresh, scale, eps,
                    HAS_BIAS: tl.constexpr, HAS_RES: tl.constexpr,
                    HAS_DROP: tl.constexpr, WRITE_H: tl.constexpr,
                    ALIGNED: tl.constexpr, BLOCK_G: tl.constexpr):
    """Program = one row, as a [BLOCK_G, 4] tile (column 4g + j): h =
    residual + dropout(x + bias), each sum and the dropout rounded to x's
    dtype as the separate ops round, written where asked; y = LayerNorm(h)
    with fp32 statistics."""
    row = tl.program_id(0).to(tl.int64)
    g = tl.arange(0, BLOCK_G)
    j = tl.arange(0, 4)
    col = g[:, None] * 4 + j[None, :]
    cm = col < n_cols
    off = row * n_cols + col
    dt = y_ptr.dtype.element_ty
    v = tl.load(x_ptr + off, mask=cm, other=0.0).to(tl.float32)
    if HAS_BIAS:
        b = tl.load(b_ptr + col, mask=cm, other=0.0).to(tl.float32)
        v = (v + b).to(dt).to(tl.float32)
    if HAS_DROP:
        if ALIGNED:     # a row starts a Philox block
            bits = _mask_bits(row * (n_cols // 4) + g[:, None], j[None, :],
                              key_ptr, site)
        else:
            bits = _mask_bits(off >> 2, off & 3, key_ptr, site)
        keep = (bits >> 8).to(tl.int32) >= thresh
        v = tl.where(keep, v * scale, 0.0).to(dt).to(tl.float32)
    if HAS_RES:
        r = tl.load(r_ptr + off, mask=cm, other=0.0).to(tl.float32)
        v = (v + r).to(dt).to(tl.float32)
    if WRITE_H:
        tl.store(h_ptr + off, v.to(dt), mask=cm)
    mean = tl.sum(tl.sum(v, axis=1), axis=0) / n_cols
    c = tl.where(cm, v - mean, 0.0)
    var = tl.sum(tl.sum(c * c, axis=1), axis=0) / n_cols
    rstd = tl.rsqrt(var + eps)
    w = tl.load(w_ptr + col, mask=cm, other=0.0).to(tl.float32)
    nb = tl.load(nb_ptr + col, mask=cm, other=0.0).to(tl.float32)
    tl.store(y_ptr + off, (c * rstd * w + nb).to(dt), mask=cm)


def _dln_bwd_kernel(h_ptr, w_ptr, dy_ptr, dh_ptr, dx_ptr, part_ptr, key_ptr,
                    n_rows, n_cols, rows_per_prog, site, thresh, scale, eps,
                    HAS_DROP: tl.constexpr, ALIGNED: tl.constexpr,
                    BLOCK_G: tl.constexpr):
    """Program p: rows [p * rows_per_prog, ...) of dh (LayerNorm's input
    gradient, rounded to h's dtype: the residual's), dx (dh through the
    dropout's mask, drawn again) and its fp32 partial sums of dweight,
    dbias of the norm and dbias of the input into part[p] ([3, n_cols])."""
    pid = tl.program_id(0)
    g = tl.arange(0, BLOCK_G)
    j = tl.arange(0, 4)
    col = g[:, None] * 4 + j[None, :]
    cm = col < n_cols
    dt = dh_ptr.dtype.element_ty
    w = tl.load(w_ptr + col, mask=cm, other=0.0).to(tl.float32)
    acc_w = tl.zeros([BLOCK_G, 4], dtype=tl.float32)
    acc_b = tl.zeros([BLOCK_G, 4], dtype=tl.float32)
    acc_x = tl.zeros([BLOCK_G, 4], dtype=tl.float32)
    for i in range(0, rows_per_prog):
        row = pid.to(tl.int64) * rows_per_prog + i
        m = cm & (row < n_rows)
        off = row * n_cols + col
        h = tl.load(h_ptr + off, mask=m, other=0.0).to(tl.float32)
        dy = tl.load(dy_ptr + off, mask=m, other=0.0).to(tl.float32)
        mean = tl.sum(tl.sum(h, axis=1), axis=0) / n_cols
        c = tl.where(m, h - mean, 0.0)
        var = tl.sum(tl.sum(c * c, axis=1), axis=0) / n_cols
        rstd = tl.rsqrt(var + eps)
        xhat = c * rstd
        acc_w += dy * xhat
        acc_b += dy
        gw = dy * w
        mg = tl.sum(tl.sum(gw, axis=1), axis=0) / n_cols
        mgx = tl.sum(tl.sum(gw * xhat, axis=1), axis=0) / n_cols
        dh = (rstd * (gw - mg - xhat * mgx)).to(dt)
        tl.store(dh_ptr + off, dh, mask=m)
        d = dh.to(tl.float32)
        if HAS_DROP:
            if ALIGNED:
                bits = _mask_bits(row * (n_cols // 4) + g[:, None],
                                  j[None, :], key_ptr, site)
            else:
                bits = _mask_bits(off >> 2, off & 3, key_ptr, site)
            keep = (bits >> 8).to(tl.int32) >= thresh
            d = tl.where(keep, d * scale, 0.0).to(dt).to(tl.float32)
            tl.store(dx_ptr + off, d.to(dt), mask=m)
        acc_x += d
    base = part_ptr + pid.to(tl.int64) * (3 * n_cols)
    tl.store(base + col, acc_w, mask=cm)
    tl.store(base + n_cols + col, acc_b, mask=cm)
    tl.store(base + 2 * n_cols + col, acc_x, mask=cm)


@functools.lru_cache(maxsize=None)
def _jit():
    """Import Triton and wrap the kernels (once)."""
    global tl, _mask_bits
    import triton
    import triton.language
    tl = triton.language
    D._jit()
    _mask_bits = D._mask_bits      # the dropout kernel's mask, wrapped
    return triton, {"rms": triton.jit(_rms_norm_kernel),
                    "rms_bwd": triton.jit(_rms_norm_bwd_kernel),
                    "col_sum": triton.jit(_col_sum_kernel),
                    "swiglu_fwd": triton.jit(_swiglu_fwd_kernel),
                    "swiglu_bwd": triton.jit(_swiglu_bwd_kernel),
                    "dln_fwd": triton.jit(_dln_fwd_kernel,
                                          do_not_specialize=["site",
                                                             "thresh"]),
                    "dln_bwd": triton.jit(_dln_bwd_kernel,
                                          do_not_specialize=["site",
                                                             "thresh"]),
                    # H and KVH pick the head count in one branch or the
                    # other: an argument equal to 1 must not turn constexpr
                    "rope": triton.jit(_rope_kernel,
                                       do_not_specialize=["H", "KVH"])}


# -- plain versions -------------------------------------------------------------

def rms_norm_plain(x, weight, eps=1e-6):
    """RMSNorm over the last axis in fp32, cast back to x's dtype."""
    x32 = x.float()
    ms = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * weight.float()).to(x.dtype)


def add_rms_norm_plain(x, residual, weight, eps=1e-6):
    """(x + residual, rms_norm(x + residual)): the sum rounded to x's
    dtype, then the norm of that rounded sum."""
    h = (x.float() + residual.float()).to(x.dtype)
    return h, rms_norm_plain(h, weight, eps)


def rms_norm_backward_plain(x, weight, dy, eps=1e-6):
    """(dx, dw) of ``rms_norm_plain`` at x for the output gradient dy: the
    autograd of its fp32 formula, dx in x's dtype and dw in the weight's."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_()
        ww = weight.detach().requires_grad_()
        y = rms_norm_plain(xx, ww, eps)
        dx, dw = torch.autograd.grad(y, (xx, ww), dy)
    return dx, dw


def swiglu_plain(gate, up):
    """``silu(gate) * up`` as the Llama MLP's two ops: silu rounded to
    gate's dtype, then the product in the two dtypes' promotion (each
    computed in fp32)."""
    return torch.nn.functional.silu(gate) * up


def swiglu_backward_plain(gate, up, dy):
    """(dgate, dup) of ``swiglu_plain``: its autograd."""
    with torch.enable_grad():
        g = gate.detach().requires_grad_()
        u = up.detach().requires_grad_()
        dg, du = torch.autograd.grad(swiglu_plain(g, u), (g, u), dy)
    return dg, du


def fused_rope_plain(q, k, cos, sin):
    """Interleaved-pair rotary embedding. q [b, s, h, d], k [b, s, kvh, d],
    cos/sin [s, d/2]; computed in fp32, cast back."""
    c = cos.float()[None, :, None, :]
    s = sin.float()[None, :, None, :]

    def rotate(x):
        x1 = x[..., 0::2].float()
        x2 = x[..., 1::2].float()
        return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1) \
            .reshape(x.shape).to(x.dtype)

    return rotate(q), rotate(k)


# -- wrappers -------------------------------------------------------------------

_DTYPES = (torch.float32, torch.bfloat16)


def _on_cuda(name, *tensors):
    """True for CUDA tensors the kernel takes, False for CPU tensors;
    raises on anything else."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    for x in tensors:
        if x.device != dev:
            raise ValueError(f"{name}: tensors on {x.device} and {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return True


def _norm_launch(x, weight, eps, residual):
    hidden = x.shape[-1]
    if x.dtype not in _DTYPES or weight.shape != (hidden,):
        raise ValueError(f"rms_norm takes float32/bfloat16 x [..., {hidden}] "
                         f"and weight [{hidden}], got {x.dtype}, "
                         f"{tuple(weight.shape)}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype):
        raise ValueError("residual must have x's shape and dtype")
    triton, k = _jit()
    rows = x.numel() // hidden
    y = torch.empty_like(x)
    s = torch.empty_like(x) if residual is not None else y
    block = triton.next_power_of_2(hidden)
    k["rms"][(rows,)](x, residual if residual is not None else x, weight, y,
                      s, hidden, eps, HAS_RES=residual is not None,
                      BLOCK=block, num_warps=min(max(block // 256, 1), 16))
    return y, s


# -- the kernels as torch.library ops ---------------------------------------------
#
# Each op's CPU implementation is the plain version and its CUDA
# implementation launches the kernel (and counts it): the dispatcher picks
# by the tensors' device, so a program exported with ``torch.export`` (the
# ``jit`` artifact) holds the op and, loaded on the card, launches the
# kernel. The fake implementations give the shapes to the tracer.

@torch.library.custom_op("ptt::rms_norm", mutates_args=(),
                         device_types="cpu")
def rms_norm_op(x: torch.Tensor, weight: torch.Tensor,
                eps: float) -> torch.Tensor:
    """RMSNorm over the last axis: the Triton kernel on CUDA tensors."""
    return rms_norm_plain(x, weight, eps)


@rms_norm_op.register_kernel("cuda")
def _rms_norm_cuda(x, weight, eps):
    _on_cuda("rms_norm", x, weight)
    y, _ = _norm_launch(x, weight, eps, None)
    LAUNCHES["rms_norm"] += 1
    return y


@rms_norm_op.register_fake
def _rms_norm_fake(x, weight, eps):
    return x.new_empty(x.shape)


@torch.library.custom_op("ptt::add_rms_norm", mutates_args=(),
                         device_types="cpu")
def add_rms_norm_op(x: torch.Tensor, residual: torch.Tensor,
                    weight: torch.Tensor,
                    eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + residual, RMSNorm(x + residual)): the Triton kernel with its
    residual on CUDA tensors."""
    return add_rms_norm_plain(x, residual, weight, eps)


@add_rms_norm_op.register_kernel("cuda")
def _add_rms_norm_cuda(x, residual, weight, eps):
    _on_cuda("add_rms_norm", x, residual, weight)
    y, s = _norm_launch(x, weight, eps, residual)
    LAUNCHES["rms_norm_residual"] += 1
    return s, y


@add_rms_norm_op.register_fake
def _add_rms_norm_fake(x, residual, weight, eps):
    return x.new_empty(x.shape), x.new_empty(x.shape)


@torch.library.custom_op("ptt::rope", mutates_args=(), device_types="cpu")
def rope_op(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Interleaved-pair RoPE of q and k: the Triton kernel on CUDA
    tensors."""
    return fused_rope_plain(q, k, cos, sin)


@rope_op.register_kernel("cuda")
def _rope_cuda(q, k, cos, sin):
    _on_cuda("fused_rope", q, k, cos, sin)
    return _rope_launch(q, k, cos, sin)


@rope_op.register_fake
def _rope_fake(q, k, cos, sin):
    return q.new_empty(q.shape), k.new_empty(k.shape)


class RMSNormFunction(torch.autograd.Function):
    """RMSNorm whose forward is ``rms_norm_op`` and whose backward is
    ``rms_norm_backward`` (the Triton kernels on CUDA tensors), the vjp of
    the fp32 formula, as the JAX code differentiates its oracle."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return rms_norm_op(x, weight, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw = rms_norm_backward(x, weight, dy, ctx.eps)
        return dx, dw, None


def rms_norm_backward(x, weight, dy, eps=1e-6):
    """(dx, dw) of RMSNorm over the last axis: on CUDA tensors the Triton
    kernels (one pass over the rows, each program summing its rows' dw in
    fp32; a second pass adding the programs' sums in order), on CPU
    tensors ``rms_norm_backward_plain``."""
    dy = dy.contiguous()
    if not _on_cuda("rms_norm_backward", x, weight, dy):
        return rms_norm_backward_plain(x, weight, dy, eps)
    hidden = x.shape[-1]
    if x.dtype not in _DTYPES or dy.dtype != x.dtype \
            or weight.shape != (hidden,) or dy.shape != x.shape:
        raise ValueError(f"rms_norm_backward takes float32/bfloat16 x and dy "
                         f"of one shape [..., {hidden}] and weight "
                         f"[{hidden}], got {x.dtype}, {dy.dtype}, "
                         f"{tuple(dy.shape)}, {tuple(weight.shape)}")
    triton, k = _jit()
    rows = x.numel() // hidden
    progs = max(1, min(rows, 4 * torch.cuda.get_device_properties(
        x.device).multi_processor_count))
    per = triton.cdiv(rows, progs)
    progs = triton.cdiv(rows, per)
    block = triton.next_power_of_2(hidden)
    dx = torch.empty_like(x)
    part = torch.empty(progs, hidden, dtype=torch.float32, device=x.device)
    k["rms_bwd"][(progs,)](x, weight, dy, dx, part, rows, hidden, per, eps,
                           BLOCK=block,
                           num_warps=min(max(block // 256, 1), 16))
    dw = torch.empty_like(weight)
    k["col_sum"][(triton.cdiv(hidden, 64),)](part, dw, progs, hidden,
                                             BLOCK_P=64, BLOCK_C=64,
                                             num_warps=4)
    LAUNCHES["rms_norm_bwd"] += 1
    return dx, dw


def rms_norm(x, weight, eps=1e-6):
    """RMSNorm of x over the last axis, in x's dtype, differentiable,
    through ``rms_norm_op``: the Triton kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    return RMSNormFunction.apply(x, weight, eps)


def add_rms_norm(x, residual, weight, eps=1e-6):
    """(x + residual, RMSNorm(x + residual)) in one pass: the residual
    variant of ``fused_rms_norm_pallas``, which also writes the sum. The
    sum is rounded to x's dtype and the norm is taken of that rounded sum,
    as the decoder's ``h = h + o; _rms(h)`` does (the Pallas kernel
    normalises the unrounded fp32 sum: the same in float32, up to one
    rounding of the sum in bf16). Through ``add_rms_norm_op``; not
    differentiable (serving's)."""
    return add_rms_norm_op(x, residual, weight, eps)


def _rope_launch(q, k, cos, sin):
    b, s, h, d = q.shape
    if k.dim() != 4 or k.shape[:2] != (b, s) or k.shape[3] != d or d % 2:
        raise ValueError(f"fused_rope: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not match")
    if cos.shape != (s, d // 2) or sin.shape != (s, d // 2) \
            or cos.dtype != torch.float32 or sin.dtype != torch.float32:
        raise ValueError(f"fused_rope: cos/sin must be float32 [{s}, {d // 2}]")
    if q.dtype not in _DTYPES or k.dtype != q.dtype:
        raise ValueError("fused_rope: q and k must share a float32/bfloat16 "
                         "dtype")
    triton, kern = _jit()
    oq = torch.empty_like(q)
    ok = torch.empty_like(k)
    kvh = k.shape[2]
    bh = min(8, triton.next_power_of_2(max(h, kvh)))
    n_qb = triton.cdiv(h, bh)
    kern["rope"][(b * s, n_qb + triton.cdiv(kvh, bh))](
        q, k, cos, sin, oq, ok, s, h, kvh, n_qb, HALF=d // 2, BLOCK_H=bh,
        BLOCK_P=triton.next_power_of_2(d // 2), num_warps=4)
    LAUNCHES["rope"] += 1
    return oq, ok


class RopeFunction(torch.autograd.Function):
    """Rotary embedding whose forward and backward are both ``rope_op``
    (the Triton kernel on CUDA tensors): the backward rotates the output
    gradients by -theta (the same op with -sin), which is the exact
    transpose of the rotation. The JAX code takes the vjp of its oracle,
    which computes the same."""

    @staticmethod
    def forward(ctx, q, k, cos, sin):
        ctx.save_for_backward(cos, sin)
        return rope_op(q, k, cos, sin)

    @staticmethod
    def backward(ctx, gq, gk):
        cos, sin = ctx.saved_tensors
        dq, dk = rope_op(gq.contiguous(), gk.contiguous(), cos, -sin)
        return dq, dk, None, None


class SwiGLUFunction(torch.autograd.Function):
    """``silu(gate) * up`` whose forward (``swiglu_op``, so an exported
    program holds it) and backward are one Triton kernel each on CUDA
    tensors (the plain versions on CPU tensors). It keeps gate
    and up for the backward, as PyTorch kept them for silu's backward and
    the product's (and silu's output, which the kernel recomputes)."""

    @staticmethod
    def forward(ctx, gate, up):
        ctx.save_for_backward(gate, up)
        return swiglu_op(gate, up)

    @staticmethod
    def backward(ctx, dy):
        gate, up = ctx.saved_tensors
        return swiglu_backward(gate, up, dy)


def swiglu_backward(gate, up, dy):
    """(dgate, dup) of ``silu(gate) * up``: one Triton kernel on CUDA
    tensors (silu recomputed from gate), ``swiglu_backward_plain`` on CPU
    tensors."""
    dy = dy.contiguous()
    if not _swiglu_on_cuda(gate, up, dy):
        return swiglu_backward_plain(gate, up, dy)
    triton, k = _jit()
    dg = torch.empty_like(gate)
    du = torch.empty_like(up)
    n = dg.numel()
    k["swiglu_bwd"][(triton.cdiv(n, _SWIGLU_BLOCK),)](
        gate, up, dy, dg, du, n, BLOCK=_SWIGLU_BLOCK, num_warps=8)
    LAUNCHES["swiglu_bwd"] += 1
    return dg, du


_SWIGLU_BLOCK = 4096


@torch.library.custom_op("ptt::swiglu", mutates_args=(), device_types="cpu")
def swiglu_op(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up``: the Triton kernel on CUDA tensors."""
    return swiglu_plain(gate, up)


@swiglu_op.register_kernel("cuda")
def _swiglu_cuda(gate, up):
    _swiglu_on_cuda(gate, up)
    triton, k = _jit()
    y = torch.empty(gate.shape, dtype=_promoted(gate, up),
                    device=gate.device)
    n = y.numel()
    k["swiglu_fwd"][(triton.cdiv(n, _SWIGLU_BLOCK),)](
        gate, up, y, n, BLOCK=_SWIGLU_BLOCK, num_warps=8)
    LAUNCHES["swiglu_fwd"] += 1
    return y


@swiglu_op.register_fake
def _swiglu_fake(gate, up):
    return gate.new_empty(gate.shape, dtype=_promoted(gate, up))


def _promoted(gate, up):
    """The product's dtype, as ``silu(gate) * up`` promotes."""
    return torch.promote_types(gate.dtype, up.dtype)


def _swiglu_on_cuda(*tensors):
    if not _on_cuda("swiglu", *tensors):
        return False
    x = tensors[0]
    if any(t.dtype not in _DTYPES or t.shape != x.shape for t in tensors):
        raise ValueError(f"swiglu takes float32/bfloat16 tensors of one "
                         f"shape, got "
                         f"{[(tuple(t.shape), t.dtype) for t in tensors]}")
    return True


def swiglu(gate, up):
    """``silu(gate) * up``, differentiable, through ``SwiGLUFunction``: a
    Triton kernel forward and backward on CUDA tensors (gate and up of one
    shape, in float32 or bfloat16 each: silu rounds to gate's dtype and
    the product to the two dtypes' promotion, as the two ops do), the
    plain version on CPU tensors."""
    return SwiGLUFunction.apply(gate, up)


def fused_rope(q, k, cos, sin):
    """Interleaved-pair rotary embedding of q [b, s, h, d] and k
    [b, s, kvh, d] with cos/sin [s, d/2] (fp32), in one pass over both,
    differentiable, through ``rope_op``: the Triton kernel on CUDA
    tensors, the plain version on CPU tensors."""
    return RopeFunction.apply(q, k, cos, sin)


# -- LayerNorm with a dropout and a residual ----------------------------------------

def layer_norm_plain(x, weight=None, bias=None, eps=1e-5, n_axes=1):
    """LayerNorm over the trailing ``n_axes`` axes with the JAX formula
    (``paddle_tpu/nn/functional/norm.py:27``): mean and (biased) variance
    of x in fp32, ``(x - mean) / sqrt(var + eps)``, times the weight and
    plus the bias in fp32, cast back to x's dtype."""
    axes = tuple(range(x.dim() - n_axes, x.dim()))
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    centered = xf - mean
    var = (centered * centered).mean(dim=axes, keepdim=True)
    out = centered / torch.sqrt(var + eps)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def dropout_add_plain(x, residual=None, bias=None, p=0.0, key=None,
                      mode="upscale_in_train"):
    """``residual + dropout(x + bias)`` as the separate ops compute it
    (each rounded to its dtype): the input of the norm."""
    h = x if bias is None else x + bias
    if p > 0.0:
        h = D.dropout_plain(h, p, key, mode)
    return h if residual is None else h + residual


def dropout_add_layer_norm_plain(x, weight=None, norm_bias=None, eps=1e-5,
                                 residual=None, bias=None, p=0.0, key=None,
                                 mode="upscale_in_train"):
    """``LayerNorm(residual + dropout(x + bias))`` over the last axis by
    the plain ops (the JAX ``fused_bias_dropout_residual_layer_norm``,
    ``paddle_tpu/incubate/nn/functional/fused_ops.py:636``), differentiable
    by autograd."""
    h = dropout_add_plain(x, residual, bias, p, key, mode)
    return layer_norm_plain(h, weight, norm_bias, eps)


def _dln_check(x, weight, norm_bias, residual, bias, p, key):
    n = x.shape[-1]
    if x.dtype not in D._DTYPES:
        raise ValueError(f"layer_norm takes {D._DTYPES}, got {x.dtype}")
    for name, t, shape in (("weight", weight, (n,)),
                           ("norm bias", norm_bias, (n,)),
                           ("bias", bias, (n,)),
                           ("residual", residual, tuple(x.shape))):
        if t is not None and (tuple(t.shape) != shape
                              or not t.is_contiguous()):
            raise ValueError(f"dropout_add_layer_norm: {name} must be "
                             f"contiguous {list(shape)}, got "
                             f"{tuple(t.shape)}")
    for name, t in (("bias", bias), ("residual", residual)):
        if t is not None and t.dtype != x.dtype:
            raise ValueError(f"dropout_add_layer_norm: {name} must have "
                             f"x's dtype {x.dtype}, got {t.dtype}")
    if p > 0.0 and key is None:
        raise ValueError("dropout_add_layer_norm: p > 0 needs a key")


def _dln_args(x, p, key, mode):
    """(key tensor, site, threshold, scale, aligned) of a launch; without
    a dropout the kernel reads no key, and x stands in for its pointer."""
    if p > 0.0:
        base, site = key
        return (D.key_tensor(base, x.device), int(site) & D.M32,
                D.threshold(p), D.scale_of(p, mode), x.shape[-1] % 4 == 0)
    return x, 0, 0, 1.0, True


def _dln_block(n):
    return max(1, 1 << (max(n, 4) - 1).bit_length()) // 4


def dropout_add_layer_norm_forward(x, weight, norm_bias, eps=1e-5,
                                   residual=None, bias=None, p=0.0,
                                   key=None, mode="upscale_in_train"):
    """(y, h) of the forward kernel on CUDA tensors: h = residual +
    dropout(x + bias) (x itself when there is nothing to add or drop), y =
    LayerNorm(h) over the last axis with ``weight`` and ``norm_bias``
    (tensors of [hidden]), both in x's dtype."""
    _on_cuda("dropout_add_layer_norm", *(t for t in (x, weight, norm_bias,
                                                     residual, bias)
                                         if t is not None))
    _dln_check(x, weight, norm_bias, residual, bias, p, key)
    triton, k = _jit()
    n = x.shape[-1]
    rows = x.numel() // n if n else 0
    y = torch.empty_like(x)
    write_h = residual is not None or bias is not None or p > 0.0
    h = torch.empty_like(x) if write_h else x
    kt, site, thresh, scale, aligned = _dln_args(x, p, key, mode)
    bg = _dln_block(n)
    if rows:
        k["dln_fwd"][(rows,)](
            x, bias if bias is not None else x,
            residual if residual is not None else x, weight, norm_bias, y, h,
            kt, n, site, thresh, scale, eps, HAS_BIAS=bias is not None,
            HAS_RES=residual is not None, HAS_DROP=p > 0.0, WRITE_H=write_h,
            ALIGNED=aligned, BLOCK_G=bg,
            num_warps=min(max(4 * bg // 256, 1), 16))
    LAUNCHES["dropout_add_ln"] += 1
    return y, h


# The CUDA backward (csrc/layer_norm_bwd.cu): 8 warps a block; a block
# keeps at most this many bytes of shared memory at two blocks an SM
# ((233,472 / 2) less the 1 KB each block keeps) and at one
_LN_WARPS = 8
_LN_VEC = 8                 # values a lane's chunk
_LN_MAX_CHUNKS = 5          # chunks a lane: rows of up to 1280 values
_LN_STAGES = 2              # rows a warp's ring holds (the kernel's STAGES)
_LN_COL_ROWS = 32           # thread rows of its column sum
_LN_BLOCK_BYTES = {2: 115712, 1: 232448}
_LN_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


class LnBwdPlan(NamedTuple):
    """The LayerNorm backward's launch: ``route`` "warp" (the CUDA kernel:
    ``blocks`` blocks of 8 warps, a warp a row, ``rows`` rows a warp at
    most, ``smem`` bytes a block, ``chunks`` 8-value chunks a lane) or
    "triton" (``_dln_bwd_kernel``: ``blocks`` programs of ``rows`` rows,
    ``chunks`` its BLOCK_G; smem 0)."""
    route: str
    blocks: int
    rows: int
    smem: int
    chunks: int


def _ln_smem(n, esize):
    """Shared memory bytes of a CUDA-kernel block, which the wrapper hands
    the kernel: the weight in fp32, then 8 warps' rings of two rows of h
    and dy, or the warps' three column sums in fp32 where those take
    more."""
    return -(-4 * n // 16) * 16 + max(_LN_WARPS * _LN_STAGES * 2 * n * esize,
                                      _LN_WARPS * 3 * n * 4)


def layer_norm_backward_plan(rows, n, dtype, sms):
    """The backward's route for ``rows`` rows of ``n`` values of ``dtype``
    on ``sms`` SMs. The CUDA kernel ("warp") takes fp32, bf16 and fp16
    rows of a multiple of 8 values from 8 to 1280 (ERNIE's and GPT's 768,
    the UNet's 320, 640 and 1280, Transformer-base's 512): two blocks an
    SM for 16-bit rows whose lane holds at most 3 chunks (n <= 768), else
    one; no more blocks than 8 rows each fill. (``tools/norm_bwd_plans.py``
    times 1 to 3 blocks an SM at the models' shapes on the H100: a second
    block was faster at 16 bits only.) Other widths (the tests' 130) and
    dtypes go to the Triton kernel, about four programs an SM."""
    esize = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}.get(dtype)
    chunks = -(-(n // _LN_VEC) // 32)
    if esize and rows > 0 and n % _LN_VEC == 0 and 0 < chunks <= _LN_MAX_CHUNKS:
        per_sm = 2 if esize == 2 and chunks <= 3 else 1
        blocks = max(1, min(sms * per_sm, -(-rows // _LN_WARPS)))
        return LnBwdPlan("warp", blocks, -(-rows // (blocks * _LN_WARPS)),
                         _ln_smem(n, esize), chunks)
    return _triton_plan(rows, n, sms)


def _triton_plan(rows, n, sms):
    """The Triton kernel's launch: about four programs an SM."""
    progs = max(1, min(rows, 4 * sms))
    per = -(-max(rows, 1) // progs)
    return LnBwdPlan("triton", -(-max(rows, 1) // per), per, 0, _dln_block(n))


def xor_tree_plain(t):
    """The ``__shfl_xor_sync`` sum over the last axis (32 lanes, or a
    power of two fewer) in its order: at offsets L / 2, ..., 2, 1 each lane
    adds its partner's value. Returns every lane's total (lane 0's is the
    kernels')."""
    size = t.shape[-1]
    lane = torch.arange(size, device=t.device)
    off = size // 2
    while off:
        t = t + t[..., lane ^ off]
        off //= 2
    return t


def layer_norm_column_sums_split_plain(terms, plan):
    """The sums over the rows of ``terms`` [k, rows, n] fp32 in the CUDA
    kernel's order, [k, n]: row r on warp r % (8 blocks), a warp's rows in
    order into its lanes' registers, a block's warps added in warp order
    into its partial row, and the column sum's 32 thread rows (partial rows
    p, p + 32, ... in order) added in row order. Only additions: given the
    kernel's own addends (dy for the norm's dbias, dx for dbias) it gives
    the kernel's bits, which the card's tests hold. ``plan`` is a "warp"
    ``LnBwdPlan``."""
    k, rows, n = terms.shape
    warps = plan.blocks * _LN_WARPS
    acc = torch.zeros(k, warps, n, dtype=torch.float32, device=terms.device)
    for i in range(plan.rows):
        r = torch.arange(warps, device=terms.device) + i * warps
        ok = r < rows
        acc[:, ok] = acc[:, ok] + terms[:, r[ok]]
    acc = acc.reshape(k, plan.blocks, _LN_WARPS, n)
    red = acc[:, :, 0]
    for wi in range(1, _LN_WARPS):
        red = red + acc[:, :, wi]
    sums = torch.zeros(_LN_COL_ROWS, k, n, dtype=torch.float32,
                       device=terms.device)
    for q in range(plan.blocks):
        sums[q % _LN_COL_ROWS] = sums[q % _LN_COL_ROWS] + red[:, q]
    total = sums[0]
    for r in range(1, _LN_COL_ROWS):
        total = total + sums[r]
    return total


def layer_norm_backward_split_plain(h, weight, dy, eps, plan, p=0.0,
                                    key=None, mode="upscale_in_train"):
    """(dweight, dnorm_bias, dbias) [n] fp32 in the CUDA kernel's order of
    sums, in fp32 on h's device: a warp a row, lane l holding the row's
    8-value chunks l, l + 32, ... and each row's reduction its values in
    order then the xor tree (the mean and variance in one pass of the
    values less the row's first); the column sums as
    ``layer_norm_column_sums_split_plain``. The addends here are plain
    fp32 arithmetic; the kernel contracts products into fused
    multiply-adds and takes rstd by ``rsqrtf``, so dweight's addends (dy
    x-hat) and dh may differ from the kernel's in the last bits, and only
    sums of the kernel's own addends are bit-equal. ``plan`` is a "warp"
    ``LnBwdPlan``."""
    n = h.shape[-1]
    rows = h.numel() // n
    hf = h.reshape(rows, n).float()
    g = dy.reshape(rows, n).float()
    w = weight.float()
    nch = plan.chunks
    pad = 32 * nch * _LN_VEC - n

    def warp_sum(t):
        lanes = torch.nn.functional.pad(t, (0, pad)).reshape(
            rows, nch, 32, _LN_VEC)
        acc = torch.zeros(rows, 32, dtype=torch.float32, device=t.device)
        for k in range(nch):
            for j in range(_LN_VEC):
                acc = acc + lanes[:, k, :, j]
        return xor_tree_plain(acc)[:, 0:1]
    c = hf - hf[:, :1]
    m1 = warp_sum(c) / n
    mean = hf[:, :1] + m1
    rstd = torch.rsqrt((warp_sum(c * c) / n - m1 * m1).clamp(min=0) + eps)
    xh = (hf - mean) * rstd
    gw = g * w
    mg, mgx = warp_sum(gw) / n, warp_sum(gw * xh) / n
    d = (rstd * (gw - mg - xh * mgx)).to(h.dtype).float()
    if p > 0.0:
        keep = D.keep_mask_plain((rows, n), p, key, h.device)
        d = torch.where(keep, (d * D.scale_of(p, mode)).to(h.dtype).float(),
                        torch.zeros((), device=h.device))
    total = layer_norm_column_sums_split_plain(torch.stack([g * xh, g, d]),
                                               plan)
    return total[0], total[1], total[2]


def _ln_lib():
    """The library of ``csrc/layer_norm_bwd.cu``, its entry points'
    arguments set."""
    lib = library("layer_norm_bwd")
    if lib.ptt_error_string.restype is not ctypes.c_char_p:
        lib.ptt_layer_norm_bwd.argtypes = [ctypes.c_void_p] * 8 \
            + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_uint,
                                    ctypes.c_int, ctypes.c_float,
                                    ctypes.c_int, ctypes.c_void_p]
        lib.ptt_layer_norm_bwd.restype = ctypes.c_int
        lib.ptt_dropout_keep_mask.argtypes = [
            ctypes.c_void_p, ctypes.c_uint, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.ptt_dropout_keep_mask.restype = ctypes.c_int
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
    return lib


def _ln_check(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.ptt_error_string(err).decode())


def keep_mask_cuda(count, p, key, start=0):
    """The keep mask (bool [count]) of elements ``start`` .. ``start +
    count - 1`` (start % 4 == 0) of a mask drawn under ``key`` (a
    ``RandomKey`` whose base is a CUDA tensor) at rate p, by the CUDA
    LayerNorm backward's Philox, a Philox block a thread as the kernel's
    rows. It reaches starts past 2^34 elements, where Philox's second
    counter word is not 0, which no LayerNorm call in a test can; the
    card's tests hold it against ``dropout.keep_mask_plain``."""
    base, site = key
    kt = D.key_tensor(base, base.device)
    out = torch.empty(count, dtype=torch.uint8, device=kt.device)
    lib = _ln_lib()
    _ln_check(lib, lib.ptt_dropout_keep_mask(
        kt.data_ptr(), int(site) & D.M32, D.threshold(p), int(start), count,
        out.data_ptr(), torch.cuda.current_stream(kt.device).cuda_stream),
        "keep mask")
    return out.bool()


def _ln_aligned(*tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _warp_backward(h, weight, dy, dh, dx, sums, eps, p, key, mode, plan):
    """The CUDA kernel and its column sum on contiguous CUDA tensors."""
    n = h.shape[-1]
    kt, site, thresh, scale, _ = _dln_args(h, p, key, mode)
    part = torch.empty(plan.blocks, 3 * n, dtype=torch.float32,
                       device=h.device)
    lib = _ln_lib()
    _ln_check(lib, lib.ptt_layer_norm_bwd(
        h.data_ptr(), weight.data_ptr(), dy.data_ptr(), dh.data_ptr(),
        dx.data_ptr(), part.data_ptr(), sums.data_ptr(), kt.data_ptr(),
        h.numel() // n, n, plan.blocks, plan.smem, _LN_CODES[h.dtype],
        _LN_CODES[weight.dtype], float(eps), site, thresh, scale,
        int(p > 0.0), torch.cuda.current_stream(h.device).cuda_stream),
        "layer_norm backward kernel")


def _triton_backward(h, weight, dy, dh, dx, sums, eps, p, key, mode, plan):
    """The Triton kernel and the column sum on ``_triton_plan``'s grid
    (also called alone: the smoke and the card's tests hold the CUDA
    kernel against it)."""
    triton, k = _jit()
    n = h.shape[-1]
    part = torch.empty(plan.blocks, 3 * n, dtype=torch.float32,
                       device=h.device)
    kt, site, thresh, scale, aligned = _dln_args(h, p, key, mode)
    bg = plan.chunks
    k["dln_bwd"][(plan.blocks,)](
        h, weight, dy, dh, dx, part, kt, h.numel() // n, n, plan.rows, site,
        thresh, scale, eps, HAS_DROP=p > 0.0, ALIGNED=aligned, BLOCK_G=bg,
        num_warps=min(max(4 * bg // 256, 1), 16))
    k["col_sum"][(triton.cdiv(3 * n, 64),)](part, sums, plan.blocks, 3 * n,
                                            BLOCK_P=64, BLOCK_C=64,
                                            num_warps=4)


def dropout_add_layer_norm_backward(h, weight, dy, eps=1e-5, p=0.0, key=None,
                                    mode="upscale_in_train"):
    """(dx, dh, dweight, dnorm_bias, dbias) of ``LayerNorm(residual +
    dropout(x + bias))`` on CUDA tensors, from the norm's input h: dh (the
    residual's gradient) rounded to h's dtype, dx = dh through the mask
    drawn again (dh itself without dropout), and the three parameter
    gradients in fp32, each a sum over the rows of per-block partials
    added in a fixed order (no atomics: the same bits every run). The
    route is ``layer_norm_backward_plan``'s; tensors not 16-byte aligned
    take the Triton kernel. ``LAUNCHES["dropout_add_ln_bwd"]`` counts
    every call, ``["dropout_add_ln_bwd_warp"]`` those of the CUDA
    kernel."""
    dy = dy.contiguous()
    _on_cuda("dropout_add_layer_norm_backward", h, weight, dy)
    n = h.shape[-1]
    if dy.shape != h.shape or dy.dtype != h.dtype:
        raise ValueError(f"dropout_add_layer_norm_backward: dy {dy.dtype} "
                         f"{tuple(dy.shape)} against h {h.dtype} "
                         f"{tuple(h.shape)}")
    rows = h.numel() // n if n else 0
    sms = sm_count(h.device)
    plan = layer_norm_backward_plan(rows, n, h.dtype, sms)
    dh = torch.empty_like(h)
    dx = torch.empty_like(h) if p > 0.0 else dh
    sums = torch.empty(3 * n, dtype=torch.float32, device=h.device)
    if plan.route == "warp" and _ln_aligned(h, dy):
        _warp_backward(h, weight, dy, dh, dx, sums, eps, p, key, mode, plan)
        LAUNCHES["dropout_add_ln_bwd_warp"] += 1
    else:
        _triton_backward(h, weight, dy, dh, dx, sums, eps, p, key, mode,
                         _triton_plan(rows, n, sms))
    LAUNCHES["dropout_add_ln_bwd"] += 1
    return dx, dh, sums[:n], sums[n:2 * n], sums[2 * n:]


class DropoutAddLayerNormFunction(torch.autograd.Function):
    """``LayerNorm(residual + dropout(x + bias))`` through the two kernels:
    it keeps the norm's input h (x itself when nothing is added or
    dropped) and the weight; the mask is drawn again in the backward."""

    @staticmethod
    def forward(ctx, x, weight, norm_bias, eps, residual, bias, p, key, mode):
        n = x.shape[-1]
        w = weight if weight is not None else torch.ones(
            n, dtype=torch.float32, device=x.device)
        nb = norm_bias if norm_bias is not None else torch.zeros(
            n, dtype=torch.float32, device=x.device)
        y, h = dropout_add_layer_norm_forward(x, w, nb, eps, residual, bias,
                                              p, key, mode)
        ctx.save_for_backward(h, w)
        ctx.args = (eps, p, key, mode)
        ctx.dtypes = tuple(None if t is None else t.dtype
                           for t in (weight, norm_bias, residual, bias))
        return y

    @staticmethod
    def backward(ctx, dy):
        h, w = ctx.saved_tensors
        eps, p, key, mode = ctx.args
        dx, dh, dw, dnb, db = dropout_add_layer_norm_backward(
            h, w, dy, eps, p, key, mode)
        tw, tnb, tres, tb = ctx.dtypes
        return (dx, None if tw is None else dw.to(tw), None if tnb is None
                else dnb.to(tnb), None, None if tres is None else dh,
                None if tb is None else db.to(tb), None, None, None)


def dropout_add_layer_norm(x, weight=None, norm_bias=None, eps=1e-5,
                           residual=None, bias=None, p=0.0, key=None,
                           mode="upscale_in_train"):
    """``LayerNorm(residual + dropout(x + bias))`` over the last axis in
    x's dtype, differentiable (``p = 0`` and no residual or bias: plain
    LayerNorm): on CUDA tensors one Triton kernel forward and one backward
    (with the column sums), the mask drawn under ``key`` (a
    ``RandomKey``) as ``kernels.dropout`` draws it; on CPU tensors
    ``dropout_add_layer_norm_plain``."""
    if x.device.type == "cpu":
        return dropout_add_layer_norm_plain(x, weight, norm_bias, eps,
                                            residual, bias, p, key, mode)
    if p > 0.0:
        D.scale_of(p, mode)
    return DropoutAddLayerNormFunction.apply(
        x.contiguous(), weight, norm_bias, float(eps), residual, bias,
        float(p), key, mode)


__all__ = ["rms_norm", "add_rms_norm", "fused_rope", "rms_norm_plain",
           "add_rms_norm_plain", "fused_rope_plain", "RMSNormFunction",
           "RopeFunction", "rms_norm_op", "add_rms_norm_op", "rope_op",
           "rms_norm_backward", "rms_norm_backward_plain", "swiglu",
           "swiglu_plain", "swiglu_backward_plain", "SwiGLUFunction",
           "swiglu_op", "swiglu_backward", "layer_norm_plain",
           "dropout_add_plain", "dropout_add_layer_norm_plain",
           "dropout_add_layer_norm", "dropout_add_layer_norm_forward",
           "dropout_add_layer_norm_backward", "DropoutAddLayerNormFunction",
           "layer_norm_backward_plan", "LnBwdPlan", "keep_mask_cuda",
           "layer_norm_backward_split_plain",
           "layer_norm_column_sums_split_plain", "xor_tree_plain"]
