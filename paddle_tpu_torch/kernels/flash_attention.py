"""Flash attention, forward and backward, dense and with FlashMask
bounds: the CUDA kernels, their plain PyTorch versions and the autograd
functions around them.

Replaces ``paddle_tpu/kernels/flash_pallas.py``: ``_flash_forward``
(``_fa_kernel``) -> ``flash_forward``, ``_flash_backward`` (``_fa_dq_kernel``
and ``_fa_dkv_kernel``) -> ``flash_backward``, each also with ``bounds``
and ``window`` (``flashmask_attention``, ``_fm_fwd``, ``_fm_bwd``; the
autograd function is ``FlashAttention`` for both);
``_flashmask_visible`` -> ``flashmask_visible``.
``flash_attention_bshd`` is the counterpart of
``paddle_tpu/kernels/flash_attention.py``'s wrapper of the same name. The
bf16 kernels (``csrc/flash_attention_bf16.cu``: TMA, a producer warp and
wgmma) are bound by operations on the H100 at training shapes, and their
source note says how they meet it; float32 inputs take the kernels of
``csrc/flash_attention.cu``, which also holds the bounds' pre-pass.

The function: ``q [b, h, sq, d]``, ``k, v [b, h, sk, d]`` in float32 or
bfloat16; ``causal`` is bottom-right aligned (query i sees keys
``<= i + sk - sq``); ``scale`` defaults to ``1/sqrt(d)``. The forward
returns ``out`` (q's dtype) and ``lse [b, h, sq]`` in fp32. Rounding
follows the JAX kernels: scores and sums in fp32, P cast to v's dtype
before P.V; in the backward ds cast to k's dtype for dq, p to dO's dtype
for dv and ds to q's dtype for dk; ``delta = rowsum(dO * O)`` in fp32,
by the dq kernel (which the dk/dv kernel follows). The JAX kernel keeps
lse broadcast over 8 lanes, a TPU tiling layout; here it is ``[b, h,
sq]``.

FlashMask: ``bounds [b, hb, sk, 4]`` int32 canonical ``(LTS, LTE, UTS,
UTE)`` column bounds with ``hb`` in ``{1, h}``, ``window = (wl, wr)``
(either None) or None, and only with bounds; see ``flashmask_visible``. The
bounds' tile summary (``flashmask_summary``) can be made once and passed
to every call that shares the bounds. The dense kernels never
meet a row that sees no key (causal needs ``sq <= sk``); with bounds or a
window such a row can occur, and it gets ``lse = -1e30`` and an output of
0 (the JAX kernel gives the mean of v over the tiles it did not skip, its
dense path the mean over all keys).

The kernels take head_dim 64 and 128 and any sequence length (a ragged
last tile is masked); the wrapper raises on anything else, on ``sq > sk``
under ``causal`` (leading rows would see no key) and, with bounds, on
``sq != sk``. ``flash_takes`` says which mask-free calls they take, as
the JAX package's ``is_available`` gates its kernel:
``nn.functional.scaled_dot_product_attention`` sends the others to its
plain path, on either device, and ``nn.functional.flashmask_attention``
sends the FlashMask calls they do not take to ``flashmask_attention_plain``.

The forward and the pre-pass are ``torch.library`` ops
(``ptt::flash_fwd``, ``ptt::flashmask_summary``): the plain version on CPU
tensors, the kernel (launched and counted) on CUDA tensors, so a
``jit.save`` program holds them. The backward launches directly.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import LAUNCHES
from ._build import library

NEG_INF = -1e30
NO_WINDOW = 1 << 30     # the kernels' window when there is none: |i - j| < 2^30
TILE = 128              # the bf16 kernels' key tile: the bounds summary's
KIND_TILE = {torch.float32: 64, torch.bfloat16: 128}   # tiles of ``tile_kinds``
HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _scale(d, scale):
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


def _visible(sq, sk, causal, device):
    """[sq, sk] bool: which keys each query row sees."""
    if not causal:
        return torch.ones(sq, sk, dtype=torch.bool, device=device)
    return torch.ones(sq, sk, dtype=torch.bool, device=device).tril(sk - sq)


def flashmask_visible(bounds, sq, sk, causal, window=None):
    """[b, hb, sq, sk] bool from canonical bounds [b, hb, sk, 4] (LTS, LTE,
    UTS, UTE): query i is masked from key j where i > j and LTS[j] <= i <
    LTE[j]; where i < j under causal (top-left: the diagonal stays), or
    i < j and UTS[j] <= i < UTE[j] otherwise; where i > j + wl; and, not
    causal, where i < j - wr (``window = (wl, wr)``, either None)."""
    i = torch.arange(sq, device=bounds.device)[:, None]
    j = torch.arange(sk, device=bounds.device)[None, :]
    col = bounds[..., None, :, :]                         # [b, hb, 1, sk, 4]
    masked = (i > j) & (i >= col[..., 0]) & (i < col[..., 1])
    if causal:
        masked = masked | (i < j)
    else:
        masked = masked | ((i < j) & (i >= col[..., 2]) & (i < col[..., 3]))
    if window is not None:
        wl, wr = window
        if wl is not None:
            masked = masked | (i > j + wl)
        if not causal and wr is not None:
            masked = masked | (i < j - wr)
    return ~masked


# -- plain versions -------------------------------------------------------------

def _forward_plain(q, k, v, vis, scale):
    """(out, lse) of softmax(q k^T * scale) v over the visible keys, in fp32
    with the kernel's roundings: P = exp(s - max) cast to v's dtype before
    P.V, the sum of the fp32 P as the normaliser; a masked entry's P is 0,
    so a row that sees no key gets lse -1e30 and an output of 0."""
    s_ = _scale(q.shape[-1], scale)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * s_
    s = s.masked_fill(~vis, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~vis, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / l_safe
    lse = torch.where(l == 0, torch.full_like(l, NEG_INF), m + torch.log(l_safe))
    return out.to(q.dtype), lse[..., 0]


def _backward_plain(q, k, v, out, lse, dout, vis, scale):
    """(dq, dk, dv) of ``_forward_plain`` from the saved out and lse, as the
    FA2 split computes them: p = exp(s - lse), delta = rowsum(dO * O),
    ds = p * (dO v^T - delta) * scale."""
    s_ = _scale(q.shape[-1], scale)
    delta = (dout.float() * out.float()).sum(dim=-1, keepdim=True)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * s_
    p = torch.exp(s - lse.float()[..., None]).masked_fill(~vis, 0.0)
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta) * s_
    dq = torch.matmul(ds.to(k.dtype).float(), k.float())
    dv = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2), dout.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _visible_of(q, k, causal, bounds, window):
    if bounds is None:
        return _visible(q.shape[2], k.shape[2], causal, q.device)
    return flashmask_visible(bounds, q.shape[2], k.shape[2], causal, window)


def flash_forward_plain(q, k, v, causal=False, scale=None, bounds=None,
                        window=None):
    """(out, lse) of ``_forward_plain``: without bounds, causal
    (bottom-right) or no masking; with bounds, over
    ``flashmask_visible(bounds, ...)`` (any sq, sk; causal is top-left, as
    the JAX dense path has it)."""
    _check_mask(q, k, bounds, window)
    return _forward_plain(q, k, v, _visible_of(q, k, causal, bounds, window),
                          scale)


def flash_backward_plain(q, k, v, out, lse, dout, causal=False, scale=None,
                         bounds=None, window=None):
    """(dq, dk, dv) of ``flash_forward_plain`` from its out and lse."""
    _check_mask(q, k, bounds, window)
    return _backward_plain(q, k, v, out, lse, dout,
                           _visible_of(q, k, causal, bounds, window), scale)


def flashmask_summary_plain(bounds):
    """[b, hb, nk, 8] int32: per key tile of TILE columns, (min LTS, max LTS,
    min LTE, max LTE, min UTS, max UTS, min UTE, max UTE)."""
    b, hb, sk, _ = bounds.shape
    nk = -(-sk // TILE)
    pad = nk * TILE - sk
    lo = torch.nn.functional.pad(bounds, (0, 0, 0, pad),
                                 value=torch.iinfo(torch.int32).max)
    hi = torch.nn.functional.pad(bounds, (0, 0, 0, pad),
                                 value=torch.iinfo(torch.int32).min)
    lo = lo.reshape(b, hb, nk, TILE, 4).amin(dim=3)
    hi = hi.reshape(b, hb, nk, TILE, 4).amax(dim=3)
    return torch.stack([lo, hi], dim=-1).reshape(b, hb, nk, 8) \
        .to(torch.int32)


# -- kernels --------------------------------------------------------------------

def _lib(dtype=torch.float32):
    """The float32 kernels' library (and the pre-pass's) or, for bf16, the
    Hopper kernels'; both export the same entry points."""
    lib = library("flash_attention_bf16" if dtype == torch.bfloat16
                  else "flash_attention")
    if lib.ptt_flash_fwd.argtypes is None:
        ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # bh, sq, sk, d, dtype, causal, scale, h, hb, wl, wr, stream
        tail = [i] * 6 + [f] + [i] * 4 + [ptr]
        lib.ptt_flash_fwd.argtypes = [ptr] * 8 + tail
        lib.ptt_flash_bwd_dq.argtypes = [ptr] * 10 + tail
        lib.ptt_flash_bwd_dkv.argtypes = [ptr] * 10 + tail
        for fn in (lib.ptt_flash_fwd, lib.ptt_flash_bwd_dq,
                   lib.ptt_flash_bwd_dkv):
            fn.restype = ctypes.c_int
        if hasattr(lib, "ptt_flashmask_summary"):
            lib.ptt_flashmask_summary.argtypes = [ptr, ptr, i, i, ptr]
            lib.ptt_flashmask_summary.restype = ctypes.c_int
        lib.ptt_error_string.argtypes = [i]
        lib.ptt_error_string.restype = ctypes.c_char_p
    return lib


def flash_takes(q, k, causal=False, v=None):
    """Whether the flash kernels take a mask-free call on ``[batch, seq,
    heads, head_dim]`` inputs (the functional's layout): head_dim in
    ``HEAD_DIMS``, float32 or bfloat16 throughout, shapes that fit, and not
    causal with q_len > kv_len. The counterpart of the JAX package's
    ``kernels/flash_attention.py:is_available`` less its TPU tiling
    conditions (sequence lengths multiples of 128): these kernels take
    any length. The device plays no part."""
    if q.dim() != 4 or k.dim() != 4 or (v is not None and v.shape != k.shape):
        return False
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or (v is not None and v.dtype != q.dtype):
        return False
    b, sq, h, d = q.shape
    if d not in HEAD_DIMS or k.shape[0] != b or k.shape[2:] != (h, d):
        return False
    return not (causal and sq > k.shape[1])


def _check(q, k, v, causal):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {q.dtype}")
        if x.dim() != 4:
            raise ValueError(f"{name} must be [b, h, s, d], got "
                             f"{tuple(x.shape)}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit")
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS}, got {d}")
    _check_causal(q, k, causal)


def _check_causal(q, k, causal):
    if causal and q.shape[2] > k.shape[2]:
        raise ValueError(f"causal flash attention needs q_len <= kv_len "
                         f"(got {q.shape[2]} > {k.shape[2]}): leading rows "
                         f"would see no key")


def _check_mask(q, k, bounds, window):
    if bounds is None:
        if window is not None:
            raise ValueError("a window needs bounds (empty bands for a "
                             "window alone)")
        return
    b, h = q.shape[:2]
    if bounds.dim() != 4 or bounds.shape[0] != b \
            or bounds.shape[1] not in (1, h) \
            or bounds.shape[2] != k.shape[2] or bounds.shape[3] != 4:
        raise ValueError(f"bounds must be [{b}, 1 or {h}, {k.shape[2]}, 4], "
                         f"got {tuple(bounds.shape)}")


def _on_cuda(q, k, v, causal, bounds=None, window=None):
    """False for CPU tensors (plain version); True for CUDA tensors the
    kernels take; raises on anything else. With bounds the kernels take
    sq == sk and int32 bounds on q's device."""
    _check_mask(q, k, bounds, window)
    if q.device.type == "cpu":
        _check_causal(q, k, causal)
        return False
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    _check(q, k, v, causal)
    if bounds is not None:
        if q.shape[2] != k.shape[2]:
            raise NotImplementedError(
                f"the FlashMask kernels take q_len == kv_len, got "
                f"{q.shape[2]} and {k.shape[2]} (the JAX kernel is gated "
                f"the same way)")
        if bounds.device != q.device:
            raise ValueError(f"bounds are on {bounds.device}, q on "
                             f"{q.device}")
        if bounds.dtype != torch.int32:
            raise TypeError(f"bounds must be int32, got {bounds.dtype}")
    return True


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.ptt_error_string(err).decode())


def _window_args(window, causal):
    """(wl, wr) as the kernels take them: NO_WINDOW for None (and for wr
    under causal, which ignores it), others clamped to +-NO_WINDOW."""
    wl, wr = (None, None) if window is None else window

    def clamp(w):
        return NO_WINDOW if w is None else max(-NO_WINDOW,
                                               min(NO_WINDOW, int(w)))
    return clamp(wl), NO_WINDOW if causal else clamp(wr)


def _aligned(bounds):
    """Contiguous bounds whose 16-byte columns are 16-byte aligned, as the
    kernels' vector loads need."""
    bounds = bounds.contiguous()
    return bounds if bounds.data_ptr() % 16 == 0 else bounds.clone()


def _ptr(x):
    return None if x is None else x.data_ptr()


def _mask_of(bounds, summary):
    """(bounds, summary) as the kernels read them: (None, None) for the
    dense kernels; the summary launched here unless given."""
    if bounds is None:
        return None, None
    bounds = _aligned(bounds)
    if summary is None:
        return bounds, flashmask_summary(bounds)
    b, hb, sk, _ = bounds.shape
    want = (b, hb, -(-sk // TILE), 8)
    if tuple(summary.shape) != want or summary.dtype != torch.int32 \
            or summary.device != bounds.device:
        raise ValueError(f"summary must be int32 {want} on {bounds.device}, "
                         f"got {summary.dtype} {tuple(summary.shape)} on "
                         f"{summary.device}")
    return bounds, _aligned(summary)


def _geometry(q, k, causal, scale, bounds, window):
    b, h, sq, d = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return (b * h, sq, k.shape[2], d, _DTYPE_CODE[q.dtype], int(bool(causal)),
            _scale(d, scale), h, 0 if bounds is None else bounds.shape[1],
            *_window_args(window, causal), stream)


def _summary_check(bounds):
    if bounds.dtype != torch.int32 or bounds.dim() != 4 \
            or bounds.shape[3] != 4:
        raise ValueError(f"bounds must be int32 [b, hb, sk, 4], got "
                         f"{bounds.dtype} {tuple(bounds.shape)}")


@torch.library.custom_op("ptt::flashmask_summary", mutates_args=(),
                         device_types="cpu")
def flashmask_summary_op(bounds: torch.Tensor) -> torch.Tensor:
    """The bounds' tile summary: the pre-pass kernel on CUDA tensors."""
    _summary_check(bounds)
    return flashmask_summary_plain(bounds)


@flashmask_summary_op.register_kernel("cuda")
def _flashmask_summary_cuda(bounds):
    _summary_check(bounds)
    bounds = _aligned(bounds)
    b, hb, sk, _ = bounds.shape
    summary = torch.empty(b, hb, -(-sk // TILE), 8, dtype=torch.int32,
                          device=bounds.device)
    lib = _lib()
    err = lib.ptt_flashmask_summary(
        bounds.data_ptr(), summary.data_ptr(), b * hb, sk,
        torch.cuda.current_stream(bounds.device).cuda_stream)
    _raise_on(lib, err, "flashmask summary")
    LAUNCHES["flashmask_summary"] += 1
    return summary


@flashmask_summary_op.register_fake
def _flashmask_summary_fake(bounds):
    b, hb, sk, _ = bounds.shape
    return bounds.new_empty((b, hb, -(-sk // TILE), 8))


def flashmask_summary(bounds):
    """The kernels' tile summary of CUDA int32 bounds [b, hb, sk, 4]: the
    pre-pass kernel (``flashmask_summary_plain``'s function), through
    ``flashmask_summary_op``."""
    if bounds.device.type != "cuda":
        raise ValueError(f"flashmask_summary launches a kernel: bounds are "
                         f"on {bounds.device}")
    return flashmask_summary_op(bounds)


def _forward_launch(q, k, v, causal, scale, bounds, window, summary,
                    tile_kinds=None):
    """The forward kernel on CUDA tensors it takes (raises on others)."""
    _on_cuda(q, k, v, causal, bounds, window)
    if tile_kinds is not None:
        t = KIND_TILE[q.dtype]
        want = (q.shape[0] * q.shape[1], -(-q.shape[2] // t),
                -(-k.shape[2] // t))
        if bounds is None or tuple(tile_kinds.shape) != want \
                or tile_kinds.dtype != torch.int8 \
                or tile_kinds.device != q.device \
                or not tile_kinds.is_contiguous():
            raise ValueError(f"tile_kinds must be a contiguous int8 {want} "
                             f"on {q.device}, with bounds")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bounds, summary = _mask_of(bounds, summary)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    lib = _lib(q.dtype)
    name = "flash_fwd" if bounds is None else "flashmask_fwd"
    err = lib.ptt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), lse.data_ptr(), _ptr(bounds),
                            _ptr(summary), _ptr(tile_kinds),
                            *_geometry(q, k, causal, scale, bounds, window))
    _raise_on(lib, err, name)
    LAUNCHES[name] += 1
    return out, lse


def _window_of(windowed, wl, wr):
    return (wl, wr) if windowed else None


@torch.library.custom_op("ptt::flash_fwd", mutates_args=(),
                         device_types="cpu")
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, scale: Optional[float],
                 bounds: Optional[torch.Tensor],
                 summary: Optional[torch.Tensor], windowed: bool,
                 wl: Optional[int],
                 wr: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of flash attention over ``[b, h, s, d]``, dense or with
    FlashMask bounds and a window ``(wl, wr)`` (``windowed``): the forward
    kernel on CUDA tensors (raising on what it does not take), the plain
    version on CPU tensors."""
    out, lse = flash_forward_plain(q, k, v, causal, scale, bounds,
                                   _window_of(windowed, wl, wr))
    return out, lse.contiguous()


@flash_fwd_op.register_kernel("cuda")
def _flash_fwd_cuda(q, k, v, causal, scale, bounds, summary, windowed, wl,
                    wr):
    return _forward_launch(q, k, v, causal, scale, bounds,
                           _window_of(windowed, wl, wr), summary)


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, causal, scale, bounds, summary, windowed, wl,
                    wr):
    return (q.new_empty(q.shape),
            q.new_empty(q.shape[:3], dtype=torch.float32))


def flash_forward(q, k, v, causal=False, scale=None, bounds=None, window=None,
                  summary=None, tile_kinds=None):
    """(out, lse), through ``flash_fwd_op``: on CUDA tensors the forward
    kernel, dense or, with ``bounds`` (and ``window``), masked (and the
    tile-summary pre-pass unless ``summary`` gives its result), raising on
    what they do not take; on CPU tensors the plain version.
    ``tile_kinds``, for checking the masked kernel (a direct launch, not
    the op): an int8 CUDA tensor [b * h, nq, nk] of the kernel's tiles
    (``KIND_TILE[q.dtype]`` rows and keys) where it writes each tile's
    kind, 0 skipped, 1 partial or 2 full, for every tile its loop ranges
    over."""
    on_cuda = _on_cuda(q, k, v, causal, bounds, window)
    if tile_kinds is not None:
        if not on_cuda:
            raise ValueError("tile_kinds is the CUDA kernel's")
        return _forward_launch(q, k, v, causal, scale, bounds, window,
                               summary, tile_kinds)
    wl, wr = (None, None) if window is None else window
    return flash_fwd_op(q, k, v, bool(causal),
                        None if scale is None else float(scale), bounds,
                        summary, window is not None,
                        None if wl is None else int(wl),
                        None if wr is None else int(wr))


def flash_backward(q, k, v, out, lse, dout, causal=False, scale=None,
                   bounds=None, window=None, summary=None):
    """(dq, dk, dv). On CUDA tensors this launches the dq kernel (sweeps
    the kv tiles of a q tile, and writes delta = rowsum(dO * O) for the
    next) and the dk/dv kernel (sweeps the q tiles of a kv tile), dense or
    masked as ``flash_forward``: no atomics, the same result on every run.
    On CPU tensors it runs the plain version."""
    if not _on_cuda(q, k, v, causal, bounds, window):
        return flash_backward_plain(q, k, v, out, lse, dout, causal, scale,
                                    bounds, window)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    dout = dout.to(q.dtype).contiguous()
    out = out.to(q.dtype).contiguous()
    lse = lse.contiguous()
    if lse.dtype != torch.float32 or lse.shape != q.shape[:3]:
        raise ValueError(f"lse must be float32 {tuple(q.shape[:3])}")
    if out.shape != q.shape:
        raise ValueError(f"out must be {tuple(q.shape)}, got "
                         f"{tuple(out.shape)}")
    bounds, summary = _mask_of(bounds, summary)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _lib(q.dtype)
    geo = _geometry(q, k, causal, scale, bounds, window)
    mask = (_ptr(bounds), _ptr(summary))
    pre = "flash" if bounds is None else "flashmask"
    err = lib.ptt_flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               dout.data_ptr(), out.data_ptr(),
                               lse.data_ptr(), delta.data_ptr(),
                               dq.data_ptr(), *mask, *geo)
    _raise_on(lib, err, f"{pre} backward (dq)")
    LAUNCHES[f"{pre}_bwd_dq"] += 1
    err = lib.ptt_flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                dout.data_ptr(), lse.data_ptr(),
                                delta.data_ptr(), dk.data_ptr(),
                                dv.data_ptr(), *mask, *geo)
    _raise_on(lib, err, f"{pre} backward (dk, dv)")
    LAUNCHES[f"{pre}_bwd_dkv"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """(out, lse) = flash_forward(q, k, v, ...); the backward runs
    flash_backward from the saved q, k, v, out and lse (and the bounds and
    their summary: one pre-pass serves both, unless ``summary`` is given);
    no [sq, sk] matrix is kept. lse is not differentiable; the bounds get
    no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, bounds=None, window=None,
                summary=None):
        if bounds is not None and summary is None and q.is_cuda:
            summary = flashmask_summary(bounds)
        out, lse = flash_forward(q, k, v, causal, scale, bounds, window,
                                 summary=summary)
        ctx.save_for_backward(q, k, v, out, lse, bounds, summary)
        ctx.causal, ctx.scale, ctx.window = causal, scale, window
        ctx.mark_non_differentiable(lse)
        ctx.set_materialize_grads(False)    # no zero-filled grad for lse
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse, bounds, summary = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout, ctx.causal,
                                    ctx.scale, bounds, ctx.window,
                                    summary=summary)
        return dq, dk, dv, None, None, None, None, None


class _PlainFlashAttention(torch.autograd.Function):
    """(out, lse) = flash_forward_plain(...); the backward is
    flash_backward_plain from the saved out and lse: the kernels'
    function and roundings, on any device, for the calls the kernels do
    not take."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, bounds, window):
        out, lse = flash_forward_plain(q, k, v, causal, scale, bounds, window)
        ctx.save_for_backward(q, k, v, out, lse, bounds)
        ctx.causal, ctx.scale, ctx.window = causal, scale, window
        ctx.mark_non_differentiable(lse)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse, bounds = ctx.saved_tensors
        dq, dk, dv = flash_backward_plain(q, k, v, out, lse, dout,
                                          ctx.causal, ctx.scale, bounds,
                                          ctx.window)
        return dq, dk, dv, None, None, None, None


def flashmask_attention_plain(q, k, v, bounds, causal=False, scale=None,
                              window=None):
    """``flashmask_attention``'s function through the plain versions on
    any device and at any (sq, sk), causal top-left as the JAX dense path
    has it: (out, lse), differentiable in q, k and v."""
    return _PlainFlashAttention.apply(q, k, v, bool(causal), scale, bounds,
                                      None if window is None
                                      else tuple(window))


def flash_attention(q, k, v, causal=False, scale=None):
    """Attention over ``[b, h, s, d]`` inputs, differentiable."""
    return FlashAttention.apply(q, k, v, bool(causal), scale)[0]


def flash_attention_bshd(q, k, v, causal=False, scale=None):
    """``[batch, seq, heads, dim]`` layout around ``flash_attention``."""
    out = flash_attention(q.transpose(1, 2).contiguous(),
                          k.transpose(1, 2).contiguous(),
                          v.transpose(1, 2).contiguous(), causal, scale)
    return out.transpose(1, 2)


def flashmask_attention(q, k, v, bounds, causal=False, scale=None,
                        window=None, summary=None):
    """FlashMask attention over ``[b, h, s, d]`` inputs and canonical bounds
    ``[b, hb, sk, 4]``, differentiable in q, k and v: (out, lse)."""
    return FlashAttention.apply(q, k, v, bool(causal), scale, bounds,
                                None if window is None else tuple(window),
                                summary)


__all__ = ["flash_attention", "flash_attention_bshd", "flash_takes",
           "flash_forward", "flash_backward", "flash_forward_plain",
           "flash_backward_plain",
           "FlashAttention", "flashmask_visible", "flashmask_summary",
           "flashmask_summary_plain", "flashmask_attention",
           "flashmask_attention_plain", "flash_fwd_op",
           "flashmask_summary_op"]
