"""The dense attention's middle: the scale, the masks, the fp32 softmax and
the probabilities' dropout, forward and backward, as Triton kernels (and a
CUDA forward at short rows), and their plain PyTorch version.

No TPU kernel: the JAX package's ``_sdpa_reference``
(``paddle_tpu/nn/functional/attention.py:20-43``) scales the fp32 scores,
masks them (bottom-right causal and a bool mask as -1e30, an additive mask
added), takes ``jax.nn.softmax`` and drops the probabilities, and XLA fuses
those passes into its compiled step around the two products. Every
attention with a mask or a dropout takes that path (every Transformer layer
built with a dropout, training or not; ERNIE; ``flash_attn_unpadded``), and
so do shapes the flash kernels do not take (the UNet's head_dims). Run op by
op, the middle is four or more passes over the fp32 scores ``[b, h, sq,
sk]`` each way; here it is one.

What it computes, over each row of ``z = scores * scale``: ``z`` set to
-1e30 where causal (``j > i + sk - sq``) or the bool mask (False) hides it,
an additive mask added; ``probs = exp(z - max) / sum`` in fp32 (a row that
sees no key averages every value, as in the JAX function); with a dropout
``p`` the probabilities kept where ``kernels/dropout.py``'s mask under the
same ``(key, site)`` keeps element ``e`` of the contiguous ``[b, h, sq,
sk]`` (the same bits as ``D.dropout(probs, key, p)``), times the fp32
``1 / (1 - p)``. The backward takes g, the gradient of the dropped
probabilities, and writes ``ds = where(visible, p * (gp - sum(gp * p)),
0) * scale`` with ``gp = g * keep * (1 / (1 - p))``, the keep mask drawn
again (nothing of it is stored); where an additive mask needs a gradient it
also writes ``dz = p * (gp - sum(gp * p))``, which the wrapper sums to the
mask's shape.

Bound on the H100: bytes. A forward reads the scores once and writes the
probabilities (and the dropped ones); a backward reads g and the
probabilities and writes ds: 8 to 12 bytes an element, against about 30
flops and, with a dropout, a quarter of a Philox4x32-10 block (~25 integer
operations). The design:

* One program takes R whole rows as an ``[R, G, 4]`` tile (column 4g + j):
  R > 1 for short rows (64 at Transformer-base, 512 at ERNIE), so that a
  program moves ~8 KB. Each row of a tile of four is one Philox block when
  ``sk % 4 == 0``, so a block's four words serve four elements.
* A row of up to ``MAX_ONE`` keys is read once and kept in registers. A
  longer one (``flash_attn_unpadded``'s packed total) is walked in chunks
  of 4096 twice: an online max and sum, then the normalisation; its
  backward likewise (the row's ``sum(gp * p)``, then ds).
* The mask is read through its strides (0 on a broadcast dimension), so a
  ``[b, 1, 1, sk]`` padding mask or a ``[sq, sk]`` causal one is never
  materialised at ``[b, h, sq, sk]``.
* Sums in a fixed order; no atomics: two calls give the same bits, and a
  captured step replays the eager one's.
* ``dense_softmax_forward_plan`` sends the forward of rows of a multiple
  of 4 keys up to ``CUDA_MAX_KEYS`` (Transformer-base's 64, the UNet's
  self-attentions at 8 x 8 and 16 x 16) to
  ``csrc/dense_softmax.cu`` instead: a thread holds four keys and draws
  one Philox block for them (the Triton kernel draws a block for each
  element and keeps one word), a block walks all heads of its query rows
  and reads a mask broadcast over the heads once. Longer rows keep the
  Triton kernel; the backward is Triton at every length, and draws the
  CUDA kernel's mask bit for bit.

Triton is imported, and the kernels compiled, at the first launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import LAUNCHES
from . import dropout as D
from ._build import library

tl = None    # triton.language, bound by _jit() at the first launch
_mask_bits = None   # kernels/dropout.py's, bound by _jit()
_vis_tile = None    # the helpers below, wrapped by _jit()
_z_tile = None
_keep_tile = None

NEG = -1e30          # the masked score, as the JAX function's
MAX_ONE = 8192       # the longest row kept whole in registers
CHUNK = 4096         # a longer row's chunk
# the longest row the CUDA forward takes, and the longest its kernel holds:
# ``tools/norm_fwd_plans.py`` timed it faster than the Triton kernel in the
# same call up to 256 keys, and a build that held 1024 slower at ERNIE's
# 512 and the UNet's 1024 (PERF.md)
CUDA_MAX_KEYS = 256


def _vis_tile_tl(m_ptr, rows, col, n_rows, sq, h, sk, diag, smb, smh, smq,
                 smk, MASK: tl.constexpr, CAUSAL: tl.constexpr):
    """(in bounds, visible, the mask's offsets) of the rows ``[R, 1, 1]``
    at the columns ``col [1, G, 4]``: visible where causal and a bool mask
    (MASK 1) let the key through."""
    inb = (rows < n_rows) & (col < sk)
    qi = rows % sq
    moff = (rows // (h * sq)) * smb + ((rows // sq) % h) * smh + qi * smq \
        + col * smk
    vis = inb
    if CAUSAL:
        vis = vis & (col <= qi + diag)
    if MASK == 1:
        vis = vis & (tl.load(m_ptr + moff, mask=inb, other=0) != 0)
    return inb, vis, moff


def _z_tile_tl(s_ptr, m_ptr, rows, col, n_rows, sq, h, sk, diag, scale, smb,
               smh, smq, smk, MASK: tl.constexpr, CAUSAL: tl.constexpr):
    """(z, in bounds) of the rows at the columns: the scores times the
    scale, -1e30 where not visible, the additive mask (MASK 2) added; -inf
    outside the rows and columns."""
    inb, vis, moff = _vis_tile(m_ptr, rows, col, n_rows, sq, h, sk, diag,
                               smb, smh, smq, smk, MASK, CAUSAL)
    z = tl.load(s_ptr + rows * sk + col, mask=inb, other=0.0) * scale
    z = tl.where(vis, z, -1e30)
    if MASK == 2:
        z = z + tl.load(m_ptr + moff, mask=inb, other=0.0).to(tl.float32)
    return tl.where(inb, z, float("-inf")), inb


def _keep_tile_tl(rows, c0, g, j, sk, key_ptr, site, thresh,
                  ALIGNED: tl.constexpr):
    """The dropout's keep mask at the elements ``rows * sk + c0 + 4g + j``:
    ``kernels/dropout.py``'s words (one Philox block a group of four where
    the rows start blocks)."""
    if ALIGNED:
        bits = _mask_bits(rows * (sk // 4) + (c0 // 4) + g, j, key_ptr, site)
    else:
        off = rows * sk + c0 + g * 4 + j
        bits = _mask_bits(off >> 2, off & 3, key_ptr, site)
    return (bits >> 8).to(tl.int32) >= thresh


def _dense_softmax_fwd_kernel(s_ptr, m_ptr, p_ptr, d_ptr, key_ptr, n_rows,
                              sq, h, sk, diag, scale, smb, smh, smq, smk,
                              site, thresh, dscale, MASK: tl.constexpr,
                              CAUSAL: tl.constexpr, DROP: tl.constexpr,
                              ALIGNED: tl.constexpr, ONE: tl.constexpr,
                              R: tl.constexpr, G: tl.constexpr):
    """Program = R rows: probs (and the dropped probs) of each."""
    rows = (tl.program_id(0).to(tl.int64) * R + tl.arange(0, R))[:, None,
                                                                  None]
    g = tl.arange(0, G)[None, :, None]
    j = tl.arange(0, 4)[None, None, :]
    if ONE:
        col = g * 4 + j
        z, inb = _z_tile(s_ptr, m_ptr, rows, col, n_rows, sq, h, sk, diag,
                         scale, smb, smh, smq, smk, MASK, CAUSAL)
        mx = tl.max(tl.max(z, axis=2), axis=1)[:, None, None]
        e = tl.exp(z - mx)
        p = e / tl.sum(tl.sum(e, axis=2), axis=1)[:, None, None]
        off = rows * sk + col
        tl.store(p_ptr + off, p, mask=inb)
        if DROP:
            keep = _keep_tile(rows, 0, g, j, sk, key_ptr, site, thresh,
                              ALIGNED)
            tl.store(d_ptr + off, tl.where(keep, p * dscale, 0.0), mask=inb)
    else:
        mx = tl.full([R, 1, 1], float("-inf"), tl.float32)
        den = tl.zeros([R, 1, 1], tl.float32)
        for c0 in range(0, sk, 4 * G):
            col = c0 + g * 4 + j
            z, inb = _z_tile(s_ptr, m_ptr, rows, col, n_rows, sq, h, sk,
                             diag, scale, smb, smh, smq, smk, MASK, CAUSAL)
            mn = tl.maximum(mx, tl.max(tl.max(z, axis=2), axis=1)[:, None,
                                                                   None])
            ms = tl.where(mn == float("-inf"), 0.0, mn)
            den = den * tl.exp(mx - ms) \
                + tl.sum(tl.sum(tl.exp(z - ms), axis=2), axis=1)[:, None,
                                                                 None]
            mx = mn
        for c0 in range(0, sk, 4 * G):
            col = c0 + g * 4 + j
            z, inb = _z_tile(s_ptr, m_ptr, rows, col, n_rows, sq, h, sk,
                             diag, scale, smb, smh, smq, smk, MASK, CAUSAL)
            p = tl.exp(z - mx) / den
            off = rows * sk + col
            tl.store(p_ptr + off, p, mask=inb)
            if DROP:
                keep = _keep_tile(rows, c0, g, j, sk, key_ptr, site, thresh,
                                  ALIGNED)
                tl.store(d_ptr + off, tl.where(keep, p * dscale, 0.0),
                         mask=inb)


def _dense_softmax_bwd_kernel(g_ptr, p_ptr, m_ptr, ds_ptr, dz_ptr, key_ptr,
                              n_rows, sq, h, sk, diag, scale, smb, smh, smq,
                              smk, site, thresh, dscale, MASK: tl.constexpr,
                              CAUSAL: tl.constexpr, DROP: tl.constexpr,
                              ALIGNED: tl.constexpr, ONE: tl.constexpr,
                              WRITE_DZ: tl.constexpr, R: tl.constexpr,
                              G: tl.constexpr):
    """Program = R rows: ds (and dz) of each from g and probs."""
    rows = (tl.program_id(0).to(tl.int64) * R + tl.arange(0, R))[:, None,
                                                                  None]
    g = tl.arange(0, G)[None, :, None]
    j = tl.arange(0, 4)[None, None, :]
    if ONE:
        col = g * 4 + j
        inb = (rows < n_rows) & (col < sk)
        off = rows * sk + col
        gp = tl.load(g_ptr + off, mask=inb, other=0.0)
        p = tl.load(p_ptr + off, mask=inb, other=0.0)
        if DROP:
            keep = _keep_tile(rows, 0, g, j, sk, key_ptr, site, thresh,
                              ALIGNED)
            gp = tl.where(keep, gp * dscale, 0.0)
        dot = tl.sum(tl.sum(gp * p, axis=2), axis=1)[:, None, None]
        dz = p * (gp - dot)
        inb, vis, moff = _vis_tile(m_ptr, rows, col, n_rows, sq, h, sk, diag,
                                   smb, smh, smq, smk, MASK, CAUSAL)
        tl.store(ds_ptr + off, tl.where(vis, dz, 0.0) * scale, mask=inb)
        if WRITE_DZ:
            tl.store(dz_ptr + off, dz, mask=inb)
    else:
        dot = tl.zeros([R, 1, 1], tl.float32)
        for c0 in range(0, sk, 4 * G):
            col = c0 + g * 4 + j
            inb = (rows < n_rows) & (col < sk)
            off = rows * sk + col
            gp = tl.load(g_ptr + off, mask=inb, other=0.0)
            if DROP:
                keep = _keep_tile(rows, c0, g, j, sk, key_ptr, site, thresh,
                                  ALIGNED)
                gp = tl.where(keep, gp * dscale, 0.0)
            p = tl.load(p_ptr + off, mask=inb, other=0.0)
            dot += tl.sum(tl.sum(gp * p, axis=2), axis=1)[:, None, None]
        for c0 in range(0, sk, 4 * G):
            col = c0 + g * 4 + j
            off = rows * sk + col
            inb, vis, moff = _vis_tile(m_ptr, rows, col, n_rows, sq, h, sk,
                                       diag, smb, smh, smq, smk, MASK,
                                       CAUSAL)
            gp = tl.load(g_ptr + off, mask=inb, other=0.0)
            if DROP:
                keep = _keep_tile(rows, c0, g, j, sk, key_ptr, site, thresh,
                                  ALIGNED)
                gp = tl.where(keep, gp * dscale, 0.0)
            p = tl.load(p_ptr + off, mask=inb, other=0.0)
            dz = p * (gp - dot)
            tl.store(ds_ptr + off, tl.where(vis, dz, 0.0) * scale, mask=inb)
            if WRITE_DZ:
                tl.store(dz_ptr + off, dz, mask=inb)


@functools.lru_cache(maxsize=None)
def _jit():
    """Import Triton and wrap the kernels and their helpers (once); the
    kernels call the helpers by their module names, bound here."""
    global tl, _mask_bits, _vis_tile, _z_tile, _keep_tile
    import triton
    import triton.language
    tl = triton.language
    D._jit()
    _mask_bits = D._mask_bits
    _vis_tile = triton.jit(_vis_tile_tl)
    _z_tile = triton.jit(_z_tile_tl)
    _keep_tile = triton.jit(_keep_tile_tl)
    # sk and the mask's key stride stay specialised (16-byte loads where
    # sk is a multiple of 16; a stride of 1 a constant)
    skip = ["site", "thresh", "n_rows", "sq", "h", "diag", "smb", "smh",
            "smq"]
    return triton, {"fwd": triton.jit(_dense_softmax_fwd_kernel,
                                      do_not_specialize=skip),
                    "bwd": triton.jit(_dense_softmax_bwd_kernel,
                                      do_not_specialize=skip)}


# -- the plain version ------------------------------------------------------------

def dense_softmax_plain(scores, mask=None, causal=False, scale=1.0, p=0.0,
                        key=None):
    """(probs, dropped probs) of the fp32 ``scores [..., sq, sk]``, as the
    JAX ``_sdpa_reference``'s middle: ``scores * scale``, bottom-right
    causal and a bool ``mask`` (True = visible) as -1e30, an additive mask
    added, fp32 softmax over the keys, and at ``p > 0`` the dropout of
    ``kernels/dropout.py`` under ``key`` (its kernel on a CUDA tensor, its
    plain version on a CPU one; the dropped probs are the probs themselves
    without). ``mask`` broadcasts to the scores. Differentiable."""
    z = scores * scale
    if causal:
        sq, sk = z.shape[-2], z.shape[-1]
        vis = torch.ones(sq, sk, dtype=torch.bool, device=z.device)
        z = z.masked_fill(~vis.tril(sk - sq), NEG)
    if mask is not None:
        mask = mask.to(z.device)
        if mask.dtype == torch.bool:
            z = z.masked_fill(~mask, NEG)
        else:
            z = z + mask.float()
    probs = torch.softmax(z, dim=-1)
    if p > 0.0 and key is not None:
        return probs, D.dropout(probs, key, p)
    return probs, probs


# -- the kernels ----------------------------------------------------------------------

def plan(sk):
    """(R rows, G groups of four, ONE) of a row of ``sk`` keys: a row of up
    to ``MAX_ONE`` whole (R rows a program, ~2048 elements), a longer one
    in chunks of ``CHUNK``."""
    n = 4
    while n < sk:
        n *= 2
    if n > MAX_ONE:
        return 1, CHUNK // 4, False
    return max(1, min(64, 2048 // n)), n // 4, True


def _warps(r, g):
    return min(16, max(4, r * g * 4 // 256))


def dense_softmax_forward_plan(sk):
    """The forward's route for rows of ``sk`` keys of fp32 scores (the only
    scores ``_check`` lets through): "cuda" (``csrc/dense_softmax.cu``) for
    a multiple of 4 keys up to ``CUDA_MAX_KEYS`` (a thread's four keys one
    float4 and one Philox block), else "triton" (``plan(sk)``'s
    program)."""
    if sk % 4 == 0 and 0 < sk <= CUDA_MAX_KEYS:
        return "cuda"
    return "triton"


_MASK_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.uint8: 3}


def _cuda_lib():
    """The library of ``csrc/dense_softmax.cu``, its entry point's
    arguments set."""
    lib = library("dense_softmax")
    if lib.ptt_error_string.restype is not ctypes.c_char_p:
        lib.ptt_dense_softmax_fwd.argtypes = [ctypes.c_void_p] * 5 \
            + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 2 \
            + [ctypes.c_longlong] * 4 + [ctypes.c_uint, ctypes.c_int,
                                         ctypes.c_float, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p]
        lib.ptt_dense_softmax_fwd.restype = ctypes.c_int
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
    return lib


def _cuda_forward(scores, kind, m, ms, causal, scale, kt, site, thresh,
                  dscale, drop, probs, dropped):
    """The CUDA forward on contiguous, 16-byte aligned fp32 scores (also
    called alone: the smoke and the card's tests hold it beside the Triton
    kernel)."""
    b, h, sq, sk = scores.shape
    lib = _cuda_lib()
    err = lib.ptt_dense_softmax_fwd(
        scores.data_ptr(), m.data_ptr() if m is not None else 0,
        probs.data_ptr(), dropped.data_ptr(),
        kt.data_ptr() if kt is not None else 0, b, h, sq, sk, float(scale),
        kind, _MASK_CODES[m.dtype] if m is not None else 0, *ms, site,
        thresh, dscale, int(bool(causal)), int(drop),
        torch.cuda.current_stream(scores.device).cuda_stream)
    if err != 0:
        raise RuntimeError("dense_softmax CUDA kernel launch failed: "
                           + lib.ptt_error_string(err).decode())


def _triton_forward(scores, kind, m, ms, causal, scale, kt, site, thresh,
                    dscale, drop, probs, dropped):
    """The Triton forward (``plan(sk)``'s program) on contiguous fp32
    scores."""
    b, h, sq, sk = scores.shape
    triton, k = _jit()
    n_rows = b * h * sq
    r, g, one = plan(sk)
    k["fwd"][(triton.cdiv(n_rows, r),)](
        scores, m if m is not None else scores, probs, dropped,
        kt if kt is not None else scores, n_rows, sq, h, sk, sk - sq,
        float(scale), *ms, site, thresh, dscale, MASK=kind,
        CAUSAL=bool(causal), DROP=drop, ALIGNED=sk % 4 == 0, ONE=one,
        R=r, G=g, num_warps=_warps(r, g))


def _mask_args(mask, shape, device):
    """(kind, tensor, strides) of a mask broadcast to ``shape``: kind 0
    none, 1 bool (read as bytes), 2 additive (fp32, bf16 or fp16, else
    cast to fp32)."""
    if mask is None:
        return 0, None, (0, 0, 0, 0)
    mask = mask.to(device)
    if mask.dtype == torch.bool:
        m = mask.expand(shape).view(torch.uint8)
        return 1, m, m.stride()
    if mask.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        mask = mask.float()
    m = mask.expand(shape)
    return 2, m, m.stride()


def _check(name, scores):
    if scores.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {scores.device}")
    if scores.dtype != torch.float32 or scores.dim() != 4:
        raise ValueError(f"{name} takes fp32 scores [b, h, sq, sk], got "
                         f"{scores.dtype} {tuple(scores.shape)}")


def _drop_args(p, key, device):
    """(key tensor, site, threshold, the kept values' factor, drop)."""
    if p > 0.0 and key is not None:
        base, site = key
        return (D.key_tensor(base, device), int(site) & D.M32,
                D.threshold(p), D.scale_of(p, "upscale_in_train"), True)
    return None, 0, 0, 1.0, False


def dense_softmax_forward(scores, mask=None, causal=False, scale=1.0, p=0.0,
                          key=None):
    """(probs, dropped) of ``dense_softmax_plain`` by the forward kernel, on
    CUDA fp32 scores ``[b, h, sq, sk]`` (dropped is probs without a
    dropout). The route is ``dense_softmax_forward_plan``'s; scores not
    16-byte aligned take the Triton kernel. ``LAUNCHES["dense_softmax"]``
    counts every call, ``["dense_softmax_cuda"]`` those of the CUDA
    kernel."""
    _check("dense_softmax_forward", scores)
    scores = scores.contiguous()
    kind, m, ms = _mask_args(mask, scores.shape, scores.device)
    args = (kind, m, ms, causal, scale,
            *_drop_args(p, key, scores.device))
    probs = torch.empty_like(scores)
    dropped = torch.empty_like(scores) if args[-1] else probs
    if scores.numel():
        if dense_softmax_forward_plan(scores.shape[-1]) == "cuda" \
                and scores.data_ptr() % 16 == 0:
            _cuda_forward(scores, *args, probs, dropped)
            LAUNCHES["dense_softmax_cuda"] += 1
        else:
            _triton_forward(scores, *args, probs, dropped)
    LAUNCHES["dense_softmax"] += 1
    return probs, dropped


def dense_softmax_backward(g, probs, mask=None, causal=False, scale=1.0,
                           p=0.0, key=None, want_dz=False):
    """(ds, dz) of the backward kernel: ds the gradient of the raw scores
    from g (the dropped probs' gradient) and the forward's probs; dz (the
    softmax input's gradient, for an additive mask that needs one) where
    ``want_dz``, else None."""
    _check("dense_softmax_backward", probs)
    g = g.contiguous()
    if g.shape != probs.shape or g.dtype != torch.float32:
        raise ValueError(f"dense_softmax_backward: g {g.dtype} "
                         f"{tuple(g.shape)} against probs "
                         f"{tuple(probs.shape)}")
    b, h, sq, sk = probs.shape
    kind, m, ms = _mask_args(mask, probs.shape, probs.device)
    kt, site, thresh, dscale, drop = _drop_args(p, key, probs.device)
    triton, k = _jit()
    ds = torch.empty_like(probs)
    dz = torch.empty_like(probs) if want_dz else None
    n_rows = b * h * sq
    r, gg, one = plan(sk)
    if n_rows and sk:
        k["bwd"][(triton.cdiv(n_rows, r),)](
            g, probs, m if m is not None else probs, ds,
            dz if dz is not None else ds, kt if kt is not None else probs,
            n_rows, sq, h, sk, sk - sq, float(scale), *ms, site, thresh,
            dscale, MASK=kind, CAUSAL=bool(causal), DROP=drop,
            ALIGNED=sk % 4 == 0, ONE=one, WRITE_DZ=bool(want_dz), R=r, G=gg,
            num_warps=_warps(r, gg))
    LAUNCHES["dense_softmax_bwd"] += 1
    return ds, dz


class DenseSoftmaxFunction(torch.autograd.Function):
    """The kernels as a differentiable function of the scores (and of an
    additive mask): the dropped probs out; the backward draws the keep mask
    again."""

    @staticmethod
    def forward(ctx, scores, mask, causal, scale, p, key):
        probs, dropped = dense_softmax_forward(scores, mask, causal, scale,
                                               p, key)
        ctx.save_for_backward(probs, mask)
        ctx.args = (causal, scale, p, key)
        return dropped

    @staticmethod
    def backward(ctx, g):
        probs, mask = ctx.saved_tensors
        causal, scale, p, key = ctx.args
        want_dz = ctx.needs_input_grad[1]
        ds, dz = dense_softmax_backward(g, probs, mask, causal, scale, p, key,
                                        want_dz)
        dmask = None
        if want_dz:
            dmask = dz.sum_to_size(mask.shape).to(mask.dtype)
        return ds, dmask, None, None, None, None


def dense_softmax(scores, mask=None, causal=False, scale=1.0, p=0.0,
                  key=None):
    """The dropped probabilities (the probabilities without a dropout) of
    fp32 ``scores [b, h, sq, sk]``, differentiable: the kernels on CUDA
    tensors (the forward by its plan), ``dense_softmax_plain`` on CPU
    tensors (see the module's note for what both compute)."""
    p = float(p) if key is not None else 0.0
    if scores.device.type == "cpu":
        return dense_softmax_plain(scores, mask, causal, scale, p, key)[1]
    return DenseSoftmaxFunction.apply(scores, mask, bool(causal),
                                      float(scale), p, key)


__all__ = ["dense_softmax", "dense_softmax_plain", "dense_softmax_forward",
           "dense_softmax_backward", "DenseSoftmaxFunction", "plan",
           "dense_softmax_forward_plan", "NEG", "MAX_ONE",
           "CHUNK", "CUDA_MAX_KEYS"]
