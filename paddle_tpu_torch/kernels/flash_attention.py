"""Flash attention, forward and backward: the CUDA kernels, their plain
PyTorch versions and the autograd function around them.

Replaces ``paddle_tpu/kernels/flash_pallas.py``: ``_flash_forward``
(``_fa_kernel``) -> ``flash_forward``, ``_flash_backward`` (``_fa_dq_kernel``
and ``_fa_dkv_kernel``) -> ``flash_backward``; ``flash_attention_bshd`` is
the counterpart of ``paddle_tpu/kernels/flash_attention.py``'s wrapper of
the same name. The kernels (``csrc/flash_attention.cu``) are bound by
operations on the H100 at training shapes; the source note says how.

The function: ``q [b, h, sq, d]``, ``k, v [b, h, sk, d]`` in float32 or
bfloat16; ``causal`` is bottom-right aligned (query i sees keys
``<= i + sk - sq``); ``scale`` defaults to ``1/sqrt(d)``. The forward
returns ``out`` (q's dtype) and ``lse [b, h, sq]`` in fp32; a row that
sees no key has ``lse = -1e30`` and an output of 0. Rounding follows the
JAX kernels: scores and sums in fp32, P cast to v's dtype before P.V; in
the backward ds cast to k's dtype for dq, p to dO's dtype for dv and ds
to q's dtype for dk; ``delta = rowsum(dO * O)`` in fp32 outside the
kernels. The JAX kernel keeps lse broadcast over 8 lanes, a TPU tiling
layout; here it is ``[b, h, sq]``.

The kernels take head_dim 64 and 128 and any sequence length (a ragged
last tile is masked); the wrapper raises on anything else, and on
``sq > sk`` under ``causal`` (leading rows would see no key).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import LAUNCHES
from ._build import library

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _scale(d, scale):
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


def _visible(sq, sk, causal, device):
    """[sq, sk] bool: which keys each query row sees."""
    if not causal:
        return torch.ones(sq, sk, dtype=torch.bool, device=device)
    return torch.ones(sq, sk, dtype=torch.bool, device=device).tril(sk - sq)


# -- plain versions -------------------------------------------------------------

def flash_forward_plain(q, k, v, causal=False, scale=None):
    """(out, lse) of softmax(q k^T * scale) v, in fp32 with the kernel's
    roundings: P = exp(s - max) cast to v's dtype before P.V, the sum of
    the fp32 P as the normaliser."""
    s_ = _scale(q.shape[-1], scale)
    sq, sk = q.shape[2], k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * s_
    vis = _visible(sq, sk, causal, q.device)
    s = s.masked_fill(~vis, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / l_safe
    lse = torch.where(l == 0, torch.full_like(l, NEG_INF), m + torch.log(l_safe))
    return out.to(q.dtype), lse[..., 0]


def flash_backward_plain(q, k, v, out, lse, dout, causal=False, scale=None):
    """(dq, dk, dv) of the forward above from the saved out and lse, as the
    FA2 split computes them: p = exp(s - lse), delta = rowsum(dO * O),
    ds = p * (dO v^T - delta) * scale."""
    s_ = _scale(q.shape[-1], scale)
    sq, sk = q.shape[2], k.shape[2]
    delta = (dout.float() * out.float()).sum(dim=-1, keepdim=True)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * s_
    vis = _visible(sq, sk, causal, q.device)
    p = torch.exp(s - lse.float()[..., None]).masked_fill(~vis, 0.0)
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta) * s_
    dq = torch.matmul(ds.to(k.dtype).float(), k.float())
    dv = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2), dout.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -- kernels --------------------------------------------------------------------

def _lib():
    lib = library("flash_attention")
    if lib.ptt_flash_fwd.argtypes is None:
        ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [i] * 6 + [f, ptr]         # bh, sq, sk, d, dtype, causal, scale, stream
        lib.ptt_flash_fwd.argtypes = [ptr] * 5 + tail
        lib.ptt_flash_bwd_dq.argtypes = [ptr] * 7 + tail
        lib.ptt_flash_bwd_dkv.argtypes = [ptr] * 8 + tail
        for fn in (lib.ptt_flash_fwd, lib.ptt_flash_bwd_dq,
                   lib.ptt_flash_bwd_dkv):
            fn.restype = ctypes.c_int
        lib.ptt_error_string.argtypes = [i]
        lib.ptt_error_string.restype = ctypes.c_char_p
    return lib


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


def _on_cuda(q, k, v, causal):
    """False for CPU tensors (plain version); True for CUDA tensors the
    kernels take; raises on anything else."""
    if q.device.type == "cpu":
        _check_causal(q, k, causal)
        return False
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    _check(q, k, v, causal)
    return True


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.ptt_error_string(err).decode())


def _geometry(q, k, causal, scale):
    b, h, sq, d = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return (b * h, sq, k.shape[2], d, _DTYPE_CODE[q.dtype], int(bool(causal)),
            _scale(d, scale), stream)


def flash_forward(q, k, v, causal=False, scale=None):
    """(out, lse). On CUDA tensors this launches the forward kernel (and
    raises on what it does not take); on CPU tensors it runs the plain
    version."""
    if not _on_cuda(q, k, v, causal):
        return flash_forward_plain(q, k, v, causal, scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    lib = _lib()
    err = lib.ptt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), lse.data_ptr(),
                            *_geometry(q, k, causal, scale))
    _raise_on(lib, err, "flash forward")
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def flash_backward(q, k, v, out, lse, dout, causal=False, scale=None):
    """(dq, dk, dv). On CUDA tensors this launches the dq kernel (sweeps
    the kv tiles of a q tile) and the dk/dv kernel (sweeps the q tiles of
    a kv tile): no atomics, the same result on every run. On CPU tensors
    it runs the plain version."""
    if not _on_cuda(q, k, v, causal):
        return flash_backward_plain(q, k, v, out, lse, dout, causal, scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    dout = dout.to(q.dtype).contiguous()
    lse = lse.contiguous()
    if lse.dtype != torch.float32 or lse.shape != q.shape[:3]:
        raise ValueError(f"lse must be float32 {tuple(q.shape[:3])}")
    delta = (dout.float() * out.float()).sum(dim=-1)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _lib()
    geo = _geometry(q, k, causal, scale)
    err = lib.ptt_flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               dout.data_ptr(), lse.data_ptr(),
                               delta.data_ptr(), dq.data_ptr(), *geo)
    _raise_on(lib, err, "flash backward (dq)")
    LAUNCHES["flash_bwd_dq"] += 1
    err = lib.ptt_flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                dout.data_ptr(), lse.data_ptr(),
                                delta.data_ptr(), dk.data_ptr(),
                                dv.data_ptr(), *geo)
    _raise_on(lib, err, "flash backward (dk, dv)")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """out = flash_forward(q, k, v)[0]; the backward runs flash_backward
    from the saved q, k, v, out and lse (no [sq, sk] matrix is kept)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout, ctx.causal,
                                    ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None):
    """Attention over ``[b, h, s, d]`` inputs, differentiable."""
    return FlashAttention.apply(q, k, v, bool(causal), scale)


def flash_attention_bshd(q, k, v, causal=False, scale=None):
    """``[batch, seq, heads, dim]`` layout around ``flash_attention``."""
    out = flash_attention(q.transpose(1, 2).contiguous(),
                          k.transpose(1, 2).contiguous(),
                          v.transpose(1, 2).contiguous(), causal, scale)
    return out.transpose(1, 2)


__all__ = ["flash_attention", "flash_attention_bshd", "flash_forward",
           "flash_backward", "flash_forward_plain", "flash_backward_plain",
           "FlashAttention"]
