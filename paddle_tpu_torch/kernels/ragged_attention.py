"""Ragged paged attention: the CUDA kernel and its plain PyTorch version.

Replaces ``paddle_tpu/kernels/ragged_pallas.py:ragged_decode_attention``.
The kernel (``csrc/ragged_attention.cu``) is bound by bytes on the H100;
its source note says how its design reads only the pages each token can
see and each page once per (token, kv head).

Layouts are the JAX package's: packed queries ``q [T, H, D]``, pools
``[P, kvh, bs, D]``, ``page_tables [S, MP]`` int32 (-1 = unassigned),
``slot_ids``/``positions [T]`` int32, ``valid [T]`` bool. Token t sees its
slot's cache positions ``<= positions[t]``; invalid rows are zeros.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import LAUNCHES
from ._build import library

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
GROUP_SIZES = (1, 2, 4, 8)


def ragged_attention_plain(q, k_pool, v_pool, page_tables, slot_ids,
                           positions, valid, rep=1):
    """Plain PyTorch version: per sequence slot, gather its pages once and
    run a masked softmax for the slot's tokens in fp32. Agrees with the
    JAX reference ``serving.ragged.ragged_paged_attention``; a valid row
    that sees no slot at all (which the engine never sends) is zero, as in
    the kernel."""
    t, h, d = q.shape
    p_total, kvh, bs, _ = k_pool.shape
    mp = page_tables.shape[1]
    out = torch.zeros(t, h, d, dtype=torch.float32, device=q.device)
    valid = valid.to(torch.bool)
    for s in torch.unique(slot_ids[valid]).tolist():
        rows = torch.nonzero(valid & (slot_ids == s)).squeeze(1)
        n = rows.numel()
        pos = positions[rows].long()
        cols = min(mp, max(int(pos.max()) // bs + 1, 1))
        tab = page_tables[s, :cols].long()
        safe = tab.clamp(0, p_total - 1)
        kg = k_pool[safe].permute(1, 0, 2, 3).reshape(kvh, cols * bs, d)
        vg = v_pool[safe].permute(1, 0, 2, 3).reshape(kvh, cols * bs, d)
        slot_pos = torch.arange(cols * bs, device=q.device)
        page_ok = (tab >= 0).repeat_interleave(bs)
        live = (slot_pos[None, :] <= pos[:, None]) & page_ok[None, :]
        qg = q[rows].reshape(n, kvh, rep, d).float()
        scores = torch.einsum("ngrd,gld->ngrl", qg, kg.float()) / math.sqrt(d)
        scores = scores.masked_fill(~live[:, None, None, :], NEG_INF)
        p = torch.softmax(scores, dim=-1) \
            * live.any(dim=-1).to(scores.dtype)[:, None, None, None]
        o = torch.einsum("ngrl,gld->ngrd", p, vg.float())
        out[rows] = o.reshape(n, h, d)
    return out.to(q.dtype)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _fn():
    lib = library("ragged_attention")
    fn = lib.ptt_ragged_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
    return lib, fn


def kernel_takes(head_dim, rep):
    """Whether the kernel takes this head_dim and GQA group (query heads
    per kv head); ``serving.ragged.make_attend`` sends the others to
    ``ragged_attention_plain``, as the JAX package takes its jnp path
    wherever its kernel is off."""
    return head_dim in HEAD_DIMS and rep in GROUP_SIZES


def _check(q, k_pool, v_pool, page_tables, slot_ids, positions, valid, rep):
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "page_tables": page_tables, "slot_ids": slot_ids,
               "positions": positions, "valid": valid}
    for name, x in tensors.items():
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("the pools must start on a 16-byte boundary")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("k_pool and v_pool must have q's dtype")
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError("want q [T, H, D] and pools [P, kvh, bs, D]")
    t, h, d = q.shape
    _, kvh, bs, dk = k_pool.shape
    if dk != d or h != kvh * rep:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_pool.shape)} with rep={rep}")
    if not kernel_takes(d, rep):
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS} and "
                         f"rep in {GROUP_SIZES}, got {d} and {rep}")
    for name, x in (("page_tables", page_tables), ("slot_ids", slot_ids),
                    ("positions", positions)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    if page_tables.dim() != 2:
        raise ValueError("page_tables must be [S, MP]")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if slot_ids.shape != (t,) or positions.shape != (t,) \
            or valid.shape != (t,):
        raise ValueError("slot_ids, positions and valid must be [T]")


def ragged_attention(q, k_pool, v_pool, page_tables, slot_ids, positions,
                     valid, rep=1):
    """Ragged paged attention. On a CUDA tensor this launches the kernel
    (and raises on anything it does not take); on a CPU tensor it runs
    the plain version."""
    if q.device.type == "cpu":
        return ragged_attention_plain(q, k_pool, v_pool, page_tables,
                                      slot_ids, positions, valid, rep)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_attention runs on cuda or cpu, not "
                         f"{q.device}")
    _check(q, k_pool, v_pool, page_tables, slot_ids, positions, valid, rep)
    t, h, d = q.shape
    p_total, kvh, bs, _ = k_pool.shape
    out = torch.empty_like(q)
    lib, fn = _fn()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             page_tables.data_ptr(), slot_ids.data_ptr(),
             positions.data_ptr(), valid.data_ptr(), out.data_ptr(),
             t, h, kvh, d, p_total, bs, page_tables.shape[1],
             _DTYPE_CODE[q.dtype], d ** -0.5, stream)
    if err != 0:
        raise RuntimeError("ragged_attention kernel launch failed: "
                           + lib.ptt_error_string(err).decode())
    LAUNCHES["ragged_attention"] += 1
    return out


__all__ = ["ragged_attention", "ragged_attention_plain", "kernel_takes"]
