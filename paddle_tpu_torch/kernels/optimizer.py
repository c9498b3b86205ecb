"""Multi-tensor AdamW: the CUDA kernel and its plain PyTorch version.

Replaces ``paddle_tpu/kernels/optimizer_pallas.py``:
``multi_tensor_adamw_pallas`` and ``_fused_adamw_flat`` (``_adamw_kernel``)
-> ``multi_tensor_adamw``. The math is ``_adam_update`` of
``paddle_tpu/optimizer/__init__.py`` in fp32: ``(m/bc1) / (sqrt(v/bc2) +
eps)``, decoupled decay ``p * (1 - lr*wd)`` or coupled ``g + wd*p``, with
``bc1 = 1 - beta1**step`` and ``bc2 = 1 - beta2**step`` in float32, at a
rate per tensor: the base rate times the tensor's multiplier, a float32
product (the JAX trainer's ``lr * _lr_mult(name)``); p is written back in
its own dtype, m and v stay float32.

**The update is in place.** The JAX arrays are immutable, so the TPU path
returns new parameters and moments (and concatenates each group into flat
buffers around its kernel); here ``multi_tensor_adamw`` overwrites the
parameters, m and v it is given, which saves a second copy of all three
(about 15 GB at 1.1B parameters) and the copies into and out of flat
buffers. The kernel (``csrc/adamw.cu``) is bound by bytes on the H100; its
source note says how one launch per dtype group walks a cached table of
(tensor, chunk) entries with 16-byte accesses.
"""
from __future__ import annotations

import ctypes
from collections import OrderedDict

import numpy as np
import torch

from .._scalars import const, scalar
from . import LAUNCHES
from ._build import library

CHUNK = 65536                 # elements of one table entry (one block)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_TABLES: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
_MAX_TABLES = 8


def adamw_scalars(lr, beta1, beta2, step, device):
    """float32 ``[lr, 1 - beta1**step, 1 - beta2**step]`` on ``device``,
    from ``lr`` and ``step`` given as numbers or 0-d tensors: the bias
    corrections in float32 as the JAX update computes them, on the device
    (``_fused_adamw_flat`` computes them in the compiled program). The
    kernel reads this array, and ``adamw_plain`` computes with it."""
    one = const(1.0, device)
    st = scalar(step, device)
    return torch.stack([scalar(lr, device),
                        one - const(beta1, device) ** st,
                        one - const(beta2, device) ** st])


def adamw_plain(p, g, m, v, lr, beta1, beta2, eps, wd, step, decoupled=True,
                lr_mult=1.0):
    """(p_new, m_new, v_new) of one tensor, in fp32 with ``_adam_update``'s
    order of operations at the rate ``float32(lr) * float32(lr_mult)``
    (the JAX trainer's float32 product; with ``lr_mult`` 1.0 the rate is
    ``float32(lr)``); p_new in p's dtype. ``lr`` and ``step`` are numbers
    or 0-d tensors (``adamw_scalars``). Nothing is written."""
    dev = p.device
    lr_, bc1, bc2 = adamw_scalars(lr, beta1, beta2, step, dev)
    lr_ = lr_ * const(lr_mult, dev)
    b1, b2, eps_, wd_ = (const(x, dev) for x in (beta1, beta2, eps, wd))
    gf = g.float()
    pf = p.float()
    if not decoupled:
        gf = gf + wd_ * pf
    m_new = b1 * m + (1 - b1) * gf
    v_new = b2 * v + (1 - b2) * gf * gf
    upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps_)
    if decoupled:
        pf = pf * (1 - lr_ * wd_)
    return (pf - lr_ * upd).to(p.dtype), m_new, v_new


def _lib():
    lib = library("adamw")
    fn = lib.ptt_adamw
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p] + [ctypes.c_float] * 3
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
    return lib


def _bits(x):
    return int(np.float32(x).view(np.uint32))


def _table(group, device):
    """The device table of (tensor, chunk) entries of ``group`` (a list of
    (p, g, m, v, wd, lr_mult)), six int64 per entry: the four pointers at
    the chunk's start; its length with the tensor's wd (float32 bits) in
    the upper word; the tensor's rate multiplier (float32 bits) with a
    16-byte-alignment flag in the upper word. Cached by pointers, lengths,
    wd and multipliers: an in-place update keeps them, and the base rate
    and step (which change) are read from ``adamw_scalars``, so a training
    loop builds it once. A CUDA graph that captured a launch reads the
    table at every replay: its owner keeps the tensor
    (``multi_tensor_adamw`` returns it) as long as the graph."""
    key = tuple((p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                 p.numel(), p.element_size(), float(wd), float(mult))
                for p, g, m, v, wd, mult in group)
    table = _TABLES.get(key)
    if table is not None:
        _TABLES.move_to_end(key)
        return table
    blocks = []
    for p, g, m, v, wd, mult in group:
        n = p.numel()
        if n == 0:
            continue
        starts = np.arange(0, n, CHUNK, dtype=np.int64)
        ptrs = (p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr())
        vec = int(all(x % 16 == 0 for x in ptrs))
        rows = np.empty((starts.size, 6), np.int64)
        for col, (ptr, size) in enumerate(zip(ptrs, (p.element_size(),
                                                     g.element_size(), 4, 4))):
            rows[:, col] = ptr + starts * size
        rows[:, 4] = np.minimum(CHUNK, n - starts) | (_bits(wd) << 32)
        rows[:, 5] = _bits(mult) | (vec << 32)
        blocks.append(rows)
    host = np.concatenate(blocks) if blocks else np.zeros((0, 6), np.int64)
    table = torch.from_numpy(host).to(device)
    _TABLES[key] = table
    while len(_TABLES) > _MAX_TABLES:
        _TABLES.popitem(last=False)
    return table


def _check(params, grads, ms, vs):
    dev = params[0].device
    for p, g, m, v in zip(params, grads, ms, vs):
        for name, x in (("param", p), ("grad", g), ("m", m), ("v", v)):
            if x.device != dev:
                raise ValueError(f"multi_tensor_adamw: a {name} is on "
                                 f"{x.device}, the first param on {dev}")
            if not x.is_contiguous():
                raise ValueError(f"multi_tensor_adamw: a {name} is not "
                                 f"contiguous")
            if x.shape != p.shape:
                raise ValueError("multi_tensor_adamw: shapes differ within "
                                 "a (param, grad, m, v) entry")
        if p.dtype not in _DTYPE_CODE or g.dtype != p.dtype:
            raise TypeError(f"multi_tensor_adamw takes float32/bfloat16 "
                            f"params with grads of the same dtype, got "
                            f"{p.dtype} and {g.dtype}")
        if m.dtype != torch.float32 or v.dtype != torch.float32:
            raise TypeError("multi_tensor_adamw keeps m and v in float32")


@torch.no_grad()
def multi_tensor_adamw(params, grads, ms, vs, *, lr, beta1, beta2, eps, wds,
                       step, decoupled=True, lr_mults=None):
    """AdamW over lists of tensors, IN PLACE: params, ms and vs are
    overwritten; tensor i at the rate ``float32(lr) * float32(lr_mults[i])``
    (every multiplier 1.0 when None) with weight decay ``wds[i]``; ``lr``
    and ``step`` are numbers or 0-d tensors on the parameters' device (a
    trainer's, which it fills before each step). On CUDA tensors one kernel
    launch updates every tensor of a dtype group, reading the rate and the
    bias corrections from ``adamw_scalars`` on the device; on CPU tensors
    each tensor goes through ``adamw_plain``. Returns the device tensors
    the launches read (the tables and the scalars), which a CUDA graph
    that captured them must keep."""
    if lr_mults is None:
        lr_mults = [1.0] * len(params)
    if not (len(params) == len(grads) == len(ms) == len(vs) == len(wds)
            == len(lr_mults)):
        raise ValueError("multi_tensor_adamw: list length mismatch")
    if not params:
        return []
    dev = params[0].device
    if dev.type == "cpu":
        for p, g, m, v, wd, mult in zip(params, grads, ms, vs, wds,
                                        lr_mults):
            pn, mn, vn = adamw_plain(p, g, m, v, lr, beta1, beta2, eps, wd,
                                     step, decoupled, mult)
            p.copy_(pn)
            m.copy_(mn)
            v.copy_(vn)
        return []
    if dev.type != "cuda":
        raise ValueError(f"multi_tensor_adamw runs on cuda or cpu, not {dev}")
    _check(params, grads, ms, vs)
    scalars = adamw_scalars(lr, beta1, beta2, step, dev)
    if scalars.device != dev:
        raise ValueError(f"multi_tensor_adamw: lr and step are on "
                         f"{scalars.device}, the params on {dev}")
    groups = {}
    for entry in zip(params, grads, ms, vs, wds, lr_mults):
        groups.setdefault(entry[0].dtype, []).append(entry)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    read = [scalars]
    for dtype, group in groups.items():
        table = _table(group, dev)
        err = lib.ptt_adamw(table.data_ptr(), table.shape[0],
                            _DTYPE_CODE[dtype], scalars.data_ptr(), beta1,
                            beta2, eps, int(bool(decoupled)), stream)
        if err != 0:
            raise RuntimeError("adamw kernel launch failed: "
                               + lib.ptt_error_string(err).decode())
        LAUNCHES["adamw"] += 1
        read.append(table)
    return read


__all__ = ["multi_tensor_adamw", "adamw_plain", "adamw_scalars", "const",
           "CHUNK"]
