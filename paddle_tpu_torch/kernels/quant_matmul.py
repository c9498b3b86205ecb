"""The weight-only GEMM: ``x @ W`` for an int8, int4 or float8 ``W`` with
per-output-channel scales, reading the narrow bytes.

Replaces no Pallas kernel: it is the port of the convert that XLA fuses
into the dot of ``paddle_tpu/quantization/_kernels.py:99
quant_matmul_arrays`` (``csrc/weight_only_gemm.cu`` says how). The
weight is in the port's layout (``quantization/_kernels.py``): ``[N, K]``
int8 or float8_e4m3fn, or ``[N, ceil(K/2)]`` nibble-packed int8, with
fp32 scales ``[N]``.

``weight_only_gemm`` launches the kernel on CUDA tensors and raises on
what it does not take (activations in any dtype but bf16 among them: a
float32 model is not served quantized on the card); on CPU tensors, in
any dtype, it runs the plain version,
``quantization._kernels.quant_matmul_arrays``.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES
from ._build import library
from ..quantization._kernels import quant_matmul_arrays

_FMT = {torch.int8: 0, torch.float8_e4m3fn: 2}     # int4 (1): packed int8


def _lib():
    lib = library("weight_only_gemm")
    fn = lib.ptt_weight_only_gemm
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
    return lib, fn


def weight_only_gemm(x, q, s):
    """``(x @ W) * s`` in x's dtype, x ``[..., K]``. On CUDA tensors this
    launches the kernel (bf16 x, a contiguous int8 / float8_e4m3fn /
    packed-int4 ``q`` and fp32 ``s`` on x's device, or it raises); on CPU
    tensors it runs the plain version."""
    if x.device.type == "cpu":
        return quant_matmul_arrays(x, q, s)
    if x.device.type != "cuda":
        raise ValueError(f"weight_only_gemm runs on cuda or cpu, not "
                         f"{x.device}")
    k = x.shape[-1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"weight_only_gemm takes bf16 activations, got "
                        f"{x.dtype}")
    if q.device != x.device or s.device != x.device:
        raise ValueError("weight_only_gemm: the weight and its scales must "
                         "be on the activations' device")
    if q.dtype not in _FMT or q.dim() != 2 or not q.is_contiguous():
        raise TypeError(f"weight_only_gemm takes a contiguous 2-D int8 or "
                        f"float8_e4m3fn weight, got {q.dtype} "
                        f"{tuple(q.shape)}")
    if q.shape[1] == k:
        fmt = _FMT[q.dtype]
    elif q.dtype == torch.int8 and q.shape[1] == (k + 1) // 2:
        fmt = 1                                           # packed int4
    else:
        raise ValueError(f"weight_only_gemm: weight width {q.shape[1]} "
                         f"matches neither K={k} nor its packed half")
    n = q.shape[0]
    if s.dtype != torch.float32 or s.shape != (n,) or not s.is_contiguous():
        raise TypeError(f"weight_only_gemm: scales must be contiguous fp32 "
                        f"[{n}], got {s.dtype} {tuple(s.shape)}")
    x2 = x.reshape(-1, k).contiguous()
    y = torch.empty(x2.shape[0], n, dtype=x.dtype, device=x.device)
    lib, fn = _lib()
    err = fn(x2.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
             x2.shape[0], n, k, fmt, q.shape[1],
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("weight_only_gemm kernel launch failed: "
                           + lib.ptt_error_string(err).decode())
    LAUNCHES["weight_only_gemm"] += 1
    return y.reshape(*x.shape[:-1], n)


__all__ = ["weight_only_gemm"]
