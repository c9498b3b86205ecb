"""Weight-only quantization: ``weight_quantize``, ``weight_dequantize``
and ``weight_only_linear``.

Mirrors the three functions of ``paddle_tpu/quantization/__init__.py``
that share the serving path's kernels (``_kernels``; on the card the
weight-only GEMM of ``kernels/quant_matmul.py``). The quantized weight is
in the port's layout, ``[out, in]`` (``[N, ceil(in/2)]`` packed for
int4): see ``_kernels``. QAT fake-quant, the PTQ observers and
``QuantedLinear`` are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from ._kernels import (ALGO_BITS, dequantize_weight_arrays,
                       quantize_weight_arrays)


def weight_quantize(w, algo: str = "weight_only_int8"):
    """(quantized weight, fp32 scale ``[out]``) of ``w`` (``[in, out]``,
    used as ``x @ w``); ``algo`` one of ``ALGO_BITS``."""
    bits = ALGO_BITS.get(algo)
    if bits is None:
        raise NotImplementedError(
            f"weight_quantize algo={algo!r}: implemented algos are "
            f"{sorted(ALGO_BITS)}")
    return quantize_weight_arrays(w, bits=bits)


def weight_dequantize(w_int8, scale, algo: str = "weight_only_int8"):
    """The fp32 ``[in, out]`` weight back from ``weight_quantize``'s
    output. For int4 the in-dim is taken as twice the packed width, so an
    odd original in-dim keeps its zero pad row, as in the JAX package."""
    n_rows = 2 * w_int8.shape[-1] if algo == "weight_only_int4" else None
    return dequantize_weight_arrays(w_int8, scale, n_rows)


def weight_only_linear(x, weight_int8, bias=None, weight_scale=None,
                       weight_dtype="int8"):
    """``x @ W (+ bias)`` for a ``weight_quantize`` output: the
    weight-only GEMM on the card, its plain version on the CPU."""
    from ..kernels.quant_matmul import weight_only_gemm
    y = weight_only_gemm(x, weight_int8, weight_scale)
    return y if bias is None else y + bias.to(y.dtype)


__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear",
           "ALGO_BITS"]
