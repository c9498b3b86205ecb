"""Weight-only int8 / int4 / fp8 quantization on raw tensors: the
quantizer, the dequantizer and the plain weight-only matmul.

Mirrors ``paddle_tpu/quantization/_kernels.py``, which the JAX package's
``weight_quantize`` / ``weight_only_linear`` and its quantized decoding
(``generation.generate(quant=...)``) share; the port's public functions
and its decoders share this module the same way. The weight-only GEMM of
``kernels/quant_matmul.py`` computes ``quant_matmul_arrays`` on the card.

Layout. A quantized matrix is held TRANSPOSED against the weight it
comes from: a weight used as ``x @ w`` (``[in, out]`` = ``[K, N]``)
quantizes to ``q [N, K]``, the contraction dim contiguous, with one fp32
scale per output channel ``s [N]``. int4 packs two K positions into a
byte along that contiguous dim: ``[N, ceil(K/2)]``, position ``2j`` in
the low nibble and ``2j + 1`` in the high one, a zero pad nibble when K
is odd. That is the JAX package's ``[K, N]`` / ``[ceil(K/2), N]`` arrays
transposed, bit for bit (``q_port == q_jax.T``), and it is the order in
which the GEMM's tensor-core B operand reads K pairs of one column.
"""
from __future__ import annotations

import torch

# the one algo registry both public surfaces (quantization.weight_quantize
# and generation.generate(quant=...)) validate against
ALGO_BITS = {"weight_only_int8": 8, "weight_only_int4": 4,
             "weight_only_fp8": "fp8_e4m3"}

# float8_e4m3fn has no inf: an out-of-range cast gives nan, so every
# quantizer clips to +-max before the cast
FP8_MAX = {"fp8_e4m3": 448.0, "fp8_e5m2": 57344.0}
FP8_DTYPE = {"fp8_e4m3": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}


def pack_int4_rows(q8):
    """Pack int4 values held in int8 ``[N, K]`` into nibbles along K ->
    int8 ``[N, ceil(K/2)]`` (the JAX package's rows of ``[K, N]`` are this
    layout's columns): even positions in the low nibble, odd ones in the
    high nibble; an odd K gets a zero pad position that
    ``unpack_int4_rows`` drops."""
    if q8.shape[-1] % 2:
        q8 = torch.cat([q8, torch.zeros_like(q8[..., :1])], dim=-1)
    even = q8[..., 0::2]
    odd = q8[..., 1::2]
    return ((odd << 4) | (even & 0x0F)).to(torch.int8)


def unpack_int4_rows(packed, n_rows):
    """Inverse of ``pack_int4_rows``: int8 ``[N, p]`` -> int8
    ``[N, n_rows]``, each nibble sign-extended."""
    even = (packed << 4) >> 4        # arithmetic shifts sign-extend
    odd = packed >> 4
    full = torch.stack([even, odd], dim=-1).reshape(
        *packed.shape[:-1], 2 * packed.shape[-1])
    return full[..., :n_rows]


def quantize_weight_arrays(arr, bits=8):
    """Per-output-channel symmetric quantization of a weight used as
    ``x @ arr`` (``[K, N]``): returns (q in this module's ``[N, ...]``
    layout, scale fp32 ``[N]``). The fp32 upcast makes a bf16 weight
    quantize against its true channel max; rounding is half to even, as
    ``jnp.round``. ``bits``: 8 (int8 ``[N, K]``), 4 (nibble-packed int8
    ``[N, ceil(K/2)]``) or ``"fp8_e4m3"`` / ``"fp8_e5m2"`` (float8
    ``[N, K]``)."""
    a32 = arr.float()
    if bits in FP8_MAX:
        fmax = FP8_MAX[bits]
        scale = torch.clamp(a32.abs().amax(dim=0), min=1e-8) / fmax
        q = torch.clamp(a32 / scale, -fmax, fmax).to(FP8_DTYPE[bits])
        return q.T.contiguous(), scale
    if bits == 8:
        qmax, lo, hi = 127.0, -128, 127
    elif bits == 4:
        qmax, lo, hi = 7.0, -8, 7
    else:
        raise NotImplementedError(f"weight quantization bits={bits}")
    scale = torch.clamp(a32.abs().amax(dim=0), min=1e-8) / qmax
    q = torch.clamp(torch.round(a32 / scale), lo, hi).to(torch.int8).T \
        .contiguous()
    if bits == 4:
        q = pack_int4_rows(q)
    return q, scale


def dequantize_weight_arrays(q, s, n_rows=None):
    """The output of ``quantize_weight_arrays`` back to an fp32 weight in
    the ``[K, N]`` layout it came from. The int4-packed form needs
    ``n_rows`` (the original K, which tells it from int8 and drops the
    pad position); int8 and fp8 ignore it."""
    if q.dtype == torch.int8 and n_rows is not None \
            and q.shape[-1] != n_rows:
        q = unpack_int4_rows(q, n_rows)
    return (q.float() * s[:, None]).T


def quantize_tensor_fp8_arrays(arr, fmt="fp8_e4m3"):
    """Dynamic per-tensor float8 quantization: (q float8, scale fp32
    scalar) with ``q ~= arr / scale``, scale = absmax / format max."""
    fmax = FP8_MAX[fmt]
    a32 = arr.float()
    scale = torch.clamp(a32.abs().amax(), min=1e-8) / fmax
    q = torch.clamp(a32 / scale, -fmax, fmax).to(FP8_DTYPE[fmt])
    return q, scale


def quant_matmul_arrays(x, q, s):
    """``x @ W`` for the quantized ``W``, the plain version: the product
    with the narrow matrix converted to x's dtype, summed in x's matmul
    precision and rounded to x's dtype, then the per-output-channel scale
    applied in fp32 and the result rounded to x's dtype again, as the JAX
    function computes it (``sum_i x_i q_ij s_j``). The JAX function sums
    an int4 product as two half products (even and odd K) added in x's
    dtype, an XLA fusion device; here it is one product, so the GEMM and
    this version differ in summation order only. x: ``[..., K]``; q, s
    in this module's layout."""
    k = x.shape[-1]
    w = q
    if q.shape[-1] != k:
        if q.dtype != torch.int8 or q.shape[-1] != (k + 1) // 2:
            raise ValueError(
                f"quant_matmul: weight width {q.shape[-1]} matches neither "
                f"the contraction dim {k} (int8, fp8) nor its nibble-packed "
                "half")
        w = unpack_int4_rows(q, k)
    y = x @ w.to(x.dtype).T
    return (y.float() * s).to(x.dtype)


__all__ = ["ALGO_BITS", "FP8_MAX", "FP8_DTYPE", "pack_int4_rows",
           "unpack_int4_rows", "quantize_weight_arrays",
           "dequantize_weight_arrays", "quantize_tensor_fp8_arrays",
           "quant_matmul_arrays"]
