"""Build variants of the weight-only GEMM source and time them on one GPU.

    python3 paddle_tpu_torch/tools/quant_gemm_variants.py [NAME ...]

Each variant (``VARIANTS`` below, all of them by default) is
``csrc/weight_only_gemm.cu`` with some text replaced: a design choice
undone or changed. Each is built with the port's nvcc flags into
``build/variants/``, checked against the plain version (every row within 2
bf16 ulps of its largest value) and timed by CUDA-graph replay over
enough copies of the weight to exceed the L2 (``chip_smoke.py`` phase 3's
method) at Llama-2-7B's 4096 x 4096 and 4096 x 11008 matrices, M = 8, 256
and 4096, in int8, int4 and fp8, with ``torch.matmul`` on the bf16 weight
as the yardstick. Compare variants only within one run: two runs may land
on two cards.
"""
from __future__ import annotations

import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.quantization import weight_quantize  # noqa: E402
from paddle_tpu_torch.quantization._kernels import \
    quant_matmul_arrays  # noqa: E402

SMALL = "launch<FMT, 16, 32, 256, 1, 4, 4, 4>"
LARGE = "launch<FMT, 64, 128, 64, 2, 2, 2, 4>"
I2F_INT8 = """  const uint32_t u = *reinterpret_cast<const uint16_t*>(row + k) ^ 0x8080u;
  const float lo = __uint_as_float(0x4B000000u | (u & 0xFFu)) - 8388736.f;
  const float hi = __uint_as_float(0x4B000000u | (u >> 8)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);"""

VARIANTS = {
    "as_is": [],
    # int8 converted by I2F (a quarter-rate instruction) and F2FP
    "i2f_int8": [(I2F_INT8, """  const uint16_t v = *reinterpret_cast<const uint16_t*>(row + k);
  return bf162_bits(__floats2bfloat162_rn((float)(int8_t)(v & 0xff),
                                          (float)(int8_t)(v >> 8)));""")],
    # no warps along K: one warp a tile's 8 (small) or 32 x 64 (large)
    "no_k_split": [(SMALL, "launch<FMT, 16, 32, 256, 1, 4, 1, 4>"),
                   (LARGE, "launch<FMT, 64, 128, 64, 2, 2, 1, 4>")],
    # 3 stages in the large tiling
    "large_3_stages": [(LARGE, "launch<FMT, 64, 128, 64, 2, 2, 2, 3>")],
    # 128 x 128 tiles, 4 warps of 64 x 64, no K split
    "large_128x128": [(LARGE, "launch<FMT, 128, 128, 64, 2, 2, 1, 4>")],
    # 512-deep K stages, 32 warps, 3 stages in the small tiling
    "small_bk512": [(SMALL, "launch<FMT, 16, 32, 512, 1, 4, 8, 3>")],
    # each block walks K from its own start (blockIdx.x), so blocks read
    # different x tiles at once
    "rotate_k": [("const int KT = (K + BK - 1) / BK;",
                  "const int KT = (K + BK - 1) / BK;\n"
                  "  const int rot = (int)(blockIdx.x % KT);"),
                 ("n0, s, M, N,", "n0, (s + rot) % KT, M, N,"),
                 ("n0, nk, M,", "n0, (nk + rot) % KT, M,")],
}
SHAPES = ((4096, 4096), (4096, 11008))
ROWS = (8, 256, 4096)
FORMATS = {"weight_only_int8": 0, "weight_only_int4": 1, "weight_only_fp8": 2}


def _call(lib, fmt):
    def run(x, q, s):
        y = torch.empty(x.shape[0], q.shape[0], dtype=x.dtype,
                        device=x.device)
        err = lib.ptt_weight_only_gemm(
            x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
            x.shape[0], q.shape[0], x.shape[1], fmt, q.shape[1],
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")
        return y
    return run


def main(names):
    if not torch.cuda.is_available():
        print("quant_gemm_variants: no CUDA device", file=sys.stderr)
        return 2
    variants = {n: VARIANTS[n] for n in (names or VARIANTS)}
    libs = {}
    for name, path in _build.build_variants("weight_only_gemm",
                                            variants).items():
        libs[name] = lib = ctypes.CDLL(str(path))
        lib.ptt_weight_only_gemm.argtypes = \
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.ptt_weight_only_gemm.restype = ctypes.c_int
    card = S._card_line()
    print(f"card [{card}]", flush=True)
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    g = torch.Generator(device="cuda").manual_seed(40)
    for k, n in SHAPES:
        w = (torch.randn(k, n, device="cuda", generator=g) * 0.02) \
            .to(torch.bfloat16)
        for algo, fmt in FORMATS.items():
            q, s = weight_quantize(w, algo)
            wbytes = q.numel() * q.element_size() + s.numel() * 4
            for m in ROWS:
                x = torch.randn(m, k, device="cuda", generator=g) \
                    .to(torch.bfloat16)
                want = quant_matmul_arrays(x, q, s)
                bound, by = S._bound(x.numel() * 2 + wbytes + m * n * 2,
                                     2 * m * k * n, S.BF16_FLOPS)
                lib_ms, _ = S._rotated_ms(torch, torch.matmul, (x, w),
                                          w.numel() * 2)
                cells = []
                for name, lib in libs.items():
                    run = _call(lib, fmt)
                    S._check_rows(f"{name} {algo[12:]} {k}x{n} M={m}",
                                  run(x, q, s), want, 2)
                    ms, _ = S._rotated_ms(torch, run, (x, q, s), wbytes)
                    cells.append(f"{name} {ms:.4f}")
                print(f"{k}x{n} {algo[12:]} M={m}: ms " + ", ".join(cells)
                      + f"; bound {bound:.4f} ({by}); torch.matmul bf16 "
                      f"{lib_ms:.4f} [{card}]", flush=True)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        reduced
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
