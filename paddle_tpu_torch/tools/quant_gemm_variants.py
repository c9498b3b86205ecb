"""Build variants of the weight-only GEMM's wgmma kernel and time them on
one GPU.

    python3 paddle_tpu_torch/tools/quant_gemm_variants.py [NAME ...]

Each variant (``VARIANTS`` below, all of them by default) is
``csrc/weight_only_gemm.cu`` with some text replaced (a design choice
undone or changed), run on the plan of ``kernels/quant_matmul.py`` or on
a plan changed by the variant (split count, token tile). Each is built
with the port's nvcc flags into ``build/variants/``, checked against the
plain version (every row within 2 bf16 ulps of its largest value; not the
``TIMING_ONLY`` ones, which change what is computed) and timed by
CUDA-graph replay over enough copies of the weight to exceed the L2
(``chip_smoke.py`` phase 3's method) at Llama-2-7B's 4096 x 4096, 4096 x
11008 and 11008 x 4096 matrices, M = 8, 256 and 4096, in int8, int4 and
fp8, beside the mma.sync kernel (``sm80``) and ``torch.matmul`` on the
bf16 weight. Compare variants only within one run: two runs may land on
two cards.
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
from paddle_tpu_torch.kernels import quant_matmul as QM  # noqa: E402
from paddle_tpu_torch.quantization import weight_quantize  # noqa: E402
from paddle_tpu_torch.quantization._kernels import \
    quant_matmul_arrays  # noqa: E402


def _splits(n):
    return lambda plan, m, n_, k, cap: plan._replace(splits=min(
        n, max(1, -(-k // QM.STAGE_K) // QM.MIN_SPLIT_STAGES)))


class _patched:
    """Module constants of quant_matmul changed for one plan."""
    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.old = {k: getattr(QM, k) for k in self.values}
        for k, v in self.values.items():
            setattr(QM, k, v)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            setattr(QM, k, v)


def _large_tiles(*tiles):
    """The plan with only ``tiles`` (tokens, channels) past 128 rows."""
    def change(plan, m, n, k, cap):
        with _patched(LARGE_TILES=tiles):
            return QM.weight_only_gemm_plan(m, n, k, cap)
    return change


# name: [(old text, new text), ...]
VARIANTS = {
    "as_is": [],
    # the plan's split count replaced (PLANS): one block an output tile, or
    # a fixed count whatever the card holds at once
    "splits_1": [],
    "splits_2": [],
    "splits_4": [],
    "splits_8": [],
    # one large tile each past 128 rows (PLANS): 128 tokens (M = 256: two
    # tiles, each weight byte converted twice), 256 tokens at 128 channels
    # (one tile, split further), 256 tokens at 64 channels (one consumer
    # warpgroup, twice the tiles)
    "tile_128x128": [],
    "tile_256x128": [],
    "tile_256x64": [],
    # one block an SM at every token tile (the default runs two of the
    # 8-token tile's)
    "one_block_tn8": [("constexpr int SMALL_TN = 8; ", "constexpr int SMALL_TN = 0; ")],
    # timing only: the split blocks sum their own partial S times from
    # their own shared memory, no distributed shared memory
    "local_reduce": [("p[q][0] = ld_cluster_f4(at, q), p[q][1] = ld_cluster_f4(at + 16, q);",
                      "p[q][0] = lds_f4(at), p[q][1] = lds_f4(at + 16);")],
    # timing only: no partial tile written
    "no_partial_write": [("      sts_f32(base", "      if (acc[4 * j + e] == 12345.f) sts_f32(base")],
    # a 4-deep ring (the default fills ~200 KB or ~96 KB, at most 16
    # stages)
    "stages_4": [("constexpr int MAX_STAGES = 16;",
                  "constexpr int MAX_STAGES = 4;")],
    # no overlap of a stage's converts with the batch before
    "no_overlap": [("wgmma_wait<DEPTH - 1>();", "wgmma_wait<0>();")],
    # three and four wgmma batches in flight (DEPTH fragment buffers)
    "depth_3": [("constexpr int DEPTH = 2; ", "constexpr int DEPTH = 3; ")],
    "depth_4": [("constexpr int DEPTH = 2; ", "constexpr int DEPTH = 4; ")],
    # 128- and 256-deep stages at the 8-token tile: longer runs of each
    # weight row a load (256 bytes: two boxes a stage)
    "small_stage_k_128": [("constexpr int SK_SMALL = 64; ",
                           "constexpr int SK_SMALL = 128; ")],
    "small_stage_k_256": [("constexpr int SK_SMALL = 64; ",
                           "constexpr int SK_SMALL = 256; ")],
    # no programmatic dependent launch: each GEMM launches after the kernel
    # before it has finished
    "no_early_launch": [("constexpr bool EARLY_LAUNCH = true; ",
                         "constexpr bool EARLY_LAUNCH = false; ")],
    # timing only: one wgmma.fence before the k loop, none a stage (what
    # the fence before each stage's batch costs)
    "no_fence": [("    wgmma_fence();\n#pragma unroll\n    for (int kk = 0; kk < SK / 16; ++kk) wgmma_rs_kb",
                  "#pragma unroll\n    for (int kk = 0; kk < SK / 16; ++kk) wgmma_rs_kb"),
                 ("  int i = kb;\n", "  wgmma_fence();\n  int i = kb;\n")],
    # timing only: each wgmma issued twice (what a wgmma costs)
    "x2_wgmma": [("wgmma_rs_kb<TN>(acc, a[kk], kmajor(xt, TN, 0, kk));",
                  "{\n      wgmma_rs_kb<TN>(acc, a[kk], kmajor(xt, TN, 0, kk));\n"
                  "      wgmma_rs_kb<TN>(acc, a[kk], kmajor(xt, TN, 0, kk));\n    }")],
    # timing only: no products (the stages are loaded and converted)
    "no_wgmma": [("wgmma_rs_kb<TN>(acc, a[kk], kmajor(xt, TN, 0, kk));",
                  "asm volatile(\"\" :: \"r\"(a[kk][0]), \"r\"(a[kk][1]), "
                  "\"r\"(a[kk][2]), \"r\"(a[kk][3]));")],
    # timing only: no partial tile, no reduction, no output
    "no_epilogue": [
        ("      sts_f32(base", "      if (acc[4 * j + e] == 12345.f) sts_f32(base"),
        ("for (int u = lo + (int)threadIdx.x; u < hi;",
         "for (int u = lo + (int)threadIdx.x; u < lo;")],
    # timing only: no k loop (the launch, the set-up and the epilogue)
    "no_mainloop": [("ke = n_st * (split + 1) / splits;", "ke = kb;")],
    # timing only (its output is wrong): the raw bytes as the fragments,
    # no convert
    "no_convert": [(f"a[{i}] = cvt<{f}>(", f"a[{i}] = (")
                   for f in ("FMT", "INT4") for i in range(4)],
}
# name: the plan's change (plan, m, n, k, capacity) -> plan
PLANS = {"splits_1": _splits(1), "splits_2": _splits(2),
         "splits_4": _splits(4), "splits_8": _splits(8),
         "tile_128x128": _large_tiles((128, 128)),
         "tile_256x128": _large_tiles((256, 128)),
         "tile_256x64": _large_tiles((256, 64))}
TIMING_ONLY = ("no_convert", "no_wgmma", "no_epilogue",
               "no_mainloop", "local_reduce", "no_partial_write", "x2_wgmma",
               "no_fence")
SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))
ROWS = (8, 256, 4096)
FORMATS = {"weight_only_int8": 0, "weight_only_int4": 1, "weight_only_fp8": 2}


def _bind(lib):
    fn = lib.ptt_weight_only_gemm_wgmma
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ptt_weight_only_gemm_clusters.argtypes = \
        [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    lib.ptt_weight_only_gemm_clusters.restype = ctypes.c_int
    return lib


def _capacity(lib, fmt):
    memo = {}

    def cap(tn, tc, splits):
        if (tn, tc, splits) not in memo:
            out = ctypes.c_int(0)
            err = lib.ptt_weight_only_gemm_clusters(fmt, tn, tc, splits,
                                                    ctypes.byref(out))
            if err:
                raise RuntimeError(f"cluster query failed: {err}")
            memo[tn, tc, splits] = out.value * splits
        return memo[tn, tc, splits]
    return cap


def _call(lib, fmt, plan):
    def run(x, q, s):
        y = torch.empty(x.shape[0], q.shape[0], dtype=x.dtype,
                        device=x.device)
        err = lib.ptt_weight_only_gemm_wgmma(
            x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
            x.shape[0], q.shape[0], x.shape[1], fmt, q.shape[1],
            plan.token_tile, plan.channel_tile, plan.splits,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")
        return y
    return run


def main(names):
    if not torch.cuda.is_available():
        print("quant_gemm_variants: no CUDA device", file=sys.stderr)
        return 2
    names = names or list(VARIANTS)
    # a variant that changes only the plan runs on the source as it is
    texts = {n: VARIANTS[n] for n in names if VARIANTS[n]}
    texts["as_is"] = []
    built = {name: _bind(ctypes.CDLL(str(path))) for name, path in
             _build.build_variants("weight_only_gemm", texts).items()}
    libs = {n: built[n if VARIANTS[n] else "as_is"] for n in names
            if (n if VARIANTS[n] else "as_is") in built}
    card = S._card_line()
    print(f"card [{card}]", flush=True)
    for algo, fmt in FORMATS.items():       # the plan's capacity input
        cap = _capacity(built["as_is"], fmt)
        tiles = [(tn, QM.CHANNEL_TILE) for tn in QM.TOKEN_TILES] + [(256, 64)]
        print(f"as_is {algo[12:]}: clusters of s blocks held at once "
              + ", ".join(f"tile {tn}x{tc}: " + " ".join(
                  f"{s}:{cap(tn, tc, s) // s}"
                  for s in range(1, QM.MAX_SPLITS + 1)) for tn, tc in tiles),
              flush=True)
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
                sm80_ms, _ = S._rotated_ms(torch, QM.weight_only_gemm_sm80,
                                           (x, q, s), wbytes)
                cells = []
                for name, lib in libs.items():
                    cap = _capacity(lib, fmt)
                    plan = QM.weight_only_gemm_plan(m, n, k, cap)
                    if name in PLANS:
                        plan = PLANS[name](plan, m, n, k, cap)
                    run = _call(lib, fmt, plan)
                    if name not in TIMING_ONLY:
                        S._check_rows(f"{name} {algo[12:]} {k}x{n} M={m}",
                                      run(x, q, s), want, 2)
                    ms, _ = S._rotated_ms(torch, run, (x, q, s), wbytes)
                    cells.append(f"{name} {ms:.4f} (tile {plan.token_tile}"
                                 f"x{plan.channel_tile}, {plan.splits} "
                                 f"splits)")
                print(f"{k}x{n} {algo[12:]} M={m}: ms " + ", ".join(cells)
                      + f"; sm80 {sm80_ms:.4f}; bound {bound:.4f} ({by}); "
                      f"torch.matmul bf16 {lib_ms:.4f} [{card}]", flush=True)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        reduced
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
