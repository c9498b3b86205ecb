"""Time variants of the bf16 ragged attention kernels side by side on one GPU.

    python3 paddle_tpu_torch/tools/ragged_variants.py [NAME ...]

A variant (``VARIANTS`` below, all of them by default) is a set of text
replacements in ``csrc/ragged_attention_bf16.cu`` (a design choice undone
or changed; built with the port's nvcc flags into ``build/variants/``)
and of the settings of ``kernels/ragged_attention.py`` for its bf16
kernels: the keys of a split of a one-row tile (``KS_DECODE``) and of a
longer tile (``KS_PREFILL``), the stages of the TMA ring (``STAGES``) and
the blocks an SM (``BLOCKS_PER_SM``). Each is checked against the plain
version (one bf16 ulp of the largest value, invalid rows 0;
``TIMING_ONLY`` variants, which change what is computed, are not) and
timed by CUDA-graph replay at ``chip_smoke.py`` phase 3's ragged cases in
turns (every variant, then every variant again in reverse order; both
times are printed), with the device ms of each of its CUDA kernels from a
profile. Compare variants only within one run: two runs may land on two
cards.
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
from paddle_tpu_torch.kernels import ragged_attention as RA  # noqa: E402

LIB = "ragged_attention_bf16"
TIMING_ONLY = ("no_products",)
VARIANTS = {   # name: (source replacements, settings)
    "as_is": ([], {}),
    # timing only (its output is wrong): the consumers wait for each stage
    # and free it without computing, which times the loads alone
    "no_products": ([("      const uint32_t k_s = base + L.k + st * TILE, v_s = base + L.v + st * TILE;\n"
                      "      float s[ROWS / 2];",
                      "      if (st < 0) {\n"
                      "      const uint32_t k_s = base + L.k + st * TILE, v_s = base + L.v + st * TILE;\n"
                      "      float s[ROWS / 2];"),
                     ("      fence_regs(o);\n      const int is_last = last[st];",
                      "      fence_regs(o);\n      }\n      const int is_last = last[st];")],
                    {}),
    # the plan kernel with 256 threads instead of 512
    "plan_256_threads": ([("constexpr int PLAN_THREADS = 512;",
                           "constexpr int PLAN_THREADS = 256;")], {}),
    # splits of a one-row tile: one stage, four stages
    "ks_decode_64": ([], dict(KS_DECODE=64)),
    "ks_decode_256": ([], dict(KS_DECODE=256)),
    # splits of a chunk tile: half, twice
    "ks_prefill_256": ([], dict(KS_PREFILL=256)),
    "ks_prefill_1024": ([], dict(KS_PREFILL=1024)),
    # one block an SM with a deeper ring
    "one_block_4_stages": ([], dict(BLOCKS_PER_SM=1, STAGES={128: 4, 64: 6})),
}


def build(names):
    """{name: loaded library} of every variant; source variants compiled in
    parallel, the others sharing the port's own build."""
    built = _build.build_variants(
        LIB, {n: VARIANTS[n][0] for n in names if VARIANTS[n][0]})
    libs = {}
    for name in names:
        if not VARIANTS[name][0]:
            libs[name] = _build.library(LIB)
        elif name in built:
            libs[name] = ctypes.CDLL(str(built[name]))
        else:
            raise RuntimeError(f"variant {name} did not build")
    return libs

def main(argv=None):
    names = list(argv if argv is not None else sys.argv[1:]) or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: "
                         f"{list(VARIANTS)}")
    if not torch.cuda.is_available():
        raise SystemExit("ragged_variants: no CUDA device")
    card = S._card_line()
    built = _build.build_all()
    for line in built[LIB]["log"].splitlines():
        if any(w in line for w in ("registers", "spill")):
            print(f"  ptxas: {line.strip()}")
    libs = build(names)
    dev = torch.device("cuda")

    defaults = {k: getattr(RA, k) for k in
                ("KS_DECODE", "KS_PREFILL", "STAGES", "BLOCKS_PER_SM")}

    def run(name, args, rep):
        _build._loaded[LIB] = libs[name]
        for k, v in {**defaults, **VARIANTS[name][1]}.items():
            setattr(RA, k, v)
        try:
            return RA.ragged_attention(*args, rep=rep)
        finally:
            for k, v in defaults.items():
                setattr(RA, k, v)

    times = {}
    for i, (case, spec) in enumerate(S.RAGGED_CASES.items()):
        args, rep, nbytes, flops = S._ragged_case(
            torch, dev, budget=S.RAGGED_BUDGET, seed=10 + i, **spec)
        want = RA.ragged_attention_plain(*args, rep=rep)
        tol = S.ULP_BF16 * float(want.float().abs().max())
        bound_ms, _ = S._bound(nbytes, flops, S.BF16_FLOPS)
        for name in names:
            got = run(name, args, rep)
            torch.cuda.synchronize()
            if name in TIMING_ONLY:
                continue
            err = float((got.float() - want.float()).abs().max())
            if not err <= tol or got[~args[-1]].any():
                raise AssertionError(f"{name} [{case}]: {err} > {tol} or an "
                                     f"invalid row is not 0")
        for name in names + names[::-1]:
            times.setdefault((case, name), []).append(
                S._graph_ms(lambda: run(name, args, rep)))
        for name in names:
            a, b = times[(case, name)]
            parts = S._kernels_a_call(torch, lambda: run(name, args, rep))
            print(f"{case:10s} {name:20s} ms {a:.4f} / {b:.4f} (bound "
                  f"{bound_ms:.4f}) kernels {parts} [{card}]", flush=True)
        del args, want
        torch.cuda.empty_cache()
    _build._loaded[LIB] = libs.get("as_is") or _build.library(LIB)
    return 0


if __name__ == "__main__":
    sys.exit(main())
