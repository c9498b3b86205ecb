"""Build variants of the grouped-matmul source and time them on one GPU.

    python3 paddle_tpu_torch/tools/gmm_variants.py [NAME ...]

Each variant (``VARIANTS`` below, all of them by default) is
``csrc/gmm.cu`` with some text replaced: a design choice of the bf16
kernels undone or changed. Each is built with the port's nvcc flags into
``build/variants/`` (its ptxas spill lines printed), checked against the
plain versions (every row within 2 bf16 ulps, rows past the groups and
empty groups' dw exactly 0) and timed by CUDA-graph replay at the GPT-MoE
slice's six products (``chip_smoke.py`` phase 3's inputs, the model's
routing) and at its skewed routing, with ``torch._grouped_mm`` timed
beside them as the yardstick. Compare variants only within one run: two
runs may land on two cards.
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
from paddle_tpu_torch.kernels import gmm as PG  # noqa: E402

VARIANTS = {
    "as_is": [],
    # no clusters: each block loads all of B itself
    "no_cluster": [("constexpr int CLUSTER = 2;", "constexpr int CLUSTER = 1;")],
    # one cluster a work item (no persistent loop over tiles)
    "one_item_a_cluster": [("std::min(work, clusters)", "work")],
    # every wgmma batch waited for before the next is issued
    "wait_each_batch": [("wgmma_wait<1>();", "wgmma_wait<0>();")],
    # gmm in 128 x 192 tiles, 4 stages
    "gmm_n192": [("constexpr int GMM_BN = 256;", "constexpr int GMM_BN = 192;"),
                 ("Ring<GMM_BN, 3,", "Ring<GMM_BN, 4,")],
    # tgmm in 128 x 256 tiles, 4 stages, or 128 x 128, 6 stages
    "tgmm_n256": [("TGMM_BN = 192;", "TGMM_BN = 256;"),
                  ("Ring<TGMM_BN, 5, 0, 0>", "Ring<TGMM_BN, 4, 0, 0>")],
    "tgmm_n128": [("TGMM_BN = 192;", "TGMM_BN = 128;"),
                  ("Ring<TGMM_BN, 5, 0, 0>", "Ring<TGMM_BN, 6, 0, 0>")],
}


def launcher(lib, kind, a, b, gs):
    """(call, out) of one product of ``lib`` on these tensors: "gmm", "gmm_t"
    (trans_w) or "tgmm"."""
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.ptt_gmm.argtypes = [ptr] * 4 + [i] * 6 + [ptr]
    lib.ptt_tgmm.argtypes = [ptr] * 4 + [i] * 5 + [ptr]
    off = PG._offsets(gs)
    t, k = a.shape
    e = gs.shape[0]
    if kind == "tgmm":
        n = b.shape[1]
        out = torch.empty(e, k, n, dtype=torch.float32, device=a.device)
        args = (a.data_ptr(), b.data_ptr(), off.data_ptr(), out.data_ptr(),
                t, k, n, e, 1)
        fn = lib.ptt_tgmm
    else:
        n = b.shape[1] if kind == "gmm_t" else b.shape[2]
        out = torch.empty(t, n, dtype=a.dtype, device=a.device)
        args = (a.data_ptr(), b.data_ptr(), off.data_ptr(), out.data_ptr(),
                t, k, n, e, 1, int(kind == "gmm_t"))
        fn = lib.ptt_gmm

    def call():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")
    call.off = off          # kept alive with the call
    return call, out


def cases(dev):
    """[(name, kind, a, b, group sizes)]: the slice's six products and the
    skewed routing's three, bf16."""
    xs, w1, w2, hs, dy1, dy2, gs = S._gmm_slice_inputs(torch, dev, 40)
    out = [("fwd_w1", "gmm", xs, w1, gs), ("fwd_w2", "gmm", hs, w2, gs),
           ("dx_w1", "gmm_t", dy1, w1, gs), ("dx_w2", "gmm_t", dy2, w2, gs),
           ("dw_w1", "tgmm", xs, dy1, gs), ("dw_w2", "tgmm", hs, dy2, gs)]
    g = torch.Generator(device=dev).manual_seed(41)
    bf = torch.bfloat16
    skew = torch.tensor([1, 1, 1, 1, 0, 2048, 3, 1945], dtype=torch.int32,
                        device=dev)
    x = torch.randn(4096, 768, device=dev, generator=g).to(bf)
    w = (0.03 * torch.randn(8, 768, 3072, device=dev, generator=g)).to(bf)
    dy = torch.randn(4096, 3072, device=dev, generator=g).to(bf)
    out += [("skew_fwd", "gmm", x, w, skew), ("skew_dx", "gmm_t", dy, w, skew),
            ("skew_dw", "tgmm", x, dy, skew)]
    return out


def main(argv=None):
    names = (sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: "
                         f"{list(VARIANTS)}")
    if not torch.cuda.is_available():
        raise SystemExit("gmm_variants: no CUDA device")
    print(S._card_line(), flush=True)
    built = _build.build_variants("gmm", {n: VARIANTS[n] for n in names})
    dev = torch.device("cuda")
    todo = cases(dev)
    wants = []
    for name, kind, a, b, gs in todo:
        if kind == "tgmm":
            want = PG.tgmm_plain(a, b, gs).to(a.dtype)
        else:
            want = PG.gmm_plain(a, b, gs, trans_w=kind == "gmm_t")
        lib_ms, _ = S._library_gmm(torch, a, b, gs.tolist(), kind)
        wants.append((want, lib_ms))
    print("TIME _grouped_mm: " + "; ".join(
        f"{c[0]} {w[1]:.4f}" for c, w in zip(todo, wants)), flush=True)
    for name, path in built.items():
        lib = ctypes.CDLL(str(path))
        times = []
        for (case, kind, a, b, gs), (want, _) in zip(todo, wants):
            call, out = launcher(lib, kind, a, b, gs)
            call()
            torch.cuda.synchronize()
            sizes = gs.tolist()
            got = out.to(a.dtype) if kind == "tgmm" else out
            S._check_rows(f"{name} {case}", got, want, 2)
            if kind != "tgmm" and out[sum(sizes):].any():
                raise AssertionError(f"{name} {case}: rows past the groups")
            if kind == "tgmm" and any(bool(out[j].any())
                                      for j, s in enumerate(sizes) if not s):
                raise AssertionError(f"{name} {case}: an empty group's dw")
            times.append(S._graph_ms(call, iters=5, reps=3))
        print(f"TIME {name}: " + "; ".join(
            f"{c[0]} {ms:.4f}" for c, ms in zip(todo, times)), flush=True)


if __name__ == "__main__":
    main()
