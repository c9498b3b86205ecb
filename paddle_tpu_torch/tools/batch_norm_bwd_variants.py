"""Time variants of BatchNorm's cluster backward kernel side by side on one
GPU.

    python3 paddle_tpu_torch/tools/batch_norm_bwd_variants.py [NAME ...]

A variant (``VARIANTS`` below, all of them by default) is
``csrc/batch_norm_bwd.cu`` with some text replaced, built by
``kernels._build.build_variants``. Each runs the backward at ResNet-50's
short-run shapes in bf16 under amp O1's dtypes (fp32 dy, output and
residual): [128, 2048, 7, 7] +residual +ReLU, [128, 1024, 14, 14]
+residual +ReLU, [128, 512, 28, 28] +ReLU, at each cluster size of
``LAYOUTS`` (blocks a cluster, a cluster a channel), timed by graph replay in turns
(every variant and layout, then all again in reverse order; both times
are printed) beside the bytes bound. Each is held to the two-pass Triton
backward (dx within two bf16 ulps of its largest value, the rest 1e-5).
Compare variants only within one run: two runs may land on two cards.
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
from paddle_tpu_torch.kernels import batch_norm as BN  # noqa: E402

VARIANTS = {   # name: [(old, new), ...]
    "as_is": [],
    "unroll_8": [("constexpr int UNROLL = 4;", "constexpr int UNROLL = 8;")],
    # 256 threads a block, up to four blocks an SM
    "threads_256": [("constexpr int THREADS = 512;", "constexpr int THREADS = 256;"),
                    ("__launch_bounds__(THREADS, 2)", "__launch_bounds__(THREADS, 4)")],
    # three 512-thread blocks an SM (at most 40 registers a thread)
    "three_blocks": [("__launch_bounds__(THREADS, 2)", "__launch_bounds__(THREADS, 3)")],
}
# (shape, residual, ReLU) -> [blocks a cluster, ...]
LAYOUTS = {
    ((128, 2048, 7, 7), True, True): [1],
    ((128, 2048, 7, 7), False, False): [1],
    ((128, 1024, 14, 14), True, True): [2, 4],
    ((128, 512, 28, 28), False, True): [8, 4],
}


def _load(path):
    lib = ctypes.CDLL(str(path))
    lib.ptt_batch_norm_bwd.argtypes = [ctypes.c_void_p] * 8 \
        + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    lib.ptt_batch_norm_bwd.restype = ctypes.c_int
    return lib


def _inputs(shape, res, relu, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[1]
    x = (3 + 2 * torch.randn(*shape, device="cuda", generator=g)).to(
        torch.bfloat16)
    w = 1 + 0.2 * torch.randn(c, device="cuda", generator=g)
    b = 0.2 * torch.randn(c, device="cuda", generator=g)
    r = torch.randn(*shape, device="cuda", generator=g) if res else None
    dy = torch.randn(*shape, device="cuda", generator=g)
    rm, rv = torch.zeros(c, device="cuda"), torch.ones(c, device="cuda")
    y, st = BN.batch_norm_forward(x, w, b, rm, rv, True, 0.9, 1e-5, False, r,
                                  relu, False, torch.float32)
    return x, w, st, dy, y


def _call(lib, x, w, st, dy, y, res, relu, cs):
    n, c = x.shape[:2]
    s = x.numel() // (n * c)
    dx = torch.empty_like(x)
    dres = torch.empty(x.shape, device="cuda") if res else None
    sums = torch.empty(2, c, device="cuda")
    err = lib.ptt_batch_norm_bwd(
        x.data_ptr(), dy.data_ptr(), y.data_ptr(), st.data_ptr(), w.data_ptr(),
        dx.data_ptr(), None if dres is None else dres.data_ptr(),
        sums.data_ptr(), n, c, s, cs, 1, 0, 0, 0, 0, int(relu), 0,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return dx, dres, sums[0], sums[1]


def _two_pass(x, w, st, dy, y, res, relu):
    """The two Triton kernels' (dx, dresidual, dweight, dbias)."""
    dx = torch.empty_like(x)
    dres = torch.empty(x.shape, device="cuda") if res else None
    sums = torch.zeros(2, x.shape[1], device="cuda")
    BN._two_pass_backward(x, w, st, dy, y, True, False, relu, False, dx, dres,
                          sums)
    return dx, dres, sums[0], sums[1]


def main(names):
    card = S._card_line()
    libs = {n: _load(p) for n, p in _build.build_variants(
        "batch_norm_bwd", {n: VARIANTS[n] for n in names}).items()}
    cases = {k: _inputs(*k) for k in LAYOUTS}
    for name, lib in libs.items():
        for key, layouts in LAYOUTS.items():
            x, w, st, dy, y = cases[key]
            want = _two_pass(x, w, st, dy, y, key[1], key[2])
            for cs in layouts:
                got = _call(lib, x, w, st, dy, y, key[1], key[2], cs)
                for i, (a, b) in enumerate(zip(got, want)):
                    if a is None:
                        continue
                    tol = (2 * 2.0 ** -7 if i == 0 else 1e-5) * max(
                        1.0, float(b.float().abs().max()))
                    if float((a.float() - b.float()).abs().max()) > tol:
                        raise AssertionError(f"{name} {key} ({cs} blocks): "
                                             f"output {i} off the two-pass")
    runs = [(n, k, lay) for n in libs for k, lays in LAYOUTS.items()
            for lay in lays]
    times = {}
    for seq in (runs, runs[::-1]):
        for name, key, cs in seq:
            x, w, st, dy, y = cases[key]
            ms = S._graph_ms(lambda: _call(libs[name], x, w, st, dy, y,
                                           key[1], key[2], cs),
                             iters=10, reps=3)
            times.setdefault((name, key, cs), []).append(ms)
    for key in LAYOUTS:
        x, _, _, _, _ = cases[key]
        bound, _ = S._bound(*S._bn_bytes_ops(x.numel(), 2, True, key[1],
                                             key[2]), S.FP32_FLOPS)
        two = S._graph_ms(lambda: _two_pass(*cases[key], key[1], key[2]),
                          iters=10, reps=3)
        print(f"{key}: bound {bound:.4f} ms, two-pass Triton {two:.4f} ms "
              f"[{card}]", flush=True)
        for (name, k, cs), ms in times.items():
            if k == key:
                print(f"  {name:12s} {cs} blocks a channel: "
                      + " / ".join(f"{m:.4f}" for m in ms)
                      + f" ms ({bound / min(ms):.3f} of the bound)",
                      flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or list(VARIANTS))
