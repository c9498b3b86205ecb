"""Time variants of BatchNorm's cluster forward kernel side by side on one
GPU.

    python3 paddle_tpu_torch/tools/batch_norm_fwd_variants.py [NAME ...]

A variant (``VARIANTS`` below, all of them by default) is
``csrc/batch_norm_fwd.cu`` with some text replaced, built by
``kernels._build.build_variants``. Each runs the training forward at
ResNet-50's shapes in bf16 under amp O1's dtypes (fp32 weights, residual
and output): [128, 2048, 7, 7] +residual +ReLU and alone, [128, 1024,
14, 14] +residual +ReLU, [128, 512, 28, 28] +ReLU and [128, 256, 56, 56]
+residual +ReLU, at the blocks a cluster of ``LAYOUTS``, timed by graph
replay in turns (every variant and layout, then all again in reverse
order; both times are printed) beside the bytes bound and the Triton
kernels (``batch_norm._triton_forward``). Each is held to the Triton
kernels: y and the saved (mean, rstd) within 2e-5 of their largest value.
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
    # four 512-thread blocks an SM (at most 32 registers a thread)
    "four_blocks": [("__launch_bounds__(THREADS, 2)", "__launch_bounds__(THREADS, 4)")],
    # 256 threads a block, up to eight blocks an SM
    "threads_256": [("constexpr int THREADS = 512;", "constexpr int THREADS = 256;"),
                    ("__launch_bounds__(THREADS, 2)", "__launch_bounds__(THREADS, 8)")],
    # one element an access: 16 residual loads in flight a thread
    "unroll_y_16": [("UY = VEC == 1 ? 8 : 2;", "UY = VEC == 1 ? 16 : 2;")],
}
# (shape, residual, ReLU) -> [blocks a cluster, ...]
LAYOUTS = {
    ((128, 2048, 7, 7), True, True): [1],
    ((128, 2048, 7, 7), False, False): [1],
    ((128, 1024, 14, 14), True, True): [1, 2],
    ((128, 512, 28, 28), False, True): [2, 4],
    ((128, 256, 56, 56), True, True): [8],
}


def _load(path):
    lib = ctypes.CDLL(str(path))
    lib.ptt_batch_norm_fwd.argtypes = [ctypes.c_void_p] * 8 \
        + [ctypes.c_int] * 4 + [ctypes.c_float] * 3 + [ctypes.c_int] * 10 \
        + [ctypes.c_void_p]
    lib.ptt_batch_norm_fwd.restype = ctypes.c_int
    return lib


def _inputs(shape, res, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[1]
    x = (3 + 2 * torch.randn(*shape, device="cuda", generator=g)).to(
        torch.bfloat16)
    w = 1 + 0.2 * torch.randn(c, device="cuda", generator=g)
    b = 0.2 * torch.randn(c, device="cuda", generator=g)
    r = torch.randn(*shape, device="cuda", generator=g) if res else None
    return x, w, b, r


def _call(lib, x, w, b, r, relu, cs):
    n, c = x.shape[:2]
    s = x.numel() // (n * c)
    y = torch.empty(x.shape, device="cuda")
    st = torch.empty(2, c, device="cuda")
    rm, rv = torch.zeros(c, device="cuda"), torch.ones(c, device="cuda")
    err = lib.ptt_batch_norm_fwd(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), rm.data_ptr(),
        rv.data_ptr(), None if r is None else r.data_ptr(), y.data_ptr(),
        st.data_ptr(), n, c, s, cs, 1e-5, 0.9, 0.1, 1, 0, 0, 0, 0, 0, 0,
        int(r is not None), int(relu), 0,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return y, st


def _triton(x, w, b, r, relu):
    c = x.shape[1]
    y = torch.empty(x.shape, device="cuda")
    st = torch.empty(2, c, device="cuda")
    rm, rv = torch.zeros(c, device="cuda"), torch.ones(c, device="cuda")
    BN._triton_forward(x, w, b, rm, rv, True, 0.9, 1e-5, False, r, relu,
                       False, y, st)
    return y, st


def main(names):
    card = S._card_line()
    libs = {n: _load(p) for n, p in _build.build_variants(
        "batch_norm_fwd", {n: VARIANTS[n] for n in names}).items()}
    cases = {k: _inputs(k[0], k[1]) for k in LAYOUTS}
    for name, lib in libs.items():
        for key, layouts in LAYOUTS.items():
            x, w, b, r = cases[key]
            want = _triton(x, w, b, r, key[2])
            for cs in layouts:
                got = _call(lib, x, w, b, r, key[2], cs)
                for i, (a, e) in enumerate(zip(got, want)):
                    if float((a - e).abs().max()) > 2e-5 * max(
                            1.0, float(e.abs().max())):
                        raise AssertionError(f"{name} {key} ({cs} blocks): "
                                             f"output {i} off Triton's")
    runs = [(n, k, lay) for n in libs for k, lays in LAYOUTS.items()
            for lay in lays]
    times = {}
    for seq in (runs, runs[::-1]):
        for name, key, cs in seq:
            x, w, b, r = cases[key]
            ms = S._graph_ms(lambda: _call(libs[name], x, w, b, r, key[2],
                                           cs), iters=10, reps=3)
            times.setdefault((name, key, cs), []).append(ms)
    for key in LAYOUTS:
        x, w, b, r = cases[key]
        bound, _ = S._bound(*S._bn_bytes_ops(x.numel(), 2, False, key[1],
                                             key[2]), S.FP32_FLOPS)
        tri = S._graph_ms(lambda: _triton(x, w, b, r, key[2]), iters=10,
                          reps=3)
        print(f"{key}: bound {bound:.4f} ms, Triton {tri:.4f} ms [{card}]",
              flush=True)
        for (name, k, cs), ms in times.items():
            if k == key:
                print(f"  {name:12s} {cs} blocks a channel: "
                      + " / ".join(f"{m:.4f}" for m in ms)
                      + f" ms ({bound / ms[0]:.3f} of the bound)", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or list(VARIANTS))
