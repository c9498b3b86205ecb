"""Time variants of the recurrence's forward kernels side by side on one
GPU.

    python3 paddle_tpu_torch/tools/rnn_variants.py [NAME ...]

A variant (``VARIANTS`` below, all of them by default) is
``csrc/rnn_recurrence.cu`` with some text replaced, built by
``kernels._build.build_variants``. Each runs the forward of the IWSLT'15
model's shapes, fp32: one LSTM layer [T 50, B 128, H 512] on the
persistent kernel, and the beam step (T 1, B 1280) and the decoder cell
(T 1, B 128) on the step kernel with each row tile (64, 32 rows a
block), timed by graph replay in turns (every variant, then every variant
again in reverse order; both times are printed). Variants marked
"timing only" remove work and give wrong outputs: they say what the
removed part costs. The others are held to the plain loop (1e-5 of the
largest value). Compare variants only within one run: two runs may land
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
from paddle_tpu_torch.kernels import rnn as R  # noqa: E402

_STEP_FMA = ("    warp_fma<G>(acc, st + wm * F_ROWS * LD",
             "    if (0) warp_fma<G>(acc, st + wm * F_ROWS * LD")
_STEP_BOUNDS = ("__global__ void __launch_bounds__(F_THREADS, 1)\nrnn_fwd_step_kernel",
                "__global__ void __launch_bounds__(F_THREADS, 2)\nrnn_fwd_step_kernel")
VARIANTS = {   # name: [(old, new), ...]; "timing only" where outputs break
    "as_is": [],
    # timing only: the persistent kernel's barrier a block barrier
    "no_grid_barrier": [("group_barrier(group_counter, (unsigned)(step + 1) * gridDim.x);",
                         "__syncthreads();")],
    # the barrier over the whole grid instead of a row group
    "grid_barrier": [("group_barrier(group_counter, (unsigned)(step + 1) * gridDim.x);",
                      "group_barrier(counter, (unsigned)(step + 1) * gridDim.x * gridDim.y);")],
    # timing only: no recurrent product (the loads and the epilogue stay)
    "no_fma": [("      warp_fma<G>(acc, hs, ld, ws, ld, kb",
                "      if (0) warp_fma<G>(acc, hs, ld, ws, ld, kb"), _STEP_FMA],
    # timing only: the step kernel loads only its first stages
    "step_no_loads": [("    if (s + NS - 1 < ns) load(s + NS - 1);", "")],
    "h_parts_1": [("constexpr int H_PARTS = 2;", "constexpr int H_PARTS = 1;")],
    # two step-kernel blocks an SM (at most 128 registers a thread)
    "step_two_blocks": [_STEP_BOUNDS],
    # and the FMA loop not unrolled (fewer registers)
    "step_two_blocks_unroll_1": [_STEP_BOUNDS, (
        "#pragma unroll 2\n  for (int k = k0; k < k1; k += 4) {",
        "#pragma unroll 1\n  for (int k = k0; k < k1; k += 4) {")],
}
_SHAPES = (("lstm layer", 50, 128, "persistent", 1),
           ("beam step", 1, 1280, "step", 2), ("beam step", 1, 1280, "step", 1),
           ("decoder cell", 1, 128, "step", 1))
_BROKEN = ("no_grid_barrier", "no_fma", "step_no_loads")


def _load(path):
    lib = ctypes.CDLL(str(path))
    for fn, args in R._SIGS.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _inputs(T, B, H=512, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    xw = torch.randn(T, B, 4 * H, device="cuda", generator=g)
    h0 = torch.randn(B, H, device="cuda", generator=g) * 0.5
    c0 = torch.randn(B, H, device="cuda", generator=g) * 0.5
    w = (torch.rand(4 * H, H, device="cuda", generator=g) * 2 - 1) * H ** -0.5
    return xw, h0, c0, w


def _call(lib, xw, h0, c0, w, route, wm):
    T, B, GH = xw.shape
    H = GH // 4
    f32 = dict(dtype=torch.float32, device="cuda")
    y, cs = torch.empty(T, B, H, **f32), torch.empty(T, B, H, **f32)
    saved = torch.empty(T, B, 4 * H, **f32)
    hT, cT = torch.empty(B, H, **f32), torch.empty(B, H, **f32)
    ctr = torch.zeros(-(-B // 32), dtype=torch.int32, device="cuda")
    err = lib.ptt_rnn_forward(0, xw.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                              w.data_ptr(), None, y.data_ptr(), cs.data_ptr(),
                              saved.data_ptr(), hT.data_ptr(), cT.data_ptr(),
                              ctr.data_ptr(), T, B, H, 0,
                              int(route == "persistent"), wm,
                              torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return y, hT, cT


def main(names):
    card = S._card_line()
    libs = {n: _load(p) for n, p in _build.build_variants(
        "rnn_recurrence", {n: VARIANTS[n] for n in names}).items()}
    inputs = {T * 10000 + B: _inputs(T, B) for _, T, B, _, _ in _SHAPES}
    for name, lib in libs.items():
        if name in _BROKEN:
            continue
        for tag, T, B, route, wm in _SHAPES:
            xw, h0, c0, w = inputs[T * 10000 + B]
            got = _call(lib, xw, h0, c0, w, route, wm)
            want = R.rnn_scan_plain("lstm", xw, h0, c0, w)
            err = max(float((a - b).abs().max()) / max(1.0, float(
                b.abs().max())) for a, b in zip(got, want))
            if err > 1e-5:
                raise AssertionError(f"{name} {tag}: {err:.3g} off the plain "
                                     f"loop")
    order = list(libs)
    times = {}
    for turn, seq in enumerate((order, order[::-1])):
        for name in seq:
            for tag, T, B, route, wm in _SHAPES:
                xw, h0, c0, w = inputs[T * 10000 + B]
                ms = S._graph_ms(lambda: _call(libs[name], xw, h0, c0, w,
                                               route, wm),
                                 iters=3 if T > 1 else 20, reps=3)
                times.setdefault((name, tag, route, wm), []).append(ms)
    for (name, tag, route, wm), ms in times.items():
        T = next(s[1] for s in _SHAPES if s[0] == tag)
        print(f"{name:18s} {tag:12s} {route:10s} rows {32 * wm:3d}: "
              + " / ".join(f"{m:.4f}" for m in ms) + f" ms ({ms[0] / T * 1e3:.2f}"
              f" us a step){' [timing only]' if name in _BROKEN else ''} "
              f"[{card}]", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or list(VARIANTS))
