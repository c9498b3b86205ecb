"""Time variants of the recurrence's kernels side by side on one GPU.

    python3 paddle_tpu_torch/tools/rnn_variants.py [NAME ...]

A variant (``VARIANTS`` below, all of them by default) is
``csrc/rnn_recurrence.cu`` with some text replaced, built by
``kernels._build.build_variants``. Each runs the forward of the IWSLT'15
model's shapes, fp32: one LSTM layer [T 50, B 128, H 512] on the
persistent kernel, and the beam step (T 1, B 1280) and the decoder cell
(T 1, B 128) on the step kernel with each row tile (64, 32 rows a
block); and the backward of the three on ``rnn_backward_plan``'s routes
(the layer and the cell persistent, the beam step the step route). Each
is timed by graph
replay in turns (every variant, then every variant again in reverse
order; both times are printed). Variants marked "timing only" remove
work and give wrong outputs: they say what the removed part costs. The
others are held to the plain loop (1e-5 of the largest value forward,
1e-4 backward). Compare variants only within one run: two runs may land
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
    # timing only, the backward's persistent kernel: no barrier; no
    # product; no partials stored; none read back
    "bwd_no_barrier": [("group_barrier(row_counter, (unsigned)(step + 1) * nbx);",
                        "__syncthreads();")],
    "bwd_no_product": [("  for (int k = 0; k < D; ++k) {",
                        "  for (int k = 0; k < 0; ++k) {")],
    "bwd_no_stores": [("          __stcg(reinterpret_cast<float4*>(pp + ",
                       "          if (0) __stcg(reinterpret_cast<float4*>(pp + ")],
    "bwd_no_reduce": [("for (int x0 = lo; x0 < hi; x0 += 8) {",
                       "for (int x0 = lo; x0 < lo; x0 += 8) {")],
    # the persistent backward's product loop unrolled 4 deep (as built: 16)
    "bwd_unroll_4": [("#pragma unroll 16\n  for (int k = 0; k < D; ++k) {",
                      "#pragma unroll 4\n  for (int k = 0; k < D; ++k) {")],
    # timing only: the backward's step product without its FMAs
    "step_no_fma": [("    for (int k = wk * KW; k < wk * KW + KW; k += 4) {",
                     "    for (int k = wk * KW; k < wk * KW; k += 4) {")],
    # timing only: the step product's loads and FMAs, no epilogue (the
    # accumulators kept alive by a store that never runs); no product
    # launch at all (the gates kernel alone)
    "step_no_epilogue": [("  // the depth warps' sums, red[wk][row][column], added in warp order",
                          "  if (B < 0) dh_out[tid] = acc[0][0] + acc[7][7];\n  return;\n"
                          "  // the depth warps' sums, red[wk][row][column], added in warp order")],
    "gates_only": [("    product<<<grid, F_THREADS, smem, s>>>(",
                    "    if (0) product<<<grid, F_THREADS, smem, s>>>(")],
}
_SHAPES = (("lstm layer", 50, 128, "persistent", 1),
           ("beam step", 1, 1280, "step", 2), ("beam step", 1, 1280, "step", 1),
           ("decoder cell", 1, 128, "step", 1))
_BROKEN = ("no_grid_barrier", "no_fma", "step_no_loads", "bwd_no_barrier",
           "bwd_no_product", "bwd_no_stores", "bwd_no_reduce", "step_no_fma",
           "step_no_epilogue", "gates_only")
# the backward's shapes: (tag, T, B)
_BWD_SHAPES = (("lstm layer bwd", 50, 128), ("decoder cell bwd", 1, 128),
               ("beam step bwd", 1, 1280))


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


def _call_bwd(lib, xw, h0, c0, w, fwd, dy):
    """The backward on ``rnn_backward_plan``'s route through ``lib``, from
    the forward ``fwd`` (``R.rnn_forward``'s outputs): (dxw, dh0, dc0)."""
    T, B, GH = xw.shape
    H = GH // 4
    y, _, _, saved, cs = fwd
    plan = R.rnn_backward_plan("lstm", T, B, H,
                               torch.cuda.get_device_properties(0)
                               .multi_processor_count)
    f32 = dict(dtype=torch.float32, device="cuda")
    dxw = torch.empty(T, B, GH, **f32)
    dh0, dc0 = torch.empty(B, H, **f32), torch.empty(B, H, **f32)
    persistent = plan.route == "persistent"
    if persistent:
        scratch = torch.empty(2 * plan.grid[0] * plan.grid[1] * 32
                              * (-(-H // 128) * 128), **f32)
        ctr = torch.zeros(plan.grid[1], dtype=torch.int32, device="cuda")
    else:
        scratch, ctr = torch.empty(4, B, H, **f32), None
    err = lib.ptt_rnn_backward(
        0, dy.data_ptr(), None, None, saved.data_ptr(), cs.data_ptr(),
        h0.data_ptr(), c0.data_ptr(), y.data_ptr(), w.data_ptr(),
        dxw.data_ptr(), None, scratch.data_ptr(), dh0.data_ptr(),
        dc0.data_ptr(), None if ctr is None else ctr.data_ptr(), T, B, H, 0,
        int(persistent), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"backward launch failed: {err}")
    return dxw, dh0, dc0


def _bwd_want(xw, h0, c0, w, dy):
    """The plain loop's gradients of xw, h0 and c0 from dy."""
    leaves = [t.clone().requires_grad_() for t in (xw, h0, c0)]
    y = R.rnn_scan_plain("lstm", *leaves, w)[0]
    return torch.autograd.grad(y, leaves, dy)


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
    bwd = {}
    for tag, T, B in _BWD_SHAPES:
        xw, h0, c0, w = _inputs(T, B, seed=1)
        dy = torch.randn(T, B, 512, device="cuda")
        fwd = R.rnn_forward("lstm", xw, h0, c0, w)
        bwd[tag] = (xw, h0, c0, w, fwd, dy)
        want = _bwd_want(xw, h0, c0, w, dy)
        for name, lib in libs.items():
            if name in _BROKEN:
                continue
            got = _call_bwd(lib, xw, h0, c0, w, fwd, dy)
            err = max(float((a - b).abs().max()) / max(1.0, float(
                b.abs().max())) for a, b in zip(got, want))
            if err > 1e-4:
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
            for tag, T, B in _BWD_SHAPES:
                args = bwd[tag]
                ms = S._graph_ms(lambda: _call_bwd(libs[name], *args),
                                 iters=3 if T > 1 else 20, reps=3)
                times.setdefault((name, tag, "backward", 0), []).append(ms)
    for (name, tag, route, wm), ms in times.items():
        T = next(s[1] for s in _SHAPES + _BWD_SHAPES if s[0] == tag)
        rows = f"rows {32 * wm:3d}" if wm else "plan's"
        print(f"{name:18s} {tag:16s} {route:10s} {rows}: "
              + " / ".join(f"{m:.4f}" for m in ms) + f" ms ({ms[0] / T * 1e3:.2f}"
              f" us a step){' [timing only]' if name in _BROKEN else ''} "
              f"[{card}]", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or list(VARIANTS))
