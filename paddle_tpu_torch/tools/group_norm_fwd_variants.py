"""Time variants of GroupNorm's cluster forward kernel side by side on one
GPU.

    python3 paddle_tpu_torch/tools/group_norm_fwd_variants.py [NAME ...]

A variant (``VARIANTS`` below, all of them by default) is
``csrc/group_norm_fwd.cu`` with some text replaced, built by
``kernels._build.build_variants``. Each runs the forward at the UNet's
bf16 shapes (batch 4, G 32) in ``LAYOUTS`` (with and without the SiLU, at
the cluster sizes listed), timed by graph replay in turns (every variant
and layout, then all again in reverse order; both times are printed)
beside the Triton kernels (``group_norm._triton_forward``). Variants
marked timing only skip work and are not checked; the others are held to
the Triton kernels: y within one bf16 ulp of each row's largest value (two
with the SiLU). Compare variants only within one run: two runs may land
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
from paddle_tpu_torch.kernels import group_norm as GN  # noqa: E402

_OUT = "store8(yg + (int64_t)v * VEC * OB, f, ODT);"
_SRC = (_build.CSRC / "group_norm_fwd.cu").read_text()
# the statistics after the loads: the block's sums, the exchange, the merge
_STATS = _SRC[_SRC.index("  // the block's mean, then its values' squares"):
              _SRC.index("  const float mean = sums[10], rstd = sums[11];\n")
              + len("  const float mean = sums[10], rstd = sums[11];\n")]
# the kernel's load: TMA bulk copies, each chunk summed as it lands
_BULK = _SRC[_SRC.index("  __shared__ __align__(8) uint64_t bars[MAX_CHUNKS];"):
             _SRC.index("  // the block's mean, then its values' squares")]
# x by cp.async, 16 bytes a thread a vector, summed once all have landed
_CP_ASYNC = """  for (int v = tid; v < nv; v += THREADS) {
    const uint32_t d = smem_u32(xs + v);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(d), "l"(xg + v) : "memory");
  }
  asm volatile("cp.async.commit_group;\\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\\n" ::: "memory");
  float s1 = 0.f;
  for (int v = tid; v < nv; v += THREADS) {
    float f[VEC];
    unpack8(xs[v], xdt, f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) s1 += f[e];
  }
"""
VARIANTS = {   # name: [(old, new), ...]
    "as_is": [],
    # x by cp.async, a thread a vector at a time, summed once all landed
    "cp_async": [(_BULK, _CP_ASYNC)],
    # timing only: no statistics (mean 0, rstd 1)
    "no_stats": [(_STATS, "  const float mean = 0.f, rstd = 1.f;\n")],
    # timing only: y not written
    "no_output": [(_OUT, "if (f[0] == 1234.5f) " + _OUT)],
}
TIMING_ONLY = ("no_stats", "no_output")
# (channels, side, SiLU) -> [blocks a cluster, ...]
LAYOUTS = {
    (960, 64, True): [2, 4, 8],
    (960, 64, False): [2, 4, 8],
    (640, 64, True): [1, 2, 4],
    (320, 64, True): [1, 2],
    (1920, 32, False): [1, 2],
    (1280, 8, True): [1],
}


def _load(path):
    lib = ctypes.CDLL(str(path))
    lib.ptt_group_norm_fwd.argtypes = [ctypes.c_void_p] * 5 \
        + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    lib.ptt_group_norm_fwd.restype = ctypes.c_int
    return lib


def _inputs(c, side, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (3 + 2 * torch.randn(4, c, side, side, device="cuda",
                             generator=g)).bfloat16()
    w = (1 + 0.2 * torch.randn(c, device="cuda", generator=g)).bfloat16()
    b = (0.2 * torch.randn(c, device="cuda", generator=g)).bfloat16()
    return x, w, b


def _call(lib, x, w, b, silu, cs, y, st):
    n, c = x.shape[:2]
    s = x.numel() // (n * c)
    err = lib.ptt_group_norm_fwd(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), st.data_ptr(),
        n, c, 32, s, cs, GN._fwd_smem(c // 32, s, cs), 1e-5, 1, 1, 1, 1,
        int(silu), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {err}")


def main(names):
    card = S._card_line()
    libs = {n: _load(p) for n, p in _build.build_variants(
        "group_norm_fwd", {n: VARIANTS[n] for n in names}).items()}
    cases = {(c, side): _inputs(c, side) for c, side, _ in LAYOUTS}
    outs = {k: (torch.empty_like(v[0]), torch.empty(128, 2, device="cuda"))
            for k, v in cases.items()}
    for name, lib in libs.items():
        if name in TIMING_ONLY:
            continue
        for (c, side, silu), layouts in LAYOUTS.items():
            x, w, b = cases[(c, side)]
            want = torch.empty_like(x)
            GN._triton_forward(x, w, b, want, torch.empty(128, 2,
                                                          device="cuda"),
                               32, 1e-5, False, silu)
            for cs in layouts:
                y, st = outs[(c, side)]
                _call(lib, x, w, b, silu, cs, y, st)
                S._check_rows(f"{name} [4, {c}, {side}, {side}] cs {cs}", y,
                              want, 2 if silu else 1)
    runs = [(n, k, cs) for n in libs for k, lays in LAYOUTS.items()
            for cs in lays]
    times = {}
    for seq in (runs, runs[::-1]):
        for name, (c, side, silu), cs in seq:
            x, w, b = cases[(c, side)]
            y, st = outs[(c, side)]
            times.setdefault((name, c, side, silu, cs), []).append(
                S._graph_ms(lambda: _call(libs[name], x, w, b, silu, cs, y,
                                          st)))
    for (c, side, silu), layouts in LAYOUTS.items():
        x, w, b = cases[(c, side)]
        y, st = outs[(c, side)]
        tri = S._graph_ms(lambda: GN._triton_forward(x, w, b, y, st, 32, 1e-5,
                                                     False, silu))
        bound = S._bound(*S._gn_bytes_ops(x.numel(), 2, False, silu),
                         S.FP32_FLOPS)[0]
        print(f"[4, {c}, {side}, {side}]{' +SiLU' if silu else ''}: bound "
              f"{bound:.4f} ms, Triton {tri:.4f}; plan cs "
              f"{GN.group_norm_forward_plan(c // 32, side * side, False, torch.bfloat16).cs} "
              f"[{card}]", flush=True)
        for name in libs:
            print("  " + name + ("(timing only)" if name in TIMING_ONLY
                                 else "") + ": " + ", ".join(
                f"cs {cs} {t[0]:.4f} / {t[1]:.4f}" for cs in layouts
                for t in [times[(name, c, side, silu, cs)]]), flush=True)
    return 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("group_norm_fwd_variants: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1:] or list(VARIANTS)))
