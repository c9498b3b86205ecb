"""Time GroupNorm's cluster forward at every cluster size, and the dense
attention's CUDA forward middle at every row length it holds, beside the
Triton kernels they replace, on one GPU.

    python3 paddle_tpu_torch/tools/norm_fwd_plans.py

GroupNorm (``csrc/group_norm_fwd.cu``): at the UNet's bf16 shapes (batch 4,
G 32), with and without the SiLU, every cluster size whose block fits 227
KB, beside ``group_norm_forward_plan``'s and the two Triton kernels, and
the 61 calls of a UNet forward summed at the plan's sizes, at each shape's
fastest and on Triton.
X2's forward (``csrc/dense_softmax.cu``): at Transformer-base's rows and
the UNet's at 8 x 8 and 16 x 16 (64 to 256 keys, all the kernel holds),
the CUDA kernel beside the Triton one on the same inputs;
``CUDA_MAX_KEYS`` is the longest row where the CUDA kernel is the
faster. Each time is one call by graph replay
(``chip_smoke._graph_ms``). Compare only within one run: two runs may
land on two cards.
"""
from __future__ import annotations

import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
from paddle_tpu_torch.framework.random import RandomKey  # noqa: E402
from paddle_tpu_torch.kernels import dense_attention as DA  # noqa: E402
from paddle_tpu_torch.kernels import group_norm as GN  # noqa: E402

SMEM = 232448          # shared memory a block may use
DA_RTOL = S.DENSE_RTOL  # each X2 element against its size
# (channels, side, calls a forward): the UNet's 14 shapes at batch 4
GN_SHAPES = ((320, 64, 13), (640, 64, 2), (960, 64, 1), (320, 32, 1),
             (640, 32, 11), (960, 32, 1), (1280, 32, 1), (1920, 32, 1),
             (640, 16, 1), (1280, 16, 11), (1920, 16, 1), (2560, 16, 2),
             (1280, 8, 12), (2560, 8, 3))
# (tag, [b, h, sq, sk], mask): Transformer-base's decoder and encoder, the
# UNet's self-attentions at 8 x 8 and 16 x 16
X2_CASES = (("transformer decoder", (64, 8, 64, 64), "rows"),
            ("transformer encoder", (64, 8, 64, 64), "pad"),
            ("unet 8x8", (4, 8, 64, 64), None),
            ("rows of 128", (32, 8, 128, 128), "pad"),
            ("unet 16x16", (4, 8, 256, 256), None))


def group_norm(dev):
    times = {}
    for c, side, _ in GN_SHAPES:
        shape = (4, c, side, side)
        g = torch.Generator(device=dev).manual_seed(2)
        x = (3 + 2 * torch.randn(*shape, device=dev, generator=g)).bfloat16()
        w = (1 + 0.2 * torch.randn(c, device=dev, generator=g)).bfloat16()
        b = (0.2 * torch.randn(c, device=dev, generator=g)).bfloat16()
        cg, s = c // 32, side * side
        plan = GN.group_norm_forward_plan(cg, s, False, torch.bfloat16)
        y = torch.empty_like(x)
        stats = torch.empty(4 * 32, 2, device=dev)
        for silu in (True, False):
            res = {}
            for cs in (1, 2, 4, 8):
                smem = GN._fwd_smem(cg, s, cs)
                if smem > SMEM - 1024:
                    continue
                pl = GN.GnFwdPlan("cluster", cs, smem)
                res[cs] = S._graph_ms(lambda pl=pl: GN._cluster_forward(
                    x, w, b, y, stats, 32, 1e-5, silu, pl))
            tri = S._graph_ms(lambda: GN._triton_forward(
                x, w, b, y, stats, 32, 1e-5, False, silu))
            res["triton"] = tri
            times[(c, side, silu)] = res
            print(f"group_norm {list(shape)}{' +SiLU' if silu else ''}: plan "
                  f"cs {plan.cs}; " + ", ".join(
                      f"cs {cs}: {ms:.4f}" for cs, ms in sorted(
                          res.items(), key=lambda kv: kv[1])), flush=True)
    for silu in (True, False):
        total = {k: sum(n * times[(c, h, silu)][v(c, h)] for c, h, n in GN_SHAPES)
                 for k, v in (("plan", lambda c, h: GN.group_norm_forward_plan(
                                  c // 32, h * h, False, torch.bfloat16).cs),
                              ("Triton", lambda c, h: "triton"))}
        best = sum(n * min(t for k, t in times[(c, h, silu)].items() if k != "triton")
                   for c, h, n in GN_SHAPES)
        print(f"group_norm: the UNet's 61 calls{' +SiLU' if silu else ''}: the plan's "
              f"cluster sizes {total['plan']:.4f} ms, each shape's fastest {best:.4f}, "
              f"Triton {total['Triton']:.4f}", flush=True)


def _x2_mask(kind, shape, g, dev):
    b, h, sq, sk = shape
    if kind is None:
        return None
    keep = torch.randint(int(0.6 * sk), sk + 1, (b,), device=dev, generator=g)
    pad = torch.arange(sk, device=dev)[None, :] < keep[:, None]
    add = torch.where(pad, 0.0, -1e9)[:, None, None]
    if kind == "pad":
        return add
    return torch.triu(torch.full((sq, sk), -1e9, device=dev), 1)[None, None] \
        + add


def dense_softmax(dev):
    for tag, shape, kind in X2_CASES:
        g = torch.Generator(device=dev).manual_seed(3)
        scores = torch.randn(shape, device=dev, generator=g) * 4
        mask = _x2_mask(kind, shape, g, dev)
        key = RandomKey(torch.tensor([5, 6], device=dev), 7)
        p = 0.0 if tag.startswith("unet") else 0.1
        kind_, m, ms = DA._mask_args(mask, scores.shape, dev)
        args = (kind_, m, ms, False, 1 / math.sqrt(64),
                *DA._drop_args(p, key, scores.device))
        probs = torch.empty_like(scores)
        dropped = torch.empty_like(scores) if p else probs
        cuda = S._graph_ms(lambda: DA._cuda_forward(scores, *args, probs,
                                                    dropped))
        want = DA.dense_softmax_plain(scores, mask, False, 1 / math.sqrt(64),
                                      p, key)
        err = float(((probs - want[0]).abs()
                     / (want[0].abs() * DA_RTOL + 1e-30)).max())
        tri = S._graph_ms(lambda: DA._triton_forward(scores, *args, probs,
                                                     dropped))
        route = DA.dense_softmax_forward_plan(shape[-1])
        print(f"dense_softmax {tag} {list(shape)} mask {kind} p {p}: CUDA "
              f"{cuda:.4f} (worst element {err:.3g} of the tolerance), Triton "
              f"{tri:.4f}; plan {route}", flush=True)
        del scores, mask, probs, dropped, want
        torch.cuda.empty_cache()



def main():
    if not torch.cuda.is_available():
        print("norm_fwd_plans: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(S._card_line(), flush=True)
    group_norm(dev)
    dense_softmax(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
