"""Time the LayerNorm and GroupNorm backwards' CUDA kernels at launch
settings other than their plans' on one GPU.

    python3 paddle_tpu_torch/tools/norm_bwd_plans.py

LayerNorm (``csrc/layer_norm_bwd.cu``): at the main paths' shapes (ERNIE's
[16384, 768] bf16 at p 0.1 and p 0, GPT-MoE's [8192, 768] bf16, the
UNet's fp32 rows of 320, 640 and 1280, Transformer-base's [4096, 512]
fp32), every setting of 1 to 3 blocks an SM whose shared memory fits,
beside ``layer_norm_backward_plan``'s.
GroupNorm (``csrc/group_norm_bwd.cu``): at the UNet's bf16 shapes (batch 4,
G 32, +SiLU), every cluster size whose block fits 227 KB, beside
``group_norm_backward_plan``'s and the Triton kernels. Each time is one
call by graph replay (``chip_smoke._graph_ms``), fastest first. Compare
settings only within one run: two runs may land on two cards.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
from paddle_tpu_torch.framework.random import RandomKey  # noqa: E402
from paddle_tpu_torch.kernels import fused as F  # noqa: E402
from paddle_tpu_torch.kernels import group_norm as GN  # noqa: E402
from paddle_tpu_torch.kernels import sm_count  # noqa: E402

SMEM = 232448          # shared memory a block may use
LN_SHAPES = ((16384, 768, torch.bfloat16, 0.1), (16384, 768, torch.bfloat16, 0.0),
             (8192, 768, torch.bfloat16, 0.0), (16384, 320, torch.float32, 0.0),
             (4096, 640, torch.float32, 0.0), (1024, 1280, torch.float32, 0.0),
             (4096, 512, torch.float32, 0.0))
GN_SHAPES = ((320, 64), (960, 64), (640, 64), (320, 32), (640, 32), (1920, 32),
             (1280, 16), (2560, 16), (1280, 8), (2560, 8))   # (channels, side)


def layer_norm(dev, sms):
    for rows, n, dt, p in LN_SHAPES:
        g = torch.Generator(device=dev).manual_seed(1)
        h = torch.randn(rows, n, device=dev, generator=g).to(dt)
        dy = torch.randn(rows, n, device=dev, generator=g).to(dt)
        w = 1 + 0.1 * torch.randn(n, device=dev, generator=g)
        key = RandomKey(torch.tensor([3, 4], device=dev), 5) if p else None
        plan = F.layer_norm_backward_plan(rows, n, dt, sms)
        dh = torch.empty_like(h)
        dx = torch.empty_like(h) if p else dh
        sums = torch.empty(3 * n, device=dev)
        res = []
        for per_sm in (1, 2, 3):
            if plan.smem * per_sm > SMEM - 1024 * per_sm:
                continue
            blocks = max(1, min(sms * per_sm, -(-rows // 8)))
            pl = plan._replace(blocks=blocks, rows=-(-rows // (blocks * 8)))
            ms = S._graph_ms(lambda pl=pl: F._warp_backward(
                h, w, dy, dh, dx, sums, 1e-5, p, key, "upscale_in_train", pl))
            res.append((ms, per_sm))
        print(f"layer_norm_bwd [{rows}, {n}] {dt} p {p}: plan "
              f"{plan.blocks} blocks; "
              + ", ".join(f"{ps} an SM: {ms:.4f}" for ms, ps in sorted(res)),
              flush=True)


def group_norm(dev):
    for c, side in GN_SHAPES:
        shape = (4, c, side, side)
        g = torch.Generator(device=dev).manual_seed(2)
        x = (3 + 2 * torch.randn(*shape, device=dev, generator=g)).bfloat16()
        dy = torch.randn(*shape, device=dev, generator=g).bfloat16()
        w = (1 + 0.2 * torch.randn(c, device=dev, generator=g)).bfloat16()
        b = (0.2 * torch.randn(c, device=dev, generator=g)).bfloat16()
        _, stats = GN.group_norm_forward(x, w, b, 32, 1e-5, False, True)
        plan = GN.group_norm_backward_plan(c // 32, side * side, False,
                                           torch.bfloat16)
        dx = torch.empty_like(x)
        sums = torch.empty(2 * c, device=dev)
        res = []
        for cs in (1, 2, 4, 8):
            smem = GN._cluster_smem(c // 32, side * side, cs)
            if smem > SMEM - 1024:
                continue
            pl = GN.GnBwdPlan("cluster", cs, smem)
            ms = S._graph_ms(lambda pl=pl: GN._cluster_backward(
                x, w, b, stats, dy, 32, True, dx, sums, pl))
            res.append((ms, cs))
        tri = S._graph_ms(lambda: GN._triton_backward(
            x, w, b, stats, dy, 32, False, True, dx, sums))
        print(f"group_norm_bwd {list(shape)} +SiLU: plan cs {plan.cs}; "
              + ", ".join(f"cs {cs}: {ms:.4f}" for ms, cs in sorted(res))
              + f"; Triton {tri:.4f}", flush=True)


def main():
    if not torch.cuda.is_available():
        print("norm_bwd_plans: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(S._card_line(), flush=True)
    sms = sm_count(dev)
    layer_norm(dev, sms)
    group_norm(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
