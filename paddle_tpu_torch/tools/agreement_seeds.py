"""Run the bf16 agreements of ``chip_smoke.py``'s phases 13 (c) (ERNIE)
and 14 (c) (the UNet) at several seeds on one GPU.

    python3 paddle_tpu_torch/tools/agreement_seeds.py [N]

Seeds 0..N-1 (5 by default). Each agreement is one forward and backward
through the kernels and through the plain versions, in float32 and in
bf16 (``chip_smoke._ernie_agreement``, ``chip_smoke._unet_agreement``);
its line gives, per parameter, the kernel path's and the plain path's
distances from the float32 step: the gate's largest ratio, the readings
of every parameter below ``chip_smoke.SMALL_LEAF`` elements, and the
four largest ratios of a parameter's own distances. A seed that fails
the gate is printed and the sweep goes on.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main(argv):
    import torch

    import chip_smoke as CS
    if not torch.cuda.is_available():
        print("agreement_seeds: no CUDA device", file=sys.stderr)
        return 2
    # float32 products as the smoke runs them: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failed = 0
    for seed in range(int(argv[0]) if argv else 5):
        for fn in (CS._ernie_agreement, CS._unet_agreement):
            try:
                fn(torch, seed)
            except AssertionError as e:
                failed += 1
                print(f"  seed {seed}: {e}", flush=True)
    print(f"agreements failing the gate: {failed}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
