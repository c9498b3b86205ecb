"""Time variants of the BatchNorm kernels' launch plan side by side on one
GPU.

    python3 paddle_tpu_torch/tools/batch_norm_variants.py [NAME ...]

A variant (``VARIANTS`` below, all of them by default) sets the plan
constants of ``kernels/batch_norm.py``: the elements of a tile
(``_TILE``), the programs an SM the chunks aim at (``_PROGRAMS_PER_SM``),
the lanes a spatial run's tiles may hold beyond the run (``_RUN_WASTE``)
and the warps a program (``_warps``). Each runs ResNet-50's 53 BatchNorm
calls of one training step at batch 128 (bf16 x, fp32 weights, residual
and output, as under amp O1; the stem's and the blocks' inner ones with
the ReLU, each block's last with the residual add and the ReLU, the
downsamples alone), forward and backward, captured in one CUDA graph:
its ms, and the ms of the calls at each spatial size, timed in turns
(every variant, then every variant again in reverse order; both times are
printed). Each variant's outputs are held to the first variant's (2e-5
of the largest value: the statistics' sums run in another order; the
gradients are not compared, since a value within rounding of 0 may take
the ReLU's other side). Compare variants only within one run: two runs
may land on two cards.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
from paddle_tpu_torch.kernels import batch_norm as BN  # noqa: E402

_DEFAULT = dict(_TILE=BN._TILE, _PROGRAMS_PER_SM=BN._PROGRAMS_PER_SM,
                _RUN_WASTE=BN._RUN_WASTE, _warps=BN._warps)
VARIANTS = {   # name: settings
    "as_is": {},
    "programs_2": dict(_PROGRAMS_PER_SM=2),
    "programs_8": dict(_PROGRAMS_PER_SM=8),
    "tile_2048": dict(_TILE=2048),
    "tile_8192": dict(_TILE=8192),
    # spatial runs cut into tiles of at most 15% more lanes than the run
    # (784 in 128s, 196 in 32s) instead of one tile a run
    "waste_1_15": dict(_RUN_WASTE=1.15),
    "warps_4": dict(_warps=lambda bc, bs: 4),
    "warps_8": dict(_warps=lambda bc, bs: 8),
    # eight warps for full tiles of short runs too (7 x 7), as before
    "warps_8_short_runs": dict(
        _warps=lambda bc, bs: 8 if bc * bs >= BN._TILE else 4),
}


def _resnet50_calls():
    """(C, H, form) of ResNet-50's 53 BatchNorms at 224 x 224."""
    calls, h = [(64, 112, "relu")], 56
    for planes, blocks, stride in ((64, 3, 1), (128, 4, 2), (256, 6, 2),
                                   (512, 3, 2)):
        for i in range(blocks):
            out = h // (stride if i == 0 else 1)
            calls += [(planes, h, "relu"), (planes, out, "relu"),
                      (4 * planes, out, "residual")]
            if i == 0:
                calls.append((4 * planes, out, "plain"))
            h = out
    return calls


def _inputs(n=128):
    g = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for c, h, form in _resnet50_calls():
        shape = (n, c, h, h)
        x = (3 + 2 * torch.randn(*shape, device="cuda", generator=g)) \
            .to(torch.bfloat16)
        r = torch.randn(*shape, device="cuda", generator=g) \
            if form == "residual" else None
        out.append(dict(h=h, x=x, r=r, relu=form != "plain",
                        w=1 + 0.2 * torch.randn(c, device="cuda", generator=g),
                        b=0.2 * torch.randn(c, device="cuda", generator=g),
                        dy=torch.randn(*shape, device="cuda", generator=g),
                        stats=(torch.zeros(c, device="cuda"),
                               torch.ones(c, device="cuda"))))
    return out


def _call(a):
    y, st = BN.batch_norm_forward(a["x"], a["w"], a["b"], *a["stats"], True,
                                  0.9, 1e-5, False, a["r"], a["relu"], False,
                                  torch.float32)
    rdt = None if a["r"] is None else a["r"].dtype
    return (y,) + BN.batch_norm_backward(a["x"], a["w"], st, a["dy"], y,
                                         True, False, a["relu"], False, rdt)


def _set(settings):
    for k, v in {**_DEFAULT, **settings}.items():
        setattr(BN, k, v)


def _run(name, calls, want):
    _set(VARIANTS[name])
    got = [_call(a) for a in calls]           # compiles, and the check
    torch.cuda.synchronize()
    if want is not None:
        for g, w in zip(got, want):
            tol = 2e-5 * max(1.0, float(w[0].abs().max()))
            if float((g[0] - w[0]).abs().max()) > tol:
                raise AssertionError(f"{name}: the output disagrees")
    ms = S._graph_ms(lambda: [_call(a) for a in calls], iters=1, reps=5)
    by_h = {}
    for h in sorted({a["h"] for a in calls}):
        sub = [a for a in calls if a["h"] == h]
        by_h[h] = S._graph_ms(lambda s=sub: [_call(a) for a in s], iters=1,
                              reps=5)
    _set({})
    return got, ms, by_h


def main(names):
    card = S._card_line()
    names = names or list(VARIANTS)
    calls = _inputs()
    want = None
    times = {n: [] for n in names}
    for order in (names, names[::-1]):
        for name in order:
            got, ms, by_h = _run(name, calls, want)
            want = want or [g[:1] for g in got]
            del got
            times[name].append(ms)
            print(f"  {name}: 53 BatchNorms forward and backward {ms:.3f} ms;"
                  f" by spatial size " + ", ".join(
                      f"{h}x{h} {t:.3f}" for h, t in by_h.items())
                  + f" [{card}]", flush=True)
    for name in names:
        print(f"{name}: {' / '.join(f'{t:.3f}' for t in times[name])} ms "
              f"[{card}]", flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("batch_norm_variants: needs a CUDA device")
    main(sys.argv[1:])
