"""paddle_tpu_torch.optimizer.lr against paddle_tpu.optimizer.lr.

Both are pure Python with the same formulas in the same order, so each
scheduler's sequence of rates must be equal (``==``) to the JAX
package's over 30 steps, including ``ReduceOnPlateau`` fed a metric,
``LinearWarmup`` around another scheduler and a ``state_dict`` round
trip in the middle of a run.
"""
import math

import pytest

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.optimizer import lr as plr

STEPS = 30

# name -> (args, kwargs) for both packages' constructors
CASES = {
    "NoamDecay": ((64, 5), {"learning_rate": 0.7}),
    "PiecewiseDecay": (([3, 9, 17], [0.1, 0.05, 0.02, 0.004]), {}),
    "NaturalExpDecay": ((0.3, 0.15), {}),
    "InverseTimeDecay": ((0.3, 0.4), {}),
    "PolynomialDecay": ((0.2, 11), {"end_lr": 1e-3, "power": 1.7}),
    "ExponentialDecay": ((0.3, 0.93), {}),
    "MultiStepDecay": ((0.25, [4, 11, 20]), {"gamma": 0.3}),
    "StepDecay": ((0.25, 6), {"gamma": 0.55}),
    "LambdaDecay": ((0.4, lambda e: 0.97 ** e + 0.01 * (e % 3)), {}),
    "MultiplicativeDecay": ((0.4, lambda e: 0.9 + 0.01 * (e % 4)), {}),
    "CosineAnnealingDecay": ((3e-4, 10), {"eta_min": 1e-6}),
    "CosineAnnealingWarmRestarts": ((0.1, 4), {"T_mult": 2,
                                               "eta_min": 0.001}),
    "ReduceOnPlateau": ((0.5,), {"factor": 0.5, "patience": 2,
                                 "cooldown": 1, "min_lr": 0.01}),
    "OneCycleLR": ((0.9, 25), {"phase_pct": 0.35}),
    "CyclicLR": ((0.01, 0.1, 4), {"step_size_down": 6,
                                  "mode": "triangular2"}),
    "LinearLR": ((0.2, 12), {"start_factor": 0.25, "end_factor": 0.9}),
    "LinearWarmup": ((0.3, 7, 0.0, 0.3), {}),
}

# a metric that falls, stalls and rises, for ReduceOnPlateau
METRIC = [1.0 / (1 + i) if i < 8 else 0.1 + 0.01 * (i % 5)
          for i in range(STEPS)]


def _seq(mod, name, steps=STEPS):
    args, kw = CASES[name]
    s = getattr(mod, name)(*args, **kw)
    out = [s()]
    for i in range(steps):
        if name == "ReduceOnPlateau":
            s.step(METRIC[i])
        else:
            s.step()
        out.append(s())
    return out


def test_all_seventeen_are_covered():
    assert set(CASES) == set(plr.__all__) - {"LRScheduler"}
    assert len(CASES) == 17


@pytest.mark.parametrize("name", sorted(CASES))
def test_scheduler_sequence_equals_jax(name):
    want = _seq(jlr, name)
    got = _seq(plr, name)
    assert got == want
    assert all(math.isfinite(x) for x in got)


@pytest.mark.parametrize("inner", ["CosineAnnealingDecay", "StepDecay",
                                   "PolynomialDecay"])
def test_linear_warmup_around_a_scheduler(inner):
    def seq(mod):
        args, kw = CASES[inner]
        s = mod.LinearWarmup(getattr(mod, inner)(*args, **kw), 5, 1e-5,
                             args[0])
        out = []
        for _ in range(STEPS):
            out.append(s())
            s.step()
        return out
    want, got = seq(jlr), seq(plr)
    assert got == want
    assert got[0] == 1e-5 and got[5] != got[4]


@pytest.mark.parametrize("name", ["CosineAnnealingDecay", "ReduceOnPlateau",
                                  "MultiplicativeDecay", "LinearWarmup"])
def test_state_dict_round_trip_continues_the_sequence(name):
    """Run 12 steps, take state_dict(), load it into a fresh scheduler
    and run the rest: the same sequence as 30 uninterrupted steps (and as
    JAX's)."""
    def step(s, i):
        if name == "ReduceOnPlateau":
            s.step(METRIC[i])
        else:
            s.step()

    args, kw = CASES[name]
    first = getattr(plr, name)(*args, **kw)
    out = [first()]
    for i in range(12):
        step(first, i)
        out.append(first())
    state = first.state_dict()
    assert all(isinstance(v, (int, float, bool, str, list))
               for v in state.values())
    second = getattr(plr, name)(*args, **kw)
    second.set_state_dict(state)
    assert second() == first()
    for i in range(12, STEPS):
        step(second, i)
        out.append(second())
    assert out == _seq(plr, name) == _seq(jlr, name)
