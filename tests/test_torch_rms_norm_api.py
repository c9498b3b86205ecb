"""``nn.functional.rms_norm`` with the JAX signature, ``rms_norm(x,
weight=None, bias=None, epsilon=1e-6, begin_norm_axis=-1, name=None)``,
against paddle_tpu's on the CPU: keyword calls, a bias, no weight, norms
over more than the last axis, in float32 and bfloat16; and its route: the
RMSNorm kernel exactly where the JAX package routes to its Pallas kernel
(the last axis, a weight, no bias), the JAX formula everywhere else.

Tolerances: float32 outputs and gradients within 1e-5 of the largest
reference value (fp32 means in another order); bfloat16 within two bf16
ulps (2^-6) of the largest (one fp32 formula rounded once on each side,
from sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.tensor import Tensor

from paddle_tpu_torch.kernels import fused
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import functional as F

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

_CALLS = {
    "weight": dict(weight=True),
    "weight_eps": dict(weight=True, epsilon=1e-3),
    "weight_bias": dict(weight=True, bias=True),
    "bias_only": dict(bias=True),
    "neither": dict(),
    "axis_1": dict(weight=True, begin_norm_axis=1),
    "axis_1_bias": dict(weight=True, bias=True, begin_norm_axis=1),
    "axis_last_pos": dict(weight=True, begin_norm_axis=2),
}


def _f(t):
    if isinstance(t, Tensor):
        return np.asarray(t._data.astype(jnp.float32))
    return t.detach().float().numpy()


def _close(got, want, dtype):
    got, want = _f(got), _f(want)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -6
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("call", sorted(_CALLS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_keyword_calls_match_jax(call, dtype, monkeypatch):
    """Each keyword form against the JAX function: output and the
    gradients of x, the weight and the bias; the kernel's route (spied
    on) taken exactly for the last axis with a weight and no bias."""
    spec = dict(_CALLS[call])
    rng = np.random.default_rng(1)
    shape = (2, 3, 8)
    ax = spec.get("begin_norm_axis", -1)
    pshape = shape[ax:] if ax >= 0 else shape[-1:]
    x = rng.standard_normal(shape).astype(np.float32) * 2
    w = (1 + 0.2 * rng.standard_normal(pshape)).astype(np.float32)
    b = (0.2 * rng.standard_normal(pshape)).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    jdt, pdt = _JDT[dtype], getattr(torch, dtype)
    jx = Tensor(jnp.asarray(x, jdt), stop_gradient=False)
    px = torch.from_numpy(x).to(pdt).requires_grad_()
    jkw, pkw = {}, {}
    leaves = []
    for name, arr in (("weight", w), ("bias", b)):
        if spec.pop(name, False):
            jkw[name] = paddle.to_tensor(arr, stop_gradient=False)
            pkw[name] = torch.from_numpy(arr).requires_grad_()
            leaves.append((jkw[name], pkw[name]))
    jkw.update(spec)
    pkw.update(spec)
    routed = []
    real = fused.rms_norm
    monkeypatch.setattr(fused, "rms_norm",
                        lambda *a, **k: routed.append(1) or real(*a, **k))
    jy = paddle.nn.functional.rms_norm(jx, **jkw)
    py = F.rms_norm(px, **pkw)
    want_route = "weight" in pkw and "bias" not in pkw \
        and pkw.get("begin_norm_axis", -1) in (-1, len(shape) - 1)
    assert bool(routed) == want_route
    assert py.dtype == pdt
    (jy * Tensor(jnp.asarray(dy, jdt))).sum().backward()
    py.backward(torch.from_numpy(dy).to(pdt))
    _close(py, jy, dtype)
    _close(px.grad, jx.grad, dtype)
    for jl, pl in leaves:
        _close(pl.grad, jl.grad, dtype)


def test_llama_norms_pass_epsilon_by_keyword(monkeypatch):
    """The Llama RMSNorms pass their epsilon by keyword: with the JAX
    signature a third positional argument would be the bias."""
    seen = []
    real = F.rms_norm

    def spy(x, *args, **kw):
        seen.append((len(args), kw.get("epsilon")))
        return real(x, *args, **kw)
    monkeypatch.setattr(F, "rms_norm", spy)
    cfg = LlamaConfig.tiny(layers=1)
    cfg.rms_norm_eps = 1e-5
    model = LlamaForCausalLM(cfg, device="cpu")
    model(torch.zeros(1, 4, dtype=torch.long))
    assert seen and all(s == (1, 1e-5) for s in seen)
