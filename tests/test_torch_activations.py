"""paddle_tpu_torch's activation functionals and layers against
paddle_tpu's, on the CPU: the 27 functionals of this slice (``relu_``,
``relu6``, ``sigmoid``, ``swish``, ``leaky_relu``, ``elu``, ``celu``,
``selu``, ``prelu``, ``rrelu``, ``hardshrink``, ``softshrink``,
``tanhshrink``, ``hardtanh``, ``hardsigmoid``, ``hardswish``, ``mish``,
``softplus``, ``softsign``, ``thresholded_relu``, ``log_sigmoid``,
``maxout``, ``softmax``, ``softmax_``, ``log_softmax``,
``gumbel_softmax``, ``glu``) and the 28 layers of ``activation.py``,
outputs and input gradients (the JAX package's autograd, ``jax.vjp`` of
each op), and the JAX op name each is counted and cast under.

Inputs are made with numpy from a seed (standard normals times 3, so
every threshold is crossed) and handed to both sides.

Tolerances: float32 within 1e-5 of the largest reference value (both
evaluate the same formula; exp, log, tanh and erf differ in the last
ulps); bfloat16 within two bf16 ulps (2^-6) of the largest (the same
formula in bf16 on both sides, where jnp and PyTorch round intermediate
steps in different places). ``rrelu`` in training and ``gumbel_softmax``
draw from the port's generator, whose bits cannot be JAX's: they are held
to their distributions (slopes uniform in [lower, upper): mean within 5
standard errors, all inside the bounds; the hard Gumbel-softmax's argmax
frequencies within 5 standard errors of the softmax probabilities) and to
determinism (the same seed, the same values).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.tensor import Tensor

import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as pnn
from paddle_tpu_torch import amp
from paddle_tpu_torch.amp import debugging as pdbg
from paddle_tpu_torch.nn import functional as F

JF = paddle.nn.functional
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _f(t):
    if isinstance(t, Tensor):
        return np.asarray(t._data.astype(jnp.float32))
    return t.detach().float().numpy()


def _close(got, want, dtype="float32"):
    got, want = _f(got), _f(want)
    assert got.shape == want.shape
    tol = 1e-5 if dtype == "float32" else 2.0 ** -6
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


# name -> (positional args after x, keyword args); both packages' calls
_FUNCS = {
    "relu6": ((), {}), "sigmoid": ((), {}), "swish": ((), {}),
    "leaky_relu": ((0.2,), {}), "elu": ((), {"alpha": 0.7}),
    "celu": ((1.3,), {}), "selu": ((), {}), "rrelu": ((0.1, 0.3), {}),
    "hardshrink": ((0.3,), {}), "softshrink": ((), {"threshold": 0.4}),
    "tanhshrink": ((), {}), "hardtanh": ((-0.5, 0.8), {}),
    "hardsigmoid": ((), {}), "hardswish": ((), {}), "mish": ((), {}),
    "softplus": ((), {"beta": 2.0, "threshold": 3.0}),
    "softsign": ((), {}), "thresholded_relu": ((0.5, 0.1), {}),
    "log_sigmoid": ((), {}), "maxout": ((2,), {"axis": 1}),
    "softmax": ((), {"axis": 1}), "log_softmax": ((-1,), {}),
    "glu": ((), {"axis": 1}),
}


@pytest.mark.parametrize("name", sorted(_FUNCS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_functionals_match_jax(name, dtype):
    """Output and input gradient of each functional (``rrelu`` in eval)."""
    args, kw = _FUNCS[name]
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 4, 5)) * 3).astype(np.float32)
    jx = Tensor(jnp.asarray(x, _JDT[dtype]), stop_gradient=False)
    px = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    jy = getattr(JF, name)(jx, *args, **kw)
    py = getattr(F, name)(px, *args, **kw)
    assert str(py.dtype).replace("torch.", "") == str(jy._data.dtype)
    dy = rng.standard_normal(tuple(py.shape)).astype(np.float32)
    (jy * Tensor(jnp.asarray(dy, _JDT[dtype]))).sum().backward()
    py.backward(torch.from_numpy(dy).to(py.dtype))
    _close(py, jy, dtype)
    _close(px.grad, jx.grad, dtype)


@pytest.mark.parametrize("fmt,shape,n", [("NCHW", (2, 3, 4, 4), 3),
                                         ("NHWC", (2, 4, 4, 3), 3),
                                         ("NCHW", (2, 3, 4, 4), 1)])
def test_prelu_matches_jax(fmt, shape, n):
    """One weight, or one a channel (axis 1, or last for NHWC): output and
    the gradients of x and the weight."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    w = rng.uniform(0.05, 0.5, n).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    jx, jw = (paddle.to_tensor(a, stop_gradient=False) for a in (x, w))
    px, pw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    jy = JF.prelu(jx, jw, data_format=fmt)
    py = F.prelu(px, pw, data_format=fmt)
    (jy * Tensor(jnp.asarray(dy))).sum().backward()
    py.backward(torch.from_numpy(dy))
    _close(py, jy)
    _close(px.grad, jx.grad)
    _close(pw.grad, jw.grad)


def test_in_place_forms_match_jax():
    """``relu_`` and ``softmax_`` write their result into x and return
    it."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 6)).astype(np.float32)
    for name, kw in (("relu_", {}), ("softmax_", {"axis": 0})):
        jx = paddle.to_tensor(x)
        px = torch.from_numpy(x.copy())
        jr = getattr(JF, name)(jx, **kw)
        pr = getattr(F, name)(px, **kw)
        assert pr is px
        _close(px, jx)
        _close(pr, jr)


def test_softmax_dtype_argument_matches_jax():
    x = np.random.default_rng(4).standard_normal((3, 5)).astype(np.float32)
    for fn in ("softmax", "log_softmax"):
        jy = getattr(JF, fn)(Tensor(jnp.asarray(x, jnp.bfloat16)),
                             dtype="float32")
        py = getattr(F, fn)(torch.from_numpy(x).bfloat16(), dtype="float32")
        assert py.dtype == torch.float32 and str(jy._data.dtype) == "float32"
        _close(py, jy)


def test_rrelu_training_draws_uniform_slopes():
    """In training the negative part's slope is uniform in [lower, upper)
    for each element (mean within 5 standard errors, all inside the
    bounds), drawn from the seed: the same seed gives the same slopes, the
    next call others; the positive part passes."""
    lo, hi = 0.1, 0.3
    x = -torch.ones(50000)
    ptt.seed(5)
    a = -F.rrelu(x, lo, hi, training=True)
    b = -F.rrelu(x, lo, hi, training=True)
    ptt.seed(5)
    again = -F.rrelu(x, lo, hi, training=True)
    assert torch.equal(a, again) and not torch.equal(a, b)
    assert float(a.min()) >= lo and float(a.max()) < hi
    se = (hi - lo) / np.sqrt(12) / np.sqrt(a.numel())
    assert abs(float(a.mean()) - (lo + hi) / 2) <= 5 * se
    assert torch.equal(F.rrelu(torch.ones(8), lo, hi, training=True),
                       torch.ones(8))
    layer = pnn.RReLU(lo, hi)
    layer.eval()
    _close(layer(x), JF.rrelu(Tensor(jnp.asarray(x.numpy())), lo, hi))


def test_gumbel_softmax_samples_the_softmax():
    """The hard Gumbel-softmax's one-hot rows pick each class with its
    softmax probability (frequencies within 5 standard errors); the soft
    rows sum to 1; the hard rows carry the soft rows' gradient; the same
    seed gives the same sample."""
    p = np.array([0.1, 0.2, 0.3, 0.4])
    n = 20000
    logits = torch.from_numpy(np.log(p)).float().repeat(n, 1)
    ptt.seed(6)
    hard = F.gumbel_softmax(logits, hard=True)
    ptt.seed(6)
    assert torch.equal(hard, F.gumbel_softmax(logits, hard=True))
    np.testing.assert_allclose(hard.sum(-1).numpy(), 1.0, rtol=1e-6)
    picked = hard > 0.5
    assert torch.equal(picked.sum(-1), torch.ones(n, dtype=torch.long))
    freq = picked.float().mean(0).numpy()
    assert np.all(np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n))
    soft = F.gumbel_softmax(logits[:8], temperature=0.5, axis=-1)
    np.testing.assert_allclose(soft.sum(-1).numpy(), 1.0, rtol=1e-6)
    x = logits[:4].clone().requires_grad_()
    y = F.gumbel_softmax(x, hard=True)
    y[:, 0].sum().backward()
    assert x.grad is not None and float(x.grad.abs().sum()) > 0


_LAYERS = {
    "ReLU": {}, "ReLU6": {}, "Sigmoid": {}, "Tanh": {}, "Silu": {},
    "Swish": {}, "Mish": {}, "Hardswish": {}, "Hardsigmoid": {},
    "Softsign": {}, "Tanhshrink": {}, "LogSigmoid": {},
    "GELU": {"approximate": True}, "LeakyReLU": {"negative_slope": 0.1},
    "ELU": {"alpha": 0.5}, "CELU": {"alpha": 2.0}, "SELU": {},
    "PReLU": {"num_parameters": 4, "init": 0.2}, "RReLU": {},
    "Hardshrink": {"threshold": 0.6}, "Softshrink": {},
    "Hardtanh": {"min": -2.0, "max": 1.5}, "Softplus": {"beta": 0.5},
    "ThresholdedReLU": {"threshold": 0.7}, "Softmax": {"axis": 1},
    "LogSoftmax": {}, "Maxout": {"groups": 2}, "GLU": {"axis": 1},
}


@pytest.mark.parametrize("name", sorted(_LAYERS))
def test_layers_match_jax(name):
    """Each of the 28 layers (``RReLU`` in eval), output and input
    gradient; ``PReLU``'s weight and its gradient."""
    kw = _LAYERS[name]
    jl = getattr(paddle.nn, name)(**kw)
    extra = {"device": "cpu"} if name == "PReLU" else {}
    pl = getattr(pnn, name)(**kw, **extra)
    jl.eval()
    pl.eval()
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 4, 3, 2)) * 3).astype(np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    px = torch.from_numpy(x).requires_grad_()
    jy, py = jl(jx), pl(px)
    dy = rng.standard_normal(tuple(py.shape)).astype(np.float32)
    (jy * Tensor(jnp.asarray(dy))).sum().backward()
    py.backward(torch.from_numpy(dy))
    _close(py, jy)
    _close(px.grad, jx.grad)
    if name == "PReLU":
        assert sorted(n for n, _ in pl.named_parameters()) == ["weight"]
        _close(pl.weight, jl.weight)
        _close(pl.weight.grad, jl.weight.grad)


def test_functionals_are_their_jax_ops():
    """Each functional is counted under its JAX op name and input dtype,
    as the JAX package's operator statistics count it; under
    ``auto_cast`` each output has the JAX dtype (softmax and log_softmax
    are black-listed; the rest cast to bf16 at O2 only)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 4, 3)).astype(np.float32)
    names = sorted(_FUNCS) + ["gumbel_softmax"]

    def run(mod, t, name):
        args, kw = _FUNCS.get(name, ((), {}))
        return getattr(mod, name)(t(x), *args, **kw)
    pdbg.enable_operator_stats_collection()
    try:
        for name in names:
            run(F, torch.from_numpy, name)
    finally:
        got = pdbg.disable_operator_stats_collection()
    paddle.amp.debugging.enable_operator_stats_collection()
    try:
        for name in names:
            run(JF, lambda a: Tensor(jnp.asarray(a)), name)
    finally:
        want = paddle.amp.debugging.disable_operator_stats_collection()
    assert got == want
    for level in ("O1", "O2"):
        for name in names:
            with paddle.amp.auto_cast(level=level):
                jd = str(run(JF, lambda a: Tensor(jnp.asarray(a)),
                             name)._data.dtype)
            with amp.auto_cast(level=level):
                pd = str(run(F, torch.from_numpy, name).dtype)
            assert pd.replace("torch.", "") == jd, (name, level)
