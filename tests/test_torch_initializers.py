"""paddle_tpu_torch's initializer classes against paddle_tpu's, on the CPU.

The deterministic ones (``Constant``, ``Assign``, ``Dirac``, ``Bilinear``,
``calculate_gain`` and the ``*_init`` aliases) must give the JAX values
exactly. The random ones draw from the port's own generator
(``framework.random``; JAX's threefry bits cannot be matched), so they are
held to the JAX classes' rules and moments: the bounds and standard
deviations that the fans give, the sample mean within 5 standard errors
of the distribution's and the sample standard deviation within 5% of it
(at least 20,000 draws each: a standard error of ~0.7% for a normal's,
~0.4% for a uniform's), a truncated normal inside its bounds with the
moments of the truncated distribution, an orthogonal matrix orthonormal
to 1e-5; and by determinism: the same seed gives the same values, the
next draw others. ``ParamAttr(initializer=)`` and
``set_global_initializer`` are held to the JAX layers' precedence on
``Linear`` and ``Conv2D``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import initializer as JI

import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as pnn
from paddle_tpu_torch.nn import initializer as PI


def _np(a):
    return a.detach().float().numpy() if torch.is_tensor(a) else \
        np.asarray(a, np.float32)


@pytest.mark.parametrize("case", ["constant", "constant_init", "assign",
                                  "assign_list", "dirac", "dirac_groups",
                                  "bilinear"])
def test_deterministic_initializers_equal_jax(case):
    shape, make = {
        "constant": ((3, 4), lambda m: m.Constant(0.75)),
        "constant_init": ((5,), lambda m: m.constant_init(-2.0)),
        "assign": ((2, 3), lambda m: m.Assign(np.arange(6.0).reshape(3, 2))),
        "assign_list": ((4,), lambda m: m.Assign([1.5, 2.5, 3.5, 4.5])),
        "dirac": ((4, 4, 3, 3), lambda m: m.Dirac()),
        "dirac_groups": ((6, 3, 3, 5), lambda m: m.Dirac(groups=2)),
        "bilinear": ((2, 3, 4, 5), lambda m: m.Bilinear()),
    }[case]
    for dtype in ("float32", "bfloat16"):
        want = make(JI)(shape, getattr(jnp, dtype))
        got = make(PI)(shape, getattr(torch, dtype))
        assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == shape
        np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


@pytest.mark.parametrize("name,param", [
    ("sigmoid", None), ("linear", None), ("conv2d", None), ("tanh", None),
    ("relu", None), ("selu", None), ("leaky_relu", None),
    ("leaky_relu", 0.2), ("conv3d_transpose", None)])
def test_calculate_gain_equals_jax(name, param):
    assert PI.calculate_gain(name, param) == JI.calculate_gain(name, param)


def test_calculate_gain_refuses_what_jax_refuses():
    with pytest.raises(ValueError):
        PI.calculate_gain("softmax")
    with pytest.raises(ValueError):
        JI.calculate_gain("softmax")


def _normal_ok(a, mean, std):
    n = a.size
    assert abs(a.mean() - mean) <= 5 * std / math.sqrt(n)
    assert abs(a.std() / std - 1) <= 0.05


def _uniform_ok(a, lo, hi):
    assert a.min() >= lo and a.max() < hi
    n, std = a.size, (hi - lo) / math.sqrt(12)
    assert abs(a.mean() - (lo + hi) / 2) <= 5 * std / math.sqrt(n)
    assert abs(a.std() / std - 1) <= 0.05


_FAN_SHAPES = [(160, 128), (64, 32, 3, 3)]


def _fans(shape):
    if len(shape) == 2:
        return shape
    rf = math.prod(shape[2:])
    return shape[1] * rf, shape[0] * rf


@pytest.mark.parametrize("shape", _FAN_SHAPES)
@pytest.mark.parametrize("name", ["XavierUniform", "XavierNormal",
                                  "KaimingUniform", "KaimingNormal",
                                  "KaimingNormal_relu", "Xavier_fans"])
def test_fan_rules_and_moments(shape, name):
    """The Xavier and Kaiming bounds and standard deviations from the JAX
    fan rules (a 2-D weight is [in, out]; a conv weight's fans multiply
    the receptive field), given fans overriding them."""
    ptt.seed(1)
    fi, fo = _fans(shape)
    if name == "XavierUniform":
        lim = math.sqrt(6.0 / (fi + fo))
        _uniform_ok(_np(PI.XavierUniform()(shape)), -lim, lim)
    elif name == "XavierNormal":
        _normal_ok(_np(PI.XavierNormal()(shape)), 0.0,
                   math.sqrt(2.0 / (fi + fo)))
    elif name == "Xavier_fans":
        lim = 2.0 * math.sqrt(6.0 / (10 + 30))
        _uniform_ok(_np(PI.XavierUniform(fan_in=10, fan_out=30, gain=2.0)(
            shape)), -lim, lim)
    elif name == "KaimingUniform":
        lim = math.sqrt(2.0 / (1 + 0.1 ** 2)) * math.sqrt(3.0 / fi)
        _uniform_ok(_np(PI.KaimingUniform(negative_slope=0.1)(shape)),
                    -lim, lim)
    elif name == "KaimingNormal":
        _normal_ok(_np(PI.KaimingNormal()(shape)), 0.0,
                   math.sqrt(2.0) / math.sqrt(fi))
    else:
        _normal_ok(_np(PI.KaimingNormal(fan_in=50, nonlinearity="relu")(
            shape)), 0.0, math.sqrt(2.0) / math.sqrt(50))


def test_normal_uniform_truncated_moments():
    ptt.seed(2)
    _normal_ok(_np(PI.Normal(0.5, 2.0)((200, 150))), 0.5, 2.0)
    _normal_ok(_np(PI.normal_init(-1.0, 0.1)((30000,))), -1.0, 0.1)
    _uniform_ok(_np(PI.Uniform(-0.5, 1.5)((200, 150))), -0.5, 1.5)
    _uniform_ok(_np(PI.uniform_init()((30000,))), -1.0, 1.0)
    t = _np(PI.TruncatedNormal(1.0, 2.0, a=-1.0, b=2.0)((200, 150)))
    assert t.min() >= 1.0 - 2.0 and t.max() <= 1.0 + 4.0
    # the truncated standard normal on [-1, 2]: its mean and deviation
    a, b = -1.0, 2.0
    pdf = [math.exp(-v * v / 2) / math.sqrt(2 * math.pi) for v in (a, b)]
    z = 0.5 * (math.erf(b / math.sqrt(2)) - math.erf(a / math.sqrt(2)))
    mu = (pdf[0] - pdf[1]) / z
    var = 1 + (a * pdf[0] - b * pdf[1]) / z - mu * mu
    _normal_ok(t, 1.0 + 2.0 * mu, 2.0 * math.sqrt(var))
    want = JI.TruncatedNormal(1.0, 2.0, a=-1.0, b=2.0)((200, 150),
                                                       jnp.float32)
    w = np.asarray(want)
    assert abs(w.mean() - t.mean()) <= 0.05 and abs(w.std() - t.std()) < 0.05


@pytest.mark.parametrize("shape", [(6, 10), (10, 6), (4, 3, 2, 2)])
def test_orthogonal_is_orthonormal(shape):
    ptt.seed(3)
    q = _np(PI.Orthogonal(gain=2.0)(shape)).reshape(shape[0], -1) / 2.0
    want = JI.Orthogonal(gain=2.0)(shape, jnp.float32)
    assert np.asarray(want).shape == q.reshape(shape).shape
    gram = q @ q.T if q.shape[0] <= q.shape[1] else q.T @ q
    np.testing.assert_allclose(gram, np.eye(gram.shape[0]), atol=1e-5)


def test_random_initializers_follow_the_seed():
    """The same seed draws the same values; the next draw others."""
    out = []
    for _ in range(2):
        ptt.seed(7)
        out.append([PI.Normal()((5, 5)), PI.Normal()((5, 5)),
                    PI.Uniform()((7,)), PI.TruncatedNormal()((4, 4))])
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert not torch.equal(out[0][0], out[0][1])


def test_param_attr_initializer_on_linear_and_conv2d():
    """``ParamAttr(initializer=...)`` fills the parameter (weight and
    bias, each its own), and keeps the attribute's name; the JAX layers
    give the same deterministic values."""
    attr_w = pnn.initializer.ParamAttr(name="w0",
                                       initializer=PI.Constant(0.5))
    lin = pnn.Linear(3, 4, weight_attr=attr_w,
                     bias_attr=pnn.initializer.ParamAttr(
                         initializer=PI.Assign([1.0, 2.0, 3.0, 4.0])),
                     device="cpu")
    jlin = paddle.nn.Linear(3, 4, weight_attr=JI.ParamAttr(
        initializer=JI.Constant(0.5)), bias_attr=JI.ParamAttr(
        initializer=JI.Assign([1.0, 2.0, 3.0, 4.0])))
    np.testing.assert_array_equal(_np(lin.weight), np.asarray(
        jlin.weight._data))
    np.testing.assert_array_equal(_np(lin.bias), np.asarray(jlin.bias._data))
    assert lin.weight.name == "w0"
    conv = pnn.Conv2D(4, 4, 3, weight_attr=PI.Dirac(), bias_attr=False,
                      device="cpu")
    jconv = paddle.nn.Conv2D(4, 4, 3, weight_attr=JI.Dirac(),
                             bias_attr=False)
    np.testing.assert_array_equal(_np(conv.weight),
                                  np.asarray(jconv.weight._data))
    x = torch.randn(1, 4, 5, 5)
    np.testing.assert_allclose(_np(conv(x)), _np(x[:, :, 1:-1, 1:-1]),
                               atol=1e-6)
    ptt.seed(4)
    k = pnn.Conv2D(8, 16, 3, weight_attr=pnn.initializer.ParamAttr(
        initializer=PI.KaimingNormal()), device="cpu")
    _normal_ok(_np(k.weight), 0.0, math.sqrt(2.0 / (8 * 9)))


def test_global_initializer_precedence():
    """``set_global_initializer`` overrides the layers' defaults (weights,
    and biases where given); a ``ParamAttr`` initializer still wins; None
    resets. The JAX layers give the same values."""
    try:
        PI.set_global_initializer(PI.Constant(0.25), PI.Constant(-1.0))
        JI.set_global_initializer(JI.Constant(0.25), JI.Constant(-1.0))
        lin = pnn.Linear(3, 2, device="cpu")
        jlin = paddle.nn.Linear(3, 2)
        for got, want in ((lin.weight, jlin.weight), (lin.bias, jlin.bias)):
            np.testing.assert_array_equal(_np(got), np.asarray(want._data))
        bn = pnn.BatchNorm2D(3, device="cpu")
        jbn = paddle.nn.BatchNorm2D(3)
        np.testing.assert_array_equal(_np(bn.weight),
                                      np.asarray(jbn.weight._data))
        np.testing.assert_array_equal(_np(bn.bias),
                                      np.asarray(jbn.bias._data))
        own = pnn.Linear(3, 2, weight_attr=PI.Constant(3.0), device="cpu")
        assert bool((own.weight == 3.0).all())
        assert bool((own.bias == -1.0).all())
        PI.set_global_initializer(PI.Constant(0.5))
        assert bool((pnn.Linear(2, 2, device="cpu").bias == 0).all())
    finally:
        PI.set_global_initializer(None)
        JI.set_global_initializer(None)
    assert not bool((pnn.Linear(3, 2, device="cpu").weight == 0.25).all())


def test_prelu_weight_takes_its_initializer():
    assert bool((pnn.PReLU(4, init=0.1, device="cpu").weight == 0.1).all())
    p = pnn.PReLU(3, weight_attr=PI.Assign([0.1, 0.2, 0.3]), device="cpu")
    np.testing.assert_allclose(_np(p.weight), [0.1, 0.2, 0.3])
