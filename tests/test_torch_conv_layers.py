"""paddle_tpu_torch's convolutional layers and functionals against
paddle_tpu's, on the CPU: ``conv2d`` and ``Conv2D``, ``group_norm`` and
``GroupNorm`` (and the kernel's split-and-merge arithmetic), ``batch_norm``
and ``BatchNorm2D``, nearest ``interpolate``, the pools, the activations,
``Sequential``, ``Flatten``, ``Identity`` and ``CrossEntropyLoss``, and
how ``amp`` casts each.

Inputs are made with numpy from a seed and handed to both sides.

Tolerances, float32: outputs within 1e-5 of the largest reference value
(fp32 sums in another order: a conv's 36-144 products, a group's or a
batch channel's mean over up to 640 elements); gradients within 1e-5 of
the largest; running statistics within 1e-6. The split-and-merge
statistics of the GroupNorm kernel (``group_stats_split_plain``, in fp32)
within 1e-6 relative of the float64 mean and variance, also on data whose
mean is 1000 standard deviations from 0 (where E[x^2] - E[x]^2 in fp32
would lose every digit). Initial distributions: sample moments within 5
standard errors of the distribution's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.tensor import Tensor

import paddle_tpu_torch.nn as pnn
from paddle_tpu_torch import amp
from paddle_tpu_torch.kernels import group_norm as GN
from paddle_tpu_torch.models import load_numpy_state
from paddle_tpu_torch.nn import functional as F

JF = paddle.nn.functional


def _jt(a):
    return Tensor(jnp.asarray(a))


def _pt(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    if isinstance(t, Tensor):
        return np.asarray(t._data)
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, want, tol=1e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _state(jl):
    return {n: np.asarray(t._data) for n, t in jl.named_state().items()}


_CONV_CASES = {
    "stride2": dict(stride=2, padding=1),
    "pad_pair": dict(padding=[1, 2]),
    "pad_four": dict(padding=[1, 0, 2, 1]),
    "pad_nested": dict(padding=[[0, 0], [0, 0], [1, 1], [2, 0]]),
    "same_stride2": dict(padding="SAME", stride=2),
    "valid": dict(padding="VALID"),
    "dilation2": dict(padding=2, dilation=2),
    "groups2": dict(padding=1, groups=2),
    "no_bias": dict(padding=1, bias=False),
}


@pytest.mark.parametrize("case", sorted(_CONV_CASES))
def test_conv2d_matches_jax(case):
    kw = dict(_CONV_CASES[case])
    bias = kw.pop("bias", True)
    groups = kw.get("groups", 1)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 9, 11)).astype(np.float32)
    w = rng.standard_normal((6, 4 // groups, 3, 3)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32) if bias else None
    jkw = dict(kw)
    if case == "pad_nested":    # the JAX parser reads 4 entries as ints
        jkw["padding"] = [1, 1, 2, 0]
    want = JF.conv2d(_jt(x), _jt(w), None if b is None else _jt(b), **jkw)
    got = F.conv2d(_pt(x), _pt(w), None if b is None else _pt(b), **kw)
    _close(got, want)


def test_conv2d_gradients_match_jax():
    """dx, dw and db of a stride-2, asymmetrically padded convolution."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 9, 11)).astype(np.float32)
    w = rng.standard_normal((6, 4, 3, 3)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    dy_shape = JF.conv2d(_jt(x), _jt(w), _jt(b), 2, [1, 0, 2, 1]).shape
    dy = rng.standard_normal(dy_shape).astype(np.float32)
    jx, jw, jb = (paddle.to_tensor(a, stop_gradient=False) for a in (x, w, b))
    (JF.conv2d(jx, jw, jb, 2, [1, 0, 2, 1]) * _jt(dy)).sum().backward()
    px, pw, pb = (_pt(a).requires_grad_() for a in (x, w, b))
    F.conv2d(px, pw, pb, 2, [1, 0, 2, 1]).backward(_pt(dy))
    for p, j in ((px, jx), (pw, jw), (pb, jb)):
        _close(p.grad, np.asarray(j.grad.numpy()))


@pytest.mark.parametrize("groups,bias", [(1, True), (2, False)])
def test_conv2d_layer_names_and_initial_distributions(groups, bias):
    """Conv2D's parameters: the JAX names and shapes; weight uniform in
    +-sqrt(6 / fan_in) (KaimingUniform, fan_in = (in / groups) * 9), bias
    uniform in +-1 / sqrt(fan_in); the output with the JAX weights."""
    paddle.seed(3)
    battr = None if bias else False
    jl = paddle.nn.Conv2D(16, 32, 3, padding=1, groups=groups,
                          bias_attr=battr)
    pl = pnn.Conv2D(16, 32, 3, padding=1, groups=groups, bias_attr=battr,
                    device="cpu", generator=torch.Generator().manual_seed(3))
    assert {n: tuple(p.shape) for n, p in pl.named_parameters()} == {
        n: a.shape for n, a in _state(jl).items()}
    fan_in = 16 // groups * 9
    w = pl.weight.detach().numpy().ravel()
    limit = np.sqrt(6.0 / fan_in)
    assert np.abs(w).max() <= limit
    std = limit / np.sqrt(3.0)
    assert abs(w.std() / std - 1) < 5 / np.sqrt(2 * w.size)
    assert abs(w.mean()) < 5 * std / np.sqrt(w.size)
    if bias:
        bv = pl.bias.detach().numpy()
        assert np.abs(bv).max() <= 1 / np.sqrt(fan_in)
        assert abs(bv.mean()) < 5 / np.sqrt(3 * fan_in * bv.size)
    else:
        assert pl.bias is None
    load_numpy_state(pl, _state(jl))
    x = np.random.default_rng(4).standard_normal((2, 16, 6, 6)) \
        .astype(np.float32)
    _close(pl(_pt(x)), jl(_jt(x)))


_GN_CASES = {
    "nchw": ((2, 12, 5, 7), 3, "NCHW", True),
    "nhwc": ((2, 5, 7, 12), 3, "NHWC", True),
    "one_group": ((2, 12, 5, 7), 1, "NCHW", True),
    "group_per_channel": ((2, 12, 5, 7), 12, "NCHW", True),
    "spatial_one": ((3, 8, 1, 1), 4, "NCHW", True),
    "no_affine": ((2, 12, 5, 7), 4, "NCHW", False),
    "rank3": ((2, 6, 20), 2, "NCHW", True),
}


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("case", sorted(_GN_CASES))
def test_group_norm_matches_jax(case, silu):
    """F.group_norm (with the SiLU fused: ``then="silu"``) against the JAX
    group_norm (then silu): output, and dx, dweight, dbias."""
    shape, g, fmt, affine = _GN_CASES[case]
    rng = np.random.default_rng(5)
    x = (2 + 3 * rng.standard_normal(shape)).astype(np.float32)
    c = shape[-1] if fmt == "NHWC" else shape[1]
    w = (1 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    b = (0.2 * rng.standard_normal(c)).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    jx, jw, jb = (paddle.to_tensor(a, stop_gradient=False) for a in (x, w, b))
    jy = JF.group_norm(jx, g, 1e-5, jw if affine else None,
                       jb if affine else None, fmt)
    if silu:
        jy = JF.silu(jy)
    (jy * _jt(dy)).sum().backward()
    px, pw, pb = (_pt(a).requires_grad_() for a in (x, w, b))
    py = F.group_norm(px, g, 1e-5, pw if affine else None,
                      pb if affine else None, fmt,
                      then="silu" if silu else None)
    py.backward(_pt(dy))
    _close(py, jy)
    _close(px.grad, np.asarray(jx.grad.numpy()))
    if affine:
        _close(pw.grad, np.asarray(jw.grad.numpy()))
        _close(pb.grad, np.asarray(jb.grad.numpy()))


def test_group_norm_layer_names_and_values():
    paddle.seed(6)
    jl = paddle.nn.GroupNorm(4, 16)
    pl = pnn.GroupNorm(4, 16, device="cpu")
    assert bool((pl.weight == 1).all()) and not pl.bias.any()
    assert sorted(n for n, _ in pl.named_parameters()) == sorted(_state(jl))
    jl.weight.set_value(jnp.linspace(0.5, 1.5, 16, dtype=jnp.float32))
    load_numpy_state(pl, _state(jl))
    x = np.random.default_rng(6).standard_normal((2, 16, 4, 4)) \
        .astype(np.float32)
    _close(pl(_pt(x)), jl(_jt(x)))


@pytest.mark.parametrize("offset", [0.0, 1000.0])
@pytest.mark.parametrize("shape,groups,n_chunks",
                         [((2, 320, 64, 64), 32, 4), ((2, 960, 16, 16), 32, 3),
                          ((1, 96, 33, 17), 1, 5), ((2, 1280, 8, 8), 32, 1)])
def test_group_norm_split_statistics_against_float64(shape, groups, n_chunks,
                                                     offset):
    """The kernel's statistics (each group's spatial range in chunks of
    whole tiles, each tile's mean and centred sum of squares merged by
    Chan's formula in fp32, then the chunks in order) against float64."""
    rng = np.random.default_rng(7)
    x = (offset + rng.standard_normal(shape)).astype(np.float32)
    mean, var = GN.group_stats_split_plain(_pt(x), groups, n_chunks)
    r = x.astype(np.float64).reshape(shape[0], groups, -1)
    np.testing.assert_allclose(mean.numpy(), r.mean(-1),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), r.var(-1), rtol=1e-5)


def test_group_norm_plan_fills_the_card_and_covers_each_group():
    """``_plan``: tiles of at most 4096 elements and 64 channels; chunks of
    whole tiles that cover the spatial range; about 4 programs an SM where
    the groups are large, and one chunk a group where a group is a
    tile."""
    sms = 132
    for n, g, c, h in ((2, 32, 320, 64), (4, 32, 960, 64), (2, 32, 1280, 8),
                       (4, 32, 640, 32), (1, 1, 96, 7)):
        cg, s = c // g, h * h
        bc, bs, chunk, n_chunks = GN._plan(n, g, cg, s, sms)
        assert bc * bs <= 4096 and bc <= 64 and bc >= min(cg, 64)
        assert chunk % bs == 0 and (n_chunks - 1) * chunk < s <= \
            n_chunks * chunk
        if s > bs:
            assert n * g * n_chunks >= min(4 * sms, n * g * (s // bs)) / 2
    assert GN._plan(2, 32, 40, 64, sms)[3] == 1


@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_matches_jax(training):
    """BatchNorm2D in training (two calls: the running statistics updated
    in place as the JAX eager layer updates them, momentum 0.9 on the old
    value, biased variance) and in eval (the running statistics), with
    dx, dweight and dbias."""
    paddle.seed(8)
    jl = paddle.nn.BatchNorm2D(6)
    pl = pnn.BatchNorm2D(6, device="cpu")
    assert sorted(n for n in pl.state_dict()) == sorted(_state(jl))
    rng = np.random.default_rng(8)
    jl.weight.set_value(jnp.asarray(1 + 0.1 * rng.standard_normal(6),
                                    jnp.float32))
    load_numpy_state(pl, _state(jl))
    x1, x2, dy = (rng.standard_normal((4, 6, 5, 5)).astype(np.float32) * 2
                  + 1 for _ in range(3))
    if not training:
        jl(_jt(x1))
        pl(_pt(x1))
        jl.eval()
        pl.eval()
    jl(_jt(x1))
    pl(_pt(x1))
    jx = paddle.to_tensor(x2, stop_gradient=False)
    jy = jl(jx)
    (jy * _jt(dy)).sum().backward()
    px = _pt(x2).requires_grad_()
    py = pl(px)
    py.backward(_pt(dy))
    _close(py, jy)
    for name in ("_mean", "_variance"):
        np.testing.assert_allclose(_np(getattr(pl, name)),
                                   _state(jl)[name], rtol=0, atol=1e-6)
    _close(px.grad, np.asarray(jx.grad.numpy()))
    _close(pl.weight.grad, np.asarray(jl.weight.grad.numpy()))
    _close(pl.bias.grad, np.asarray(jl.bias.grad.numpy()))


def test_batch_norm_train_output_matches_jax_and_not_torch_momentum():
    """The training output equals the JAX layer's; the running statistics
    follow the JAX convention and not PyTorch's (momentum 0.1 on the new
    value, unbiased variance), which gives other numbers."""
    paddle.seed(9)
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((4, 3, 5, 5)) * 2 + 1).astype(np.float32)
    jl = paddle.nn.BatchNorm2D(3)
    pl = pnn.BatchNorm2D(3, device="cpu")
    _close(pl(_pt(x)), jl(_jt(x)))
    np.testing.assert_allclose(_np(pl._variance), _state(jl)["_variance"],
                               rtol=0, atol=1e-6)
    rm, rv = torch.zeros(3), torch.ones(3)
    torch.nn.functional.batch_norm(_pt(x), rm, rv, training=True,
                                   momentum=0.1)
    assert not torch.allclose(rv, pl._variance, rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", ["scale2", "scale3", "size_odd", "shrink"])
def test_interpolate_nearest_matches_jax(case):
    """Nearest resizing with the JAX index rule; at integer factors the
    broadcast form, whose gradient sums each source pixel's copies. The
    other modes run too (``test_torch_common_layers.py`` holds them all to
    JAX): bilinear here as a check that it no longer raises."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 3, 6, 5)).astype(np.float32)
    kw = {"scale2": dict(scale_factor=2), "scale3": dict(scale_factor=3),
          "size_odd": dict(size=[9, 7]), "shrink": dict(size=[4, 3])}[case]
    _close(F.interpolate(_pt(x), **kw), JF.interpolate(_jt(x), **kw), 0)
    if case == "scale2":
        px = _pt(x).requires_grad_()
        dy = rng.standard_normal((2, 3, 12, 10)).astype(np.float32)
        F.interpolate(px, scale_factor=2).backward(_pt(dy))
        np.testing.assert_allclose(
            px.grad.numpy(), dy.reshape(2, 3, 6, 2, 5, 2).sum(axis=(3, 5)),
            rtol=1e-6)
    kw = dict(scale_factor=2, mode="bilinear")
    _close(F.interpolate(_pt(x), **kw), JF.interpolate(_jt(x), **kw), 1e-5)


@pytest.mark.parametrize("case", ["max_3_2_1", "max_2", "avg_1", "avg_2"])
def test_pools_match_jax(case):
    """max_pool2d (the ResNet stem's 3 x 3 / 2 / 1) and adaptive_avg_pool2d
    ((1, 1) and (2, 2)), outputs and input gradients."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    fn, args = {"max_3_2_1": ("max_pool2d", (3, 2, 1)),
                "max_2": ("max_pool2d", (2,)),
                "avg_1": ("adaptive_avg_pool2d", ((1, 1),)),
                "avg_2": ("adaptive_avg_pool2d", (2,))}[case]
    kw = {}
    jx = paddle.to_tensor(x, stop_gradient=False)
    jy = getattr(JF, fn)(jx, *args, **kw)
    dy = rng.standard_normal(jy.shape).astype(np.float32)
    (jy * _jt(dy)).sum().backward()
    px = _pt(x).requires_grad_()
    py = getattr(F, fn)(px, *args, **kw)
    py.backward(_pt(dy))
    _close(py, jy)
    _close(px.grad, np.asarray(jx.grad.numpy()))


@pytest.mark.parametrize("layer", ["ReLU", "GELU", "Identity", "Flatten"])
def test_activation_and_shape_layers_match_jax(layer):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    jl = getattr(paddle.nn, layer)()
    pl = getattr(pnn, layer)()
    _close(pl(_pt(x)), jl(_jt(x)))


def test_sequential_names_match_jax():
    """Sequential names its sublayers "0", "1", ... (or by the given
    pairs), so a downsample branch's parameters and buffers carry
    across."""
    paddle.seed(13)
    jl = paddle.nn.Sequential(paddle.nn.Conv2D(4, 8, 1, bias_attr=False),
                              paddle.nn.BatchNorm2D(8))
    pl = pnn.Sequential(pnn.Conv2D(4, 8, 1, bias_attr=False, device="cpu"),
                        pnn.BatchNorm2D(8, device="cpu"))
    assert sorted(pl.state_dict()) == sorted(_state(jl)) == [
        "0.weight", "1._mean", "1._variance", "1.bias", "1.weight"]
    named = pnn.Sequential(("conv", pnn.Identity()), ("act", pnn.ReLU()))
    assert [n for n, _ in named.named_children()] == ["conv", "act"]
    assert len(pnn.Sequential([("a", pnn.ReLU()), ("b", pnn.ReLU())])) == 2
    load_numpy_state(pl, _state(jl))
    x = np.random.default_rng(13).standard_normal((2, 4, 3, 3)) \
        .astype(np.float32)
    _close(pl(_pt(x)), jl(_jt(x)))


@pytest.mark.parametrize("labels", ["flat", "column", "ignored"])
def test_cross_entropy_loss_matches_jax(labels):
    rng = np.random.default_rng(14)
    logits = rng.standard_normal((6, 5)).astype(np.float32)
    lab = rng.integers(0, 5, 6)
    if labels == "ignored":
        lab[1] = -100
    if labels == "column":
        lab = lab[:, None]
    want = paddle.nn.CrossEntropyLoss()(_jt(logits), _jt(lab))
    got = pnn.CrossEntropyLoss()(_pt(logits), _pt(lab))
    np.testing.assert_allclose(float(got), float(want.numpy()), rtol=1e-6)


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_amp_casts_the_new_ops_as_jax(level):
    """Under auto_cast, conv2d (white list) computes in bf16; group_norm
    and batch_norm (black list) in fp32, their outputs fp32; the SiLU
    fused after a GroupNorm casts that output as the separate op would
    (O2: to bf16; O1: silu is on no list, fp32); relu and the pools keep
    fp32 at O1 and cast to bf16 at O2. The JAX package's dtypes, op by
    op."""
    rng = np.random.default_rng(15)
    x = rng.standard_normal((2, 8, 6, 6)).astype(np.float32)
    w = rng.standard_normal((8, 8, 3, 3)).astype(np.float32)
    ones, zeros = np.ones(8, np.float32), np.zeros(8, np.float32)
    cases = {
        "conv2d": (lambda f, t: f.conv2d(t(x), t(w), padding=1)),
        "group_norm": (lambda f, t: f.group_norm(t(x), 4)),
        "batch_norm": (lambda f, t: f.batch_norm(
            t(x.astype(np.float32)), t(zeros), t(ones), training=False)),
        "relu": (lambda f, t: f.relu(t(x))),
        "max_pool2d": (lambda f, t: f.max_pool2d(t(x), 2)),
        "adaptive_avg_pool2d": (lambda f, t: f.adaptive_avg_pool2d(t(x), 1)),
        "silu_after_norm": (lambda f, t: f.silu(f.group_norm(t(x), 4))),
    }
    if level == "O2":
        # the JAX max pool cannot run at O2: its -inf padding value asks
        # numpy for bf16's integer limits and raises
        del cases["max_pool2d"]
    for name, run in cases.items():
        with paddle.amp.auto_cast(level=level, dtype="bfloat16"):
            jd = str(run(JF, _jt)._data.dtype)
        with amp.auto_cast(level=level, dtype="bfloat16"):
            if name == "silu_after_norm":
                pd = F.group_norm(_pt(x), 4, then="silu").dtype
            else:
                pd = run(F, _pt).dtype
        assert str(pd).replace("torch.", "") == jd, (name, pd, jd)


@pytest.mark.parametrize("call", ["conv2d_nhwc", "max_pool_nhwc",
                                  "max_pool_ceil", "avg_pool_uneven"])
def test_cases_the_models_do_not_use_raise(call):
    """The convolutional functionals are ported for what the UNet and
    ResNet use (NCHW convolutions, symmetric pools); the other arguments
    raise and name the function. ``interpolate`` takes every layout and
    mode since the common layers were ported."""
    x = torch.zeros(1, 4, 6, 6)
    run = {"conv2d_nhwc": lambda: F.conv2d(x, torch.zeros(4, 6, 3, 3),
                                           data_format="NHWC"),
           "max_pool_nhwc": lambda: F.max_pool2d(x, 2, data_format="NHWC"),
           "max_pool_ceil": lambda: F.max_pool2d(x, 3, 2, ceil_mode=True),
           "avg_pool_uneven": lambda: F.adaptive_avg_pool2d(x, 4)}[call]
    with pytest.raises(NotImplementedError, match=call.split("_")[0]):
        run()
