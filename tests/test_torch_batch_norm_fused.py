"""The BatchNorm kernel module's plain version on the CPU: its fused form
(``residual=``, ``relu``) against the composition of its unfused form with
PyTorch's add and ReLU, through ``nn.functional.batch_norm`` with and
without ``amp.auto_cast``; the kernel's split-and-merge statistics
(``batch_stats_split_plain``) against float64; the launch plan; and the
plain version against the JAX package's ``batch_norm``.

Tolerances: the fused form and the composition must be bit-equal (the
same fp32 formula, rounded at the same places), outputs and every
gradient, with the running statistics. The split-and-merge statistics in
fp32 within 1e-6 relative of the float64 mean and 5e-5 of the variance,
also on data whose mean is 1000 standard deviations from 0, where E[x^2]
- E[x]^2 in fp32 would lose every digit: there each tile's mean carries
about half an fp32 ulp of 1000 (3e-5), which Chan's d^2 term carries into
the variance of tiles of 25 values at about 2e-5. The plain version
against JAX in fp32: outputs and gradients within 1e-5 of the largest
value (fp32 means in another order), running statistics within 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.tensor import Tensor

from paddle_tpu_torch import amp
from paddle_tpu_torch.kernels import batch_norm as BN
from paddle_tpu_torch.nn import functional as F


def _inputs(shape, channels_last, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    c = shape[-1] if channels_last and len(shape) > 2 else shape[1]
    x = torch.from_numpy((rng.standard_normal(shape) * 2 + 0.5)
                         .astype(np.float32)).to(dtype)
    res = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    w = torch.from_numpy((1 + 0.2 * rng.standard_normal(c))
                         .astype(np.float32))
    b = torch.from_numpy((0.2 * rng.standard_normal(c)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x, res, w, b, dy, c


_CASES = [((4, 6, 5, 5), "NCHW"), ((3, 5, 7), "NCL"), ((6, 4), "NC"),
          ((2, 3, 4, 3, 5), "NCDHW"), ((3, 4, 5, 6), "NHWC")]


@pytest.mark.parametrize("shape,fmt", _CASES)
@pytest.mark.parametrize("level", [None, "O1", "O2"])
@pytest.mark.parametrize("training", [True, False])
def test_fused_form_is_the_composition(shape, fmt, level, training):
    """``batch_norm(x, residual=r, then="relu")`` against
    ``relu(batch_norm(x) + r)`` op by op, with bf16 x and an fp32
    residual: bit-equal output, dx, dresidual, dweight, dbias and running
    statistics, without amp and under O1 and O2 (where the norm writes
    fp32 and the add and the ReLU cast as the separate ops do); and
    ``then="relu"`` alone against ``relu(batch_norm(x))``."""
    last = fmt.endswith("C") and fmt != "NCHW"
    x, res, w, b, dy, c = _inputs(shape, last, 1, torch.bfloat16)
    stats = [torch.zeros(c), torch.ones(c)]
    for with_res in (True, False):
        runs = []
        for fused in (True, False):
            xi = x.clone().requires_grad_()
            ri = res.clone().requires_grad_()
            wi, bi = w.clone().requires_grad_(), b.clone().requires_grad_()
            rm, rv = (t.clone() for t in stats)
            kw = dict(training=training, data_format=fmt)
            ctx = amp.auto_cast(level=level) if level else \
                torch.autograd.grad_mode.enable_grad()
            with ctx:
                if fused:
                    y = F.batch_norm(xi, rm, rv, wi, bi, **kw,
                                     residual=ri if with_res else None,
                                     then="relu")
                else:
                    z = F.batch_norm(xi, rm, rv, wi, bi, **kw)
                    y = F.relu(z + ri if with_res else z)
            y.backward(dy.to(y.dtype))
            runs.append((y, xi.grad, ri.grad, wi.grad, bi.grad, rm, rv))
        for got, want in zip(*runs):
            if got is None or want is None:
                assert got is None and want is None
                continue
            assert got.dtype == want.dtype
            assert torch.equal(got, want)


def test_residual_dtypes_promote_as_the_add():
    """Without amp a bf16 norm output and an fp32 residual add in fp32
    (the norm's output rounded to bf16 first); a bf16 residual keeps
    bf16."""
    x, res, w, b, _, c = _inputs((4, 6, 3, 3), False, 2, torch.bfloat16)
    rm, rv = torch.zeros(c), torch.ones(c)
    y = F.batch_norm(x, rm, rv, w, b, residual=res, then="relu")
    z = F.batch_norm(x, rm, rv, w, b)
    assert z.dtype == torch.bfloat16 and y.dtype == torch.float32
    assert torch.equal(y, torch.relu(z.float() + res))
    y16 = F.batch_norm(x, rm, rv, w, b, residual=res.bfloat16())
    assert y16.dtype == torch.bfloat16
    assert torch.equal(y16, z + res.bfloat16())


@pytest.mark.parametrize("shape,fmt", _CASES + [((2, 7, 1, 1), "NCHW"),
                                               ((3, 5, 12, 12), "NCHW")])
@pytest.mark.parametrize("n_chunks", [1, 3, 8])
@pytest.mark.parametrize("offset", [0.0, 1000.0])
def test_split_statistics_match_float64(shape, fmt, n_chunks, offset):
    """The kernel's arithmetic (tiles merged by Chan's formula into chunks,
    the chunks merged in order) in fp32 on the CPU: within 1e-6 relative
    of the float64 mean and 5e-5 of the variance, also 1000 standard
    deviations from 0."""
    last = fmt.endswith("C") and fmt != "NCHW"
    rng = np.random.default_rng(3)
    x64 = rng.standard_normal(shape) + offset
    x = torch.from_numpy(x64.astype(np.float32))
    mean, var = BN.batch_stats_split_plain(x, n_chunks, last)
    ch = len(shape) - 1 if last and len(shape) > 2 else 1
    axes = tuple(i for i in range(len(shape)) if i != ch)
    x32 = x64.astype(np.float32).astype(np.float64)
    want_m = x32.mean(axis=axes)
    want_v = x32.var(axis=axes)
    np.testing.assert_allclose(mean.numpy(), want_m, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), want_v, rtol=5e-5)


@pytest.mark.parametrize("shape,channels_last", [
    ((128, 64, 112, 112), False), ((128, 256, 56, 56), False),
    ((128, 512, 28, 28), False), ((128, 1024, 14, 14), False),
    ((128, 2048, 7, 7), False), ((32, 16), False), ((8, 7, 7, 320), True),
    ((4, 3, 1, 1), False)])
def test_plan_fills_the_card_and_covers_every_tile(shape, channels_last):
    """The plan at ResNet-50's shapes (and a few others): at least 132
    programs where there are that many tiles, at most about 4 an SM;
    tiles of at most 4096 elements; the chunks cover each channel's
    tiles exactly once; a spatial run's tiles hold at most 35% more lanes
    than the run (``_RUN_WASTE``) where a power of two of at least 16
    does, and a run of up to 1024 that fits one such tile takes one."""
    n, c, s, sn, sc, ss = BN._layout(shape, channels_last)
    rows = sc == 1
    bc, bs, ns, per, n_chunks = BN._plan(n, c, s, rows, 132)
    assert bc * bs <= BN._TILE and bc >= 1 and bs >= 1
    assert ns == -(-s // bs) and (n_chunks - 1) * per < n * ns <= \
        n_chunks * per
    programs = -(-c // bc) * n_chunks
    assert programs <= 4 * 132 + -(-c // bc)
    if -(-c // bc) * n * ns >= 132:
        assert programs >= 132
    if not rows and s >= 16 and any(
            -(-s // blk) * blk <= BN._RUN_WASTE * s
            for blk in BN._RUN_BLOCKS):
        assert ns * bs <= BN._RUN_WASTE * s
        if s <= 1024 and BN._next_pow2(s) <= BN._RUN_WASTE * s:
            assert ns == 1
    assert n * s * c == int(np.prod(shape))


@pytest.mark.parametrize("shape,fmt", _CASES)
@pytest.mark.parametrize("mode", ["train", "eval", "global_stats"])
def test_plain_version_matches_jax(shape, fmt, mode):
    """``batch_norm_plain`` (the kernel's plain version) against the JAX
    package's ``F.batch_norm``: output, dx, dweight, dbias and the
    running statistics after two calls."""
    last = fmt.endswith("C") and fmt != "NCHW"
    x, _, w, b, dy, c = _inputs(shape, last, 4)
    training = mode != "eval"
    ugs = True if mode == "global_stats" else None
    rng = np.random.default_rng(5)
    rm0 = (0.1 * rng.standard_normal(c)).astype(np.float32)
    rv0 = (1 + 0.1 * rng.random(c)).astype(np.float32)
    jrm, jrv = Tensor(jnp.asarray(rm0)), Tensor(jnp.asarray(rv0))
    prm, prv = torch.from_numpy(rm0.copy()), torch.from_numpy(rv0.copy())
    jw = paddle.to_tensor(w.numpy(), stop_gradient=False)
    jb = paddle.to_tensor(b.numpy(), stop_gradient=False)
    for step in range(2):
        jx = paddle.to_tensor(x.numpy(), stop_gradient=False)
        jy = paddle.nn.functional.batch_norm(
            jx, jrm, jrv, jw, jb, training=training, data_format=fmt,
            use_global_stats=ugs)
        px = x.clone().requires_grad_()
        pw, pb = w.clone().requires_grad_(), b.clone().requires_grad_()
        py = BN.batch_norm_plain(px, prm, prv, pw, pb,
                                 training and not ugs, 0.9, 1e-5, last)
    (jy * Tensor(jnp.asarray(dy.numpy()))).sum().backward()
    py.backward(dy)
    scale = max(1.0, float(np.abs(np.asarray(jy._data)).max()))
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(jy._data),
                               rtol=0, atol=1e-5 * scale)
    for got, want in ((px.grad, jx.grad), (pw.grad, jw.grad),
                      (pb.grad, jb.grad)):
        want = np.asarray(want.numpy())
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))
    np.testing.assert_allclose(prm.numpy(), np.asarray(jrm._data), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(prv.numpy(), np.asarray(jrv._data), rtol=0,
                               atol=1e-6)


def test_then_other_than_relu_raises():
    x = torch.zeros(2, 3, 4, 4)
    with pytest.raises(NotImplementedError, match="relu"):
        F.batch_norm(x, torch.zeros(3), torch.ones(3), then="silu")


@pytest.mark.parametrize("training", [True, False])
def test_empty_batch_launches_nothing_and_matches_plain(training):
    """The kernel wrappers on an empty batch launch nothing, so count
    nothing; in training the running statistics become NaN as the plain
    version's do (the mean of no values), in eval they stay."""
    from paddle_tpu_torch import kernels as K
    x = torch.zeros(0, 3, 4, 4, dtype=torch.bfloat16)
    w, b = torch.ones(3), torch.zeros(3)
    stats = [torch.zeros(3), torch.ones(3)]
    before = dict(K.LAUNCHES)
    got_rm, got_rv = (t.clone() for t in stats)
    y, saved = BN.batch_norm_forward(x, w, b, got_rm, got_rv, training,
                                     relu=True, out_dtype=torch.float32)
    dx, dres, dw, db = BN.batch_norm_backward(x, w, saved, torch.zeros(
        x.shape), y, training, relu=True)
    assert K.LAUNCHES == before
    want_rm, want_rv = (t.clone() for t in stats)
    want = BN.batch_norm_plain(x, want_rm, want_rv, w, b, training,
                               relu=True, out_dtype=torch.float32)
    assert y.shape == want.shape == x.shape and dx.shape == x.shape
    assert dres is None
    for got, ref in ((got_rm, want_rm), (got_rv, want_rv)):
        assert torch.equal(got.isnan(), ref.isnan())
        assert torch.equal(got.nan_to_num(), ref.nan_to_num())
    assert torch.isnan(got_rm).all() == training
    assert torch.equal(dw, torch.zeros(3)) and torch.equal(db, torch.zeros(3))
