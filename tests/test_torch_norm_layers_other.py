"""paddle_tpu_torch's other norm layers and functionals against
paddle_tpu's, on the CPU: ``RMSNorm``, ``InstanceNorm1D`` / ``2D`` /
``3D``, ``LocalResponseNorm``, ``SyncBatchNorm.convert_sync_batchnorm``
and the functionals ``instance_norm``, ``local_response_norm`` and
``normalize``; and the dtypes ``amp.auto_cast`` gives each norm. The
BatchNorm layers are in ``test_torch_norm_layers.py``.

Inputs are made with numpy from a seed and handed to both sides; the JAX
gradients are its autograd's (``jax.vjp`` of each op).

Tolerances: float32 outputs and gradients within 1e-5 of the largest
reference value (fp32 means and sums in another order over up to a few
hundred values); bfloat16 within two bf16 ulps (2^-6) of the largest
reference value: both compute in fp32 from the same bf16 values and round
once, but the fp32 sums before the rounding differ in order, which can
move a value across a rounding boundary. Running statistics (fp32 on both
sides) within 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.tensor import Tensor

import paddle_tpu_torch.nn as pnn
from paddle_tpu_torch import amp
from paddle_tpu_torch.models import load_numpy_state
from paddle_tpu_torch.nn import functional as F

JF = paddle.nn.functional
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _np(t):
    if isinstance(t, Tensor):
        return np.asarray(t._data.astype(jnp.float32))
    return t.detach().float().numpy()


def _close(got, want, dtype="float32"):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    tol = 1e-5 if dtype == "float32" else 2.0 ** -6
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _state(jl):
    return {n: np.asarray(t._data) for n, t in jl.named_state().items()}


def _pair(x, dtype):
    """The same values as a JAX leaf and a torch leaf, in ``dtype``."""
    jx = Tensor(jnp.asarray(x, _JDT[dtype]), stop_gradient=False)
    px = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    return jx, px


def _backward(jy, py, dy, dtype):
    (jy * Tensor(jnp.asarray(dy, _JDT[dtype]))).sum().backward()
    py.backward(torch.from_numpy(dy).to(py.dtype))


@pytest.mark.parametrize("cls,shape", [("InstanceNorm1D", (3, 4, 9)),
                                       ("InstanceNorm2D", (2, 4, 5, 6)),
                                       ("InstanceNorm3D", (2, 4, 3, 4, 5))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_norm_layers_match_jax(cls, shape, dtype):
    """Each (sample, channel) over its spatial axes, the weight and bias at
    axis 1: output, dx, dweight, dbias (the GroupNorm kernel's plain
    version with one channel a group)."""
    c = shape[1]
    jl = getattr(paddle.nn, cls)(c)
    pl = getattr(pnn, cls)(c, device="cpu")
    assert sorted(pl.state_dict()) == sorted(_state(jl))
    rng = np.random.default_rng(3)
    jl.weight.set_value(jnp.asarray(1 + 0.2 * rng.standard_normal(c),
                                    jnp.float32))
    jl.bias.set_value(jnp.asarray(0.2 * rng.standard_normal(c),
                                  jnp.float32))
    load_numpy_state(pl, _state(jl))
    x = (rng.standard_normal(shape) * 3 - 1).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    jx, px = _pair(x, dtype)
    jy, py = jl(jx), pl(px)
    _backward(jy, py, dy, dtype)
    _close(py, jy, dtype)
    _close(px.grad, jx.grad, dtype)
    _close(pl.weight.grad, jl.weight.grad)
    _close(pl.bias.grad, jl.bias.grad)


def test_instance_norm_functional_without_affine_matches_jax():
    """``instance_norm`` without weight and bias, and a 2-D input (each
    value its own instance: the output is 0)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 7)).astype(np.float32)
    _close(F.instance_norm(torch.from_numpy(x)),
           JF.instance_norm(Tensor(jnp.asarray(x))))
    x2 = rng.standard_normal((5, 3)).astype(np.float32)
    _close(F.instance_norm(torch.from_numpy(x2)),
           JF.instance_norm(Tensor(jnp.asarray(x2))))


@pytest.mark.parametrize("size", [1, 3, 4, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_local_response_norm_matches_jax(size, dtype):
    """``LocalResponseNorm`` (the JAX package's window sum, not PyTorch's
    mean), output and dx, 4-D and 3-D."""
    rng = np.random.default_rng(5)
    for shape in ((2, 6, 4, 5), (3, 7, 5)):
        x = rng.standard_normal(shape).astype(np.float32) * 3
        dy = rng.standard_normal(shape).astype(np.float32)
        jl = paddle.nn.LocalResponseNorm(size, alpha=0.1, beta=0.75, k=2.0)
        pl = pnn.LocalResponseNorm(size, alpha=0.1, beta=0.75, k=2.0)
        jx, px = _pair(x, dtype)
        jy, py = jl(jx), pl(px)
        _backward(jy, py, dy, dtype)
        _close(py, jy, dtype)
        _close(px.grad, jx.grad, dtype)
    x = torch.ones(1, 5, 1, 1)
    want = torch.nn.functional.local_response_norm(x, 3, 0.1, 0.75, 2.0)
    assert not torch.allclose(F.local_response_norm(x, 3, 0.1, 0.75, 2.0),
                              want)


@pytest.mark.parametrize("p,axis", [(2, 1), (2, -1), (1, 1), (3, 0)])
def test_normalize_matches_jax(p, axis):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 5, 3)).astype(np.float32)
    dy = rng.standard_normal((4, 5, 3)).astype(np.float32)
    jx, px = _pair(x, "float32")
    jy = JF.normalize(jx, p=p, axis=axis)
    py = F.normalize(px, p=p, axis=axis)
    _backward(jy, py, dy, "float32")
    _close(py, jy)
    _close(px.grad, jx.grad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_layer_matches_jax(dtype):
    """``RMSNorm`` (the Triton kernel's plain version on the CPU): output,
    dx and dweight."""
    jl = paddle.nn.RMSNorm(8, epsilon=1e-5)
    pl = pnn.RMSNorm(8, epsilon=1e-5, device="cpu")
    rng = np.random.default_rng(7)
    jl.weight.set_value(jnp.asarray(1 + 0.2 * rng.standard_normal(8),
                                    jnp.float32))
    load_numpy_state(pl, _state(jl))
    x = rng.standard_normal((3, 5, 8)).astype(np.float32)
    dy = rng.standard_normal((3, 5, 8)).astype(np.float32)
    jx, px = _pair(x, dtype)
    jy, py = jl(jx), pl(px)
    _backward(jy, py, dy, dtype)
    _close(py, jy, dtype)
    _close(px.grad, jx.grad, dtype)
    _close(pl.weight.grad, jl.weight.grad, dtype)


def test_convert_sync_batchnorm_matches_jax():
    """Every BatchNorm of a model, nested ones and the model itself,
    becomes a SyncBatchNorm holding the same weight, bias and running
    statistics; the converted models agree with JAX's; a SyncBatchNorm
    stays as it is."""
    paddle.seed(8)
    rng = np.random.default_rng(8)

    def build(nn, **kw):
        return nn.Sequential(nn.Conv2D(3, 4, 3, padding=1, **kw),
                             nn.BatchNorm2D(4, **kw), nn.ReLU(),
                             nn.Sequential(nn.BatchNorm(4, **kw)))
    jm, pm = build(paddle.nn), build(pnn, device="cpu")
    state = _state(jm)
    state = {k: (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
             for k, v in state.items()}
    jm.set_state_dict({k: Tensor(jnp.asarray(v)) for k, v in state.items()})
    load_numpy_state(pm, state)
    jc = paddle.nn.SyncBatchNorm.convert_sync_batchnorm(jm)
    pc = pnn.SyncBatchNorm.convert_sync_batchnorm(pm)
    assert isinstance(pc[1], pnn.SyncBatchNorm)
    assert isinstance(pc[3][0], pnn.SyncBatchNorm)
    assert sorted(pc.state_dict()) == sorted(_state(jc))
    for k, v in pc.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), state[k])
    single = pnn.BatchNorm3D(4, momentum=0.8, epsilon=1e-3,
                             data_format="NDHWC", device="cpu")
    conv = pnn.SyncBatchNorm.convert_sync_batchnorm(single)
    assert isinstance(conv, pnn.SyncBatchNorm) and conv._momentum == 0.8 \
        and conv._epsilon == 1e-3 and conv._data_format == "NDHWC"
    assert pnn.SyncBatchNorm.convert_sync_batchnorm(conv) is conv
    x = rng.standard_normal((2, 3, 5, 5)).astype(np.float32)
    _close(pc(torch.from_numpy(x)), jc(Tensor(jnp.asarray(x))))
    for name in ("1._mean", "1._variance", "3.0._mean", "3.0._variance"):
        np.testing.assert_allclose(pc.state_dict()[name].numpy(),
                                   _state(jc)[name], rtol=0, atol=1e-6)


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_norms_cast_as_jax_under_amp(level):
    """Under auto_cast the norms are their JAX ops: batch_norm,
    instance_norm and rms_norm black-listed (fp32 out of a bf16 input),
    local_response_norm and normalize on no list (cast to bf16 at O2);
    the dtypes equal the JAX package's op by op."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 4, 5, 5)).astype(np.float32)
    w = np.ones(4, np.float32)
    cases = {
        "batch_norm": lambda f, t: f.batch_norm(
            t(x), t(np.zeros(4, np.float32)), t(w), t(w), t(0 * w),
            training=True),
        "instance_norm": lambda f, t: f.instance_norm(t(x), weight=t(w)),
        "rms_norm": lambda f, t: f.rms_norm(t(x), t(np.ones(5, np.float32))),
        "local_response_norm": lambda f, t: f.local_response_norm(t(x), 3),
        "normalize": lambda f, t: f.normalize(t(x)),
    }
    for name, run in cases.items():
        for src in ("float32", "bfloat16"):
            def jt(a):
                return Tensor(jnp.asarray(a, _JDT[src]))

            def pt(a):
                return torch.from_numpy(a).to(getattr(torch, src))
            with paddle.amp.auto_cast(level=level, dtype="bfloat16"):
                jd = str(run(JF, jt)._data.dtype)
            with amp.auto_cast(level=level, dtype="bfloat16"):
                pd = str(run(F, pt).dtype).replace("torch.", "")
            assert pd == jd, (name, src, pd, jd)
