"""paddle_tpu_torch's BatchNorm layers against paddle_tpu's, on the CPU:
``BatchNorm``, ``BatchNorm1D`` / ``2D`` / ``3D`` and ``SyncBatchNorm`` over
NC, NCL, NCHW, NCDHW and the channel-last formats, in training (two
calls, so that the running statistics move), in eval and with
``use_global_stats``, in float32 and bfloat16. The other norm layers are
in ``test_torch_norm_layers_other.py``.

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
from paddle_tpu_torch.models import load_numpy_state

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


_BN = [("BatchNorm1D", (6, 4), "NC"), ("BatchNorm1D", (3, 4, 7), "NCL"),
       ("BatchNorm1D", (3, 7, 4), "NLC"), ("BatchNorm2D", (3, 4, 5, 5),
                                           "NCHW"),
       ("BatchNorm2D", (3, 5, 5, 4), "NHWC"), ("BatchNorm3D", (2, 4, 3, 3, 3),
                                               "NCDHW"),
       ("BatchNorm3D", (2, 3, 3, 3, 4), "NDHWC"), ("BatchNorm", (3, 4, 5, 5),
                                                   "NCHW"),
       ("SyncBatchNorm", (3, 4, 5, 5), "NCHW")]


@pytest.mark.parametrize("cls,shape,fmt", _BN)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["train", "eval", "global_stats"])
def test_batch_norm_layers_match_jax(cls, shape, fmt, dtype, mode):
    """Each BatchNorm layer: two training calls (the running statistics
    updated in place, as the JAX eager layer updates them), then the call
    compared: in training, in eval, or in training with
    ``use_global_stats`` (the running statistics, not updated); output,
    dx, dweight, dbias and the buffers."""
    c = 4
    ugs = True if mode == "global_stats" else None
    paddle.seed(1)
    jl = getattr(paddle.nn, cls)(c, data_format=fmt, use_global_stats=ugs)
    pl = getattr(pnn, cls)(c, data_format=fmt, use_global_stats=ugs,
                           device="cpu")
    assert sorted(pl.state_dict()) == sorted(_state(jl))
    rng = np.random.default_rng(2)
    jl.weight.set_value(jnp.asarray(1 + 0.2 * rng.standard_normal(c),
                                    jnp.float32))
    jl.bias.set_value(jnp.asarray(0.2 * rng.standard_normal(c),
                                  jnp.float32))
    load_numpy_state(pl, _state(jl))
    xs = [(rng.standard_normal(shape) * 2 + 1).astype(np.float32)
          for _ in range(3)]
    dy = rng.standard_normal(shape).astype(np.float32)
    if mode == "global_stats":
        # the statistics the call reads, moved away from (0, 1) first
        jl._use_global_stats = pl._use_global_stats = None
    for x in xs[:2]:
        jl(Tensor(jnp.asarray(x, _JDT[dtype])))
        pl(torch.from_numpy(x).to(getattr(torch, dtype)))
    if mode == "eval":
        jl.eval()
        pl.eval()
    jl._use_global_stats = pl._use_global_stats = ugs
    jx, px = _pair(xs[2], dtype)
    jy, py = jl(jx), pl(px)
    assert str(py.dtype).replace("torch.", "") == str(jy._data.dtype)
    _backward(jy, py, dy, dtype)
    _close(py, jy, dtype)
    _close(px.grad, jx.grad, dtype)
    _close(pl.weight.grad, jl.weight.grad)
    _close(pl.bias.grad, jl.bias.grad)
    for name in ("_mean", "_variance"):
        np.testing.assert_allclose(_np(getattr(pl, name)),
                                   _state(jl)[name], rtol=0, atol=1e-6)
