"""The plain versions of the training step's fused passes against the JAX
functions they stand for, on the CPU.

``kernels.fused`` ports two groups of elementwise work that XLA fuses into
the JAX package's compiled training step, each as a Triton kernel beside
its plain version (the card holds the kernels to the plain versions;
``tests/test_torch_cuda.py``). Here the plain versions meet JAX:

- ``rms_norm_backward_plain`` against ``jax.vjp`` of the JAX package's
  ``nn.functional.rms_norm`` (the oracle its ``custom_vjp`` recomputes);
- ``swiglu_plain`` and ``swiglu_backward_plain`` against ``jax.vjp`` of
  the JAX Llama MLP's ``F.silu(gate) * up``.

Tolerances. float32: rtol 1e-5, atol 1e-6 (the two differentiate the same
formula; the JAX oracle divides by ``sqrt`` where the port multiplies by
``rsqrt``, and sums in another order). bf16, RMSNorm: every element
within one bf16 ulp of the larger magnitude (2^-7 relative) plus 1e-6:
both compute in fp32 and round once to bf16. bf16, SwiGLU: the JAX
``silu`` is ``x * sigmoid(x)`` with sigmoid rounded to bf16 first, and its
vjp rounds each term, where PyTorch rounds silu once and its backward
once; so y and dup within two ulps of the larger magnitude (2^-6
relative), and dgate, whose terms cancel, within 2^-6 of the terms'
scale ``|dy * up| * (1 + |gate|)`` (seen: up to 1.44 x 2^-8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn import functional as JF
from paddle_tpu.tensor import Tensor

from paddle_tpu_torch import amp
from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.kernels import fused
from paddle_tpu_torch.nn import functional as F

DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _t(a, dtype):
    return torch.from_numpy(_np(a).copy()).to(dtype)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, name, bf16, ulps=1, scale=None):
    got = got.float().numpy()
    want = _np(want)
    if bf16:
        if scale is None:
            scale = np.maximum(np.abs(got), np.abs(want))
        tol = ulps * 2.0 ** -7 * scale + 1e-6
        assert np.all(np.abs(got - want) <= tol), name
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(4, 64), (2, 3, 96), (5, 130)])
def test_rms_norm_backward_plain_matches_jax_vjp(shape, dtype):
    _, jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(len(shape) * 7 + shape[-1])
    x = jnp.asarray(rng.standard_normal(shape), jdt)
    w = jnp.asarray(1.0 + 0.1 * rng.standard_normal(shape[-1]), jdt)
    dy = jnp.asarray(rng.standard_normal(shape), jdt)
    _, vjp = jax.vjp(lambda a, b: JF.rms_norm(Tensor(a), Tensor(b),
                                              1e-6)._data, x, w)
    want_dx, want_dw = vjp(dy)
    dx, dw = fused.rms_norm_backward_plain(_t(x, tdt), _t(w, tdt),
                                           _t(dy, tdt), 1e-6)
    assert dx.dtype == dw.dtype == tdt
    _close(dx, want_dx, "dx", dtype == "bf16")
    if dtype == "bf16":
        # dw sums a column's products over every row before its one
        # rounding: both sums in fp32, so within one bf16 ulp as well
        _close(dw, want_dw, "dw", True)
    else:
        np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw),
                                   rtol=1e-5, atol=1e-5, err_msg="dw")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(4, 64), (2, 3, 96)])
def test_swiglu_plain_matches_jax_mlp(shape, dtype):
    _, jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(shape[-1])
    g = jnp.asarray(3 * rng.standard_normal(shape), jdt)
    u = jnp.asarray(rng.standard_normal(shape), jdt)
    dy = jnp.asarray(rng.standard_normal(shape), jdt)
    y, vjp = jax.vjp(lambda a, b: (JF.silu(Tensor(a)) * Tensor(b))._data,
                     g, u)
    want_dg, want_du = vjp(dy)
    bf16 = dtype == "bf16"
    got = fused.swiglu_plain(_t(g, tdt), _t(u, tdt))
    assert got.dtype == tdt
    _close(got, y, "y", bf16, ulps=2)
    dg, du = fused.swiglu_backward_plain(_t(g, tdt), _t(u, tdt), _t(dy, tdt))
    _close(dg, want_dg, "dgate", bf16, ulps=2,
           scale=np.abs(_np(dy) * _np(u)) * (1 + np.abs(_np(g))))
    _close(du, want_du, "dup", bf16, ulps=2)


def test_fused_autograd_on_cpu_is_the_plain_versions():
    """On CPU tensors ``RMSNormFunction``'s backward and
    ``SwiGLUFunction`` are the plain versions bit for bit, and launch
    nothing."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((6, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((6, 32)).astype(np.float32))
    before = K.kernel_launches()
    xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
    fused.rms_norm(xx, ww).backward(dy)
    want = fused.rms_norm_backward_plain(x, w, dy)
    assert torch.equal(xx.grad, want[0]) and torch.equal(ww.grad, want[1])
    g, u = x.clone().requires_grad_(), (x * 0.5).requires_grad_()
    out = fused.swiglu(g, u)
    assert torch.equal(out, fused.swiglu_plain(x, x * 0.5))
    out.backward(dy)
    dg, du = fused.swiglu_backward_plain(x, x * 0.5, dy)
    assert torch.equal(g.grad, dg) and torch.equal(u.grad, du)
    assert K.kernel_launches() == before


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_swiglu_under_auto_cast_casts_as_silu_then_multiply(level):
    """``F.swiglu`` under ``auto_cast`` equals the two JAX ops run one by
    one by the cast mode, forward and backward (float32 gate, bf16 up: O1
    leaves both, so the product is float32 and each gradient keeps its
    input's dtype; O2 casts the gate to bf16)."""
    rng = np.random.default_rng(4)
    g = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32)) \
        .to(torch.bfloat16)
    dy = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    grads = []
    for two_ops in (True, False):
        gg, uu = g.clone().requires_grad_(), u.clone().requires_grad_()
        with amp.auto_cast(level=level, dtype="bfloat16"):
            out = (torch.nn.functional.silu(gg) * uu if two_ops
                   else F.swiglu(gg, uu))
        out.backward(dy.to(out.dtype))
        grads.append((out.detach(), gg.grad, uu.grad))
    (want, want_dg, want_du), (got, dg, du) = grads
    assert got.dtype == want.dtype == (torch.bfloat16 if level == "O2"
                                       else torch.float32)
    assert torch.equal(got, want)
    assert dg.dtype == torch.float32 and du.dtype == torch.bfloat16
    assert torch.equal(dg, want_dg) and torch.equal(du, want_du)


@pytest.mark.parametrize("level", [None, "O2"])
def test_swiglu_under_debugging_counts_silu_then_multiply(level):
    """``F.swiglu`` under operator-stats collection counts the JAX MLP's
    ops, "silu" then "multiply", by the same names and input dtypes as
    the JAX package counts ``F.silu(gate) * up`` (with and without
    ``auto_cast``), and gives the same values as without the collection;
    the tensor checker raises on a NaN that silu passes to the product."""
    from paddle_tpu import amp as jamp
    from paddle_tpu.amp import debugging as jdbg
    from paddle_tpu_torch.amp import debugging
    rng = np.random.default_rng(5)
    g = rng.standard_normal((4, 16)).astype(np.float32)
    u = rng.standard_normal((4, 16)).astype(np.float32)
    def cast():
        return amp.auto_cast(enable=bool(level), level=level or "O1")
    jdbg.enable_operator_stats_collection()
    with jamp.auto_cast(enable=bool(level), level=level or "O1"):
        JF.silu(Tensor(jnp.asarray(g))) * Tensor(jnp.asarray(u))
    want = jdbg.disable_operator_stats_collection()
    gt, ut = torch.from_numpy(g), torch.from_numpy(u)
    with cast():
        plain = F.swiglu(gt, ut)
    debugging.enable_operator_stats_collection()
    try:
        with cast():
            out = F.swiglu(gt, ut)
    finally:
        got = debugging.disable_operator_stats_collection()
    assert got == {k: v for k, v in want.items()
                   if k.split("(")[0] in ("silu", "multiply")}
    assert torch.equal(out, plain)
    debugging.enable_tensor_checker(debugging.TensorCheckerConfig())
    try:
        F.swiglu(gt, ut)
        gt[1, 2] = float("nan")
        with pytest.raises(FloatingPointError):
            F.swiglu(gt, ut)
    finally:
        debugging.disable_tensor_checker()
    assert amp.amp_state.modes == 0 and not amp.amp_state.observers
