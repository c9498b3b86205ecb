"""The training slice's kernel modules of paddle_tpu_torch against
paddle_tpu's, on the CPU.

The same numpy inputs go through the JAX function and the port's plain
version: flash attention forward and backward against the Pallas kernels
in interpret mode, AdamW against the Pallas kernel in interpret mode and
``_adam_update``, and the RMSNorm and RoPE gradients (the port's autograd
functions, with their launches routed to the plain versions, since no
kernel runs here) against the JAX vjp of the oracles.

Tolerances: float32 2e-5 (forward) and 1e-4 (gradients, sums of 256
products of O(1) values), both sides sum in fp32 in another order; bf16
two ulps (2^-6) of the largest reference value, since each side rounds the
same fp32 values once to bf16 and the fp32 sums before that rounding
differ in order; AdamW 1e-6 relative (the same fp32 operations, up to one
ulp from pow and from any fused multiply-add on the JAX side).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.autograd.tape import no_grad
from paddle_tpu.kernels import flash_pallas as fp
from paddle_tpu.kernels import fused_pallas
from paddle_tpu.kernels import optimizer_pallas
from paddle_tpu.models.llama import apply_rope
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import _adam_update
from paddle_tpu.tensor import Tensor

from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.kernels import fused
from paddle_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_bshd, flash_backward_plain,
    flash_forward_plain)
from paddle_tpu_torch.kernels.optimizer import adamw_plain, multi_tensor_adamw
from paddle_tpu_torch.nn import functional as F


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(fp, "_INTERPRET", True)
    monkeypatch.setattr(fused_pallas, "_INTERPRET", True)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x, dtype):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _tol(ref, dtype, f32):
    if dtype == torch.float32:
        return f32
    return 2.0 ** -6 * float(np.abs(ref).max())


_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}

# (b, h, sq, sk, d, causal, dtype)
CASES = {
    "f32": (1, 2, 256, 256, 64, False, torch.float32),
    "f32_causal": (1, 2, 256, 256, 64, True, torch.float32),
    "f32_causal_sq_lt_sk": (1, 2, 128, 256, 64, True, torch.float32),
    "bf16_causal": (1, 2, 256, 256, 64, True, torch.bfloat16),
}


def _qkv(b, h, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, h, sk, d)).astype(np.float32),
            rng.standard_normal((b, h, sk, d)).astype(np.float32),
            rng.standard_normal((b, h, sq, d)).astype(np.float32))


@pytest.mark.parametrize("case", list(CASES))
def test_flash_forward_plain_matches_pallas(case):
    b, h, sq, sk, d, causal, dt = CASES[case]
    q, k, v, _ = _qkv(b, h, sq, sk, d)
    jq, jk, jv = (jnp.asarray(x, _JDT[dt]) for x in (q, k, v))
    want, wlse = fp._flash_forward(jq, jk, jv, causal, None, 128, 128)
    got, lse = flash_forward_plain(_t(q, dt), _t(k, dt), _t(v, dt), causal)
    assert got.dtype == dt and lse.dtype == torch.float32
    want = _np(want)
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=_tol(want, dt, 2e-5))
    np.testing.assert_allclose(lse.numpy().reshape(b * h, sq),
                               np.asarray(wlse)[..., 0], atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_flash_backward_plain_matches_pallas(case):
    """Both backwards get the JAX forward's out and lse and the same dO."""
    b, h, sq, sk, d, causal, dt = CASES[case]
    q, k, v, g = _qkv(b, h, sq, sk, d)
    jq, jk, jv, jg = (jnp.asarray(x, _JDT[dt]) for x in (q, k, v, g))
    out, lse = fp._flash_forward(jq, jk, jv, causal, None, 128, 128)
    want = fp._flash_backward(jq, jk, jv, out, lse, jg, causal, None, 128,
                              128)
    got = flash_backward_plain(
        _t(q, dt), _t(k, dt), _t(v, dt), _t(_np(out), dt),
        torch.from_numpy(np.asarray(lse)[..., 0].reshape(b, h, sq)),
        _t(g, dt), causal)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dt
        w = _np(w)
        np.testing.assert_allclose(a.float().numpy(), w,
                                   atol=_tol(w, dt, 1e-4), err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_autograd_matches_jax_grad(causal):
    """FlashAttention's backward (on CPU tensors: the plain versions)
    against jax.grad through the Pallas kernel, fp32."""
    q, k, v, g = _qkv(1, 2, 256, 256, 64, seed=1)
    w = np.cos(np.arange(64, dtype=np.float32))

    def f(q_, k_, v_):
        return jnp.sum(fp.flash_attention(q_, k_, v_, causal, None, 128, 128)
                       * w)
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = K.kernel_launches()
    (flash_attention(tq, tk, tv, causal) * torch.from_numpy(w)).sum() \
        .backward()
    assert K.kernel_launches() == before  # CPU tensors launch nothing
    for name, a, b in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=1e-4,
                                   err_msg=f"d{name}")


def test_sdpa_matches_jax_reference_bshd():
    """The port's scaled_dot_product_attention ([b, s, h, d]) against the
    JAX package's, which on the CPU takes its XLA reference path."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 40, 3, 64)).astype(np.float32)
               for _ in range(3))
    want = JF.scaled_dot_product_attention(
        *(Tensor(jnp.asarray(x)) for x in (q, k, v)), is_causal=True)
    got = F.scaled_dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), is_causal=True)
    np.testing.assert_allclose(got.numpy(), _np(want._data), atol=2e-5)
    np.testing.assert_allclose(
        flash_attention_bshd(*(torch.from_numpy(x) for x in (q, k, v)),
                             causal=True).numpy(), got.numpy(), atol=0)


def test_flash_refuses_what_it_does_not_take():
    q = torch.zeros(1, 1, 8, 64)
    with pytest.raises(ValueError, match="q_len <= kv_len"):
        flash_attention(q, q[:, :, :4], q[:, :, :4], causal=True)
    # a dropout is no refusal: it takes the dense route, as in the JAX
    # package (counted in sdpa_dense)
    before = K.LAUNCHES["sdpa_dense"]
    for kw in (dict(attn_mask=torch.zeros(1, 1), dropout_p=0.1),
               dict(dropout_p=0.1)):
        assert F.scaled_dot_product_attention(q, q, q, **kw).shape == q.shape
    assert K.LAUNCHES["sdpa_dense"] == before + 2


# -- AdamW -----------------------------------------------------------------------

HP = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, wd=0.01)


def _adam_inputs(dtype, n=3000, seed=3):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(n).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32) * 0.1
    m = rng.standard_normal(n).astype(np.float32) * 0.01
    v = np.abs(rng.standard_normal(n).astype(np.float32)) * 1e-3
    jd = _JDT[dtype]
    return (p, g, m, v), (jnp.asarray(p, jd), jnp.asarray(g, jd),
                          jnp.asarray(m), jnp.asarray(v))


def _check_adam(got, want, dtype):
    for name, a, w in zip(("p", "m", "v"), got, want):
        w = _np(w)
        if name == "p" and dtype == torch.bfloat16:
            # one bf16 rounding of values that agree in fp32 to 1e-6
            np.testing.assert_allclose(a.float().numpy(), w, rtol=2 ** -8,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(a.float().numpy(), w, rtol=1e-6,
                                       atol=1e-9, err_msg=name)


@pytest.mark.parametrize("decoupled", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_plain_matches_adam_update(decoupled, dtype):
    (p, g, m, v), (jp, jg, jm, jv) = _adam_inputs(dtype)
    f = jnp.float32
    want = _adam_update(jp, jg, jm, jv, f(HP["lr"]), f(HP["beta1"]),
                        f(HP["beta2"]), f(HP["eps"]), f(5.0), f(HP["wd"]),
                        decoupled)
    got = adamw_plain(_t(p, dtype), _t(g, dtype), torch.from_numpy(m),
                      torch.from_numpy(v), HP["lr"], HP["beta1"],
                      HP["beta2"], HP["eps"], HP["wd"], 5.0, decoupled)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    _check_adam(got, want, dtype)


@pytest.mark.parametrize("decoupled", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_plain_matches_pallas_kernel(decoupled, dtype):
    (p, g, m, v), (jp, jg, jm, jv) = _adam_inputs(dtype, seed=4)
    want = optimizer_pallas.fused_adamw_pallas(
        jp, jg, jm, jv, lr=HP["lr"], beta1=HP["beta1"], beta2=HP["beta2"],
        eps=HP["eps"], wd=HP["wd"], step=3.0, decoupled=decoupled)
    got = adamw_plain(_t(p, dtype), _t(g, dtype), torch.from_numpy(m),
                      torch.from_numpy(v), HP["lr"], HP["beta1"],
                      HP["beta2"], HP["eps"], HP["wd"], 3.0, decoupled)
    _check_adam(got, want, dtype)


def test_multi_tensor_adamw_updates_in_place_on_cpu():
    """The CPU path overwrites p, m and v, with the plain result for each
    tensor's own wd, and launches nothing."""
    rng = np.random.default_rng(5)
    shapes = [(7, 5), (33,), (4, 4, 3)]
    ps = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for s in shapes]
    gs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for s in shapes]
    ms = [torch.zeros(s) for s in shapes]
    vs = [torch.zeros(s) for s in shapes]
    wds = [0.0, 0.01, 0.1]
    want = [adamw_plain(p, g, m, v, 1e-2, 0.9, 0.99, 1e-8, wd, 1.0)
            for p, g, m, v, wd in zip(ps, gs, ms, vs, wds)]
    ids = [p.data_ptr() for p in ps]
    before = K.kernel_launches()
    multi_tensor_adamw(ps, gs, ms, vs, lr=1e-2, beta1=0.9, beta2=0.99,
                       eps=1e-8, wds=wds, step=1.0)
    assert K.kernel_launches() == before
    assert [p.data_ptr() for p in ps] == ids
    for (wp, wm, wv), p, m, v in zip(want, ps, ms, vs):
        assert torch.equal(p, wp) and torch.equal(m, wm) \
            and torch.equal(v, wv)


# -- RMSNorm and RoPE gradients ---------------------------------------------------

@pytest.fixture
def plain_launches(monkeypatch):
    """Route the autograd functions' launches to the plain versions, so
    their forward and backward wiring runs on the CPU."""
    monkeypatch.setattr(
        fused, "_norm_launch",
        lambda x, w, eps, res: (fused.rms_norm_plain(x, w, eps), None))
    monkeypatch.setattr(fused, "_rope_launch", fused.fused_rope_plain)


def test_rms_norm_grads_match_jax_vjp(plain_launches):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    gy = rng.standard_normal((3, 5, 32)).astype(np.float32)

    def f(a, b):
        with no_grad():
            return JF.rms_norm(Tensor(a), Tensor(b), epsilon=1e-5)._data
    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    wx, ww = vjp(jnp.asarray(gy))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = fused.RMSNormFunction.apply(tx, tw, 1e-5)
    out.backward(torch.from_numpy(gy))
    np.testing.assert_allclose(out.detach().numpy(), _np(y), atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), _np(wx), atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), _np(ww), atol=1e-4)


def test_rope_grads_match_jax_vjp(plain_launches):
    """RopeFunction's backward (the rotation by -theta) against the vjp of
    the JAX oracle, with GQA shapes."""
    from paddle_tpu_torch.models import build_rope_cache
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    gq = rng.standard_normal(q.shape).astype(np.float32)
    gk = rng.standard_normal(k.shape).astype(np.float32)
    cos, sin = build_rope_cache(9, 16)
    (oq, ok), vjp = jax.vjp(
        lambda a, b: apply_rope(a, b, jnp.asarray(cos.numpy()),
                                jnp.asarray(sin.numpy())),
        jnp.asarray(q), jnp.asarray(k))
    wq, wk = vjp((jnp.asarray(gq), jnp.asarray(gk)))
    tq = torch.from_numpy(q).requires_grad_()
    tk = torch.from_numpy(k).requires_grad_()
    rq, rk = fused.RopeFunction.apply(tq, tk, cos, sin)
    torch.autograd.backward((rq, rk), (torch.from_numpy(gq),
                                       torch.from_numpy(gk)))
    np.testing.assert_allclose(rq.detach().numpy(), _np(oq), atol=1e-5)
    np.testing.assert_allclose(rk.detach().numpy(), _np(ok), atol=1e-5)
    np.testing.assert_allclose(tq.grad.numpy(), _np(wq), atol=1e-5)
    np.testing.assert_allclose(tk.grad.numpy(), _np(wk), atol=1e-5)
