"""paddle_tpu_torch's CTC and RNN-T losses against paddle_tpu's, on the
CPU, where they run the plain versions of ``kernels/seq_loss.py`` (the
loops the CUDA kernels replace): values and the logits' gradients (the
JAX package's autograd of its scans) with ragged input and label lengths,
an empty label sequence (and a batch with no labels at all), repeated
labels, an infeasible alignment (CTC: fewer frames than the labels need;
JAX's finite floor values and their gradients), ``norm_by_times`` (the
value unchanged, the gradient scaled), ``fastemit_lambda`` (the same),
every reduction, bfloat16 logits, and the layers.

Inputs are made with numpy from a seed and handed to both sides.

Tolerance: values within 1e-5 of the largest reference value (at least
1), gradients within 1e-5 of the largest reference gradient (at least
1): both run the same recursion in float32, and exp, log1p and the
log-softmax's sums differ in their last ulps. A CPU call launches no
kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.tensor import Tensor

import paddle_tpu_torch.nn as pnn
from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.kernels import seq_loss as SL
from paddle_tpu_torch.nn import functional as F

JF = paddle.nn.functional


def _np(t):
    if isinstance(t, Tensor):
        return np.asarray(t._data.astype(jnp.float32))
    return t.detach().float().numpy()


def _close(got, want, tol=1e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _run(jfn, pfn, x, ints, dtype="float32", seed=0):
    """(value, logits' gradient) of both sides under one cotangent."""
    jx = Tensor(jnp.asarray(x, getattr(jnp, dtype)), stop_gradient=False)
    px = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    jo = jfn(jx, *(paddle.to_tensor(a) for a in ints))
    before = K.kernel_launches()
    po = pfn(px, *(torch.from_numpy(a) for a in ints))
    ct = np.random.default_rng(seed).standard_normal(tuple(po.shape)) \
        .astype(np.float32)
    (jo * Tensor(jnp.asarray(ct))).sum().backward()
    (po * torch.from_numpy(ct)).sum().backward()
    assert K.kernel_launches() == before
    assert str(po.dtype).replace("torch.", "") == str(jo._data.dtype)
    assert px.grad.dtype == px.dtype
    return (po, jo), (px.grad, jx.grad)


def _ctc_inputs(case):
    """(logits [T, B, C], labels [B, L], input_len, label_len)."""
    rng = np.random.default_rng(1)
    T, B, C, L = 14, 5, 6, 5
    x = (rng.standard_normal((T, B, C)) * 2).astype(np.float32)
    lab = rng.integers(1, C, (B, L))
    lab[1, 1:3] = lab[1, 0]                       # repeated labels
    il = np.array([14, 11, 6, 14, 1])
    ll = np.array([5, 3, 4, 0, 1])                # an empty sequence
    if case == "infeasible":
        lab[0] = [2, 2, 2, 2, 2]                  # needs 9 frames
        il = np.array([7, 2, 6, 14, 1])
        ll = np.array([5, 3, 4, 0, 1])
    if case == "no_labels":
        lab = np.zeros((B, 0), np.int64)
        ll = np.zeros(B, np.int64)
    if case == "blank_last":
        lab = rng.integers(0, C - 1, (B, L))
    return x, lab, il, ll


_CTC_CASES = ["ragged", "infeasible", "no_labels", "blank_last"]
C_LAST = 5          # the blank of "blank_last": the last of C = 6 classes


@pytest.mark.parametrize("norm_by_times", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("case", _CTC_CASES)
def test_ctc_loss_matches_jax(case, reduction, norm_by_times):
    x, lab, il, ll = _ctc_inputs(case)
    blank = C_LAST if case == "blank_last" else 0
    kw = dict(blank=blank, reduction=reduction, norm_by_times=norm_by_times)
    (po, jo), (pg, jg) = _run(
        lambda a, *r: JF.ctc_loss(a, *r, **kw),
        lambda a, *r: F.ctc_loss(a, *r, **kw), x, (lab, il, ll))
    _close(po, jo)
    _close(pg, jg)


def test_ctc_norm_by_times_scales_only_the_gradient():
    """The value is the plain one; each sample's gradient is divided by
    its input length."""
    x, lab, il, ll = _ctc_inputs("ragged")
    args = [torch.from_numpy(a) for a in (lab, il, ll)]
    grads, values = [], []
    for nbt in (False, True):
        px = torch.from_numpy(x).requires_grad_()
        v = F.ctc_loss(px, *args, reduction="none", norm_by_times=nbt)
        v.sum().backward()
        values.append(v.detach())
        grads.append(px.grad)
    assert torch.equal(values[0], values[1])
    scale = 1.0 / torch.from_numpy(il).float().clamp(min=1)
    torch.testing.assert_close(grads[1], grads[0] * scale[None, :, None],
                               rtol=1e-6, atol=1e-7)


def test_ctc_bfloat16_logits_match_jax():
    """bf16 logits are read as they are and everything runs in fp32; the
    gradient comes back in bf16 (both round the same fp32 value once:
    one bf16 ulp of the largest, 2^-7)."""
    x, lab, il, ll = _ctc_inputs("ragged")
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    (po, jo), (pg, jg) = _run(JF.ctc_loss, F.ctc_loss, x, (lab, il, ll),
                              dtype="bfloat16")
    _close(po, jo)
    _close(pg, jg, 2.0 ** -7)


def test_ctc_infeasible_sample_gives_the_jax_floor():
    """Fewer frames than the labels need: the loss is JAX's 1e30 (the
    floor's), not inf, and the gradient JAX's finite values."""
    x, lab, il, ll = _ctc_inputs("infeasible")
    px = torch.from_numpy(x).requires_grad_()
    v = F.ctc_loss(px, *(torch.from_numpy(a) for a in (lab, il, ll)),
                   reduction="none")
    assert float(v[0].detach()) == float(np.float32(1e30))
    v.sum().backward()
    assert torch.isfinite(px.grad).all()


def test_ctc_layer_matches_jax():
    x, lab, il, ll = _ctc_inputs("ragged")
    jl, pl = paddle.nn.CTCLoss(blank=0, reduction="sum"), \
        pnn.CTCLoss(blank=0, reduction="sum")
    assert isinstance(pl, pnn.Layer)
    (po, jo), (pg, jg) = _run(lambda a, *r: jl(a, *r, norm_by_times=True),
                              lambda a, *r: pl(a, *r, norm_by_times=True),
                              x, (lab, il, ll))
    _close(po, jo)
    _close(pg, jg)


def _rnnt_inputs(case):
    """(joint logits [B, T, U+1, V], labels [B, U], input_len,
    label_len)."""
    rng = np.random.default_rng(2)
    B, T, U, V = 4, 6, 4, 7
    if case == "no_labels":
        U = 0
    x = rng.standard_normal((B, T, U + 1, V)).astype(np.float32)
    lab = rng.integers(1, V, (B, U))
    if U:
        lab[2, :2] = 3                             # repeated labels
    il = np.array([6, 4, 1, 6])
    ll = np.array([4, 2, 3, 0]) if U else np.zeros(B, np.int64)
    return x, lab, il, ll


@pytest.mark.parametrize("fastemit_lambda", [0.0, 0.001, 0.5])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("case", ["ragged", "no_labels"])
def test_rnnt_loss_matches_jax(case, reduction, fastemit_lambda):
    x, lab, il, ll = _rnnt_inputs(case)
    kw = dict(blank=0, fastemit_lambda=fastemit_lambda, reduction=reduction)
    (po, jo), (pg, jg) = _run(
        lambda a, *r: JF.rnnt_loss(a, *r, **kw),
        lambda a, *r: F.rnnt_loss(a, *r, **kw), x, (lab, il, ll))
    _close(po, jo)
    _close(pg, jg)


def test_rnnt_fastemit_scales_only_the_emission_gradient():
    """The value is the same for every lambda, the gradient is not (its
    values are JAX's: ``test_rnnt_loss_matches_jax``)."""
    x, lab, il, ll = _rnnt_inputs("ragged")
    args = [torch.from_numpy(a) for a in (lab, il, ll)]
    out = []
    for lam in (0.0, 0.25):
        px = torch.from_numpy(x).requires_grad_()
        v = F.rnnt_loss(px, *args, fastemit_lambda=lam, reduction="sum")
        v.backward()
        out.append((v.detach(), px.grad))
    assert torch.equal(out[0][0], out[1][0])
    assert not torch.allclose(out[0][1], out[1][1])


def test_rnnt_bfloat16_logits_match_jax():
    x, lab, il, ll = _rnnt_inputs("ragged")
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    (po, jo), (pg, jg) = _run(JF.rnnt_loss, F.rnnt_loss, x, (lab, il, ll),
                              dtype="bfloat16")
    _close(po, jo)
    _close(pg, jg, 2.0 ** -7)


def test_rnnt_layer_matches_jax():
    x, lab, il, ll = _rnnt_inputs("ragged")
    jl, pl = paddle.nn.RNNTLoss(), pnn.RNNTLoss()
    assert pl.fastemit_lambda == 0.001 and isinstance(pl, pnn.Layer)
    (po, jo), (pg, jg) = _run(jl, pl, x, (lab, il, ll))
    _close(po, jo)
    _close(pg, jg)


def test_plain_versions_are_the_functions_the_kernels_replace():
    """The CPU path is the plain forward and backward of
    ``kernels.seq_loss`` (what the card's kernels are held against):
    ``ctc_nll`` / ``rnnt_nll`` equal them called directly."""
    x, lab, il, ll = (torch.from_numpy(a) for a in _ctc_inputs("ragged"))
    nll, alpha = SL.ctc_forward_plain(x, lab, il, ll)
    g = torch.linspace(0.5, 1.5, x.shape[1])
    px = x.clone().requires_grad_()
    v = SL.ctc_nll(px, lab, il, ll)
    (v * g).sum().backward()
    assert torch.equal(v.detach(), nll)
    assert torch.equal(px.grad, SL.ctc_backward_plain(x, lab, il, ll,
                                                      alpha, g))
    x, lab, il, ll = (torch.from_numpy(a) for a in _rnnt_inputs("ragged"))
    nll, alpha = SL.rnnt_forward_plain(x, lab, il, ll)
    g = torch.linspace(0.5, 1.5, x.shape[0])
    px = x.clone().requires_grad_()
    v = SL.rnnt_nll(px, lab, il, ll, 0, 0.1)
    (v * g).sum().backward()
    assert torch.equal(v.detach(), nll)
    assert torch.equal(px.grad, SL.rnnt_backward_plain(x, lab, il, ll,
                                                       alpha, g, 0, 0.1))
