"""The attention entry points of ``paddle_tpu/nn/functional/attention.py``
and ``common.py:373 sparse_attention``, ported to
``paddle_tpu_torch.nn.functional``, against the JAX package on the CPU:
``flash_attention``, ``flash_attn_qkvpacked``, ``flash_attn_unpadded``
(causal and not, ragged ``cu_seqlens``, q and k packed apart),
``flash_attn_varlen_qkvpacked``, ``sdp_kernel`` and ``sparse_attention``
(each mask alone, both, neither; gradients), and their routes: which
calls count ``sdpa_dense`` (a mask or a dropout: the dense attention's
middle, ``kernels/dense_attention.py`` on the card) and which
``sdpa_plain`` (shapes the flash kernels do not take).

Tolerances: fp32, outputs within 1e-5 of the largest |value| (sums in
another order), gradients within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn.functional as JF
from paddle_tpu.nn.functional.common import sparse_attention as jax_sparse
from paddle_tpu.tensor import Tensor

from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.nn import functional as F


def _jt(a):
    return Tensor(jnp.asarray(a))


def _pt(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want._data if isinstance(want, Tensor) else want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _qkv(seed, b=2, s=12, h=2, d=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def _routes(fn):
    before = dict(K.LAUNCHES)
    out = fn()
    return out, {n: K.LAUNCHES[n] - before[n]
                 for n in ("sdpa_dense", "sdpa_plain")}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d,dropout,training,route", [
    (64, 0.0, True, {"sdpa_dense": 0, "sdpa_plain": 0}),
    (32, 0.0, True, {"sdpa_dense": 0, "sdpa_plain": 1}),
    (64, 0.1, False, {"sdpa_dense": 1, "sdpa_plain": 0})])
def test_flash_attention_matches_jax_and_routes(causal, d, dropout, training,
                                               route):
    """``flash_attention`` returns ``(out, None)``: without a dropout the
    flash route (its plain version here; head_dim 32 the plain
    ``_sdpa_reference``, ``sdpa_plain``), with a dropout in eval the dense
    route undropped (``sdpa_dense``), as the JAX function."""
    q, k, v = _qkv(1, d=d)
    want, none = JF.flash_attention(_jt(q), _jt(k), _jt(v), dropout=dropout,
                                    causal=causal, training=training)
    (got, soft), used = _routes(lambda: F.flash_attention(
        _pt(q), _pt(k), _pt(v), dropout=dropout, causal=causal,
        training=training))
    assert none is None and soft is None
    assert used == route
    _close(got, want)


def test_flash_attention_dropout_in_training_takes_the_dense_route():
    q, k, v = _qkv(2)
    (out, _), used = _routes(lambda: F.flash_attention(
        _pt(q), _pt(k), _pt(v), dropout=0.3))
    assert used == {"sdpa_dense": 1, "sdpa_plain": 0}
    assert out.shape == (2, 12, 2, 64) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attn_qkvpacked_matches_jax(causal):
    q, k, v = _qkv(3)
    qkv = np.stack([q, k, v], axis=2)
    want, _ = JF.flash_attn_qkvpacked(_jt(qkv), causal=causal)
    got, soft = F.flash_attn_qkvpacked(_pt(qkv), causal=causal)
    assert soft is None
    _close(got, want)
    with pytest.raises(ValueError):
        F.flash_attn_qkvpacked(_pt(q))


CU = [np.array([0, 3, 10, 18], np.int32), np.array([0, 18], np.int32),
      np.array([0, 1, 2, 9, 18], np.int32)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("cu", range(len(CU)))
def test_flash_attn_unpadded_matches_jax(causal, cu):
    """Packed sequences: each query sees its own segment (causal: up to its
    position in it), ``scale`` as given, ``dropout`` ignored, ``(out,
    None)``; counted in ``sdpa_dense``. Gradients of q, k, v too."""
    rng = np.random.default_rng(cu)
    cuq = CU[cu]
    t = int(cuq[-1])
    q, k, v = (rng.standard_normal((t, 3, 32)).astype(np.float32)
               for _ in range(3))
    g = rng.standard_normal((t, 3, 32)).astype(np.float32)

    def jf(a, b, c):
        return JF.flash_attn_unpadded(Tensor(a), Tensor(b), Tensor(c),
                                      _jt(cuq), _jt(cuq), 8, 8, 0.3,
                                      dropout=0.5, causal=causal)[0]._data
    want, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v)))
    ts = [_pt(a).requires_grad_() for a in (q, k, v)]
    (got, soft), used = _routes(lambda: F.flash_attn_unpadded(
        *ts, _pt(cuq), _pt(cuq), 8, 8, 0.3, dropout=0.5, causal=causal))
    assert soft is None and used == {"sdpa_dense": 1, "sdpa_plain": 0}
    _close(got, want)
    grads = torch.autograd.grad(got, ts, _pt(g))
    for a, w in zip(grads, vjp(jnp.asarray(g))):
        _close(a, w, 1e-4)


def test_flash_attn_unpadded_with_other_key_segments_matches_jax():
    """Queries and keys packed with their own ``cu_seqlens``."""
    rng = np.random.default_rng(7)
    cuq, cuk = np.array([0, 2, 7], np.int32), np.array([0, 5, 9], np.int32)
    q = rng.standard_normal((7, 2, 16)).astype(np.float32)
    k, v = (rng.standard_normal((9, 2, 16)).astype(np.float32)
            for _ in range(2))
    want, _ = JF.flash_attn_unpadded(_jt(q), _jt(k), _jt(v), _jt(cuq),
                                     _jt(cuk), 5, 5, 0.25)
    got, _ = F.flash_attn_unpadded(_pt(q), _pt(k), _pt(v), _pt(cuq),
                                   _pt(cuk), 5, 5, 0.25)
    _close(got, want)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attn_varlen_qkvpacked_matches_jax(causal):
    rng = np.random.default_rng(8)
    qkv = rng.standard_normal((18, 3, 2, 32)).astype(np.float32)
    cu = CU[0]
    want, _ = JF.flash_attn_varlen_qkvpacked(_jt(qkv), _jt(cu), _jt(cu), 8,
                                             8, 0.2, causal=causal)
    got, soft = F.flash_attn_varlen_qkvpacked(_pt(qkv), _pt(cu), _pt(cu), 8,
                                              8, 0.2, causal=causal)
    assert soft is None
    _close(got, want)
    with pytest.raises(ValueError):
        F.flash_attn_varlen_qkvpacked(_pt(qkv[:, :2]), _pt(cu), _pt(cu), 8,
                                      8, 0.2)


def test_sdp_kernel_is_a_context_that_changes_nothing():
    q, k, v = (_pt(a) for a in _qkv(4))
    with F.sdp_kernel(enable_flash=False, enable_math=True):
        inside = F.scaled_dot_product_attention(q, k, v)
    assert torch.equal(inside, F.scaled_dot_product_attention(q, k, v))


def _csr(rng, b, h, s, nnz, empty_row=1):
    """CSR offsets [b, h, s + 1] and columns [b, h, nnz]: rows of 0-4
    sorted keys, one row empty, the tail past ``offset[-1]`` padding."""
    offs, cols = [], []
    for _ in range(b * h):
        lens = rng.integers(0, 5, s)
        lens[empty_row] = 0
        offs.append(np.concatenate([[0], np.cumsum(lens)]))
        c = [np.sort(rng.choice(s, n, replace=False)) for n in lens]
        c = np.concatenate(c + [np.zeros(0, np.int64)])
        cols.append(np.concatenate([c, rng.integers(0, s, nnz - len(c))]))
    return (np.stack(offs).reshape(b, h, s + 1).astype(np.int32),
            np.stack(cols).reshape(b, h, nnz).astype(np.int32))


@pytest.mark.parametrize("kpm,am", [(False, False), (True, False),
                                    (False, True), (True, True)])
def test_sparse_attention_and_gradients_match_jax(kpm, am):
    """CSR-masked attention: each row over its own keys, ``-inf`` where the
    key padding mask or the attention mask is 0, an empty row 0; q, k, v's
    gradients by ``jax.vjp``."""
    rng = np.random.default_rng(10 + 2 * kpm + am)
    b, h, s, d = 2, 3, 9, 8
    q, k, v, g = (rng.standard_normal((b, h, s, d)).astype(np.float32)
                  for _ in range(4))
    off, cols = _csr(rng, b, h, s, 44)
    masks = [(rng.random((b, s)) > 0.25).astype(np.float32) if kpm
             else None,
             (rng.random((s, s)) > 0.25).astype(np.float32) if am else None]

    def jf(a, bb, c):
        return jax_sparse(Tensor(a), Tensor(bb), Tensor(c), _jt(off),
                          _jt(cols), *(None if m is None else _jt(m)
                                       for m in masks))._data
    want, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v)))
    ts = [_pt(a).requires_grad_() for a in (q, k, v)]
    got = F.sparse_attention(*ts, _pt(off), _pt(cols),
                             *(None if m is None else _pt(m) for m in masks))
    _close(got, want)
    grads = torch.autograd.grad(got, ts, _pt(g))
    for a, w in zip(grads, vjp(jnp.asarray(g))):
        _close(a, w, 1e-4)


def test_sparse_attention_twice_is_bit_equal():
    """The reductions run in a fixed order: two calls give the same bits,
    gradients too."""
    rng = np.random.default_rng(20)
    q, k, v = (_pt(rng.standard_normal((1, 2, 16, 8)).astype(np.float32))
               for _ in range(3))
    off, cols = (_pt(a) for a in _csr(rng, 1, 2, 16, 70))
    runs = []
    for _ in range(2):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        out = F.sparse_attention(*ts, off, cols)
        runs.append([out] + list(torch.autograd.grad(out.sum(), ts)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
