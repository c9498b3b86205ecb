"""Attention shapes the port's kernels do not take, routed as the JAX
package routes them, on the CPU.

The JAX package gates its flash kernel with ``kernels/flash_attention.py:
is_available`` and sends every other mask-free call to ``_sdpa_reference``
(where the leading rows of a causal call with q_len > kv_len average v);
its serving ``make_attend`` takes the jnp path wherever its kernel is off.
The port's ``flash_takes`` and ``ragged_attention.kernel_takes`` make the
same decisions for the port's kernels, and the calls they refuse go to
the plain versions on either device, counted in ``LAUNCHES["sdpa_plain"]``
and ``LAUNCHES["ragged_plain"]``. Here the same numpy inputs go through
the JAX functions and the port's.

Tolerances: float32 1e-5 (both compute the same fp32 softmax; sums in
another order), gradients 1e-5; bfloat16 one bf16 ulp of each value
(2^-7 relative: both round one fp32 result to bf16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels import flash_attention as jax_fa
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.functional.attention import _sdpa_reference as jax_sdpa
from paddle_tpu.serving.ragged import make_attend as jax_make_attend

from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.kernels import flash_attention as FA
from paddle_tpu_torch.kernels import ragged_attention as RA
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.serving.ragged import make_attend

# (sq, sk, head_dim, causal): shapes the flash kernels do not take
ROUTED = {
    "causal_q_longer": (7, 5, 64, True),      # leading rows see no key
    "causal_q_longer_d32": (12, 4, 32, True),
    "d32": (12, 12, 32, True),
    "d80": (9, 13, 80, False),
    "d80_causal": (13, 13, 80, True),
    "d256": (8, 8, 256, True),
    "d256_cross": (6, 10, 256, False),
}


def _bshd(b, sq, sk, h, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, h, d)).astype(np.float32))


@pytest.mark.parametrize("case", list(ROUTED))
def test_sdpa_routes_what_the_kernels_lack_like_jax(case):
    sq, sk, d, causal = ROUTED[case]
    q, k, v = _bshd(2, sq, sk, 3, d, seed=len(case))
    want = JF.scaled_dot_product_attention(
        *(paddle.to_tensor(a) for a in (q, k, v)), is_causal=causal).numpy()
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    assert not FA.flash_takes(tq, tk, causal, tv)
    before = dict(K.LAUNCHES)
    got = F.scaled_dot_product_attention(tq, tk, tv, is_causal=causal)
    assert K.LAUNCHES["sdpa_plain"] == before["sdpa_plain"] + 1
    assert K.kernel_launches() == {n: c for n, c in before.items()
                                   if n not in K.ROUTED}
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    if causal and sq > sk:       # rows that see no key average v
        lead = sq - sk
        np.testing.assert_allclose(
            got.numpy()[:, :lead],
            np.broadcast_to(v.mean(axis=1, keepdims=True),
                            (2, lead, 3, d)), atol=1e-5)


@pytest.mark.parametrize("case", ["causal_q_longer", "d80", "d256"])
def test_sdpa_routed_gradients_match_jax(case):
    sq, sk, d, causal = ROUTED[case]
    q, k, v = _bshd(1, sq, sk, 2, d, seed=3)
    g = np.random.default_rng(4).standard_normal(
        (1, sq, 2, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jax_sdpa(a, b, c, causal=causal),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    F.scaled_dot_product_attention(tq, tk, tv, is_causal=causal).backward(
        torch.from_numpy(g))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("case", ["d32", "causal_q_longer"])
def test_sdpa_routed_bf16_matches_jax(case):
    sq, sk, d, causal = ROUTED[case]
    arrays = [a.astype(jnp.bfloat16) for a in _bshd(2, sq, sk, 2, d, 7)]
    want = JF.scaled_dot_product_attention(
        *(paddle.to_tensor(a) for a in arrays), is_causal=causal)
    want = np.asarray(jnp.asarray(want._data, jnp.float32))
    t = [torch.from_numpy(a.astype(np.float32)).bfloat16() for a in arrays]
    before = K.LAUNCHES["sdpa_plain"]
    got = F.scaled_dot_product_attention(*t, is_causal=causal)
    assert got.dtype == torch.bfloat16
    assert K.LAUNCHES["sdpa_plain"] == before + 1
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                               atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sdpa_keeps_the_flash_path_for_what_the_kernels_take(causal, dtype):
    """head_dim 64 with q_len <= kv_len: the flash path (its plain version
    on the CPU), nothing routed, the JAX result."""
    q, k, v = _bshd(2, 9, 13, 2, 64, seed=8)
    want = JF.scaled_dot_product_attention(
        *(paddle.to_tensor(a) for a in (q, k, v)), is_causal=causal).numpy()
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    assert FA.flash_takes(t[0], t[1], causal, t[2])
    before = dict(K.LAUNCHES)
    got = F.scaled_dot_product_attention(*t, is_causal=causal)
    assert K.LAUNCHES == before
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_flash_wrappers_still_refuse_causal_q_longer():
    q = torch.zeros(1, 7, 2, 64)
    k = torch.zeros(1, 5, 2, 64)
    with pytest.raises(ValueError, match="q_len <= kv_len"):
        FA.flash_attention_bshd(q, k, k, causal=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("d", [32, 64, 80, 128, 256])
def test_flash_takes_agrees_with_jax_is_available(monkeypatch, dtype, d):
    """At sequence lengths that are multiples of 128 (the JAX gate's TPU
    tiling condition) the port's predicate says what ``is_available`` says
    on a TPU, but for head_dim 256, which the port routes to the plain
    path (no kernel of its own yet: ROADMAP Queue 2)."""
    monkeypatch.setattr(jax_fa, "_on_tpu", lambda: True)
    tdt = getattr(torch, dtype)
    for sq, sk, causal in [(128, 128, False), (128, 128, True),
                           (128, 256, True), (256, 128, False),
                           (256, 128, True)]:
        jq = jnp.zeros((1, sq, 2, d), getattr(jnp, dtype))
        jk = jnp.zeros((1, sk, 2, d), getattr(jnp, dtype))
        want = jax_fa.is_available(jq, jk, causal=causal) and d != 256
        got = FA.flash_takes(torch.zeros(1, sq, 2, d, dtype=tdt),
                             torch.zeros(1, sk, 2, d, dtype=tdt), causal)
        assert got == want, (sq, sk, causal)


def test_flash_takes_any_length_and_refuses_misfits():
    """Unlike the JAX gate, no sequence-length condition; like it, a
    mismatched head_dim or dtype is refused."""
    q = torch.zeros(1, 100, 2, 64)
    assert FA.flash_takes(q, torch.zeros(1, 130, 2, 64), causal=True)
    assert not FA.flash_takes(q, torch.zeros(1, 130, 2, 128))
    assert not FA.flash_takes(q, torch.zeros(1, 130, 2, 64).bfloat16())
    assert not FA.flash_takes(q, q, v=torch.zeros(1, 100, 2, 32))
    assert not FA.flash_takes(q[0], q[0])


def _ragged_inputs(d, rep, seed=1):
    """A mixed batch: decode tokens of two slots and a prefill chunk of a
    third, with an invalid row."""
    rng = np.random.default_rng(seed)
    kvh, p, bs, mp = 2, 10, 4, 4
    kp = rng.standard_normal((p, kvh, bs, d)).astype(np.float32)
    vp = rng.standard_normal((p, kvh, bs, d)).astype(np.float32)
    tables = np.full((3, mp), -1, np.int32)
    tables[0, :2] = [3, 1]
    tables[1, :3] = [0, 2, 5]
    tables[2, :4] = [4, 6, 7, 9]
    slot = np.asarray([0, 1, 2, 2, 2, 2, 0], np.int32)
    pos = np.asarray([6, 10, 8, 9, 10, 11, 0], np.int32)
    valid = np.asarray([1, 1, 1, 1, 1, 1, 0], bool)
    q = rng.standard_normal((len(slot), kvh * rep, d)).astype(np.float32)
    return q, kp, vp, tables, slot, pos, valid


@pytest.mark.parametrize("d, rep", [(32, 3), (64, 3), (80, 1), (256, 2)])
def test_make_attend_routes_what_the_kernel_lacks_like_jax(d, rep):
    q, kp, vp, tables, slot, pos, valid = _ragged_inputs(d, rep)
    assert not RA.kernel_takes(d, rep)
    want = jax_make_attend(*map(jnp.asarray, (tables, slot, pos, valid)),
                           rep)(*map(jnp.asarray, (q, kp, vp)))
    t = torch.from_numpy
    attend = make_attend(t(tables), t(slot), t(pos), t(valid), rep)
    before = dict(K.LAUNCHES)
    got = attend(t(q), t(kp), t(vp))
    assert K.LAUNCHES["ragged_plain"] == before["ragged_plain"] + 1
    assert K.kernel_launches() == {n: c for n, c in before.items()
                                   if n not in K.ROUTED}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert not got.numpy()[~valid].any()


def test_make_attend_keeps_the_kernel_path_for_what_it_takes():
    q, kp, vp, tables, slot, pos, valid = _ragged_inputs(64, 2)
    assert RA.kernel_takes(64, 2)
    t = torch.from_numpy
    before = dict(K.LAUNCHES)
    got = make_attend(t(tables), t(slot), t(pos), t(valid), 2)(
        t(q), t(kp), t(vp))
    assert K.LAUNCHES == before           # the CPU runs the plain version
    want = RA.ragged_attention_plain(t(q), t(kp), t(vp), t(tables), t(slot),
                                     t(pos), t(valid), 2)
    assert torch.equal(got, want)


# -- FlashMask calls the kernels do not take ------------------------------------
#
# The JAX package sends them (``use_pallas`` off: q_len != kv_len, a head
# dim its kernel lacks) to its dense path, whose causal is top-left; the
# port's ``flashmask_kernels_take`` sends them to the plain versions on
# either device, counted in ``sdpa_plain``. A row that sees no key is 0 in
# the port and the mean of v in the JAX dense path (ROADMAP F2): it is
# compared only with zero, and gradients are taken of the other rows.

# (sq, sk, head_dim, kv heads of 4): shapes the FlashMask kernels refuse
FM_ROUTED = {
    "causal_q_longer": (24, 16, 64, 2),     # leading rows may see no key
    "causal_q_shorter": (12, 20, 64, 4),
    "d32": (16, 16, 32, 2),
    "d256": (12, 12, 256, 4),
    "d32_q_longer": (14, 9, 32, 4),
}


def _fm_inputs(sq, sk, kh, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, sq, 4, d)).astype(np.float32)
    k, v = (rng.standard_normal((2, sk, kh, d)).astype(np.float32)
            for _ in range(2))
    # each key column's document end (its LTS): rows at or past it are
    # masked from the column
    se = rng.integers(max(1, sq // 2), sq + 1, (2, 1, sk, 1)).astype(np.int32)
    return q, k, v, se


def _fm_seen(se, sq, sk):
    """[b, 1, sq, 1] bool: the rows that see at least one key."""
    bounds = F._canonical_startend(torch.from_numpy(se), sq, True)
    vis = FA.flashmask_visible(bounds, sq, sk, True)
    return vis.any(-1)[..., None].permute(0, 2, 1, 3).numpy()


@pytest.mark.parametrize("case", list(FM_ROUTED))
def test_flashmask_routes_what_the_kernels_lack_like_jax(case):
    sq, sk, d, kh = FM_ROUTED[case]
    q, k, v, se = _fm_inputs(sq, sk, kh, d, seed=len(case))
    want = JF.flashmask_attention(
        *(paddle.to_tensor(a) for a in (q, k, v, se)), causal=True).numpy()
    t = [torch.from_numpy(a) for a in (q, k, v)]
    assert not F.flashmask_kernels_take(*t)
    before = dict(K.LAUNCHES)
    got = F.flashmask_attention(*t, torch.from_numpy(se), causal=True)
    assert K.LAUNCHES["sdpa_plain"] == before["sdpa_plain"] + 1
    assert K.kernel_launches() == {n: c for n, c in before.items()
                                   if n not in K.ROUTED}
    seen = _fm_seen(se, sq, sk)
    np.testing.assert_allclose(got.numpy() * seen, want * seen, atol=1e-5,
                               rtol=1e-5)
    assert not (got.numpy() * ~seen).any()
    if case == "causal_q_longer":
        assert not seen.all()           # the case has rows without a key


@pytest.mark.parametrize("case", ["causal_q_longer", "causal_q_shorter",
                                  "d256"])
def test_flashmask_routed_gradients_match_jax(case):
    sq, sk, d, kh = FM_ROUTED[case]
    q, k, v, se = _fm_inputs(sq, sk, kh, d, seed=5)
    seen = _fm_seen(se, sq, sk).astype(np.float32)
    g = np.random.default_rng(6).standard_normal(q.shape).astype(
        np.float32) * seen

    def jax_fn(a, b, c):
        return JF.flashmask_attention(paddle.Tensor(a), paddle.Tensor(b),
                                      paddle.Tensor(c),
                                      paddle.to_tensor(se),
                                      causal=True)._data
    _, vjp = jax.vjp(jax_fn, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    F.flashmask_attention(tq, tk, tv, torch.from_numpy(se),
                          causal=True).backward(torch.from_numpy(g))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("case", ["causal_q_longer", "d32"])
def test_flashmask_routed_bf16_matches_jax(case):
    sq, sk, d, kh = FM_ROUTED[case]
    arrays = [a.astype(jnp.bfloat16)
              for a in _fm_inputs(sq, sk, kh, d, seed=9)[:3]]
    se = _fm_inputs(sq, sk, kh, d, seed=9)[3]
    want = JF.flashmask_attention(*(paddle.to_tensor(a) for a in arrays),
                                  paddle.to_tensor(se), causal=True)
    want = np.asarray(jnp.asarray(want._data, jnp.float32))
    t = [torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
         for a in arrays]
    before = K.LAUNCHES["sdpa_plain"]
    got = F.flashmask_attention(*t, torch.from_numpy(se), causal=True)
    assert got.dtype == torch.bfloat16
    assert K.LAUNCHES["sdpa_plain"] == before + 1
    seen = _fm_seen(se, sq, sk)
    # the port rounds P to bf16 before P.V (the kernels' rounding), the
    # JAX dense path does not: two ulps of each row's largest value
    ref = np.abs(want * seen).max(-1, keepdims=True)
    err = np.abs(got.float().numpy() * seen - want * seen)
    assert (err <= 2 * 2.0 ** -7 * ref + 1e-6).all()


def test_flashmask_keeps_the_kernel_path_for_what_it_takes():
    """q_len == kv_len, head_dim 64: the kernels' path (their plain version
    on the CPU), nothing routed."""
    q, k, v, se = _fm_inputs(16, 16, 2, 64, seed=3)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    assert F.flashmask_kernels_take(*t)
    assert not F.flashmask_kernels_take(t[0], t[1].double(), t[2])
    before = dict(K.LAUNCHES)
    got = F.flashmask_attention(*t, torch.from_numpy(se), causal=True)
    assert K.LAUNCHES == before
    want = JF.flashmask_attention(
        *(paddle.to_tensor(a) for a in (q, k, v, se)), causal=True).numpy()
    seen = _fm_seen(se, 16, 16)
    np.testing.assert_allclose(got.numpy() * seen, want * seen, atol=1e-5)
