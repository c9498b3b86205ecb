"""paddle_tpu_torch's FlashMask path (packed-document attention) against
paddle_tpu's, on the CPU.

The same numpy inputs go through the JAX function and the port's: the
port's plain FlashMask forward and its gradients against the Pallas
kernel in interpret mode (the four bound forms and a sliding window), the
functional in ``[b, s, h, d]`` against the JAX ``F.flashmask_attention``
(its dense path on the CPU), a tiny packed-document Llama (logits, the
chunked loss, every gradient) against the JAX model and against the
port's own dense ``attention_mask`` path, and 3 trainer steps with the
bounds as the third batch tensor.

Tolerances: float32 2e-5 (forward; fp32 sums in another order) and 2e-4
(gradients, sums of 256 such products), as ``tests/test_flashmask.py``
holds the Pallas kernel to its dense oracle; the model and trainer as
``test_torch_training.py`` and ``test_torch_trainer.py`` hold the dense
path (logits 1e-5, gradients 1e-5 + 1e-4 relative; losses 1e-5 relative
in float32, 2e-3 in bf16). A row that sees no key is compared only with
zero: the port gives it output 0 and lse -1e30, while the Pallas kernel
gives the mean of v over the tiles it did not skip and the JAX dense path
the mean over all keys (ROADMAP Queue 3).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.kernels import flash_pallas as fp
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.functional.attention import \
    _canonical_startend as jax_canonical
from paddle_tpu.parallel.trainer import SpmdTrainer as JaxTrainer

from paddle_tpu_torch import kernels as K
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.kernels import flash_attention as FA
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     load_numpy_state)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.parallel import SpmdTrainer


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(fp, "_INTERPRET", True)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _doc_ends(rng, s, lo, hi):
    """End of each column's document, documents of lengths in [lo, hi]
    packed into s (the last one cut)."""
    ends = np.empty(s, np.int32)
    start = 0
    while start < s:
        end = min(s, start + int(rng.integers(lo, hi + 1)))
        ends[start:end] = end
        start = end
    return ends


def _bounds(form, b, h, s, seed=1):
    """(startend_row_indices [b, h, s, C] int32, causal, window_size)."""
    rng = np.random.default_rng(seed)
    col = lambda lo, hi: rng.integers(lo, hi, (b, h, s, 1))   # noqa: E731
    if form in ("causal_1", "causal_1_window"):
        se = np.stack([np.stack([_doc_ends(rng, s, 20, 90)
                                 for _ in range(h)]) for _ in range(b)])
        return (se[..., None].astype(np.int32), True,
                100 if form == "causal_1_window" else None)
    if form == "causal_2":
        lts = col(1, s)
        se = np.concatenate([lts, np.minimum(lts + col(0, s), s)], -1)
        return se.astype(np.int32), True, None
    if form == "noncausal_2":
        se = np.concatenate([col(1, s), col(0, s)], -1)
        return se.astype(np.int32), False, None
    lts = col(1, s)
    uts = col(0, s)
    se = np.concatenate([lts, np.minimum(lts + col(0, 64), s), uts,
                         np.minimum(uts + col(0, 64), s)], -1)
    return se.astype(np.int32), False, (40, 70)


FORMS = ["causal_1", "causal_2", "noncausal_2", "noncausal_4",
         "causal_1_window"]


def _qkv(b, h, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, s, d)).astype(np.float32)
                 for _ in range(4))


def _canon(se, s, causal):
    """The port's canonical bounds, checked equal to the JAX package's."""
    got = F._canonical_startend(torch.from_numpy(se), s, causal)
    want = np.asarray(jax_canonical(jnp.asarray(se), s, causal))
    np.testing.assert_array_equal(got.numpy(), want)
    return got


@pytest.mark.parametrize("form", FORMS)
def test_flashmask_forward_plain_matches_pallas(form):
    b, h, s, d = 1, 2, 256, 64
    q, k, v, _ = _qkv(b, h, s, d)
    se, causal, ws = _bounds(form, b, h, s)
    window = F._norm_window(ws, causal)
    bounds = _canon(se, s, causal)
    jb = jnp.asarray(bounds.numpy())
    want, wlse = fp._flash_forward(*(jnp.asarray(x) for x in (q, k, v)),
                                   causal, None, 128, 128, bounds=jb,
                                   window=window)
    got, lse = FA.flash_forward_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), causal, bounds=bounds,
        window=window)
    # every row of these forms sees at least its own key
    assert bool(FA.flashmask_visible(bounds, s, s, causal, window)
                .any(-1).all())
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5)
    np.testing.assert_allclose(lse.numpy().reshape(b * h, s),
                               np.asarray(wlse)[..., 0], atol=2e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("form", FORMS)
def test_flashmask_gradients_match_jax_grad(form):
    """FlashAttention's masked backward (plain versions on CPU tensors)
    against jax.grad through the Pallas kernel."""
    b, h, s, d = 1, 2, 256, 64
    q, k, v, w = _qkv(b, h, s, d, seed=2)
    se, causal, ws = _bounds(form, b, h, s, seed=3)
    window = F._norm_window(ws, causal)
    bounds = _canon(se, s, causal)
    jb = jnp.asarray(bounds.numpy())

    def f(q_, k_, v_):
        return jnp.sum(fp.flashmask_attention(q_, k_, v_, jb, causal, None,
                                              window, 128, 128) * w)
    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                            for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, _ = FA.flashmask_attention(tq, tk, tv, bounds, causal,
                                    window=window)
    (out * torch.from_numpy(w)).sum().backward()
    for name, got, ref in zip("qkv", (tq, tk, tv), want):
        np.testing.assert_allclose(got.grad.numpy(), _np(ref), atol=2e-4,
                                   rtol=2e-4, err_msg=f"d{name}")


def test_rows_that_see_no_key_give_zero():
    """Non-causal bands masking rows [90, 150) from every key off the
    diagonal, and a window (wl = -1) masking the diagonal and everything
    below it: those rows and the last one see no key. The port gives them
    output 0, lse -1e30 and zero dq; every other row matches the Pallas
    kernel."""
    b, h, s, d = 1, 2, 256, 64
    q, k, v, w = _qkv(b, h, s, d, seed=4)
    se = np.broadcast_to(np.asarray([90, 150, 90, 150], np.int32),
                         (b, h, s, 4)).copy()
    window = (-1, None)
    bounds = _canon(se, s, False)
    seen = FA.flashmask_visible(bounds, s, s, False, window).any(-1)
    empty = ~seen[0, 0].numpy()
    assert empty[90:150].all() and empty[255] and empty.sum() == 61
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = FA.flashmask_attention(tq, tk, tv, bounds, False,
                                      window=window)
    assert not out[:, :, empty].any()
    assert bool((lse[:, :, empty] == FA.NEG_INF).all())
    (out * torch.from_numpy(w)).sum().backward()
    assert not tq.grad[:, :, empty].any()
    jb = jnp.asarray(bounds.numpy())
    want, wlse = fp._flash_forward(*(jnp.asarray(x) for x in (q, k, v)),
                                   False, None, 128, 128, bounds=jb,
                                   window=window)
    np.testing.assert_allclose(out.detach().numpy()[:, :, ~empty],
                               _np(want)[:, :, ~empty], atol=2e-5)
    np.testing.assert_allclose(
        lse.numpy().reshape(b * h, s)[:, ~empty],
        np.asarray(wlse)[..., 0][:, ~empty], atol=2e-5, rtol=1e-5)


# -- the functional --------------------------------------------------------------

def _bshd(b, s, h, kh, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, kh, d)).astype(np.float32),
            rng.standard_normal((b, s, kh, d)).astype(np.float32))


def _both(fn_j, fn_p, arrays, **kw):
    want = fn_j(*(paddle.to_tensor(a) for a in arrays), **kw)
    got = fn_p(*(torch.from_numpy(a) for a in arrays), **kw)
    return want, got


@pytest.mark.parametrize("mask_heads", ["one", "kv", "q"])
def test_functional_gqa_matches_jax(mask_heads):
    """[b, s, h, d] with GQA (4 query heads, 2 kv heads) and the bounds'
    head dim 1, kv_heads or heads."""
    b, s, h, kh, d = 2, 64, 4, 2, 16
    nh = {"one": 1, "kv": kh, "q": h}[mask_heads]
    rng = np.random.default_rng(5)
    se = np.stack([np.stack([_doc_ends(rng, s, 5, 30) for _ in range(nh)])
                   for _ in range(b)])[..., None].astype(np.int32)
    want, got = _both(JF.flashmask_attention, F.flashmask_attention,
                      (*_bshd(b, s, h, kh, d, 6), se), causal=True)
    assert tuple(got.shape) == (b, s, h, d)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


def test_functional_lse_and_window_only_match_jax():
    b, s, h, d = 1, 64, 2, 16
    arrays = _bshd(b, s, h, h, d, 7)
    se = np.broadcast_to(_doc_ends(np.random.default_rng(7), s, 5, 30)
                         [None, None, :, None], (b, h, s, 1)).copy()
    (w_out, w_lse), (g_out, g_lse) = _both(
        JF.flashmask_attention, F.flashmask_attention, (*arrays, se),
        causal=True, return_softmax_lse=True)
    assert tuple(g_lse.shape) == (b, h, s)
    np.testing.assert_allclose(g_out.numpy(), w_out.numpy(), atol=2e-5)
    np.testing.assert_allclose(g_lse.numpy(), w_lse.numpy(), atol=2e-5,
                               rtol=1e-5)
    for causal, ws in ((True, 4), (False, (3, 9))):
        want, got = _both(JF.flashmask_attention, F.flashmask_attention,
                          arrays, causal=causal, window_size=ws)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)
    # no bounds, no window: plain causal attention
    want, got = _both(JF.flashmask_attention, F.flashmask_attention, arrays,
                      causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


def test_functional_refuses_what_jax_refuses():
    b, s, h, d = 1, 32, 2, 16
    q = torch.zeros(b, s, h, d)
    for bad in (np.zeros((b, h, s, 3), np.int32),      # causal takes C 1, 2
                np.zeros((b, h, 7, 1), np.int32),      # not kv_len columns
                np.zeros((b, 3, s, 1), np.int32)):     # heads 3 of 2
        with pytest.raises(ValueError):
            F.flashmask_attention(q, q, q, torch.from_numpy(bad),
                                  causal=True)
        with pytest.raises(ValueError):
            JF.flashmask_attention(*(paddle.to_tensor(np.zeros(
                (b, s, h, d), np.float32)) for _ in range(3)),
                paddle.to_tensor(bad), causal=True)
    with pytest.raises(ValueError):
        F.flashmask_attention(q, q, q, torch.zeros(b, h, s, 1,
                                                   dtype=torch.int32))
    # a dropout is no refusal: the JAX package computes it on its dense
    # path, and so does the port
    out = F.flashmask_attention(q, q, q, torch.zeros(b, h, s, 1,
                                                     dtype=torch.int32),
                                causal=True, dropout=0.1)
    assert out.shape == q.shape
    with pytest.raises(NotImplementedError):
        F.flashmask_attention(q, q, q, None, causal=True,
                              return_seed_offset=True)


def test_functional_takes_bounds_prepared_once():
    """prepare_flashmask's bounds (canonical, GQA-expanded, made once for
    every layer) give what the raw bounds give; their causal form must
    match the call's, and no kernel launches on the CPU."""
    b, s, h, kh, d = 2, 64, 4, 2, 16
    rng = np.random.default_rng(11)
    se = torch.from_numpy(np.stack([np.stack(
        [_doc_ends(rng, s, 5, 30) for _ in range(kh)]) for _ in range(b)])
        [..., None].astype(np.int32))
    q, k, v = (torch.from_numpy(x) for x in _bshd(b, s, h, kh, d, 12))
    before = K.kernel_launches()
    mask = F.prepare_flashmask(se, s, h, kh, causal=True)
    assert tuple(mask.bounds.shape) == (b, h, s, 4) and mask.summary is None
    np.testing.assert_array_equal(
        mask.bounds.numpy(),
        F._canonical_startend(se, s, True).repeat_interleave(2, 1).numpy())
    want = F.flashmask_attention(q, k, v, se, causal=True)
    got = F.flashmask_attention(q, k, v, mask, causal=True)
    assert K.kernel_launches() == before
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="causal"):
        F.flashmask_attention(q, k, v, mask, causal=False)
    with pytest.raises(ValueError):
        F.prepare_flashmask(se, s, h, 3, causal=True)    # heads 2 of 3


def test_flashmask_summary_plain_is_min_and_max_per_tile():
    """The pre-pass's plain version: per 128-column key tile (the bf16
    kernels' key tile; a ragged last one too), the min and max of each
    canonical bound."""
    rng = np.random.default_rng(13)
    bounds = torch.from_numpy(rng.integers(0, 400, (2, 3, 300, 4))
                              .astype(np.int32))
    got = FA.flashmask_summary_plain(bounds)
    assert FA.TILE == 128
    assert tuple(got.shape) == (2, 3, 3, 8) and got.dtype == torch.int32
    for t, (c0, c1) in enumerate(((0, 128), (128, 256), (256, 300))):
        tile = bounds[:, :, c0:c1]
        np.testing.assert_array_equal(got[:, :, t, 0::2].numpy(),
                                      tile.amin(2).numpy())
        np.testing.assert_array_equal(got[:, :, t, 1::2].numpy(),
                                      tile.amax(2).numpy())


def test_functional_rectangular_on_cpu_matches_jax():
    """q_len != kv_len runs the plain version (the JAX dense path's
    top-left causal); the kernels take only q_len == kv_len."""
    b, h, d = 1, 2, 16
    rng = np.random.default_rng(8)
    q = rng.standard_normal((b, 24, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, 40, h, d)).astype(np.float32)
            for _ in range(2))
    se = rng.integers(10, 24, (b, h, 40, 1)).astype(np.int32)
    want, got = _both(JF.flashmask_attention, F.flashmask_attention,
                      (q, k, v, se), causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


def test_dense_attn_mask_matches_jax():
    """scaled_dot_product_attention with a bool and an additive mask."""
    b, s, h, d = 2, 20, 2, 16
    arrays = _bshd(b, s, h, h, d, 9)
    rng = np.random.default_rng(9)
    bool_mask = rng.random((b, 1, s, s)) < 0.7
    add_mask = (rng.standard_normal((1, h, s, s)) * 2).astype(np.float32)
    for mask in (bool_mask, add_mask):
        for causal in (False, True):
            want = JF.scaled_dot_product_attention(
                *(paddle.to_tensor(a) for a in arrays),
                attn_mask=paddle.to_tensor(mask), is_causal=causal)
            got = F.scaled_dot_product_attention(
                *(torch.from_numpy(a) for a in arrays),
                attn_mask=torch.from_numpy(mask), is_causal=causal)
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


# -- the packed-document Llama -----------------------------------------------------

VOCAB = 67
SEQ = 32


def _models(kv_heads=2, bf16=False, seed=31):
    paddle.seed(seed)
    jm = JaxLlama(JaxConfig.tiny(vocab_size=VOCAB, hidden_size=32, layers=2,
                                 heads=4, kv_heads=kv_heads, seq=SEQ))
    pm = LlamaForCausalLM(LlamaConfig.tiny(vocab_size=VOCAB, hidden_size=32,
                                           layers=2, heads=4,
                                           kv_heads=kv_heads, seq=SEQ),
                          device="cpu")
    if bf16:
        jm.bfloat16()
        pm.bfloat16()
    load_numpy_state(pm, {n: np.asarray(t._data)
                          for n, t in jm.named_state().items()})
    return jm, pm


@functools.lru_cache(maxsize=None)
def _packed(b=2, s=SEQ, seed=31):
    """(ids, labels with each document's first position but 0 at -100,
    startend [b, 1, s, 1], dense visibility [b, 1, s, s])."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (b, s)).astype(np.int32)
    ends = np.stack([_doc_ends(rng, s, 3, 12) for _ in range(b)])
    labels = ids.copy()
    starts = np.zeros((b, s), bool)
    starts[:, 1:] = ends[:, 1:] != ends[:, :-1]
    labels[starts] = -100
    i = np.arange(s)
    vis = (i[:, None] >= i[None, :]) & (i[:, None] < ends[:, None, :])
    return ids, labels, ends[:, None, :, None], vis[:, None]


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_packed_llama_logits_match_jax(kv_heads):
    jm, pm = _models(kv_heads)
    ids, _, se, vis = _packed()
    want = jm(paddle.to_tensor(ids),
              attn_startend_row_indices=paddle.to_tensor(se)).numpy()
    before = K.kernel_launches()
    with torch.no_grad():
        got = pm(torch.from_numpy(ids),
                 attn_startend_row_indices=torch.from_numpy(se))
        dense = pm(torch.from_numpy(ids),
                   attention_mask=torch.from_numpy(vis))
        causal = pm(torch.from_numpy(ids))
    assert K.kernel_launches() == before
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(dense.numpy(), got.numpy(), atol=1e-5)
    assert not np.allclose(causal.numpy(), got.numpy(), atol=1e-3)


@pytest.mark.parametrize("chunk", [None, 7])
def test_packed_llama_loss_and_every_gradient_match_jax(chunk):
    """forward_loss with the bounds (whole and chunked), every parameter's
    gradient against the JAX eager backward, and the port's own dense
    attention_mask path with the same visibility."""
    jm, pm = _models()
    ids, labels, se, vis = _packed()
    jloss = jm.forward_loss(paddle.to_tensor(ids), paddle.to_tensor(labels),
                            loss_chunk_size=chunk,
                            attn_startend_row_indices=paddle.to_tensor(se))
    jloss.backward()
    want = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    loss = pm.forward_loss(torch.from_numpy(ids), torch.from_numpy(labels),
                           loss_chunk_size=chunk,
                           attn_startend_row_indices=torch.from_numpy(se))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss.numpy()),
                               rtol=1e-5)
    got = {n: p.grad.clone() for n, p in pm.named_parameters()}
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w, atol=1e-5,
                                   rtol=1e-4, err_msg=name)
    pm.zero_grad()
    dense = pm.forward_loss(torch.from_numpy(ids), torch.from_numpy(labels),
                            loss_chunk_size=chunk,
                            attention_mask=torch.from_numpy(vis))
    dense.backward()
    np.testing.assert_allclose(float(dense.detach()), float(loss.detach()),
                               rtol=1e-6)
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), got[name].numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=name)


def test_packed_llama_refuses_mask_with_bounds():
    _, pm = _models()
    ids, _, se, vis = _packed()
    with pytest.raises(NotImplementedError, match="cannot be combined"):
        pm(torch.from_numpy(ids), attention_mask=torch.from_numpy(vis),
           attn_startend_row_indices=torch.from_numpy(se))


# -- the trainer ---------------------------------------------------------------------

LR = 1e-3


def _loss_fn(m, ids, labels, se):
    return m.forward_loss(ids, labels, loss_chunk_size=8,
                          attn_startend_row_indices=se)


def _train(bf16, accumulate=1):
    jm, pm = _models(bf16=bf16, seed=5)
    ids, labels, se, _ = _packed(b=4, s=24, seed=9)
    jtr = JaxTrainer(jm, jopt.AdamW(learning_rate=LR,
                                    parameters=jm.parameters(),
                                    weight_decay=0.01),
                     _loss_fn, mesh=None, remat_layers=list(jm.model.layers),
                     remat_policy="full", accumulate_steps=accumulate)
    ptr = SpmdTrainer(pm, opt.AdamW(learning_rate=LR,
                                    parameters=pm.parameters(),
                                    weight_decay=0.01),
                      _loss_fn, remat_layers=list(pm.model.layers),
                      accumulate_steps=accumulate)
    want, got = [], []
    for _ in range(3):
        want.append(float(jtr.train_step(
            *(paddle.to_tensor(x) for x in (ids, labels, se))).numpy()))
        got.append(float(ptr.train_step(
            *(torch.from_numpy(x) for x in (ids, labels, se)))))
    jw = {n: np.asarray(p._data.astype("float32"))
          for n, p in jm.named_parameters()}
    pw = {n: p.detach().float().numpy() for n, p in pm.named_parameters()}
    return want, got, jw, pw


@pytest.mark.parametrize("accumulate", [1, 2])
def test_trainer_f32_with_bounds_matches_jax(accumulate):
    """3 steps in float32; accumulate_steps=2 splits the bounds with the
    ids and labels. Weights as test_torch_trainer.py holds them."""
    want, got, jw, pw = _train(False, accumulate)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    close = total = 0
    for name, w in jw.items():
        d = np.abs(pw[name] - w)
        assert np.all(d <= 3 * LR), name
        close += int((d <= 2e-6).sum())
        total += w.size
    assert close >= 0.999 * total, (close, total)


def test_trainer_bf16_with_bounds_matches_jax():
    want, got, jw, pw = _train(True)
    np.testing.assert_allclose(got, want, rtol=2e-3)
    for name, w in jw.items():
        tol = 2.0 ** -6 * np.abs(w) + 3 * LR
        assert np.all(np.abs(pw[name] - w) <= tol), name
