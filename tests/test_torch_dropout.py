"""paddle_tpu_torch's random state and dropout on the CPU: the
``(seed, counter)`` contract of ``paddle_tpu/framework/random.py``, the
Philox4x32-10 mask (known answers, keys, sites, its keep fraction), the
dropout functional against the JAX one where it is deterministic, the
attention routes a dropout takes, the fused bias-dropout-residual
LayerNorm against its composition, and a tiny ERNIE at dropout 0.1 that
trains bit for bit the same with and without remat and from one seed.

The JAX and torch random streams cannot match: where the JAX function is
random the port is held to its own plain version (the kernels' bits) and
to the JAX formula on the kept elements.

Tolerances: masks, counts and the plain versions bit-equal; kept values
within one fp32 ulp of the JAX formula ``x / (1 - p)`` (the port
multiplies by the fp32 ``1 / (1 - p)``); attention and LayerNorm against
JAX 1e-6 (fp32 sums in another order); the keep fraction within 5 sigma
of ``1 - p``.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import paddle_tpu as paddle
from paddle_tpu.framework import random as jrandom
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.nn import functional as JF
from paddle_tpu.tensor import Tensor

import paddle_tpu_torch as ptt
from paddle_tpu_torch import kernels as K
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.framework import random as prandom
from paddle_tpu_torch.incubate.nn import functional as PIF
from paddle_tpu_torch.kernels import dropout as D
from paddle_tpu_torch.kernels import flash_attention as FA
from paddle_tpu_torch.kernels import fused
from paddle_tpu_torch.models import (ErnieConfig, ErnieForPretraining,
                                     ernie_pretrain_step)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.parallel import SpmdTrainer


def _jt(a):
    return Tensor(jnp.asarray(a))


# -- the random state -------------------------------------------------------------

def test_rng_state_follows_the_jax_contract():
    """seed / get_rng_state / set_rng_state / next_key / key_context move
    the same ``(seed, counter)`` state in both packages, and the port's
    key at a state is ``(seed's key, counter)``."""
    for mod in (jrandom, prandom):
        mod.seed(7)
        assert mod.get_rng_state() == (7, 0)
        mod.next_key()
        mod.next_key()
        assert mod.get_rng_state() == (7, 2)
        mod.set_rng_state((7, 1))
        assert mod.get_rng_state() == (7, 1)
        base = jrandom.jax.random.PRNGKey(3) if mod is jrandom else (3, 0)
        with mod.key_context(base) as ctx:
            mod.next_key()
            mod.next_key()
            assert ctx.counter == 2
        assert mod.get_rng_state() == (7, 1)
    prandom.set_rng_state((7, 1))
    assert prandom.next_key() == prandom.RandomKey(prandom.seed_key(7), 2)
    with prandom.key_context((5, 6)):
        assert prandom.next_key() == prandom.RandomKey((5, 6), 1)
    assert ptt.get_rng_state() == (7, 2)
    ptt.seed(1 << 40 | 9)
    assert prandom.next_key().base == (9, 1 << 8)


def test_philox_matches_the_known_answers():
    """Philox4x32-10's published test vectors (Random123), in Python and
    through the plain torch version's 16-bit limbs."""
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
             ((0xffffffff,) * 4, (0xffffffff,) * 2,
              (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
             ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
              (0xa4093822, 0x299f31d0),
              (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for ctr, key, want in cases:
        assert prandom.philox4x32(ctr, key) == want
        t = [torch.tensor([c], dtype=torch.int64) for c in ctr]
        got = D.philox_plain(*t, *key)
        assert tuple(int(x) for x in got) == want
    rng = np.random.default_rng(0)
    ctrs = rng.integers(0, 2 ** 32, (500, 4))
    key = tuple(int(k) for k in rng.integers(0, 2 ** 32, 2))
    got = torch.stack(D.philox_plain(*torch.from_numpy(ctrs).T, *key), -1)
    assert [tuple(r) for r in got.tolist()] == [
        prandom.philox4x32(c, key) for c in ctrs.tolist()]


def test_mask_is_a_function_of_key_site_and_index():
    k = prandom.RandomKey((1, 2), 5)
    a = D.keep_mask_plain((3001,), 0.3, k)
    assert torch.equal(a, D.keep_mask_plain((3001,), 0.3, k))
    assert torch.equal(a, D.keep_mask_plain(
        (3001,), 0.3, prandom.RandomKey(torch.tensor([1, 2]), 5)))
    # a longer mask starts with the shorter one; a shape is only a view
    assert torch.equal(a[:1000], D.keep_mask_plain((1000,), 0.3, k))
    assert torch.equal(a[:3000].reshape(3, 1000),
                       D.keep_mask_plain((3, 1000), 0.3, k))
    for other in (prandom.RandomKey((1, 2), 6), prandom.RandomKey((1, 3), 5),
                  prandom.RandomKey((2, 2), 5)):
        assert not torch.equal(a, D.keep_mask_plain((3001,), 0.3, other))
    bits = D.mask_bits_plain(8, k)
    words = prandom.philox4x32((0, 0, 5, 0), (1, 2)) \
        + prandom.philox4x32((1, 0, 5, 0), (1, 2))
    assert bits.tolist() == list(words)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_keep_fraction_within_5_sigma(p):
    n = 400_000
    keep = D.keep_mask_plain((n,), p, prandom.RandomKey((11, 12), 3))
    frac = float(keep.float().mean())
    assert abs(frac - (1 - p)) <= 5 * math.sqrt(p * (1 - p) / n), frac
    assert D.threshold(p) == round(p * 2 ** 24)


# -- the functional ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_keeps_and_scales_as_jax(mode, dtype):
    """Training at p = 0.25: each element is 0 or kept, the mask is the
    key's, and a kept element is ``x / (1 - p)`` (upscale, within an fp32
    ulp before the rounding to x's dtype) or x (downscale)."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (64, 33)).astype(np.float32) + 3.0).to(dtype)
    ptt.seed(3)
    y = F.dropout(x, 0.25, mode=mode)
    keep = D.keep_mask_plain(x.shape, 0.25,
                             prandom.RandomKey(prandom.seed_key(3), 1))
    assert y.dtype == dtype and torch.equal(y != 0, keep)
    assert torch.equal(y, D.dropout_plain(
        x, 0.25, prandom.RandomKey(prandom.seed_key(3), 1), mode))
    if mode == "downscale_in_infer":
        assert torch.equal(y[keep], x[keep])
    else:
        want = x[keep].float() / 0.75
        err = (y[keep].float() - want.to(dtype).float()).abs()
        ulp = 2.0 ** -23 if dtype == torch.float32 else 2.0 ** -8
        assert bool((err <= ulp * want.abs()).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["p0", "p1", "eval_upscale",
                                  "eval_downscale"])
def test_dropout_equals_jax_where_deterministic(case, dtype):
    x = np.random.default_rng(2).standard_normal((5, 7)).astype(np.float32)
    p, training, mode = {"p0": (0.0, True, "upscale_in_train"),
                         "p1": (1.0, True, "upscale_in_train"),
                         "eval_upscale": (0.4, False, "upscale_in_train"),
                         "eval_downscale": (0.4, False,
                                            "downscale_in_infer")}[case]
    want = JF.dropout(Tensor(jnp.asarray(x).astype(dtype)), p=p,
                      training=training, mode=mode)
    got = F.dropout(torch.from_numpy(x).to(getattr(torch, dtype)), p=p,
                    training=training, mode=mode)
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want._data.astype("float32")))


@pytest.mark.parametrize("axis", [1, [0, 2], -1])
def test_axis_broadcasts_one_mask(axis):
    """With ``axis`` the mask spans those axes and is the same along the
    others (the JAX function's mask shape)."""
    x = torch.ones(4, 6, 8)
    ptt.seed(5)
    y = F.dropout(x, 0.5, axis=axis)
    axes = [axis] if isinstance(axis, int) else axis
    axes = [a % 3 for a in axes]
    shape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
    keep = D.keep_mask_plain(shape, 0.5,
                             prandom.RandomKey(prandom.seed_key(5), 1))
    assert torch.equal(y, torch.where(keep, 2.0, 0.0).expand(4, 6, 8))


def test_backward_draws_the_mask_again():
    x = torch.randn(40, 50, generator=torch.Generator().manual_seed(0)) \
        .requires_grad_()
    ptt.seed(9)
    y = F.dropout(x, 0.3)
    y.backward(torch.ones_like(y))
    s = D.scale_of(0.3, "upscale_in_train")
    assert torch.equal(x.grad, torch.where(y != 0, s, 0.0))


def test_dropout_launches_nothing_on_cpu():
    before = K.kernel_launches()
    F.dropout(torch.ones(10), 0.5)
    fused.dropout_add_layer_norm(torch.ones(2, 8), torch.ones(8),
                                 torch.zeros(8), 1e-5, torch.ones(2, 8),
                                 torch.ones(8), 0.5,
                                 prandom.RandomKey((1, 1), 1))
    assert K.kernel_launches() == before


# -- attention routes -------------------------------------------------------------

def _qkv(seed=0, b=2, s=16, h=2, d=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def _dense_dropped(q, k, v, p, key, vis=None):
    scores = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(q.shape[-1])
    if vis is not None:
        scores = scores.masked_fill(~vis, -1e30)
    probs = torch.softmax(scores, dim=-1)
    probs = D.dropout_plain(probs, p, key)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def test_sdpa_with_dropout_drops_the_dense_probabilities():
    q, k, v = (torch.from_numpy(a) for a in _qkv())
    ptt.seed(4)
    before = dict(K.LAUNCHES)
    out = F.scaled_dot_product_attention(q, k, v, dropout_p=0.2)
    assert K.LAUNCHES["sdpa_dense"] == before["sdpa_dense"] + 1
    assert K.LAUNCHES["sdpa_plain"] == before["sdpa_plain"]
    want = _dense_dropped(q, k, v, 0.2,
                          prandom.RandomKey(prandom.seed_key(4), 1))
    assert torch.equal(out, want)


@pytest.mark.parametrize("dropout_p,training,route", [
    (0.0, True, "flash"), (0.1, False, "sdpa_dense"),
    (0.0, False, "flash")])
def test_sdpa_routes_as_jax(dropout_p, training, route):
    """The JAX package takes flash only at ``dropout_p == 0`` without a
    mask, whatever ``training`` is (``attention.py:57``): with a dropout
    in eval it runs the dense path without dropping (Queue 3 F10). Both
    routes equal the JAX function there."""
    qn, kn, vn = _qkv(1)
    want = JF.scaled_dot_product_attention(_jt(qn), _jt(kn), _jt(vn),
                                           dropout_p=dropout_p,
                                           training=training)
    before = dict(K.LAUNCHES)
    got = F.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (qn, kn, vn)), dropout_p=dropout_p,
        training=training)
    dense = K.LAUNCHES["sdpa_dense"] - before["sdpa_dense"]
    assert dense == (1 if route == "sdpa_dense" else 0)
    assert K.LAUNCHES["sdpa_plain"] == before["sdpa_plain"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               atol=1e-6)


def _bounds(b, s, seed=2):
    """Document-end bounds [b, 1, s, 1] (causal LTS)."""
    rng = np.random.default_rng(seed)
    ends = np.full((b, 1, s, 1), s, np.int32)
    for i in range(b):
        cut = int(rng.integers(4, s - 4))
        ends[i, 0, :cut, 0] = cut
    return ends


@pytest.mark.parametrize("training", [True, False])
def test_flashmask_with_dropout_routes_as_jax(training):
    """``flashmask_attention(dropout=0.2)``: training, the dense path over
    the bounds' visibility with the probabilities dropped; in eval the
    kernels' route (their plain versions here) with no drop, equal to the
    JAX function."""
    qn, kn, vn = _qkv(3)
    se = _bounds(2, 16)
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    ptt.seed(6)
    before = dict(K.LAUNCHES)
    got = F.flashmask_attention(q, k, v, torch.from_numpy(se), dropout=0.2,
                                causal=True, training=training)
    dense = K.LAUNCHES["sdpa_dense"] - before["sdpa_dense"]
    if training:
        assert dense == 1
        bounds = F.prepare_flashmask(torch.from_numpy(se), 16, 2, 2, True,
                                     summarize=False).bounds
        vis = FA.flashmask_visible(bounds, 16, 16, True)
        want = _dense_dropped(q, k, v, 0.2,
                              prandom.RandomKey(prandom.seed_key(6), 1), vis)
        assert torch.equal(got, want)
    else:
        assert dense == 0
        want = JF.flashmask_attention(_jt(qn), _jt(kn), _jt(vn), _jt(se),
                                      dropout=0.2, causal=True,
                                      training=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                                   atol=1e-6)


# -- the fused LayerNorm ----------------------------------------------------------

def _ln_inputs(dtype, seed=0, rows=6, n=40):
    rng = np.random.default_rng(seed)
    a = [rng.standard_normal(s).astype(np.float32)
         for s in ((rows, n), (rows, n), (n,), (n,), (n,))]
    a[3] = 1 + 0.1 * a[3]
    return [torch.from_numpy(x).to(dtype).requires_grad_() for x in a]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_layer_norm_is_the_composition_of_the_plain_ops(dtype):
    """``fused_bias_dropout_residual_layer_norm`` on CPU tensors (kernel
    2's plain version) against dropout, add and layer_norm called one by
    one from the same key: output and every gradient bit-equal."""
    def run(fused_path):
        x, r, b, w, nb = _ln_inputs(dtype)
        ptt.seed(8)
        if fused_path:
            y = PIF.fused_bias_dropout_residual_layer_norm(
                x, r, bias=b, ln_scale=w, ln_bias=nb, dropout_rate=0.3,
                ln_epsilon=1e-5)
        else:
            h = F.dropout(x + b, 0.3) + r
            y = F.layer_norm(h, 40, w, nb, 1e-5)
        y.backward(torch.linspace(-1, 1, y.numel()).reshape(y.shape)
                   .to(dtype))
        return [y] + [t.grad for t in (x, r, b, w, nb)]
    for a, b in zip(run(True), run(False)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["p0", "eval", "eval_downscale"])
def test_fused_layer_norm_equals_jax_where_deterministic(case):
    x, r, b, w, nb = (t.detach() for t in _ln_inputs(torch.float32, 1))
    p, training, mode = {"p0": (0.0, True, "upscale_in_train"),
                         "eval": (0.3, False, "upscale_in_train"),
                         "eval_downscale": (0.3, False,
                                            "downscale_in_infer")}[case]
    want = JIF.fused_bias_dropout_residual_layer_norm(
        *(_jt(t.numpy()) for t in (x, r, b, w, nb)), dropout_rate=p,
        ln_epsilon=1e-5, training=training, mode=mode)
    got = PIF.fused_bias_dropout_residual_layer_norm(
        x, r, b, w, nb, dropout_rate=p, ln_epsilon=1e-5, training=training,
        mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               atol=1e-6)


# -- a tiny ERNIE at dropout 0.1 ------------------------------------------------

def _ernie(remat=False, accumulate=1):
    cfg = dataclasses.replace(ErnieConfig.tiny(), hidden_dropout_prob=0.1,
                              attention_probs_dropout_prob=0.1)
    model = ErnieForPretraining(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(1))
    tr = SpmdTrainer(model, opt.AdamW(learning_rate=1e-3,
                                      parameters=model.parameters()),
                     _loss_fn, accumulate_steps=accumulate,
                     remat_layers=list(model.ernie.encoder) if remat
                     else None)
    return tr


def _loss_fn(m, ids, tt, labels, nsp):
    return ernie_pretrain_step(m, {"input_ids": ids, "token_type_ids": tt,
                                   "mlm_labels": labels,
                                   "nsp_labels": nsp})


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 128, (4, 32))
    tt = np.zeros((4, 32), np.int64)
    tt[:, 16:] = 1
    labels = np.where(rng.random((4, 32)) < 0.15, ids, -100)
    nsp = np.arange(4) % 2
    return tuple(torch.from_numpy(a) for a in (ids, tt, labels, nsp))


def _train(tr, seed, steps=2):
    ptt.seed(seed)
    batch = _batch()
    losses = [tr.train_step(*batch) for _ in range(steps)]
    return losses, {n: g.clone() for n, g in tr._grads.items()}, \
        {n: p.detach().clone() for n, p in tr.model.named_parameters()}


def _same(a, b):
    la, ga, pa = a
    lb, gb, pb = b
    return (all(torch.equal(x, y) for x, y in zip(la, lb))
            and all(torch.equal(ga[n], gb[n]) for n in ga)
            and all(torch.equal(pa[n], pb[n]) for n in pa))


def test_remat_draws_the_forwards_masks():
    """The recompute of a remat'd block draws the masks its forward drew:
    losses, gradients and weights bit-equal with and without remat."""
    assert _same(_train(_ernie(remat=True), 21), _train(_ernie(), 21))


def test_one_seed_one_run_another_seed_other_masks():
    a = _train(_ernie(), 21)
    assert _same(a, _train(_ernie(), 21))
    assert not _same(a, _train(_ernie(), 22))


def test_each_micro_batch_draws_its_own_key():
    """accumulate_steps=2: the step's key folded into one key a
    micro-batch (the JAX trainer splits its key); the run is repeatable."""
    tr = _ernie(accumulate=2)
    a = _train(tr, 23)
    assert tr._key.shape == (2, 2) and not torch.equal(tr._key[0],
                                                       tr._key[1])
    drawn = prandom.RandomKey(prandom.seed_key(23), 2)   # the second step
    step = prandom.fold_in(drawn.base, drawn.site)
    assert tr._key.tolist() == [list(prandom.fold_in(step, i))
                                for i in range(2)]
    assert _same(a, _train(_ernie(accumulate=2), 23))


_HOST_READS = {"item", "tolist", "cpu", "numpy", "nonzero", "__bool__",
               "__float__", "__int__", "tensor", "as_tensor", "from_numpy"}


class _NoHostRoundTrip(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in _HOST_READS:
            raise AssertionError(f"the step body called {name}")
        return func(*args, **(kwargs or {}))


def test_dropout_step_body_makes_no_host_round_trip():
    """The ERNIE step at dropout 0.1 reads its keys from the trainer's
    key tensor: nothing in the body reads the host or makes a tensor from
    host data, so a CUDA graph of it replays each step's key."""
    tr = _ernie(remat=True)
    batch = _batch()
    tr._step_eager(*batch)
    static = tr._stage(batch)
    tr._begin_step()
    with _NoHostRoundTrip():
        tr._step_body(static)
