"""paddle_tpu_torch's ERNIE against paddle_tpu's, on the CPU, at dropout 0:
pretraining logits, the loss, every gradient, 3 SpmdTrainer + AdamW
steps, sequence classification with and without a mask, and the ``nn``
and fleet layers it is built from.

A tiny ERNIE (``ErnieConfig.tiny()``: hidden 64, 2 layers, 4 heads,
vocab 128, 32 positions, dropout 0) is built in paddle_tpu (its attention
takes the XLA reference path on the CPU) and its weights carried across
with ``load_numpy_state``; the port's plain versions then run the same
model. Inputs are made with numpy from a seed.

Tolerances, float32: logits 2e-5 relative to the largest (fp32 sums in
another order through two post-LN blocks); the loss 1e-6 relative (a mean
of such logits' log-softmax); each gradient 1e-4 relative L2 (sums over
the batch and sequence of such products); trainer weights 1e-5 after 3
steps (AdamW moves each by about lr a step, the gradients agree to
1e-4 relative, so the updates agree far inside 1e-5; the key bias,
whose gradient is 0 in exact arithmetic, within 3 lr). Layers: 1e-6
(one product or one normalisation).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed.fleet import meta_parallel as jmp
from paddle_tpu.models.ernie import ErnieConfig as JaxConfig
from paddle_tpu.models.ernie import ErnieForPretraining as JaxErnie
from paddle_tpu.models.ernie import \
    ErnieForSequenceClassification as JaxErnieCls
from paddle_tpu.models.ernie import ernie_pretrain_step as jax_step
from paddle_tpu.parallel.trainer import SpmdTrainer as JaxTrainer
from paddle_tpu.tensor import Tensor

import paddle_tpu_torch.nn as pnn
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.distributed.fleet import meta_parallel as pmp
from paddle_tpu_torch.models import (ErnieConfig, ErnieForPretraining,
                                     ErnieForSequenceClassification,
                                     ernie_pretrain_step, load_numpy_state)
from paddle_tpu_torch.parallel import SpmdTrainer

B, S = 2, 32
LR = 1e-3


def _state(jm):
    return {n: np.asarray(t._data) for n, t in jm.named_state().items()}


def _models(seed=3):
    paddle.seed(seed)
    cfg = JaxConfig.tiny()
    jm = JaxErnie(cfg)
    pm = ErnieForPretraining(ErnieConfig.tiny(), device="cpu")
    load_numpy_state(pm, _state(jm))
    return jm, pm


def _batch(seed=0, b=B):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 128, (b, S)).astype(np.int32)
    tt = np.zeros((b, S), np.int32)
    tt[:, S // 2:] = 1
    labels = np.where(rng.random((b, S)) < 0.15, ids, -100).astype(np.int32)
    labels[:, 0] = ids[:, 0]            # at least one label a row
    nsp = (np.arange(b) % 2).astype(np.int32)
    return ids, tt, labels, nsp


def _jt(a):
    return Tensor(jnp.asarray(a))


def _pt(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel_close(got, want, rtol):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def test_pretraining_logits_match_jax():
    jm, pm = _models()
    ids, tt, _, _ = _batch()
    jmlm, jnsp = jm(_jt(ids), _jt(tt))
    with torch.no_grad():
        mlm, nsp = pm(_pt(ids), _pt(tt))
    assert mlm.shape == (B, S, 128) and nsp.shape == (B, 2)
    _rel_close(mlm.numpy(), np.asarray(jmlm._data), 2e-5)
    _rel_close(nsp.numpy(), np.asarray(jnsp._data), 2e-5)


def test_loss_and_every_gradient_match_jax():
    jm, pm = _models()
    ids, tt, labels, nsp = _batch(1)
    jloss = jax_step(jm, {"input_ids": _jt(ids), "token_type_ids": _jt(tt),
                          "mlm_labels": _jt(labels), "nsp_labels": _jt(nsp)})
    jloss.backward()
    loss = ernie_pretrain_step(pm, {"input_ids": _pt(ids),
                                    "token_type_ids": _pt(tt),
                                    "mlm_labels": _pt(labels),
                                    "nsp_labels": _pt(nsp)})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss.numpy()),
                               rtol=1e-6)
    want = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    got = dict(pm.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].grad.numpy()
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= 1e-4, (name, err)


def _loss_fn_jax(m, ids, tt, labels, nsp):
    return jax_step(m, {"input_ids": ids, "token_type_ids": tt,
                        "mlm_labels": labels, "nsp_labels": nsp})


def _loss_fn(m, ids, tt, labels, nsp):
    return ernie_pretrain_step(m, {"input_ids": ids, "token_type_ids": tt,
                                   "mlm_labels": labels,
                                   "nsp_labels": nsp})


def test_trainer_steps_match_jax():
    """3 SpmdTrainer + AdamW steps on each side: losses and every weight."""
    jm, pm = _models()
    batch = _batch(2, b=4)
    jtr = JaxTrainer(jm, jopt.AdamW(learning_rate=LR,
                                    parameters=jm.parameters(),
                                    weight_decay=0.01), _loss_fn_jax,
                     mesh=None)
    ptr = SpmdTrainer(pm, opt.AdamW(learning_rate=LR,
                                    parameters=pm.parameters(),
                                    weight_decay=0.01), _loss_fn)
    want, got = [], []
    for _ in range(3):
        want.append(float(jtr.train_step(*map(_jt, batch)).numpy()))
        got.append(float(ptr.train_step(*map(_pt, batch))))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    jw = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    for n, p in pm.named_parameters():
        d = np.abs(p.detach().numpy() - jw[n])
        assert np.all(d <= 3 * LR), n
        if n.endswith("attention.qkv.bias"):
            # the key bias's gradient is 0 in exact arithmetic (softmax
            # ignores a constant added to every key's score), so AdamW
            # turns both sides' rounding noise into steps of ~lr
            h = d.size // 3
            d = np.concatenate([d[:h], d[2 * h:]])
        assert d.max() <= 1e-5, (n, float(d.max()))


@pytest.mark.parametrize("mask", ["none", "bool", "additive"])
def test_sequence_classification_matches_jax(mask):
    """ErnieForSequenceClassification (3 classes) in eval, without a mask
    and with a padding mask ([b, 1, 1, s]: row 1's last 9 keys hidden) as
    bool (True = visible) or additive (0 / -1e9)."""
    paddle.seed(5)
    jm = JaxErnieCls(JaxConfig.tiny(), num_classes=3)
    jm.eval()
    pm = ErnieForSequenceClassification(ErnieConfig.tiny(), num_classes=3,
                                        device="cpu")
    pm.eval()
    load_numpy_state(pm, _state(jm))
    ids, tt, _, _ = _batch(4)
    m = None
    if mask != "none":
        vis = np.ones((B, 1, 1, S), bool)
        vis[1, ..., S - 9:] = False
        m = vis if mask == "bool" else np.where(vis, 0.0, -1e9).astype(
            np.float32)
    want = jm(_jt(ids), _jt(tt), None if m is None else _jt(m))
    with torch.no_grad():
        got = pm(_pt(ids), _pt(tt), None if m is None else _pt(m))
    assert got.shape == (B, 3)
    _rel_close(got.numpy(), np.asarray(want._data), 2e-5)


def test_num_params_flops_and_the_base_preset():
    jm, pm = _models()
    assert pm.num_params() == jm.num_params()
    cfg = ErnieConfig.ernie_base()
    assert (cfg.vocab_size, cfg.hidden_size, cfg.num_hidden_layers,
            cfg.num_attention_heads, cfg.intermediate_size,
            cfg.max_position_embeddings, cfg.type_vocab_size,
            cfg.layer_norm_eps, cfg.hidden_dropout_prob,
            cfg.attention_probs_dropout_prob) == (
        18000, 768, 12, 12, 3072, 512, 4, 1e-12, 0.1, 0.1)
    assert cfg == ErnieConfig(**vars(JaxConfig.ernie_base()))
    base = ErnieForPretraining(cfg, device="meta",
                               generator=torch.Generator())
    h, f, v = 768, 3072, 18000
    blocks = 12 * (4 * h * h + 2 * h * f)
    assert base.flops_per_token(512) == pytest.approx(
        6 * (blocks + h * h + v * h + (h * h + 2 * h) / 512)
        + 12 * 12 * h * 512)
    assert 99e6 < base.num_params() < 101e6


def _ln_pair(jl, pl, x):
    y = np.asarray(jl(_jt(x))._data)
    with torch.no_grad():
        got = pl(_pt(x)).numpy()
    np.testing.assert_allclose(got, y, rtol=1e-6, atol=1e-6)


def _carry(jl, pl):
    load_numpy_state(pl, _state(jl))


@pytest.mark.parametrize("case", ["linear", "linear_no_bias", "embedding",
                                  "embedding_padding", "layer_norm",
                                  "layer_norm_2d", "dropout_eval",
                                  "layer_list"])
def test_nn_layers_match_jax(case):
    """Each layer of ``paddle_tpu_torch.nn`` against the JAX layer: the
    same parameter names and shapes, the same default initial values
    where they are constants (zeros, ones, the padding row) and the same
    distribution otherwise, and the same output with the JAX weights."""
    paddle.seed(11)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    kw = dict(device="cpu")
    if case.startswith("linear"):
        battr = False if case == "linear_no_bias" else None
        jl = paddle.nn.Linear(16, 24, bias_attr=battr)
        pl = pnn.Linear(16, 24, bias_attr=battr, **kw)
        std = float(pl.weight.detach().std())
        assert abs(std / np.sqrt(2.0 / 40) - 1) < 0.15
        if battr is None:
            assert not pl.bias.any()
    elif case.startswith("embedding"):
        pad = 2 if case == "embedding_padding" else None
        jl = paddle.nn.Embedding(50, 16, padding_idx=pad)
        pl = pnn.Embedding(50, 16, padding_idx=pad, **kw)
        assert abs(float(pl.weight.detach().std()) - 1) < 0.1
        if pad is not None:
            assert not pl.weight[pad].any()
        x = rng.integers(0, 50, (3, 5))
    elif case.startswith("layer_norm"):
        shape = [5, 16] if case == "layer_norm_2d" else 16
        jl = paddle.nn.LayerNorm(shape, epsilon=1e-12)
        pl = pnn.LayerNorm(shape, epsilon=1e-12, **kw)
        assert bool((pl.weight == 1).all()) and not pl.bias.any()
        jl.weight.set_value(jnp.asarray(
            1 + 0.1 * rng.standard_normal(jl.weight.shape), jnp.float32))
    elif case == "dropout_eval":
        jl = paddle.nn.Dropout(0.3, mode="downscale_in_infer")
        pl = pnn.Dropout(0.3, mode="downscale_in_infer")
        jl.eval()
        pl.eval()
    else:
        jl = paddle.nn.LayerList([paddle.nn.Linear(16, 16) for _ in range(3)])
        pl = pnn.LayerList([pnn.Linear(16, 16, **kw) for _ in range(3)])
        assert len(pl) == 3 and len(pl[1:]) == 2

        def run(layers):
            def f(a):
                for layer in layers:
                    a = layer(a)
                return a
            return f
        assert sorted(n for n, _ in pl.named_parameters()) == sorted(
            _state(jl))
        _carry(jl, pl)
        _ln_pair(run(jl), run(pl), x)
        return
    assert {n: tuple(p.shape) for n, p in pl.named_parameters()} == {
        n: tuple(a.shape) for n, a in _state(jl).items()}
    _carry(jl, pl)
    _ln_pair(jl, pl, x)


@pytest.mark.parametrize("case", ["column", "column_no_bias", "row",
                                  "vocab_embedding"])
def test_fleet_layers_match_jax(case):
    """The fleet tensor-parallel layers on one device against the JAX
    layers (mp degree 1): names, shapes, initial distributions and the
    output with the JAX weights."""
    paddle.seed(12)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    if case.startswith("column"):
        bias = case == "column"
        jl = jmp.ColumnParallelLinear(32, 48, has_bias=bias)
        pl = pmp.ColumnParallelLinear(32, 48, has_bias=bias, device="cpu")
        assert abs(float(pl.weight.detach().std()) / np.sqrt(2.0 / 80) - 1) < 0.15
    elif case == "row":
        jl = jmp.RowParallelLinear(32, 40)
        pl = pmp.RowParallelLinear(32, 40, device="cpu")
        assert not pl.bias.any()
    else:
        jl = jmp.VocabParallelEmbedding(300, 32)
        pl = pmp.VocabParallelEmbedding(300, 32, device="cpu")
        assert abs(float(pl.weight.detach().std()) / 0.02 - 1) < 0.1
        x = rng.integers(0, 300, (2, 7))
    assert {n: tuple(p.shape) for n, p in pl.named_parameters()} == {
        n: tuple(a.shape) for n, a in _state(jl).items()}
    _carry(jl, pl)
    _ln_pair(jl, pl, x)


class _Group:
    nranks = 2


@pytest.mark.parametrize("cls", ["ColumnParallelLinear", "RowParallelLinear",
                                 "VocabParallelEmbedding"])
def test_mp_degree_above_one_raises(cls):
    layer = getattr(pmp, cls)
    with pytest.raises(NotImplementedError, match="Queue 1, distributed"):
        layer(8, 8, mp_group=_Group(), device="cpu")
    layer(8, 8, mp_group=None, device="cpu")


def test_ernie_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ErnieForPretraining(ErnieConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pnn.Linear(4, 4)


@pytest.mark.parametrize("vocab", [4, 300])
def test_segment_table_gradient_is_the_scatter_add(vocab):
    """The token-type table (``one_hot(ids)^T @ dy`` in fp32 for its
    gradient): its rows, and its gradient against the JAX embedding's
    (the transpose of ``jnp.take``) within 1e-5 (fp32 sums of up to 60
    unit-normal terms in another order)."""
    from paddle_tpu_torch.models.ernie import _SegmentEmbedding
    rng = np.random.default_rng(vocab)
    ids = rng.integers(0, vocab, (6, 40))
    w = rng.standard_normal((vocab, 16)).astype(np.float32)
    dy = rng.standard_normal((6, 40, 16)).astype(np.float32)
    jw = paddle.to_tensor(w, stop_gradient=False)
    (paddle.nn.functional.embedding(_jt(ids), jw) * _jt(dy)).sum().backward()
    table = _SegmentEmbedding(vocab, 16, device="cpu")
    with torch.no_grad():
        table.weight.copy_(_pt(w))
    out = table(_pt(ids))
    assert torch.equal(out, _pt(w)[_pt(ids)])
    out.backward(_pt(dy))
    np.testing.assert_allclose(table.weight.grad.numpy(),
                               np.asarray(jw.grad.numpy()), rtol=1e-5,
                               atol=1e-5)
