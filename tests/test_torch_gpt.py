"""paddle_tpu_torch's GPT (dense and dropless MoE) against paddle_tpu's,
on the CPU: logits, the loss with the MoE aux term, every gradient, and 3
SpmdTrainer + AdamW steps.

A tiny GPT is built in paddle_tpu (its attention takes the XLA reference
path on the CPU, its grouped matmuls the Pallas kernels in interpret mode)
and its weights carried across with ``load_numpy_state``; the port's plain
versions then run the same model. ``dropless`` is set on every MoE block
of both models after construction, as the JAX layer reads it at forward
time.

Tolerances, float32: logits and losses 1e-5 (values O(1), fp32 sums in
another order); gradients 1e-5 plus 1e-4 relative (sums over the batch and
sequence of such products); trainer losses 1e-5 relative and weights as
tests/test_torch_trainer.py holds them (atol 2e-6 for 99.9% of the
elements, 3 lr for every one). bf16 trainer: losses 2e-3 relative, as the
Llama trainer test (the logits agree to a few bf16 ulps and the loss
averages them). Functionals: LayerNorm and GELU 1e-6 in float32, one bf16
ulp of the largest value in bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.kernels import fused_pallas as fp
from paddle_tpu.models.gpt import GPTConfig as JaxConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.nn import functional as JF
from paddle_tpu.parallel.trainer import SpmdTrainer as JaxTrainer

from paddle_tpu_torch import kernels as K
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, load_numpy_state
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.parallel import SpmdTrainer

VOCAB = 61
SEQ = 24
LR = 1e-3


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(fp, "_INTERPRET", True)
    yield


def _cfg(cls, experts, moe_every=2):
    return cls.tiny(vocab_size=VOCAB, hidden_size=32, layers=2, heads=2,
                    seq=32, num_experts=experts, moe_every=moe_every)


def _dropless(model):
    for block in model.transformer.h:
        if block.is_moe:
            block.mlp.dropless = True


def _models(experts, moe_every=2, bf16=False, seed=3):
    paddle.seed(seed)
    jm = JaxGPT(_cfg(JaxConfig, experts, moe_every))
    pm = GPTForCausalLM(_cfg(GPTConfig, experts, moe_every), device="cpu")
    if bf16:
        jm.bfloat16()
        pm.bfloat16()
    load_numpy_state(pm, {n: np.asarray(t._data)
                          for n, t in jm.named_state().items()})
    _dropless(jm)
    _dropless(pm)
    return jm, pm


def _ids(seed=0, shape=(2, SEQ)):
    return np.random.default_rng(seed).integers(0, VOCAB, shape) \
        .astype(np.int32)


MODELS = [(0, 2), (4, 2), (4, 1)]      # dense; MoE every 2nd block; all MoE


@pytest.mark.parametrize("experts,moe_every", MODELS)
def test_logits_match_jax(experts, moe_every):
    jm, pm = _models(experts, moe_every)
    want = np.asarray(jm(paddle.to_tensor(_ids()))._data)
    with torch.no_grad():
        got = pm(torch.from_numpy(_ids()))
    assert got.shape == (2, SEQ, VOCAB)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("experts,moe_every", MODELS)
def test_loss_and_every_gradient_match_jax(experts, moe_every):
    """compute_loss (shifted cross entropy with ignored labels, plus the
    scaled aux loss of the MoE blocks) and every parameter's gradient
    against the JAX eager loss.backward()."""
    jm, pm = _models(experts, moe_every)
    labels = _ids().copy()
    labels[0, 15:] = -100
    jloss = jm.compute_loss(jm(paddle.to_tensor(_ids())),
                            paddle.to_tensor(labels))
    jloss.backward()
    loss = pm.compute_loss(pm(torch.from_numpy(_ids())),
                           torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss.numpy()),
                               rtol=1e-5)
    if experts:
        jaux, paux = jm.aux_loss(), pm.aux_loss()
        np.testing.assert_allclose(float(paux.detach()),
                                   float(jaux.numpy()), rtol=1e-5)
        assert float(paux.detach()) > 0
    else:
        assert pm.aux_loss() is None
    want = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    got = dict(pm.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), w, atol=1e-5,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("experts,moe_every", MODELS)
def test_attention_mask_matches_jax(experts, moe_every):
    """A padding mask (bool [b, 1, s, s], True = visible: row 1's last 6
    keys hidden) through GPTModel's attention_mask: the logits, the loss
    and every gradient against the JAX GPT given the same mask, at the
    tolerances of the unmasked tests."""
    jm, pm = _models(experts, moe_every)
    mask = np.ones((2, 1, SEQ, SEQ), bool)
    mask[1, :, :, SEQ - 6:] = False
    labels = _ids().copy()
    labels[1, SEQ - 6:] = -100
    jlogits = jm(paddle.to_tensor(_ids()),
                 attention_mask=paddle.to_tensor(mask))
    jloss = jm.compute_loss(jlogits, paddle.to_tensor(labels))
    jloss.backward()
    logits = pm(torch.from_numpy(_ids()),
                attention_mask=torch.from_numpy(mask))
    loss = pm.compute_loss(logits, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(jlogits._data), atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jloss.numpy()),
                               rtol=1e-5)
    want = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    got = dict(pm.named_parameters())
    for name, w in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), w, atol=1e-5,
                                   rtol=1e-4, err_msg=name)


def _loss_fn(m, ids, labels):
    return m.compute_loss(m(ids), labels)


def _train(bf16, steps=3):
    jm, pm = _models(4, 2, bf16)
    ids = _ids(9, (4, SEQ))
    jtr = JaxTrainer(jm, jopt.AdamW(learning_rate=LR,
                                    parameters=jm.parameters(),
                                    weight_decay=0.01), _loss_fn, mesh=None)
    ptr = SpmdTrainer(pm, opt.AdamW(learning_rate=LR,
                                    parameters=pm.parameters(),
                                    weight_decay=0.01), _loss_fn)
    want, got = [], []
    for _ in range(steps):
        want.append(float(jtr.train_step(paddle.to_tensor(ids),
                                         paddle.to_tensor(ids)).numpy()))
        got.append(float(ptr.train_step(torch.from_numpy(ids),
                                        torch.from_numpy(ids))))
    jw = {n: np.asarray(p._data.astype("float32"))
          for n, p in jm.named_parameters()}
    pw = {n: p.detach().float().numpy() for n, p in pm.named_parameters()}
    return want, got, jw, pw


def test_trainer_f32_matches_jax():
    want, got, jw, pw = _train(False)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    close = total = 0
    for name, w in jw.items():
        d = np.abs(pw[name] - w)
        assert np.all(d <= 3 * LR), name
        if name.endswith("qkv_proj.bias"):
            h = w.size // 3
            d = np.concatenate([d[:h], d[2 * h:]])
        close += int((d <= 2e-6).sum())
        total += d.size
    assert close >= 0.999 * total, (close, total)


def test_trainer_bf16_matches_jax():
    want, got, _, _ = _train(True)
    np.testing.assert_allclose(got, want, rtol=2e-3)


def test_training_launches_nothing_on_cpu():
    _, pm = _models(4, 1)
    tr = SpmdTrainer(pm, opt.AdamW(learning_rate=LR,
                                   parameters=pm.parameters()), _loss_fn)
    before = K.kernel_launches()
    ids = torch.from_numpy(_ids())
    tr.train_step(ids, ids)
    assert K.kernel_launches() == before


def test_load_numpy_state_rejects_missing_or_unknown_names():
    jm, pm = _models(4)
    state = {n: np.asarray(t._data) for n, t in jm.named_state().items()}
    missing = dict(state)
    del missing["transformer.h.1.mlp.gate.weight"]
    with pytest.raises(KeyError, match="missing"):
        load_numpy_state(pm, missing)
    unknown = dict(state)
    unknown["transformer.h.1.mlp.w3"] = state["transformer.h.1.mlp.w1"]
    with pytest.raises(KeyError, match="unknown"):
        load_numpy_state(pm, unknown)
    wrong = dict(state)
    wrong["transformer.h.1.mlp.w1"] = state["transformer.h.1.mlp.w2"]
    with pytest.raises(ValueError):
        load_numpy_state(pm, wrong)


@pytest.mark.parametrize("experts", [0, 4])
def test_num_params_and_flops_match_jax(experts):
    jm, pm = _models(experts)
    assert pm.num_params() == jm.num_params()
    assert pm.flops_per_token(SEQ) == jm.flops_per_token(SEQ)


def test_gpt_moe_preset_has_the_published_widths():
    """GPTConfig.gpt_moe(8): GPT-2-small widths with 8 experts in every
    second block; 322,854,960 parameters (built on the meta device)."""
    cfg = GPTConfig.gpt_moe(8)
    assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads,
            cfg.vocab_size, cfg.ffn_size) == (768, 12, 12, 50304, 3072)
    model = GPTForCausalLM(cfg, device="meta", generator=torch.Generator())
    assert model.num_params() == 322_854_960
    assert sum(b.is_moe for b in model.transformer.h) == 6


def test_sequence_longer_than_positions_raises():
    _, pm = _models(0)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        pm(torch.zeros(1, 40, dtype=torch.long))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_functionals_match_jax(dtype):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32) * 2 + 0.5
    w = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    b = (0.1 * rng.standard_normal(16)).astype(np.float32)
    jt = lambda a: paddle.to_tensor(jnp.asarray(a).astype(dtype))
    pt = lambda a: torch.from_numpy(a).to(getattr(torch, dtype))
    pairs = {
        "layer_norm": (JF.layer_norm(jt(x), 16, jt(w), jt(b), 1e-5),
                       F.layer_norm(pt(x), 16, pt(w), pt(b), 1e-5)),
        "gelu": (JF.gelu(jt(x)), F.gelu(pt(x))),
        "gelu_tanh": (JF.gelu(jt(x), approximate=True),
                      F.gelu(pt(x), approximate=True)),
    }
    for name, (want, got) in pairs.items():
        want = np.asarray(want._data.astype(jnp.float32))
        tol = 1e-6 if dtype == "float32" else \
            2.0 ** -7 * float(np.abs(want).max())
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                   rtol=1e-6, err_msg=name)
    wm = rng.standard_normal((16, 8)).astype(np.float32)
    want = np.asarray(JF.linear(paddle.to_tensor(x), paddle.to_tensor(wm),
                                paddle.to_tensor(b[:8]))._data)
    got = F.linear(torch.from_numpy(x), torch.from_numpy(wm),
                   torch.from_numpy(b[:8]))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    ids = np.asarray([[0, 3, 1], [3, 3, 2]], np.int32)
    want = np.asarray(JF.embedding(paddle.to_tensor(ids), paddle.to_tensor(wm),
                                   padding_idx=3)._data)
    got = F.embedding(torch.from_numpy(ids), torch.from_numpy(wm),
                      padding_idx=3)
    np.testing.assert_array_equal(got.numpy(), want)
