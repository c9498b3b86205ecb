"""paddle_tpu_torch serving GPT and GPT-MoE against paddle_tpu, on the CPU.

Tiny float32 GPT models (dense; MoE top-2 in every block, tied and untied
head) are built in paddle_tpu and carried across as numpy. The port's
engine must return the JAX engine's greedy tokens, which equal JAX
generate()'s, including chunked prefill (a budget below the prompts) and
prefix reuse (a repeated prompt); one ragged step's logits within 1e-4 of
the JAX step's; generate() the JAX greedy tokens, and sampled runs with a
seed repeat themselves. MoE routing is compared in float32: with random
weights no two gate probabilities of a row tie exactly, so
``torch.topk`` and ``jax.lax.top_k`` pick the same experts whatever order
each gives ties. MoE forms the decoder cannot reproduce raise, as in JAX.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import generation as G
from paddle_tpu.models.gpt import GPTConfig as JaxConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.serving import EngineConfig as JaxEngineConfig
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import engine as jax_engine

from paddle_tpu_torch import generation as TG
from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.incubate.distributed.models.moe.gate import NaiveGate
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, load_numpy_state
from paddle_tpu_torch.serving import EngineConfig, ServingEngine
from paddle_tpu_torch.serving import engine as port_engine

VOCAB = 53


def _kw(experts, tied, gate="naive"):
    return dict(vocab_size=VOCAB, hidden_size=32, layers=2, heads=4, seq=64,
                num_experts=experts, moe_every=1, moe_top_k=2,
                moe_gate=gate, tie_word_embeddings=tied)


def _pair(experts, tied, gate="naive", seed=13):
    paddle.seed(seed)
    jm = JaxGPT(JaxConfig.tiny(**_kw(experts, tied, gate)))
    pm = GPTForCausalLM(GPTConfig.tiny(**_kw(experts, tied, gate)),
                        device="cpu")
    load_numpy_state(pm, {n: np.asarray(t._data)
                          for n, t in jm.named_state().items()})
    return jm, pm


_cached_pair = functools.lru_cache(maxsize=None)(_pair)

MODELS = {"gpt": (0, True), "gpt_untied": (0, False),
          "moe_tied": (4, True), "moe_untied": (4, False)}


def _prompts(n, lens=(9, 11, 10, 5, 7, 3), seed=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, (lens[i % len(lens)],)).tolist()
            for i in range(n)]


def _jax_generate(jm, prompts, max_new):
    """JAX generate() one prompt at a time: the engine's oracle."""
    out = []
    for p in prompts:
        toks, _ = G.generate(jm, paddle.to_tensor(np.asarray([p], np.int32)),
                             max_new_tokens=max_new)
        out.append(np.asarray(toks._data)[0].tolist())
    return out


@pytest.mark.parametrize("model", list(MODELS))
def test_engine_matches_jax_engine_and_generate(model):
    jm, pm = _cached_pair(*MODELS[model])
    prompts = _prompts(4)
    kw = dict(max_seqs=3, token_budget=16, block_size=4)
    want = JaxEngine(jm, JaxEngineConfig(**kw)).generate_batch(
        prompts, max_new_tokens=5)
    assert want == _jax_generate(jm, prompts, 5)
    eng = ServingEngine(pm, EngineConfig(**kw), device="cpu")
    assert eng.generate_batch(prompts, max_new_tokens=5) == want
    assert eng.pool.used_blocks() == 0


@pytest.mark.parametrize("model", ["gpt", "moe_tied"])
def test_chunked_prefill_and_prefix_reuse_match_jax(model):
    """A budget of 6 cuts every prompt into chunks; the repeated prompt
    hits the prefix cache for its full pages."""
    jm, pm = _cached_pair(*MODELS[model])
    base = _prompts(1, lens=(13,), seed=8)[0]
    prompts = [base, _prompts(1, lens=(11,), seed=9)[0], base + [5, 7]]
    kw = dict(max_seqs=2, token_budget=6, block_size=4)
    jeng = JaxEngine(jm, JaxEngineConfig(**kw))
    want = [jeng.generate_batch([p], max_new_tokens=4)[0] for p in prompts]
    eng = ServingEngine(pm, EngineConfig(**kw), device="cpu")
    got = [eng.generate_batch([p], max_new_tokens=4)[0] for p in prompts]
    assert got == want
    assert eng.pool.stats["prefix_hits"] == jeng.pool.stats["prefix_hits"] \
        > 0


def _with_spare_page(pools):
    return np.concatenate([pools, np.zeros_like(pools[:, :1])], axis=1)


@pytest.mark.parametrize("model", list(MODELS))
def test_ragged_step_logits_match_jax(model):
    """One mixed step (a prefill chunk, two decode tokens, padding rows)
    over random pools: logits within 1e-4, the pools' real pages within
    1e-5."""
    jm, pm = _cached_pair(*MODELS[model])
    rng = np.random.default_rng(5)
    layers, p, heads, bs, hd = 2, 10, 4, 4, 8
    kp = rng.standard_normal((layers, p, heads, bs, hd)).astype(np.float32)
    vp = rng.standard_normal((layers, p, heads, bs, hd)).astype(np.float32)
    tables = np.full((3, 4), -1, np.int32)
    tables[0, :2] = [3, 7]
    tables[1, :3] = [0, 5, 9]
    tables[2, :1] = [2]
    slots = np.asarray([0, 0, 0, 0, 0, 1, 2, 0, 0], np.int32)
    pos = np.asarray([2, 3, 4, 5, 6, 10, 1, 0, 0], np.int32)
    valid = np.asarray([1] * 7 + [0, 0], bool)
    tokens = rng.integers(1, VOCAB, (9,)).astype(np.int32)
    jdec = G._decoder_for(jm)
    want, wk, _ = jax_engine._engine_step_impl(
        jdec, None, jdec.weights(jm), jnp.asarray(tokens), jnp.asarray(slots),
        jnp.asarray(pos), jnp.asarray(valid), jnp.asarray(tables),
        jnp.asarray(kp), jnp.asarray(vp))
    dec = TG._decoder_for(pm)
    kpt = torch.from_numpy(_with_spare_page(kp))
    vpt = torch.from_numpy(_with_spare_page(vp))
    got = port_engine._engine_step_impl(
        dec, dec.weights(pm), torch.from_numpy(tokens).long(),
        torch.from_numpy(slots), torch.from_numpy(pos),
        torch.from_numpy(valid), torch.from_numpy(tables), kpt, vpt)
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               atol=1e-4)
    np.testing.assert_allclose(kpt[:, :p].numpy(), np.asarray(wk), atol=1e-5)


def _batch(lengths=(9, 4, 7), width=9, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lengths), width), np.int32)
    mask = np.zeros((len(lengths), width), np.int32)
    for b, n in enumerate(lengths):
        ids[b, width - n:] = rng.integers(1, VOCAB, (n,))
        mask[b, width - n:] = 1
    return ids, mask


@pytest.mark.parametrize("model", list(MODELS))
def test_generate_matches_jax(model):
    """Greedy generate() on a left-padded batch: JAX's tokens; the
    prefill's last logits within 1e-4 (GPTForCausalLM.generate is the same
    call on the model's device)."""
    jm, pm = _cached_pair(*MODELS[model])
    ids, mask = _batch()
    want, _ = G.generate(jm, paddle.to_tensor(ids),
                         attention_mask=paddle.to_tensor(mask),
                         max_new_tokens=6)
    got, fin = pm.generate(ids, attention_mask=mask, max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want._data))
    assert fin.shape == (3,)
    jdec, dec = G._decoder_for(jm), TG._decoder_for(pm)
    _, _, _, jlast = G._prefill(jdec, jdec.weights(jm), jnp.asarray(ids),
                                jnp.asarray(mask), 4)
    kcs = torch.zeros(2, 3, 4, ids.shape[1] + 4, 8)       # [L, B, kvh, M, hd]
    _, last = TG._prefill(dec, dec.weights(pm), torch.from_numpy(ids).long(),
                          torch.from_numpy(mask).long(), 4, kcs,
                          torch.zeros_like(kcs))
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=1e-4)


@pytest.mark.parametrize("model", ["gpt", "moe_untied"])
def test_sampled_generate_repeats_with_its_seed(model):
    _, pm = _cached_pair(*MODELS[model])
    ids, mask = _batch()
    kw = dict(attention_mask=mask, max_new_tokens=8, do_sample=True,
              temperature=0.8, top_k=20, top_p=0.9, eos_token_id=3)
    a, fa = pm.generate(ids, seed=11, **kw)
    b, fb = pm.generate(ids, seed=11, **kw)
    assert a.shape == (3, 8) and a.dtype == torch.int32
    assert torch.equal(a, b) and torch.equal(fa, fb)
    assert 0 <= int(a.min()) and int(a.max()) < VOCAB
    c, _ = pm.generate(ids, seed=12, **kw)
    assert not torch.equal(a, c)


def test_moe_decode_runs_every_expert_without_kernels():
    """The MoE decode step launches no kernel on the CPU, and its
    combine weights select exactly the top-2 experts of each row."""
    _, pm = _cached_pair(4, True)
    dec = TG._decoder_for(pm)
    assert set(dec.moe_layers) == {0, 1}
    before = K.kernel_launches()
    x2 = torch.randn(1, 5, 32)
    w = dec.weights(pm)
    y = dec._moe_mlp(w, 0, x2)
    assert K.kernel_launches() == before
    # against the MoE layer's own forward (dropless, the gmm plain path),
    # which routes and combines the same way
    blk = pm.transformer.h[0].mlp
    blk.dropless = True
    with torch.no_grad():
        ref = blk(x2)
    torch.testing.assert_close(y, ref, atol=1e-5, rtol=1e-5)


def test_unsupported_moe_forms_raise_as_in_jax():
    """A GShard gate drops tokens at eval capacity: refused; with
    ``_capacity_override`` at least the tokens of a forward it decodes
    (and matches JAX), below them it raises (generate() and the engine);
    a gate overriding forward() is refused; a changed block rebuilds the
    decoder."""
    jm, pm = _pair(4, True, gate="gshard", seed=14)
    ids, mask = _batch()
    with pytest.raises(NotImplementedError, match="capacity"):
        pm.generate(ids, attention_mask=mask, max_new_tokens=4)
    with pytest.raises(NotImplementedError, match="capacity"):
        ServingEngine(pm, EngineConfig(max_seqs=2, token_budget=16),
                      device="cpu")
    for m in (jm, pm):
        for blk in m.transformer.h:
            blk.mlp._capacity_override = 64
    want, _ = G.generate(jm, paddle.to_tensor(ids),
                         attention_mask=paddle.to_tensor(mask),
                         max_new_tokens=4)
    got, _ = pm.generate(ids, attention_mask=mask, max_new_tokens=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want._data))
    ServingEngine(pm, EngineConfig(max_seqs=2, token_budget=64),
                  device="cpu")
    with pytest.raises(ValueError, match="token_budget"):
        ServingEngine(pm, EngineConfig(max_seqs=2, token_budget=65),
                      device="cpu")
    for blk in pm.transformer.h:
        blk.mlp._capacity_override = 4
    with pytest.raises(ValueError, match="tokens-per-forward"):
        pm.generate(ids, attention_mask=mask, max_new_tokens=4)

    class Custom(NaiveGate):
        def forward(self, x):
            return super().forward(x) * 2

    _, pm2 = _pair(4, True)
    dec = TG._decoder_for(pm2)
    old = pm2.transformer.h[0].mlp.gate
    pm2.transformer.h[0].mlp.gate = Custom(32, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="overrides forward"):
        TG._decoder_for(pm2)
    pm2.transformer.h[0].mlp.gate = old
    old.top_k = 1
    assert TG._decoder_for(pm2) is not dec
    assert TG._decoder_for(pm2).moe_layers[0]["top_k"] == 1


def test_untying_the_head_rebuilds_the_decoder():
    _, pm = _pair(0, True, seed=15)
    ids, mask = _batch()
    pm.generate(ids, attention_mask=mask, max_new_tokens=2)
    tied = TG._decoder_for(pm)
    from paddle_tpu_torch.models.gpt import _Linear
    pm.lm_head = _Linear(32, VOCAB, "cpu", torch.float32,
                         torch.Generator().manual_seed(1), bias=False)
    dec = TG._decoder_for(pm)
    assert dec is not tied and not dec.tied
    got, _ = pm.generate(ids, attention_mask=mask, max_new_tokens=3)
    with torch.no_grad():
        logits = pm(torch.from_numpy(ids[:1]).long())
    assert int(got[0, 0]) == int(logits[0, -1].argmax())


@pytest.mark.parametrize("model", ["gpt_untied", "moe_tied"])
def test_pdparams_of_gpt_carry_across(model, tmp_path):
    """A JAX GPT / GPT-MoE state saved with ``paddle.save`` loads through
    ``framework.load`` and ``load_numpy_state`` into the port's model,
    every parameter equal, and serves JAX's tokens."""
    from paddle_tpu_torch import framework
    jm, _ = _cached_pair(*MODELS[model])
    path = str(tmp_path / "gpt.pdparams")
    paddle.save(jm.state_dict(), path)
    state = framework.load(path, return_numpy=True)
    pm = GPTForCausalLM(GPTConfig.tiny(**_kw(*MODELS[model])), device="cpu")
    load_numpy_state(pm, state)
    want = {n: np.asarray(t._data) for n, t in jm.named_state().items()}
    for name, p in pm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name])
    ids, mask = _batch()
    jt, _ = G.generate(jm, paddle.to_tensor(ids),
                       attention_mask=paddle.to_tensor(mask),
                       max_new_tokens=4)
    got, _ = pm.generate(ids, attention_mask=mask, max_new_tokens=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jt._data))
