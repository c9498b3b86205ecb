"""paddle_tpu_torch's beam search in generate() against paddle_tpu's, on
the CPU.

Tiny float32 Llama models (MHA and GQA) and a tiny GPT are built in
paddle_tpu and their weights carried across as numpy. For the same
left-padded prompts, ``generate(num_beams=K)`` must give the JAX
``_beam_impl``'s tokens and finished flags exactly: with and without
eos (the eos token is one the free beams emit, so it really finishes
beams), and with a length penalty on either side of 1. The JAX
``lax.top_k`` puts the lower index first among equal candidates; the
port keeps that order with a stable sort, so ties (the NEG_INF candidates
of finished beams) break alike. Also, as the JAX package's own tests
hold it: ``num_beams=1`` is greedy decoding; a beam's sequence log-prob
(recomputed by the full forward in float64) is never below greedy's;
sampling and the repetition penalty are refused under beams; and beams
thread weight-only int8 weights (the JAX tokens again). A bf16 model's
beams run and repeat themselves.
"""
import functools

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import generation as G
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama

from paddle_tpu_torch import generation as TG
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM, load_numpy_state)

VOCAB = 61


@functools.lru_cache(maxsize=None)
def _pair(kind):
    """(JAX model, port model) with the same float32 weights."""
    paddle.seed(7)
    if kind == "gpt":
        kw = dict(vocab_size=VOCAB, hidden_size=32, layers=2, heads=4,
                  seq=64, num_experts=0)
        jm = JaxGPT(JaxGPTConfig.tiny(**kw))
        pm = GPTForCausalLM(GPTConfig.tiny(**kw), device="cpu")
    else:
        kw = dict(vocab_size=VOCAB, hidden_size=32, layers=2, heads=4,
                  kv_heads={"mha": 4, "gqa": 2}[kind], seq=64)
        cfg = JaxConfig.tiny(**kw)
        cfg.use_flash_attention = False
        jm = JaxLlama(cfg)
        pm = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu")
    load_numpy_state(pm, {n: np.asarray(t._data)
                          for n, t in jm.named_state().items()})
    return jm, pm


def _batch(lengths=(9, 4, 7), width=9, seed=0):
    """LEFT-padded prompts: ids [B, width] and the mask."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lengths), width), np.int32)
    mask = np.zeros((len(lengths), width), np.int32)
    for b, n in enumerate(lengths):
        ids[b, width - n:] = rng.integers(1, VOCAB, (n,))
        mask[b, width - n:] = 1
    return ids, mask


def _jax(jm, ids, mask, **kw):
    toks, fin = G.generate(jm, ids, attention_mask=mask, **kw)
    return np.asarray(toks._data), np.asarray(fin._data)


CASES = {
    "full": dict(lengths=(6, 6), width=6, num_beams=3),
    "left_padded": dict(lengths=(9, 4, 7), width=9, num_beams=4),
    "eos": dict(lengths=(9, 4, 7), width=9, num_beams=3, eos=True),
    "eos_short_penalty": dict(lengths=(5, 8), width=8, num_beams=4, eos=True,
                              length_penalty=0.5),
    "eos_long_penalty": dict(lengths=(5, 8, 2), width=8, num_beams=2,
                             eos=True, length_penalty=2.0),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kind", ["mha", "gqa", "gpt"])
def test_beams_match_jax(kind, case):
    spec = dict(CASES[case])
    ids, mask = _batch(spec.pop("lengths"), spec.pop("width"))
    kw = dict(max_new_tokens=7, **spec)
    jm, pm = _pair(kind)
    if kw.pop("eos", False):
        # the first token of row 0's free best beam: eos then finishes
        # that beam at its first step
        free, _ = _jax(jm, ids, mask, **kw)
        kw["eos_token_id"] = int(free[0, 0])
    want, wfin = _jax(jm, ids, mask, **kw)
    got, fin = TG.generate(pm, ids, attention_mask=mask, device="cpu", **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(fin.numpy(), wfin)
    if "eos_token_id" in kw:
        for row, done in zip(got.numpy(), fin.numpy()):
            hit = row == kw["eos_token_id"]
            if done:             # eos persists on a finished beam
                assert hit.any() and hit[int(np.argmax(hit)):].all()


def test_model_generate_passes_beams_along():
    jm, pm = _pair("gqa")
    ids, mask = _batch()
    want, _ = _jax(jm, ids, mask, max_new_tokens=5, num_beams=3,
                   length_penalty=0.7)
    got, _ = pm.generate(ids, attention_mask=mask, max_new_tokens=5,
                         num_beams=3, length_penalty=0.7)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["mha", "gpt"])
def test_one_beam_is_greedy(kind):
    _, pm = _pair(kind)
    ids, mask = _batch()
    a, fa = TG.generate(pm, ids, attention_mask=mask, max_new_tokens=6,
                        device="cpu")
    b, fb = TG.generate(pm, ids, attention_mask=mask, max_new_tokens=6,
                        num_beams=1, device="cpu")
    assert torch.equal(a, b) and torch.equal(fa, fb)


def _seq_logprob(model, ids, cont):
    """Log-prob of the continuation ``cont`` after ``ids`` [1, S] by the
    full forward, in float64."""
    cur = torch.from_numpy(np.concatenate([ids, cont[None]], axis=1)).long()
    with torch.no_grad():
        logits = model(cur)[0].double()
    lp = torch.log_softmax(logits, dim=-1)
    s = ids.shape[1]
    return float(sum(lp[s - 1 + t, int(tok)] for t, tok in enumerate(cont)))


@pytest.mark.parametrize("kind", ["gqa", "gpt"])
@pytest.mark.parametrize("seed", [41, 42])
def test_beam_never_worse_than_greedy(kind, seed):
    _, pm = _pair(kind)
    ids = np.random.default_rng(seed).integers(0, VOCAB, (1, 6))
    greedy, _ = TG.generate(pm, ids, max_new_tokens=5, device="cpu")
    beam, _ = TG.generate(pm, ids, max_new_tokens=5, num_beams=4,
                          device="cpu")
    lp_g = _seq_logprob(pm, ids, greedy.numpy()[0])
    lp_b = _seq_logprob(pm, ids, beam.numpy()[0])
    assert lp_b >= lp_g - 1e-6, (lp_b, lp_g)


@pytest.mark.parametrize("kw,match", [
    (dict(do_sample=True), "beam search with samp"),
    (dict(repetition_penalty=1.3), "repetition_penalty under beam")],
    ids=["sampling", "repetition_penalty"])
def test_beams_refuse_what_jax_refuses(kw, match):
    jm, pm = _pair("mha")
    ids, _ = _batch()
    with pytest.raises(NotImplementedError, match=match):
        G.generate(jm, ids, max_new_tokens=2, num_beams=2, **kw)
    with pytest.raises(NotImplementedError, match=match):
        TG.generate(pm, ids, max_new_tokens=2, num_beams=2, device="cpu",
                    **kw)


@pytest.mark.parametrize("kind", ["gqa", "gpt"])
def test_int8_beams_match_jax(kind):
    jm, pm = _pair(kind)
    ids, mask = _batch((6, 3), 6, seed=2)
    kw = dict(max_new_tokens=5, num_beams=2, quant="weight_only_int8")
    want, wfin = _jax(jm, ids, mask, **kw)
    got, fin = TG.generate(pm, ids, attention_mask=mask, device="cpu", **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(fin.numpy(), wfin)


def test_bf16_beams_run_and_repeat():
    _, pm = _pair("gqa")
    model = LlamaForCausalLM(pm.config, device="cpu", dtype=torch.bfloat16)
    model.load_state_dict({n: p.bfloat16() for n, p in
                           pm.state_dict().items()})
    ids, mask = _batch()
    kw = dict(attention_mask=mask, max_new_tokens=6, num_beams=3,
              eos_token_id=5, device="cpu")
    a, fa = TG.generate(model, ids, **kw)
    b, fb = TG.generate(model, ids, **kw)
    assert torch.equal(a, b) and torch.equal(fa, fb)
    assert a.shape == (3, 6) and int(a.min()) >= 0 and int(a.max()) < VOCAB
