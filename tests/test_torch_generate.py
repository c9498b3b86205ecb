"""paddle_tpu_torch's generate() against paddle_tpu's, on the CPU.

A tiny Llama (MHA and GQA) is built in paddle_tpu and its weights carried
across as numpy. The prefill's last logits must match the JAX prefill's to
1e-5 in float32 and the greedy tokens of generate() must equal JAX's, for
a left-padded ragged batch, with eos and with the repetition penalty.
The dense attention over a bf16 cache (read in place by the port, copied
to fp32 by JAX) must match JAX's in bf16 within one bf16 ulp of the
output's largest value.
Sampling: the top-k and top-p keep sets must equal the JAX ``_sample``'s
on fixed logits (the logits it hands to ``jax.random.categorical``, read
by a stand-in), and the port's Gumbel-max draws must pass a chi-square
test against the softmax of the kept logits at a fixed seed. The two
packages draw from different generators, so sampled tokens are compared
only with themselves.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import paddle_tpu as paddle
from paddle_tpu import generation as G
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama

from paddle_tpu_torch import generation as TG
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     load_numpy_state)

VOCAB = 61


@functools.lru_cache(maxsize=None)
def _jax_model(kv_heads):
    paddle.seed(3)
    cfg = JaxConfig.tiny(vocab_size=VOCAB, hidden_size=32, layers=2, heads=4,
                         kv_heads=kv_heads, seq=64)
    cfg.use_flash_attention = False
    return JaxLlama(cfg)


@functools.lru_cache(maxsize=None)
def _port_model(kv_heads):
    model = LlamaForCausalLM(
        LlamaConfig.tiny(vocab_size=VOCAB, hidden_size=32, layers=2, heads=4,
                         kv_heads=kv_heads, seq=64), device="cpu")
    load_numpy_state(model, {n: np.asarray(t._data) for n, t in
                             _jax_model(kv_heads).named_state().items()})
    return model


def _batch(lengths=(9, 4, 7), width=9, seed=0):
    """A LEFT-padded ragged batch: ids [B, width] and its mask."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lengths), width), np.int32)
    mask = np.zeros((len(lengths), width), np.int32)
    for b, n in enumerate(lengths):
        ids[b, width - n:] = rng.integers(1, VOCAB, (n,))
        mask[b, width - n:] = 1
    return ids, mask


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_prefill_matches_jax(kv_heads):
    """The prompt step: the last position's logits within 1e-5, the key
    mask equal, the caches at the real positions within 1e-5."""
    ids, mask = _batch()
    max_new = 5
    jm, pm = _jax_model(kv_heads), _port_model(kv_heads)
    jdec = G._decoder_for(jm)
    wk, wv, wmask, want = G._prefill(jdec, jdec.weights(jm), jnp.asarray(ids),
                                     jnp.asarray(mask), max_new)
    dec = TG._decoder_for(pm)
    # the port's caches are heads-major [L, B, kvh, M, hd]
    kcs = torch.full((2, 3, kv_heads, ids.shape[1] + max_new, 8), 7.0)
    vcs = torch.full_like(kcs, 7.0)
    key_mask, got = TG._prefill(dec, dec.weights(pm),
                                torch.from_numpy(ids).long(),
                                torch.from_numpy(mask).long(), max_new, kcs,
                                vcs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(key_mask.numpy(), np.asarray(wmask))
    real = np.asarray(wmask)[None, :, :, None, None]
    for port, ref in ((kcs, wk), (vcs, wv)):
        np.testing.assert_allclose(port.transpose(2, 3).numpy() * real,
                                   np.asarray(ref) * real, atol=1e-5)


def _eos_from_greedy(kv_heads, ids, mask, kw):
    """A token the JAX run without eos emits at step 2 of row 0, used as
    eos so that the eos path really fires."""
    toks, _ = G.generate(_jax_model(kv_heads), ids, attention_mask=mask,
                         **kw)
    return int(np.asarray(toks._data)[0, 2])


GREEDY_CASES = {
    "full": dict(lengths=(6, 6), width=6),
    "left_padded": dict(lengths=(9, 4, 7, 1), width=9),
    "eos": dict(lengths=(9, 4, 7), width=9, eos=True),
    "repetition_penalty": dict(lengths=(9, 4, 7), width=9,
                               repetition_penalty=1.3),
    "eos_and_penalty": dict(lengths=(5, 8), width=8, eos=True,
                            repetition_penalty=0.8),
}


@pytest.mark.parametrize("case", list(GREEDY_CASES))
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_generate_greedy_matches_jax(kv_heads, case):
    spec = dict(GREEDY_CASES[case])
    ids, mask = _batch(spec.pop("lengths"), spec.pop("width"))
    kw = dict(max_new_tokens=8, **spec)
    if kw.pop("eos", False):
        kw["eos_token_id"] = _eos_from_greedy(kv_heads, ids, mask, kw)
    want, wfin = G.generate(_jax_model(kv_heads), ids, attention_mask=mask,
                            **kw)
    got, fin = TG.generate(_port_model(kv_heads), ids, attention_mask=mask,
                           device="cpu", **kw)
    assert got.dtype == torch.int32 and got.shape == (len(ids), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want._data))
    np.testing.assert_array_equal(fin.numpy(), np.asarray(wfin._data))
    if "eos_token_id" in kw:
        assert fin.any(), "the case no longer reaches eos"
        eos = kw["eos_token_id"]
        for row, done in zip(got.numpy(), fin.numpy()):
            if done:               # rows that hit eos keep emitting it
                first = list(row).index(eos)
                assert (row[first:] == eos).all()


@pytest.mark.parametrize("rep, s", [(1, 1), (4, 1), (2, 5)],
                         ids=["mha-decode", "gqa-decode", "gqa-prefill"])
def test_dense_attention_bf16_matches_jax(rep, s):
    """The port's _attend_gqa on a bf16 heads-major cache against JAX's
    on the same bf16 values in its [B, T, G, D] layout: within one bf16
    ulp (2^-7, relative) of the output's largest value, and each element
    within one bf16 ulp of itself (the two fp32 results round to
    neighbours at worst) plus 2^-16 of max|v| (P's head-and-tail error,
    at most 2^-18 of P, with room for fp32 sums in another order). P
    rounded once to bf16 before P.V misses the second bound 11-17 times
    over on these inputs."""
    rng = np.random.default_rng(7 + rep + s)
    b, g, t, d = 3, 2, 40, 64
    q = rng.standard_normal((b, s, g * rep, d)).astype(np.float32)
    k = rng.standard_normal((b, g, t, d)).astype(np.float32)
    v = rng.standard_normal((b, g, t, d)).astype(np.float32)
    mask = rng.random((b, 1, s, t)) > 0.3
    mask[..., 0] = True
    want = G._attend_gqa(*(jnp.asarray(x, jnp.bfloat16) for x in
                           (q, k.transpose(0, 2, 1, 3),
                            v.transpose(0, 2, 1, 3))),
                         jnp.asarray(mask), rep)
    want = np.asarray(want.astype(jnp.float32))
    got = TG._attend_gqa(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
                         torch.from_numpy(mask), rep)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    diff = np.abs(got.float().numpy() - want)
    assert float(diff.max()) <= 2.0 ** -7 * float(np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    v_max = float(torch.from_numpy(v).bfloat16().abs().max())
    assert float((diff / (ulp + 2.0 ** -16 * v_max)).max()) <= 1.0


def test_model_generate_method_takes_the_model_device():
    ids, mask = _batch()
    model = _port_model(2)
    a, fa = model.generate(ids, attention_mask=mask, max_new_tokens=4)
    b, fb = TG.generate(model, ids, attention_mask=mask, max_new_tokens=4,
                        device="cpu")
    assert torch.equal(a, b) and torch.equal(fa, fb)


def test_generate_rejects_right_padding():
    ids, mask = _batch()
    right = mask[:, ::-1].copy()
    with pytest.raises(ValueError, match="LEFT-padded"):
        G.generate(_jax_model(2), ids, attention_mask=right)
    with pytest.raises(ValueError, match="LEFT-padded"):
        TG.generate(_port_model(2), ids, attention_mask=right, device="cpu")


@pytest.mark.parametrize("kw,match", [
    # beam search is ported: sampling under beams raises, as in JAX
    (dict(num_beams=2, do_sample=True), "beam search with samp"),
    # quantized decoding is ported: an algo the JAX package lacks raises
    (dict(quant="weight_only_int2"), "supported algos")],
    ids=["num_beams", "quant"])
def test_generate_refuses_what_is_not_ported(kw, match):
    ids, _ = _batch()
    with pytest.raises(NotImplementedError, match=match):
        TG.generate(_port_model(2), ids, device="cpu", **kw)


# -- sampling ------------------------------------------------------------------

def _fixed_logits(b=4, seed=11):
    """Logits with well-separated values, so no top-p boundary sits within
    float rounding of a cumulative mass."""
    rng = np.random.default_rng(seed)
    return (rng.permutation(np.arange(b * VOCAB)).reshape(b, VOCAB)
            * 0.05 / VOCAB + rng.standard_normal((b, VOCAB)) * 1e-3) \
        .astype(np.float32) * 40


SAMPLE_CASES = {
    "top_k": dict(temperature=1.0, top_k=5, top_p=1.0),
    "top_p": dict(temperature=0.7, top_k=0, top_p=0.6),
    "top_k_top_p": dict(temperature=1.3, top_k=12, top_p=0.5),
    "temperature_only": dict(temperature=0.5, top_k=0, top_p=1.0),
}


def _jax_kept_logits(logits, spec, monkeypatch):
    """The logits the JAX ``_sample`` hands to jax.random.categorical."""
    seen = []

    def categorical(key, lg, axis=-1):
        seen.append(np.asarray(lg))
        return jnp.argmax(lg, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", categorical)
    G._sample(jnp.asarray(logits), jax.random.PRNGKey(0), True,
              spec["temperature"], spec["top_k"], spec["top_p"])
    return seen[0]


@pytest.mark.parametrize("case", list(SAMPLE_CASES))
def test_sample_keep_sets_match_jax(case, monkeypatch):
    spec = SAMPLE_CASES[case]
    logits = _fixed_logits()
    want = _jax_kept_logits(logits, spec, monkeypatch)
    got = TG._filter_logits(torch.from_numpy(logits), spec["temperature"],
                            spec["top_k"], spec["top_p"]).numpy()
    kept = want > TG.NEG_INF / 2
    np.testing.assert_array_equal(got > TG.NEG_INF / 2, kept)
    assert kept.sum(axis=1).min() > 1
    filtered = spec["top_k"] > 0 or spec["top_p"] < 1.0
    assert (kept.sum(axis=1).max() < VOCAB) == filtered
    np.testing.assert_allclose(got[kept], want[kept], rtol=1e-6)


@pytest.mark.parametrize("case", ["top_k", "top_k_top_p", "temperature_only"])
def test_sample_draws_follow_the_kept_softmax(case):
    """20000 Gumbel-max draws from one row of logits at a fixed seed: the
    counts of the kept tokens pass a chi-square test (p > 1e-3) against
    their softmax, and no dropped token is ever drawn."""
    spec = SAMPLE_CASES[case]
    n = 20000
    row = torch.from_numpy(_fixed_logits(1))
    gen = torch.Generator().manual_seed(1234)
    noise = torch.rand((n, VOCAB), generator=gen)
    toks = TG._sample(row.expand(n, VOCAB), noise, True, spec["temperature"],
                      spec["top_k"], spec["top_p"])
    kept_lg = TG._filter_logits(row, spec["temperature"], spec["top_k"],
                                spec["top_p"])[0]
    kept = kept_lg > TG.NEG_INF / 2
    counts = torch.bincount(toks.long(), minlength=VOCAB).double()
    assert counts[~kept].sum() == 0
    probs = torch.softmax(kept_lg[kept].double(), dim=0)
    expect = probs * n
    big = expect >= 5                     # chi-square's usual validity rule
    obs = counts[kept][big]
    exp = expect[big] * obs.sum() / expect[big].sum()
    p = stats.chisquare(obs.numpy(), exp.numpy()).pvalue
    assert p > 1e-3, p


def test_sampled_generate_repeats_with_its_seed():
    ids, mask = _batch()
    kw = dict(attention_mask=mask, max_new_tokens=6, do_sample=True,
              temperature=0.8, top_k=20, top_p=0.9, device="cpu")
    model = _port_model(2)
    a, _ = TG.generate(model, ids, seed=5, **kw)
    b, _ = TG.generate(model, ids, seed=5, **kw)
    c, _ = TG.generate(model, ids, seed=6, **kw)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < VOCAB


def test_decode_loop_draws_new_noise_every_step():
    ids, mask = _batch()
    model = _port_model(2)
    dec = TG._decoder_for(model)
    loop = TG._DecodeLoop(dec, dec.weights(model), 3, ids.shape[1], 4, True,
                          False, 10, 1.0, False)
    loop.start(torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
               0.8, 0, 1.0, seed=3)
    draws = []
    for _ in range(4):
        loop.step()
        draws.append(loop.noise.clone())
    assert all(not torch.equal(draws[i], draws[i + 1]) for i in range(3))
