"""paddle_tpu_torch's speculative decoding against paddle_tpu's, on the CPU.

Tiny float32 Llama (MHA and GQA) and GPT models carried across as numpy.
With speculation the engine must return exactly the tokens of plain
greedy decoding (the JAX package's invariant) and of the JAX engine with
the same ``spec_method``, and the n-gram drafter's proposed and accepted
counts and the rollback pages must equal JAX's. The units (verification,
the n-gram lookup, the draft-model drafter's batching) and the page
accounting of a rollback (``KVBlockPool.truncate``, copy-on-write of a
shared or prefix-registered boundary page) are held against the JAX
functions or to their stated contract.
"""
import functools
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import generation as G
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving import EngineConfig as JaxEngineConfig
from paddle_tpu.serving import KVBlockPool as JaxPool
from paddle_tpu.serving import NgramDrafter as JaxNgram
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import verify_greedy as jax_verify

from paddle_tpu_torch import generation as TG
from paddle_tpu_torch import inference
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM, load_numpy_state)
from paddle_tpu_torch.serving import (EngineConfig, KVBlockPool,
                                      PoolExhausted, ServingEngine)
from paddle_tpu_torch.serving.scheduler import RUNNING, Request, Scheduler
from paddle_tpu_torch.serving.speculative import (DraftModelDrafter, Drafter,
                                                  NgramDrafter, make_drafter,
                                                  verify_greedy)

VOCAB = 61


@functools.lru_cache(maxsize=None)
def _llama_pair(kv_heads, seed=3):
    paddle.seed(seed)
    cfg = JaxConfig.tiny(vocab_size=VOCAB, hidden_size=32, layers=2, heads=4,
                         kv_heads=kv_heads, seq=64)
    cfg.use_flash_attention = False
    jm = JaxLlama(cfg)
    pm = LlamaForCausalLM(LlamaConfig.tiny(
        vocab_size=VOCAB, hidden_size=32, layers=2, heads=4,
        kv_heads=kv_heads, seq=64), device="cpu")
    load_numpy_state(pm, {n: np.asarray(t._data)
                          for n, t in jm.named_state().items()})
    return jm, pm


@functools.lru_cache(maxsize=None)
def _gpt_pair():
    paddle.seed(5)
    kw = dict(vocab_size=VOCAB, hidden_size=32, layers=2, heads=4, seq=64)
    jm = JaxGPT(JaxGPTConfig.tiny(**kw))
    pm = GPTForCausalLM(GPTConfig.tiny(**kw), device="cpu")
    load_numpy_state(pm, {n: np.asarray(t._data)
                          for n, t in jm.named_state().items()})
    return jm, pm


MODELS = {"llama_mha": lambda: _llama_pair(4),
          "llama_gqa": lambda: _llama_pair(2),
          "gpt": _gpt_pair}


def _prompts(n, lens=(9, 11, 10, 5, 7, 3), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, (lens[i % len(lens)],)).tolist()
            for i in range(n)]


def _repetitive(seed=7):
    """Prompts that repeat a 5-token pattern: the n-gram drafter's home."""
    pattern = np.random.default_rng(seed).integers(1, VOCAB, (5,)).tolist()
    return [(pattern * 4)[:18], (pattern * 4)[:15]] + _prompts(2, seed=seed)


class _Req:
    def __init__(self, seq):
        self.seq = seq


# -- units --------------------------------------------------------------------------

@pytest.mark.parametrize("drafts, targets", [
    ([7, 8, 9], [7, 8, 9, 4]), ([7, 8, 9], [7, 5, 9, 4]), ([7, 8], [1, 2, 3]),
    ([], [6])])
def test_verify_greedy_matches_jax(drafts, targets):
    assert verify_greedy(drafts, targets) == jax_verify(drafts, targets)


def test_verify_greedy_contract():
    assert verify_greedy([7, 8, 9], [7, 8, 9, 4]) == (3, [7, 8, 9, 4])
    assert verify_greedy([7, 8, 9], [7, 5, 9, 4]) == (1, [7, 5])
    assert verify_greedy([7, 8], [1, 2, 3]) == (0, [1])
    with pytest.raises(ValueError, match="len\\(drafts\\)\\+1"):
        verify_greedy([7], [1])


@pytest.mark.parametrize("seq, k", [
    ([9, 2, 3, 4, 5, 2, 3], 2), ([1, 2, 1, 2, 1, 2], 4),
    ([5, 7, 1, 5, 8, 2, 5], 1), ([1, 2, 3, 4, 5], 3), ([1, 2], 0),
    ([4, 5, 6] + [9] * 10 + [4, 5], 2)])
@pytest.mark.parametrize("kw", [dict(max_match=3, min_match=1),
                                dict(max_match=3, min_match=2, lookback=8),
                                dict()])
def test_ngram_lookup_matches_jax(seq, k, kw):
    assert NgramDrafter(**kw).propose(_Req(seq), k) == \
        JaxNgram(**kw).propose(_Req(seq), k)


def test_ngram_drafter_contract():
    d = NgramDrafter(max_match=3, min_match=1)
    assert d.propose(_Req([9, 2, 3, 4, 5, 2, 3]), 2) == [4, 5]
    assert d.propose(_Req([5, 7, 1, 5, 8, 2, 5]), 1) == [8]   # most recent
    assert d.propose(_Req([1, 2, 3, 4, 5]), 3) == []
    d8 = NgramDrafter(max_match=3, min_match=2, lookback=8)
    far = [4, 5, 6] + [9] * 10 + [4, 5]
    assert d8.propose(_Req(far), 2) == []            # beyond the lookback
    assert d.propose_batch([_Req([9, 2, 3, 4, 2, 3]), _Req([1, 2, 3])],
                           [2, 2]) == [[4, 2], []]
    with pytest.raises(ValueError, match="min_match"):
        NgramDrafter(max_match=2, min_match=3)
    with pytest.raises(ValueError, match="lookback"):
        NgramDrafter(lookback=1)


def test_make_drafter():
    assert make_drafter(None) is None and make_drafter("none") is None
    assert isinstance(make_drafter("ngram", max_match=2), NgramDrafter)
    _, pm = _llama_pair(2)
    d = make_drafter("draft_model", draft_model=pm, context_width=8)
    assert isinstance(d, DraftModelDrafter) and d.context_width == 8
    with pytest.raises(ValueError, match="unknown speculative"):
        make_drafter("medusa")
    with pytest.raises(ValueError, match="needs a draft model"):
        make_drafter("draft_model")


def test_draft_greedy_matches_jax_and_generate():
    """Within its window the draft path is greedy generate(); past it the
    window slides, as in JAX."""
    jm, pm = _llama_pair(2)
    prompts = _prompts(3, lens=(9, 6, 20))
    want = G.draft_greedy_batch(jm, prompts, 3, width=16)
    assert TG.draft_greedy_batch(pm, prompts, 3, width=16) == want
    assert TG.draft_greedy(pm, prompts[0], 3, width=16) == want[0]
    full, _ = TG.generate(pm, [prompts[0]], max_new_tokens=3, device="cpu")
    assert want[0] == full[0].tolist()
    assert TG.draft_greedy(pm, prompts[0], 0) == []
    with pytest.raises(ValueError, match="caps at"):
        TG.draft_greedy_batch(pm, prompts, 64)


def test_draft_model_propose_batch_pads_and_slices():
    """One batched draft serves mixed budgets; padded to batch_pad and
    pinned to draft_k it proposes the same drafts (one decode graph
    signature however the batch changes)."""
    _, pm = _llama_pair(2)
    prompts = _prompts(3, lens=(9, 6, 4))
    rows = TG.draft_greedy_batch(pm, prompts[:2], 3, width=16)
    bare = DraftModelDrafter(pm, context_width=16)
    reqs = [_Req(p) for p in prompts]
    assert bare.propose_batch(reqs, [3, 1, 0]) == [rows[0], rows[1][:1], []]
    pinned = DraftModelDrafter(pm, context_width=16, batch_pad=4, draft_k=3)
    assert pinned.propose_batch(reqs, [2, 3, 0]) == \
        bare.propose_batch(reqs, [2, 3, 0])
    assert bare.propose(reqs[0], 2) == rows[0][:2]


# -- the engine ---------------------------------------------------------------------

def _oracle(pm, prompts, max_new):
    eng = ServingEngine(pm, EngineConfig(max_seqs=3, token_budget=24,
                                         block_size=8), device="cpu")
    return eng.generate_batch(prompts, max_new_tokens=max_new)


@pytest.mark.parametrize("model", list(MODELS))
def test_ngram_spec_matches_plain_decode_and_jax(model):
    jm, pm = MODELS[model]()
    prompts = _repetitive()
    kw = dict(max_seqs=3, token_budget=24, block_size=4,
              spec_method="ngram", num_draft_tokens=4)
    jeng = JaxEngine(jm, JaxEngineConfig(**kw))
    want = jeng.generate_batch(prompts, max_new_tokens=12)
    eng = ServingEngine(pm, EngineConfig(**kw), device="cpu")
    got = eng.generate_batch(prompts, max_new_tokens=12)
    assert got == want == _oracle(pm, prompts, 12)
    assert eng.spec_stats() == jeng.spec_stats()
    assert eng.spec_accepted > 0 and eng.spec_rollback_pages > 0
    assert eng.steps == jeng.steps
    assert eng.pool.used_blocks() == 0


@pytest.mark.parametrize("model", ["llama_gqa", "gpt"])
def test_draft_model_spec_with_a_diverging_window(model):
    """The target drafts for itself through an 8-token sliding window, so
    drafts diverge from the full-context target: output is still plain
    decoding's and JAX's, with the same counts."""
    jm, pm = MODELS[model]()
    prompts = _prompts(3, lens=(14, 9, 11))
    kw = dict(max_seqs=2, token_budget=16, block_size=4,
              spec_method="draft_model", num_draft_tokens=3,
              spec_options={"context_width": 8})
    jeng = JaxEngine(jm, JaxEngineConfig(draft_model=jm, **kw))
    want = jeng.generate_batch(prompts, max_new_tokens=8)
    eng = ServingEngine(pm, EngineConfig(draft_model=pm, **kw), device="cpu")
    got = eng.generate_batch(prompts, max_new_tokens=8)
    assert got == want == _oracle(pm, prompts, 8)
    assert eng.spec_stats() == jeng.spec_stats()
    # the window restarts positions, so drafts diverge (GPT's learned
    # positions accept none here): some are rejected and rolled back
    assert eng.spec_accepted < eng.spec_proposed
    assert eng.drafter.batch_pad == 2 and eng.drafter.draft_k == 3


def test_eos_cut_inside_a_verify():
    """An eos inside an accepted verify prefix stops the request there,
    as plain decoding does."""
    _, pm = _llama_pair(4)
    prompts = _repetitive()
    ref = _oracle(pm, prompts, 12)
    eos = ref[0][4]
    plain = ServingEngine(pm, EngineConfig(max_seqs=3, token_budget=24,
                                           block_size=4), device="cpu")
    want = [plain.submit(p, max_new_tokens=12, eos_id=eos) for p in prompts]
    plain.run_until_idle()
    eng = ServingEngine(pm, EngineConfig(
        max_seqs=3, token_budget=24, block_size=4, spec_method="ngram",
        num_draft_tokens=4), device="cpu")
    got = [eng.submit(p, max_new_tokens=12, eos_id=eos) for p in prompts]
    eng.run_until_idle()
    assert [r.result(0) for r in got] == [r.result(0) for r in want]
    assert got[0].result(0)[-1] == eos and got[0].finish_reason == "eos"
    assert eng.spec_accepted > 0


def test_rollback_copies_a_shared_boundary_page():
    """An engine rollback whose kept boundary page is shared: the request
    gets a private copy of the page (every layer, K and V), and the shared
    page is left as it was for its other holder."""
    _, pm = _llama_pair(2)
    eng = ServingEngine(pm, EngineConfig(max_seqs=2, token_budget=16,
                                         block_size=4), device="cpu")
    torch.manual_seed(0)
    eng._kp.normal_()
    eng._vp.normal_()
    pages = eng.pool.allocate(3)
    eng.pool.incref([pages[1]])
    before_k = eng._kp[:, pages[1]].clone()
    before_v = eng._vp[:, pages[1]].clone()
    kept, released, cow = eng.pool.truncate(list(pages), 6)
    assert released == 1 and cow == (pages[1], kept[1])
    eng._copy_page(*cow)
    for pool, before in ((eng._kp, before_k), (eng._vp, before_v)):
        assert torch.equal(pool[:, cow[1]], before)
        assert torch.equal(pool[:, pages[1]], before)


# -- the pool's rollback (KVBlockPool.truncate), against JAX's ------------------------

def _pools():
    return JaxPool(8, 4, enable_prefix_cache=False), \
        KVBlockPool(8, 4, enable_prefix_cache=False)


def test_truncate_on_a_shared_boundary_page_matches_jax():
    for pool in _pools():
        pages = pool.allocate(2)
        pool.incref([pages[1]])
        kept, released, cow = pool.truncate(list(pages), 6)
        assert released == 0 and cow == (pages[1], kept[1])
        assert pool._ref[pages[1]] == 1 and pool._ref[kept[1]] == 1
        pool.release([pages[1]])
        pool.release(kept)
        assert pool.used_blocks() == 0


def test_truncate_on_a_prefix_registered_boundary_page_matches_jax():
    """The registered original parks in the prefix cache with its content
    and is still matched; the rolled-back sequence owns a copy."""
    results = []
    for pool in (JaxPool(8, 4), KVBlockPool(8, 4)):
        toks = list(range(100, 108))
        pages = pool.allocate(2)
        pool.register_prefix(toks, pages)
        kept, released, cow = pool.truncate(list(pages), 6)
        assert cow is not None and cow[0] == pages[1]
        assert kept[-1] == cow[1] and kept[-1] not in pool._key_of
        assert pool._ref[pages[1]] == 0 and pages[1] in pool._key_of
        hit, n = pool.match_prefix(toks + [1])
        assert hit == pages and n == 8
        pool.release(hit)
        pool.release(kept)
        assert pool.used_blocks() == 0
        results.append((kept, released, cow))
    assert results[0] == results[1]


def test_truncate_exhaustion_is_atomic():
    pool = KVBlockPool(2, 4, enable_prefix_cache=False)
    pages = pool.allocate(2)
    pool.incref([pages[1]])
    pool.incref([pages[0]])
    with pytest.raises(PoolExhausted, match="copy-on-write"):
        pool.truncate([pages[1], pages[0]], 3)
    assert pool._ref[pages[0]] == 2 and pool._ref[pages[1]] == 2
    with pytest.raises(ValueError, match="incref on free"):
        KVBlockPool(2, 4).incref([0])


# -- the scheduler's drafting -------------------------------------------------------

def _running_decode_req(sched, pool, seq, slot):
    req = Request(seq[:1], max_new_tokens=32)
    req.seq = list(seq)
    req.pos = len(seq) - 1
    req.state = RUNNING
    req.slot = slot
    req.pages = pool.allocate((req.pos - 1) // pool.block_size + 1)
    sched.running.append(req)
    sched._free_slots.remove(slot)
    return req


def test_drafts_take_only_the_leftover_budget():
    pool = KVBlockPool(64, 4)
    rep = [3, 4, 5, 3, 4, 5, 3, 4, 5]
    sched = Scheduler(pool, max_seqs=2, token_budget=2, max_pages_per_seq=16,
                      drafter=NgramDrafter(), num_draft_tokens=4)
    for slot in (0, 1):
        _running_decode_req(sched, pool, rep, slot)
    plan = sched.schedule()
    assert plan.drafted == 0 and all(e.draft == () for e in plan.entries)
    sched2 = Scheduler(pool, max_seqs=2, token_budget=16,
                       max_pages_per_seq=16, drafter=NgramDrafter(),
                       num_draft_tokens=4)
    for slot in (0, 1):
        _running_decode_req(sched2, pool, rep, slot)
    plan2 = sched2.schedule()
    assert plan2.drafted == 6 and all(len(e.draft) == 3
                                      for e in plan2.entries)
    assert plan2.total_tokens == 8
    sched3 = Scheduler(pool, max_seqs=3, token_budget=9,
                       max_pages_per_seq=16, drafter=NgramDrafter(),
                       num_draft_tokens=4)
    for slot in (0, 1):
        _running_decode_req(sched3, pool, rep, slot)
    sched3.submit(Request(list(range(1, 8)), max_new_tokens=4))
    plan3 = sched3.schedule()
    assert plan3.admitted == 1 and plan3.drafted == 0
    with pytest.raises(ValueError, match="num_draft_tokens"):
        Scheduler(pool, 2, 16, 16, num_draft_tokens=-1)


def test_a_failing_drafter_degrades_the_step():
    """propose_batch raising turns the step into plain decode: the same
    tokens, one warning for the engine's life, nothing proposed."""
    class Exploding(Drafter):
        def propose(self, req, k):
            raise RuntimeError("boom")

    _, pm = _llama_pair(2)
    prompts = _prompts(2, lens=(7, 5))
    want = _oracle(pm, prompts, 6)
    eng = ServingEngine(pm, EngineConfig(max_seqs=2, token_budget=16,
                                         block_size=8), device="cpu")
    eng.drafter = eng.sched.drafter = Exploding()
    eng.sched.num_draft_tokens = 2
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = eng.generate_batch(prompts, max_new_tokens=6)
    assert got == want and eng.spec_proposed == 0
    assert len([w for w in rec if "drafter" in str(w.message)]) == 1


def test_engine_validates_the_spec_options():
    _, pm = _llama_pair(2)
    base = dict(max_seqs=2, token_budget=16, block_size=8)
    with pytest.raises(ValueError, match="draft model caps"):
        ServingEngine(pm, EngineConfig(spec_method="draft_model",
                                       num_draft_tokens=64, draft_model=pm,
                                       **base), device="cpu")
    with pytest.raises(ValueError, match="needs a draft_model"):
        ServingEngine(pm, EngineConfig(spec_method="draft_model", **base),
                      device="cpu")
    with pytest.raises(ValueError, match="num_draft_tokens"):
        EngineConfig(spec_method="ngram", num_draft_tokens=0)
    eng = ServingEngine(pm, EngineConfig(
        spec_method="draft_model", num_draft_tokens=3, draft_model=pm,
        spec_options={"context_width": 16, "batch_pad": 1, "draft_k": 1},
        **base), device="cpu")
    assert (eng.drafter.batch_pad, eng.drafter.draft_k) == (1, 1)


def test_speculative_config_routes_to_the_engine():
    _, pm = _llama_pair(2)
    conf = inference.Config()
    conf.set_speculative_config("ngram", num_draft_tokens=3, max_match=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")       # routed knobs do not warn
        pred = inference.create_llm_predictor(pm, conf, max_new_tokens=4,
                                              device="cpu")
    eng = pred.engine
    assert eng.config.spec_method == "ngram"
    assert isinstance(eng.drafter, NgramDrafter) and eng.drafter.max_match == 2
    assert eng.sched.num_draft_tokens == 3
    prompts = _repetitive()[:2]
    (out,) = pred.run([prompts])
    assert out.tolist() == _oracle(pm, prompts, 4)
    with pytest.raises(ValueError, match="draft_model"):
        inference.Config().set_speculative_config("draft_model")
    with pytest.raises(ValueError, match="num_draft_tokens"):
        inference.Config().set_speculative_config("ngram", 0)
    off = inference.Config()
    off.set_speculative_config("none")
    assert off.speculative_options()["spec_method"] is None
