"""paddle_tpu_torch's serving path against paddle_tpu's, on the CPU.

A tiny Llama is built in paddle_tpu and its weights carried across with
``load_numpy_state``; then the port's ragged step must give the JAX
step's logits (float32, atol 1e-4) and the port's ServingEngine must
return exactly the JAX ServingEngine's greedy tokens, in both policies,
under pool pressure that preempts, and with prefix-cache hits. The
host-side scheduler must produce the same step plans as the JAX one.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import generation as G
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving import EngineConfig as JaxEngineConfig
from paddle_tpu.serving import KVBlockPool as JaxPool
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import engine as jax_engine
from paddle_tpu.serving.scheduler import Request as JaxRequest
from paddle_tpu.serving.scheduler import Scheduler as JaxScheduler

from paddle_tpu_torch import framework
from paddle_tpu_torch import generation as TG
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     build_rope_cache, load_numpy_state)
from paddle_tpu_torch.serving import EngineConfig, KVBlockPool, ServingEngine
from paddle_tpu_torch.serving import engine as port_engine
from paddle_tpu_torch.serving.scheduler import Request, Scheduler

VOCAB = 61


@functools.lru_cache(maxsize=None)
def _jax_model(kv_heads):
    """One shared read-only JAX model per geometry (engines only read
    weights), as tests/test_serve_engine.py builds it."""
    paddle.seed(3)
    cfg = JaxConfig.tiny(vocab_size=VOCAB, hidden_size=32, layers=2, heads=4,
                         kv_heads=kv_heads, seq=64)
    cfg.use_flash_attention = False
    return JaxLlama(cfg)


def _jax_state(kv_heads):
    return {n: np.asarray(t._data)
            for n, t in _jax_model(kv_heads).named_state().items()}


def _port_config(kv_heads):
    return LlamaConfig.tiny(vocab_size=VOCAB, hidden_size=32, layers=2,
                            heads=4, kv_heads=kv_heads, seq=64)


@functools.lru_cache(maxsize=None)
def _port_model(kv_heads):
    model = LlamaForCausalLM(_port_config(kv_heads), device="cpu")
    load_numpy_state(model, _jax_state(kv_heads))
    return model


def _prompts(n, lens=(9, 11, 10, 5, 7, 3), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, (lens[i % len(lens)],)).tolist()
            for i in range(n)]


# -- weights ------------------------------------------------------------------

def test_load_numpy_state_fills_every_parameter():
    state = _jax_state(2)
    model = _port_model(2)
    got = dict(model.named_parameters())
    got.update(model.named_buffers())
    for name, arr in state.items():
        np.testing.assert_array_equal(got[name].detach().numpy(), arr)


def test_rope_cache_matches_jax():
    from paddle_tpu.models.llama import build_rope_cache as jax_rope
    wc, ws = jax_rope(64, 8)
    c, s = build_rope_cache(64, 8)
    np.testing.assert_allclose(c.numpy(), np.asarray(wc), atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), atol=1e-6)


@pytest.mark.parametrize("fault", ["missing", "unknown", "shape", "dtype"])
def test_load_numpy_state_raises_on_mismatch(fault):
    state = dict(_jax_state(2))
    name = "model.layers.1.self_attn.k_proj.weight"
    if fault == "missing":
        del state[name]
        err = KeyError
    elif fault == "unknown":
        state["model.layers.9.mlp.up_proj.weight"] = state[name]
        err = KeyError
    elif fault == "shape":
        state[name] = state[name][:, :8]
        err = ValueError
    else:
        state[name] = state[name].astype(np.float64)
        err = TypeError
    model = LlamaForCausalLM(_port_config(2), device="cpu")
    before = model.model.norm.weight.detach().clone()
    with pytest.raises(err):
        load_numpy_state(model, state)
    # nothing was written before the check failed
    assert torch.equal(model.model.norm.weight.detach(), before)


def test_pdparams_round_trip(tmp_path):
    jm = _jax_model(4)
    path = str(tmp_path / "tiny.pdparams")
    paddle.save(jm.state_dict(), path)
    state = framework.load(path, return_numpy=True)
    assert all(isinstance(v, np.ndarray) for v in state.values())
    model = LlamaForCausalLM(_port_config(4), device="cpu")
    load_numpy_state(model, state)
    want = _jax_state(4)
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name])


# -- one ragged step ----------------------------------------------------------

def _step_inputs(kv_heads):
    """A mixed step: a prefill chunk of slot 0, decode tokens of slots 1
    and 2, and two padding rows, over random pools."""
    rng = np.random.default_rng(5)
    jm, pm = _jax_model(kv_heads), _port_model(kv_heads)
    layers, p, bs, hd, mp = 2, 10, 4, 8, 4
    kp = rng.standard_normal((layers, p, kv_heads, bs, hd)).astype(np.float32)
    vp = rng.standard_normal((layers, p, kv_heads, bs, hd)).astype(np.float32)
    tables = np.full((3, mp), -1, np.int32)
    tables[0, :2] = [3, 7]
    tables[1, :3] = [0, 5, 9]
    tables[2, :1] = [2]
    slots = np.asarray([0, 0, 0, 0, 0, 1, 2, 0, 0], np.int32)
    pos = np.asarray([2, 3, 4, 5, 6, 10, 1, 0, 0], np.int32)
    valid = np.asarray([1] * 7 + [0, 0], bool)
    tokens = rng.integers(1, VOCAB, (9,)).astype(np.int32)
    return jm, pm, tokens, slots, pos, valid, tables, kp, vp


def _with_spare_page(pools):
    """The port's pools: the JAX pools and one spare page past them, where
    the rows the JAX scatter drops are written (random, so a read of it
    would show)."""
    spare = np.random.default_rng(9).standard_normal(
        pools[:, :1].shape).astype(pools.dtype)
    return torch.from_numpy(np.concatenate([pools, spare], axis=1))


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_step_ragged_logits_match_jax(kv_heads):
    """The step's logits, and the pool's real pages after it (the port's
    spare page aside), equal the JAX step's."""
    jm, pm, tokens, slots, pos, valid, tables, kp, vp = _step_inputs(kv_heads)
    dec = G._decoder_for(jm)
    want, wkp, wvp = jax_engine._engine_step_impl(
        dec, None, dec.weights(jm), *map(jnp.asarray, (
            tokens, slots, pos, valid, tables, kp, vp)))
    tkp, tvp = _with_spare_page(kp), _with_spare_page(vp)
    t = torch.from_numpy
    got = port_engine._engine_step_impl(
        TG._decoder_for(pm), TG._LlamaDecoder.weights(pm), t(tokens).long(),
        t(slots), t(pos), t(valid), t(tables), tkp, tvp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    p = kp.shape[1]
    np.testing.assert_allclose(tkp[:, :p].numpy(), np.asarray(wkp), atol=1e-5)
    np.testing.assert_allclose(tvp[:, :p].numpy(), np.asarray(wvp), atol=1e-5)


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_step_ragged_logits_match_jax_bf16(kv_heads):
    """The same step with bf16 weights and pools (the rope tables stay
    float32 on both sides): the port rounds where the JAX decoder rounds,
    so the logits agree to atol 1e-2, under one bf16 ulp (2^-6) of the
    largest logits (about 2.7). The real pages after the step hold the
    same bf16 values (each is one rounding of the same fp32 K or V) up to
    one bf16 ulp where the two sums round apart."""
    jm, pm, tokens, slots, pos, valid, tables, kp, vp = _step_inputs(kv_heads)
    dec = G._decoder_for(jm)
    jw = {k: v if k.startswith("__") else v.astype(jnp.bfloat16)
          for k, v in dec.weights(jm).items()}
    want, wkp, wvp = jax_engine._engine_step_impl(
        dec, None, jw, *map(jnp.asarray, (tokens, slots, pos, valid, tables)),
        jnp.asarray(kp, dtype=jnp.bfloat16), jnp.asarray(vp, dtype=jnp.bfloat16))
    tw = {k: v if k.startswith("__") else v.to(torch.bfloat16)
          for k, v in TG._LlamaDecoder.weights(pm).items()}
    t = torch.from_numpy
    tkp = _with_spare_page(kp).to(torch.bfloat16)
    tvp = _with_spare_page(vp).to(torch.bfloat16)
    got = port_engine._engine_step_impl(
        TG._decoder_for(pm), tw, t(tokens).long(), t(slots), t(pos),
        t(valid), t(tables), tkp, tvp)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), atol=1e-2)
    p = kp.shape[1]
    for port, ref in ((tkp, wkp), (tvp, wvp)):
        ref = np.asarray(ref.astype(jnp.float32))
        np.testing.assert_allclose(port[:, :p].float().numpy(), ref,
                                   rtol=2.0 ** -8, atol=1e-6)


# -- the engine ---------------------------------------------------------------

def _engines(kv_heads, **cfg):
    jax_eng = JaxEngine(_jax_model(kv_heads), JaxEngineConfig(**cfg))
    port_eng = ServingEngine(_port_model(kv_heads), EngineConfig(**cfg),
                             device="cpu")
    return jax_eng, port_eng


@pytest.mark.parametrize("policy", ["continuous", "static"])
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_engine_tokens_match_jax_under_pressure(kv_heads, policy):
    """A pool too small for every sequence's growth preempts; a prompt
    served again afterwards hits the prefix cache. Both engines must
    return the same tokens and take the same path."""
    prompts = _prompts(3)
    engines = _engines(kv_heads, max_seqs=3, token_budget=16, block_size=4,
                       num_blocks=9, policy=policy)
    outs, stats = [], []
    for eng in engines:
        reqs = [eng.submit(pr, max_new_tokens=8) for pr in prompts]
        eng.run_until_idle(max_steps=500)
        again = eng.generate_batch([prompts[1]], max_new_tokens=4)
        outs.append(([r.result(0) for r in reqs], again))
        stats.append((sum(r.preemptions for r in reqs), eng.steps,
                      eng.pool.stats["prefix_hits"]))
    assert outs[1] == outs[0]
    assert stats[1] == stats[0]
    preempted, _, hits = stats[1]
    if policy == "continuous":
        assert preempted > 0, "config no longer exercises preemption"
    assert hits > 0, "config no longer exercises the prefix cache"


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_engine_generate_batch_matches_jax(kv_heads):
    prompts = _prompts(6)
    outs = [eng.generate_batch(prompts, max_new_tokens=6)
            for eng in _engines(kv_heads, max_seqs=4, token_budget=16,
                                block_size=4)]
    assert outs[1] == outs[0]


def test_engine_streams_tokens_and_drains():
    eng = _engines(2, max_seqs=2, token_budget=8, block_size=4)[1]
    seen = []
    req = eng.submit(_prompts(1)[0], max_new_tokens=5, stream=True,
                     on_token=seen.append)
    assert eng.has_work()
    eng.run_until_idle()
    assert list(req.stream()) == req.result(0) == seen
    assert len(seen) == 5 and not eng.has_work()
    assert eng.pool.used_blocks() == 0


def test_request_timestamps_are_set_and_ordered():
    """arrival <= first token <= finish for every request; with two slots
    the third request gets its first token only after a slot frees. The
    engine's host seconds add up over the steps."""
    eng = _engines(2, max_seqs=2, token_budget=8, block_size=4)[1]
    reqs = [eng.submit(p, max_new_tokens=3) for p in _prompts(3)]
    assert all(r.first_token_at is None and r.finished_at is None
               for r in reqs)
    eng.run_until_idle()
    for r in reqs:
        assert r.arrival <= r.first_token_at <= r.finished_at
    assert reqs[2].first_token_at >= min(r.finished_at for r in reqs[:2])
    assert set(eng.host_seconds) == {"schedule", "pack", "device", "emit"}
    assert all(v > 0 for v in eng.host_seconds.values())


@pytest.mark.parametrize("option", ["quant", "spec_method", "aot_cache",
                                    "obs", "memwatch", "resilience", "mesh",
                                    "role"])
def test_engine_config_refuses_unported_options(option):
    # quant and spec_method are ported: a value the JAX engine lacks still
    # raises (an unknown algo as generate(quant=) does, an unknown method
    # as the JAX make_drafter does)
    err = ValueError if option == "spec_method" else NotImplementedError
    with pytest.raises(err):
        EngineConfig(**{option: "int8"})


# -- host-side scheduler and pool ---------------------------------------------

def _drive(sched_cls, req_cls, pool, prompts, policy, max_new=6):
    """Step a scheduler to idle, feeding a deterministic token per sample;
    returns every plan as (request index, start, n) tuples plus counts."""
    sched = sched_cls(pool, 3, 12, 8, policy=policy)
    reqs = [req_cls(p, max_new_tokens=max_new) for p in prompts]
    index = {id(r): i for i, r in enumerate(reqs)}
    for r in reqs:
        sched.submit(r)
    plans = []
    for _ in range(200):
        if not sched.has_work():
            break
        plan = sched.schedule()
        plans.append(([(index[id(e.req)], e.start, e.n)
                       for e in plan.entries], plan.admitted, plan.preempted))
        done = []
        for e in plan.entries:
            e.req.pos = e.start + e.n
            if e.samples:
                e.req.emit((len(e.req.seq) * 7) % VOCAB)
                if len(e.req.output) >= e.req.max_new_tokens:
                    done.append(e.req)
        for r in done:
            sched.evict_finished(r)
    return plans, [r.output for r in reqs], dict(pool.stats)


@pytest.mark.parametrize("policy", ["continuous", "static"])
@pytest.mark.parametrize("num_blocks", [7, 40])
def test_scheduler_plans_match_jax(policy, num_blocks):
    prompts = _prompts(5, lens=(9, 14, 3, 9, 6), seed=4)
    prompts[3] = list(prompts[0])           # a repeated prompt
    want = _drive(JaxScheduler, JaxRequest, JaxPool(num_blocks, 4), prompts,
                  policy)
    got = _drive(Scheduler, Request, KVBlockPool(num_blocks, 4), prompts,
                 policy)
    assert got == want


def test_pool_truncate_matches_jax():
    out = []
    for cls in (JaxPool, KVBlockPool):
        pool = cls(8, 4)
        pages = pool.allocate(3)
        pool.register_prefix(list(range(12)), pages)
        hit, n = pool.match_prefix(list(range(12)), max_tokens=11)
        kept, released, cow = pool.truncate(hit + pool.allocate(1), 6)
        out.append((hit, n, kept, released, cow, pool.used_blocks(),
                    pool.cached_blocks(), dict(pool.stats)))
    assert out[1] == out[0]
