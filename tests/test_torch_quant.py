"""paddle_tpu_torch's weight-only quantization against paddle_tpu's, on the
CPU.

The quantizer runs on the same numpy weights on both sides: the port's
``q`` and ``s`` must equal the JAX arrays bit for bit (both take the fp32
absmax and round half to even; the port holds ``q`` transposed, ``[out,
in]``, so ``q_port == q_jax.T``). The plain weight-only matmul within
1e-5 relative in float32 (fp32 sums in another order; the JAX int4
product is two half products). Tiny float32 Llama (MHA, GQA) and GPT
models carried across as numpy: ``generate(quant=...)`` gives JAX's greedy
tokens, the prefill's logits within 1e-4, and the engine with ``quant=``
gives the JAX engine's tokens. The GEMM itself runs only on the card
(tests/test_torch_cuda.py); here every quantized matmul takes the plain
version, as a CPU tensor does.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import generation as G
from paddle_tpu import quantization as JQ
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.quantization import _kernels as JK
from paddle_tpu.serving import EngineConfig as JaxEngineConfig
from paddle_tpu.serving import ServingEngine as JaxEngine

from paddle_tpu_torch import generation as TG
from paddle_tpu_torch import kernels as K
from paddle_tpu_torch import quantization as Q
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.kernels.quant_matmul import weight_only_gemm
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM, load_numpy_state)
from paddle_tpu_torch.quantization import _kernels as PK
from paddle_tpu_torch.serving import EngineConfig, ServingEngine

VOCAB = 61
ALGOS = ["weight_only_int8", "weight_only_int4", "weight_only_fp8"]


def _bits(q):
    """A quantized array's raw bytes as numpy (float8 viewed as uint8)."""
    if isinstance(q, torch.Tensor):
        if q.dtype == torch.float8_e4m3fn:
            q = q.view(torch.uint8)
        return q.numpy()
    q = np.asarray(q)
    return q.view(np.uint8) if q.dtype.itemsize == 1 and \
        q.dtype != np.int8 else q


def _weight(k, n=24, seed=0, bf16=False):
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32) * 0.3
    if bf16:
        w = np.array(jnp.asarray(w).astype(jnp.bfloat16).astype(
            jnp.float32))
    return w


# -- the quantizer and the plain matmul -------------------------------------------

@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("k", [64, 33])
def test_quantized_weights_bit_equal_to_jax(algo, k):
    bits = JK.ALGO_BITS[algo]
    assert PK.ALGO_BITS[algo] == bits
    w = _weight(k, seed=k)
    jq, js = JK.quantize_weight_arrays(jnp.asarray(w), bits=bits)
    pq, ps = PK.quantize_weight_arrays(torch.from_numpy(w), bits=bits)
    np.testing.assert_array_equal(_bits(pq), _bits(jq).T)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    assert pq.shape[1] == ((k + 1) // 2 if bits == 4 else k)


@pytest.mark.parametrize("algo", ALGOS)
def test_bf16_weights_quantize_bit_equal_to_jax(algo):
    """A bf16 weight quantizes against its fp32 upcast on both sides."""
    w = _weight(48, seed=5, bf16=True)
    bits = JK.ALGO_BITS[algo]
    jq, js = JK.quantize_weight_arrays(
        jnp.asarray(w).astype(jnp.bfloat16), bits=bits)
    pq, ps = PK.quantize_weight_arrays(
        torch.from_numpy(w).to(torch.bfloat16), bits=bits)
    np.testing.assert_array_equal(_bits(pq), _bits(jq).T)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


@pytest.mark.parametrize("k", [64, 33])
def test_int4_pack_round_trip(k):
    q8 = torch.from_numpy(np.random.default_rng(k).integers(
        -8, 8, (5, k)).astype(np.int8))
    packed = PK.pack_int4_rows(q8)
    assert packed.shape == (5, (k + 1) // 2)
    assert torch.equal(PK.unpack_int4_rows(packed, k), q8)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(JK.pack_int4_rows(jnp.asarray(
            q8.numpy().T))).T)


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("k", [64, 33])
def test_dequantize_matches_jax(algo, k):
    bits = JK.ALGO_BITS[algo]
    w = _weight(k, seed=2)
    jq, js = JK.quantize_weight_arrays(jnp.asarray(w), bits=bits)
    pq, ps = PK.quantize_weight_arrays(torch.from_numpy(w), bits=bits)
    want = np.asarray(JK.dequantize_weight_arrays(jq, js, n_rows=k))
    got = PK.dequantize_weight_arrays(pq, ps, n_rows=k)
    assert got.shape == (k, 24)
    np.testing.assert_array_equal(got.numpy(), want)


def test_per_tensor_fp8_bit_equal_to_jax():
    x = _weight(40, seed=9) * 100
    jq, js = JK.quantize_tensor_fp8_arrays(jnp.asarray(x))
    pq, ps = PK.quantize_tensor_fp8_arrays(torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(pq), _bits(jq))
    assert float(ps) == float(js)


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("k", [64, 33])
def test_quant_matmul_matches_jax(algo, k):
    bits = JK.ALGO_BITS[algo]
    w = _weight(k, seed=3)
    x = np.random.default_rng(4).standard_normal((2, 3, k)).astype(
        np.float32)
    jq, js = JK.quantize_weight_arrays(jnp.asarray(w), bits=bits)
    pq, ps = PK.quantize_weight_arrays(torch.from_numpy(w), bits=bits)
    want = np.asarray(JK.quant_matmul_arrays(jnp.asarray(x), jq, js))
    got = PK.quant_matmul_arrays(torch.from_numpy(x), pq, ps)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match="contraction"):
        PK.quant_matmul_arrays(torch.from_numpy(x[..., :-3]), pq, ps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weight_only_gemm_runs_the_plain_version_on_cpu(dtype):
    """On CPU tensors the GEMM's wrapper runs the plain version, in the
    activations' dtype, and counts nothing: there is no kernel launch and
    no routed call."""
    q, s = PK.quantize_weight_arrays(torch.from_numpy(_weight(32)))
    x = torch.randn(4, 32, generator=torch.Generator().manual_seed(5)) \
        .to(dtype)
    before = dict(K.LAUNCHES)
    y = weight_only_gemm(x, q, s)
    assert y.dtype == dtype
    torch.testing.assert_close(y, PK.quant_matmul_arrays(x, q, s),
                               rtol=0, atol=0)
    assert K.LAUNCHES == before


def test_quant_refuses_a_float32_model_on_the_card(monkeypatch):
    """The GEMM reads bf16 activations, so quantized weights on the card
    serve a bf16 model; a float32 one raises before anything is quantized
    (the CPU check stands in for the card by marking the weights as CUDA
    tensors)."""
    model = LlamaForCausalLM(LlamaConfig.tiny(vocab_size=VOCAB), device="cpu")
    dec = TG._decoder_for(model)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    with pytest.raises(TypeError, match="bf16 model"):
        TG._quant_weights_cached(dec, model, "weight_only_int8")
    assert "_quant_weights_cache" not in model.__dict__


# -- the public functions -----------------------------------------------------------

@pytest.mark.parametrize("algo", ALGOS)
def test_public_functions_match_jax(algo):
    k = 33 if algo == "weight_only_int4" else 32
    w = _weight(k, seed=6)
    x = np.random.default_rng(7).standard_normal((3, k)).astype(np.float32)
    b = np.random.default_rng(8).standard_normal(24).astype(np.float32)
    jq, js = JQ.weight_quantize(paddle.to_tensor(w), algo=algo)
    pq, ps = Q.weight_quantize(torch.from_numpy(w), algo=algo)
    np.testing.assert_array_equal(_bits(pq), _bits(jq._data).T)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js._data))
    want = np.asarray(JQ.weight_dequantize(jq, js, algo=algo)._data)
    np.testing.assert_array_equal(
        Q.weight_dequantize(pq, ps, algo=algo).numpy(), want)
    want = np.asarray(JQ.weight_only_linear(
        paddle.to_tensor(x), jq, bias=paddle.to_tensor(b),
        weight_scale=js)._data)
    got = Q.weight_only_linear(torch.from_numpy(x), pq,
                               bias=torch.from_numpy(b), weight_scale=ps)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError, match="implemented algos"):
        Q.weight_quantize(torch.from_numpy(w), algo="weight_only_int2")


# -- quantized decoding ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _llama_pair(kv_heads):
    paddle.seed(3)
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
def _gpt_pair(tied):
    paddle.seed(4)
    kw = dict(vocab_size=VOCAB, hidden_size=32, layers=2, heads=4, seq=64,
              tie_word_embeddings=tied)
    jm = JaxGPT(JaxGPTConfig.tiny(**kw))
    pm = GPTForCausalLM(GPTConfig.tiny(**kw), device="cpu")
    load_numpy_state(pm, {n: np.asarray(t._data)
                          for n, t in jm.named_state().items()})
    return jm, pm


MODELS = {"llama_mha": lambda: _llama_pair(4),
          "llama_gqa": lambda: _llama_pair(2),
          "gpt_tied": lambda: _gpt_pair(True),
          "gpt_untied": lambda: _gpt_pair(False)}


def _batch(lengths=(9, 4, 7), width=9, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lengths), width), np.int32)
    mask = np.zeros((len(lengths), width), np.int32)
    for b, n in enumerate(lengths):
        ids[b, width - n:] = rng.integers(1, VOCAB, (n,))
        mask[b, width - n:] = 1
    return ids, mask


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("model", list(MODELS))
def test_quantized_generate_matches_jax(model, algo):
    """Greedy tokens of generate(quant=) equal JAX's; the prefill's last
    logits over the quantized weights within 1e-4."""
    jm, pm = MODELS[model]()
    ids, mask = _batch()
    want, _ = G.generate(jm, paddle.to_tensor(ids),
                         attention_mask=paddle.to_tensor(mask),
                         max_new_tokens=6, quant=algo)
    got, _ = TG.generate(pm, ids, attention_mask=mask, max_new_tokens=6,
                         quant=algo, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want._data))
    jdec, dec = G._decoder_for(jm), TG._decoder_for(pm)
    jw = G._quant_weights_cached(jdec, jm, algo)
    w = TG._quant_weights_cached(dec, pm, algo)
    assert {k for k in jw if "::" in k} == {k for k in w if "::" in k}
    _, _, _, jlast = G._prefill(jdec, jw, jnp.asarray(ids), jnp.asarray(mask),
                                4)
    kcs = torch.zeros(dec.n_layers, 3, dec.n_kv, ids.shape[1] + 4, dec.hd)
    _, last = TG._prefill(dec, w, torch.from_numpy(ids).long(),
                          torch.from_numpy(mask).long(), 4, kcs,
                          torch.zeros_like(kcs))
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=1e-4)


def _prompts(n, lens=(9, 11, 10, 5, 7, 3), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, (lens[i % len(lens)],)).tolist()
            for i in range(n)]


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("model", list(MODELS))
def test_quantized_engine_matches_jax(model, algo):
    jm, pm = MODELS[model]()
    prompts = _prompts(5)
    kw = dict(max_seqs=3, token_budget=16, block_size=4, quant=algo)
    want = JaxEngine(jm, JaxEngineConfig(**kw)).generate_batch(
        prompts, max_new_tokens=6)
    got = ServingEngine(pm, EngineConfig(**kw), device="cpu") \
        .generate_batch(prompts, max_new_tokens=6)
    assert got == want


def test_engine_refuses_an_unknown_algo():
    with pytest.raises(NotImplementedError, match="supported algos"):
        EngineConfig(quant="weight_only_int2")


def test_quant_cache_follows_the_weight_snapshot():
    """The leaves are quantized once per snapshot: a second call reuses
    them; an optimizer step (the port's AdamW writes through p.data and
    bumps the version) or a load gives new leaves of the new weights."""
    paddle.seed(5)
    pm = LlamaForCausalLM(LlamaConfig.tiny(vocab_size=VOCAB, hidden_size=32,
                                           layers=1, heads=4, kv_heads=2,
                                           seq=64), device="cpu")
    dec = TG._decoder_for(pm)
    algo = "weight_only_int8"
    name = "model.layers.0.mlp.up_proj.weight::q"
    w1 = TG._quant_weights_cached(dec, pm, algo)
    w2 = TG._quant_weights_cached(dec, pm, algo)
    assert w1[name] is w2[name]
    assert "model.layers.0.mlp.up_proj.weight" not in w1
    assert w1["model.norm.weight"] is not None
    o = opt.AdamW(learning_rate=0.5, parameters=pm.parameters())
    ids = torch.randint(1, VOCAB, (2, 8))
    pm.compute_loss(pm(ids), ids).backward()
    o.step()
    w3 = TG._quant_weights_cached(dec, pm, algo)
    assert w3[name] is not w1[name]
    want, _ = PK.quantize_weight_arrays(
        pm.model.layers[0].mlp.up_proj.weight.detach())
    assert torch.equal(w3[name], want)
    # int4 leaves are cached beside the int8 ones
    w4 = TG._quant_weights_cached(dec, pm, "weight_only_int4")
    assert TG._quant_weights_cached(dec, pm, algo)[name] is w3[name]
    assert w4[name].shape[1] == w3[name].shape[1] // 2


def test_tied_head_quantizes_the_embedding_transpose():
    _, pm = _gpt_pair(True)
    dec = TG._decoder_for(pm)
    names, lm = dec.quant_plan()
    assert lm == "transformer.wte.weight" and "lm_head.weight" not in names
    w = TG._quant_weights_cached(dec, pm, "weight_only_int8")
    assert w["__lm::q"].shape == (VOCAB, 32)
    assert "transformer.wte.weight" in w         # the gather keeps it
