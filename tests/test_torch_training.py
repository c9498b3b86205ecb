"""paddle_tpu_torch's dense Llama forward, loss and gradients against
paddle_tpu's, on the CPU.

A tiny Llama is built in paddle_tpu (on the CPU its attention takes the
XLA reference path) and its weights carried across with
``load_numpy_state``; the port's plain versions then run the same model.
Tolerances, float32: logits and losses atol 1e-5 (values O(1), fp32 sums
in another order); gradients atol 1e-5 plus 1e-4 relative (sums over the
batch and sequence of such products). bf16: logits within 2^-5 of the
largest logit (four bf16 ulps): both models round weights and activations
to bf16 at the same places but the port rounds P to bf16 before P.V, as the
flash kernel does, where the JAX reference path keeps it in fp32.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama

from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     load_numpy_state)
from paddle_tpu_torch.nn import functional as F

VOCAB = 61
SEQ = 24


def _jax_model(kv_heads, tied=False, seed=3):
    paddle.seed(seed)
    cfg = JaxConfig.tiny(vocab_size=VOCAB, hidden_size=32, layers=2, heads=4,
                         kv_heads=kv_heads, seq=32)
    cfg.tie_word_embeddings = tied
    return JaxLlama(cfg)


def _state(jm):
    return {n: np.asarray(t._data) for n, t in jm.named_state().items()}


def _port_model(jm, kv_heads, tied=False):
    cfg = LlamaConfig.tiny(vocab_size=VOCAB, hidden_size=32, layers=2,
                           heads=4, kv_heads=kv_heads, seq=32)
    cfg.tie_word_embeddings = tied
    model = LlamaForCausalLM(cfg, device="cpu")
    load_numpy_state(model, _state(jm))
    return model


@functools.lru_cache(maxsize=None)
def _ids(seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (2, SEQ)) \
        .astype(np.int32)


def _labels_with_ignored():
    labels = _ids().copy()
    labels[0, 15:] = -100        # a padded tail
    labels[1, 3] = -100
    return labels


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_logits_match_jax(kv_heads):
    jm = _jax_model(kv_heads)
    pm = _port_model(jm, kv_heads)
    want = np.asarray(jm(paddle.to_tensor(_ids()))._data)
    with torch.no_grad():
        got = pm(torch.from_numpy(_ids()))
    assert got.shape == (2, SEQ, VOCAB)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("chunk", [None, 7])
@pytest.mark.parametrize("tied", [False, True])
def test_forward_loss_matches_jax(chunk, tied):
    """Shifted cross entropy with ignore_index rows, whole and chunked
    (7 does not divide the 23 shifted positions)."""
    jm = _jax_model(2, tied)
    pm = _port_model(jm, 2, tied)
    labels = _labels_with_ignored()
    want = float(jm.forward_loss(paddle.to_tensor(_ids()),
                                 paddle.to_tensor(labels),
                                 loss_chunk_size=chunk).numpy())
    with torch.no_grad():
        got = float(pm.forward_loss(torch.from_numpy(_ids()),
                                    torch.from_numpy(labels),
                                    loss_chunk_size=chunk))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_cross_entropy_matches_jax():
    from paddle_tpu.nn import functional as JF
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((9, 13)).astype(np.float32) * 3
    labels = rng.integers(0, 13, 9)
    labels[[2, 5]] = -100
    want = float(JF.cross_entropy(paddle.to_tensor(logits),
                                  paddle.to_tensor(labels)).numpy())
    got = float(F.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    want = float(JF.cross_entropy(paddle.to_tensor(logits),
                                  paddle.to_tensor(labels),
                                  reduction="sum").numpy())
    got = float(F.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels), reduction="sum"))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("kv_heads,chunk", [(4, None), (2, 8)])
def test_every_gradient_matches_jax_backward(kv_heads, chunk):
    """Every parameter's gradient of forward_loss against the JAX eager
    loss.backward(); GQA sums dk/dv over the repeated heads."""
    jm = _jax_model(kv_heads)
    pm = _port_model(jm, kv_heads)
    labels = _labels_with_ignored()
    jloss = jm.forward_loss(paddle.to_tensor(_ids()),
                            paddle.to_tensor(labels), loss_chunk_size=chunk)
    jloss.backward()
    want = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    loss = pm.forward_loss(torch.from_numpy(_ids()), torch.from_numpy(labels),
                           loss_chunk_size=chunk)
    loss.backward()
    got = dict(pm.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), w, atol=1e-5,
                                   rtol=1e-4, err_msg=name)


def test_bf16_state_loads_and_logits_match_jax():
    """The JAX model after .bfloat16() (bf16 weights AND rope tables, as
    its Layer.to casts floating buffers) loads into the port's model after
    .bfloat16(); the port upcasts the bf16 tables to fp32 for the RoPE
    kernel's plain version, keeping their values."""
    jm = _jax_model(2)
    jm.bfloat16()
    state = _state(jm)
    assert state["model.rope_cos"].dtype.name == "bfloat16"
    pm = LlamaForCausalLM(LlamaConfig.tiny(vocab_size=VOCAB, hidden_size=32,
                                           layers=2, heads=4, kv_heads=2,
                                           seq=32), device="cpu").bfloat16()
    assert pm.model.rope_cos.dtype == torch.bfloat16
    load_numpy_state(pm, state)
    want = np.asarray(jm(paddle.to_tensor(_ids()))._data.astype(jnp.float32))
    with torch.no_grad():
        got = pm(torch.from_numpy(_ids()))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2.0 ** -5 * float(np.abs(want).max()))


def test_serving_decoder_takes_bf16_rope_tables():
    """The serving decoder hands fp32 tables to the RoPE kernel whatever
    the buffers' dtype, with the bf16 values kept exactly."""
    from paddle_tpu_torch.generation import _LlamaDecoder
    pm = LlamaForCausalLM(LlamaConfig.tiny(vocab_size=VOCAB, hidden_size=32,
                                           layers=1, heads=4, kv_heads=2,
                                           seq=32), device="cpu").bfloat16()
    w = _LlamaDecoder.weights(pm)
    assert w["__rope_cos"].dtype == torch.float32
    assert torch.equal(w["__rope_cos"], pm.model.rope_cos.float())


def test_dense_forward_raises_on_masks_and_launches_nothing_on_cpu():
    """A dense mask and FlashMask bounds together raise; on the CPU the
    forward and backward, with bounds or without, launch no kernel."""
    jm = _jax_model(2)
    pm = _port_model(jm, 2)
    ids = torch.from_numpy(_ids())
    bounds = torch.full((2, 2, SEQ, 1), SEQ, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="cannot be combined"):
        pm(ids, attention_mask=torch.ones(2, 1, SEQ, SEQ, dtype=torch.bool),
           attn_startend_row_indices=bounds)
    before = K.kernel_launches()
    pm.forward_loss(ids, ids, loss_chunk_size=5).backward()
    pm.forward_loss(ids, ids, loss_chunk_size=5,
                    attn_startend_row_indices=bounds).backward()
    assert K.kernel_launches() == before


def test_num_params_and_flops_match_jax():
    jm = _jax_model(2)
    pm = _port_model(jm, 2)
    assert pm.num_params() == jm.num_params()
    assert pm.flops_per_token(SEQ) == jm.flops_per_token(SEQ)
