"""``paddle_tpu_torch.nn``'s Transformer layers against
``paddle_tpu/nn/layer/transformer.py`` on the CPU, at d_model 32, 4 heads,
2 + 2 layers, feed-forward 64, the JAX weights carried across as numpy
(``load_numpy_state``): ``state_dict`` names equal to the JAX
``named_state()``, forwards with every mask form (bool and additive,
broadcast from [b, 1, 1, sk], [b, 1, sq, sk] and [sq, sk]) and with both
``normalize_before`` settings, every parameter's gradient, both cache
types, ``kdim`` / ``vdim``, ``generate_square_subsequent_mask``, the
custom stacks, and the JAX routing fact that a layer built with a dropout
takes the dense attention route in eval too.

Tolerances: fp32, outputs within 1e-5 of the largest |value| (sums in
another order), gradients within 1e-4 relative L2 each.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.tensor import Tensor

import paddle_tpu_torch.nn as pnn
from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.models import load_numpy_state

D, NH, FF = 32, 4, 64


def _jt(a):
    return None if a is None else Tensor(jnp.asarray(a))


def _pt(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _np(t):
    return np.asarray(t._data) if isinstance(t, Tensor) else \
        t.detach().numpy()


def _close(got, want, tol=1e-5):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _carry(jm, pm):
    """The JAX layer's parameters and buffers into the port's, by name."""
    assert list(pm.state_dict()) == list(jm.named_state())
    load_numpy_state(pm, {n: np.asarray(t._data)
                          for n, t in jm.named_state().items()})
    return jm, pm


def _pair(seed, make_j, make_p):
    paddle.seed(seed)
    return _carry(make_j(), make_p())


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _masks(rng, b, sq, sk):
    sub = np.triu(np.full((sq, sk), -1e9, np.float32), 1)
    return {
        "none": None,
        "bool-rows": rng.random((b, 1, sq, sk)) > 0.3,
        "add-pad": np.where(rng.random((b, 1, 1, sk)) > 0.3, 0.0,
                            -1e9).astype(np.float32),
        "add-2d": sub,
    }


def _grads_close(jm, pm):
    """Each gradient within 1e-4 of its norm, or of 1e-3 of the largest
    gradient's norm where its own is below that: the keys' biases, to
    which softmax is blind, have an exact gradient of 0, and both
    packages give rounding noise there."""
    want = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()
            if p.grad is not None}
    got = {n: p.grad for n, p in pm.named_parameters()}
    assert set(want) <= set(got)
    big = max(np.linalg.norm(w) for w in want.values())
    for name, w in want.items():
        g = got[name].numpy()
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-3 * big)
        assert err <= 1e-4, (name, err)


def _transformer(seed, normalize_before, dropout=0.0, **kw):
    return _pair(seed,
                 lambda: jnn.Transformer(D, NH, 2, 2, FF, dropout=dropout,
                                         normalize_before=normalize_before,
                                         **kw),
                 lambda: pnn.Transformer(D, NH, 2, 2, FF, dropout=dropout,
                                         normalize_before=normalize_before,
                                         device="cpu", **kw))


@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("mask", ["none", "bool-rows", "add-pad", "add-2d"])
def test_transformer_forward_and_gradients_match_jax(normalize_before, mask):
    """The encoder-decoder's output and every parameter's gradient, the
    mask given as src_mask (self) and memory_mask (cross, its own shape)
    and the subsequent mask as tgt_mask."""
    jm, pm = _transformer(3, normalize_before)
    rng = np.random.default_rng(4)
    src, tgt = _x(5, 2, 7, D), _x(6, 2, 5, D)
    sm = _masks(rng, 2, 7, 7)[mask]
    mm = _masks(rng, 2, 5, 7)[mask]
    tm = np.asarray(jm.generate_square_subsequent_mask(5)._data)
    g = _x(7, 2, 5, D)
    want = jm(_jt(src), _jt(tgt), _jt(sm), _jt(tm), _jt(mm))
    (want * _jt(g)).sum().backward()
    got = pm(_pt(src), _pt(tgt), _pt(sm), _pt(tm), _pt(mm))
    (got * _pt(g)).sum().backward()
    _close(got, want)
    _grads_close(jm, pm)


def test_state_dict_names_equal_the_jax_named_state():
    """Every module's ``state_dict`` names (and order) are the JAX
    ``named_state()``'s."""
    for make_j, make_p in [
            (lambda: jnn.Transformer(D, NH, 1, 2, FF, normalize_before=True),
             lambda: pnn.Transformer(D, NH, 1, 2, FF, normalize_before=True,
                                     device="cpu")),
            (lambda: jnn.MultiHeadAttention(D, NH, kdim=12, vdim=20),
             lambda: pnn.MultiHeadAttention(D, NH, kdim=12, vdim=20,
                                            device="cpu")),
            (lambda: jnn.TransformerDecoderLayer(D, NH, FF),
             lambda: pnn.TransformerDecoderLayer(D, NH, FF, device="cpu"))]:
        assert list(make_p().state_dict()) == list(make_j().named_state())


def test_multi_head_attention_kdim_vdim_matches_jax():
    jm, pm = _pair(8, lambda: jnn.MultiHeadAttention(D, NH, kdim=12, vdim=20),
                   lambda: pnn.MultiHeadAttention(D, NH, kdim=12, vdim=20,
                                                  device="cpu"))
    q, k, v = _x(9, 2, 3, D), _x(10, 2, 6, 12), _x(11, 2, 6, 20)
    mask = np.random.default_rng(12).random((2, NH, 3, 6)) > 0.4
    _close(pm(_pt(q), _pt(k), _pt(v), _pt(mask)),
           jm(_jt(q), _jt(k), _jt(v), _jt(mask)))


def test_incremental_cache_matches_jax():
    """``gen_cache`` (an empty ``Cache``), then one token at a time: each
    output and the grown cache's keys and values equal the JAX layer's,
    and the last step equals a causal forward over the whole sequence."""
    jm, pm = _pair(13, lambda: jnn.MultiHeadAttention(D, NH),
                   lambda: pnn.MultiHeadAttention(D, NH, device="cpu"))
    x = _x(14, 2, 4, D)
    jc = jm.gen_cache(_jt(x))
    pc = pm.gen_cache(_pt(x))
    assert tuple(pc.k.shape) == (2, 0, NH, D // NH)
    for t in range(4):
        jo, jc = jm(_jt(x[:, t:t + 1]), cache=jc)
        po, pc = pm(_pt(x[:, t:t + 1]), cache=pc)
        assert isinstance(pc, pnn.MultiHeadAttention.Cache)
        _close(po, jo)
        _close(pc.k, jc.k)
        _close(pc.v, jc.v)
    sub = np.triu(np.full((4, 4), -1e9, np.float32), 1)
    _close(po, pm(_pt(x), attn_mask=_pt(sub))[:, 3:])


def test_static_cache_matches_jax():
    """A ``StaticCache`` of projected memory keys and values is used as
    they are, and the call returns ``(out, None)``."""
    jm, pm = _pair(15, lambda: jnn.MultiHeadAttention(D, NH),
                   lambda: pnn.MultiHeadAttention(D, NH, device="cpu"))
    q, mem = _x(16, 2, 3, D), _x(17, 2, 5, D)
    jc = jm.gen_cache(_jt(mem), type=jnn.MultiHeadAttention.StaticCache)
    pc = pm.gen_cache(_pt(mem), type=pnn.MultiHeadAttention.StaticCache)
    _close(pc.k, jc.k)
    jo, jn = jm(_jt(q), _jt(mem), _jt(mem), cache=jc)
    po, pn = pm(_pt(q), _pt(mem), _pt(mem), cache=pc)
    assert jn is None and pn is None
    _close(po, jo)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_layer_with_cache_and_options_matches_jax(normalize_before):
    """An encoder layer with GELU, ``layer_norm_eps``, ``attn_dropout`` /
    ``act_dropout`` (0 here), called with a cache: ``(out, new_cache)``."""
    def make(mod, **kw):
        return mod.TransformerEncoderLayer(
            D, NH, FF, dropout=0.0, activation="gelu", attn_dropout=0.0,
            act_dropout=0.0, normalize_before=normalize_before,
            layer_norm_eps=1e-3, **kw)
    jm, pm = _pair(18, lambda: make(jnn), lambda: make(pnn, device="cpu"))
    x = _x(19, 2, 3, D)
    jo, jc = jm(_jt(x), cache=jm.self_attn.gen_cache(_jt(x)))
    po, pc = pm(_pt(x), cache=pm.self_attn.gen_cache(_pt(x)))
    _close(po, jo)
    _close(pc.k, jc.k)


def test_decoder_layer_accepts_and_ignores_its_cache():
    """As the JAX layer (``transformer.py:213-233``), the decoder layer's
    ``cache`` argument changes nothing and is not returned."""
    jm, pm = _pair(20, lambda: jnn.TransformerDecoderLayer(D, NH, FF, 0.0),
                   lambda: pnn.TransformerDecoderLayer(D, NH, FF, 0.0,
                                                       device="cpu"))
    tgt, mem = _x(21, 2, 4, D), _x(22, 2, 6, D)
    want = jm(_jt(tgt), _jt(mem), cache=object())
    plain = pm(_pt(tgt), _pt(mem))
    got = pm(_pt(tgt), _pt(mem), cache=object())
    assert torch.is_tensor(got)
    assert torch.equal(got, plain)
    _close(got, want)


def test_generate_square_subsequent_mask_is_the_jax_mask():
    """0 on and below the diagonal, -1e9 (not -inf) above, float32."""
    pm = pnn.Transformer(D, NH, 1, 1, FF, device="cpu")
    paddle.seed(0)
    jm = jnn.Transformer(D, NH, 1, 1, FF)
    got = pm.generate_square_subsequent_mask(6)
    assert got.dtype == torch.float32
    assert torch.equal(got, _pt(np.asarray(
        jm.generate_square_subsequent_mask(6)._data)))
    assert float(got.min()) == -1e9 and bool(torch.isfinite(got).all())


def test_custom_encoder_and_decoder():
    """``custom_encoder`` / ``custom_decoder`` replace the stacks, under
    the JAX names."""
    def make(mod, **kw):
        enc = mod.TransformerEncoder(mod.TransformerEncoderLayer(
            D, NH, FF, 0.0, **kw), 1)
        dec = mod.TransformerDecoder(mod.TransformerDecoderLayer(
            D, NH, FF, 0.0, **kw), 1, mod.LayerNorm(D, **kw))
        return mod.Transformer(D, NH, custom_encoder=enc,
                               custom_decoder=dec, **kw)
    jm, pm = _pair(23, lambda: make(jnn), lambda: make(pnn, device="cpu"))
    src, tgt = _x(24, 2, 5, D), _x(25, 2, 4, D)
    _close(pm(_pt(src), _pt(tgt)), jm(_jt(src), _jt(tgt)))


def test_defaults_are_transformer_base():
    """d_model 512, 8 heads, 6 + 6 layers, FFN 2048, dropout 0.1, ReLU,
    post-norm: the JAX defaults, the same parameter count."""
    pm = pnn.Transformer(device="cpu")
    assert (pm.d_model, pm.nhead) == (512, 8)
    assert len(pm.encoder.layers) == 6 and len(pm.decoder.layers) == 6
    layer = pm.encoder.layers[0]
    assert layer.linear1.weight.shape == (512, 2048)
    assert layer.self_attn.dropout == 0.1 and layer.dropout1.p == 0.1
    assert not layer.normalize_before and pm.encoder.norm is None
    assert layer.activation is pnn.functional.relu
    n = sum(p.numel() for p in pm.parameters())
    attn, ffn, ln = 4 * (512 * 512 + 512), 2 * 512 * 2048 + 2048 + 512, 1024
    assert n == 6 * (attn + ffn + 2 * ln) + 6 * (2 * attn + ffn + 3 * ln)


def test_dropout_routes_dense_in_eval_as_jax():
    """A Transformer built with dropout 0.1 (the default) passes
    ``dropout_p=0.1`` to every attention, in eval too, so it never takes
    flash: each of its 6 attentions counts ``sdpa_dense`` (the dense
    attention's middle on the card) and drops nothing; the output equals
    the JAX layer's in eval."""
    jm, pm = _transformer(26, False, dropout=0.1)
    jm.eval()
    pm.eval()
    src, tgt = _x(27, 2, 6, D), _x(28, 2, 6, D)
    before = dict(K.LAUNCHES)
    got = pm(_pt(src), _pt(tgt))
    assert K.LAUNCHES["sdpa_dense"] - before["sdpa_dense"] == 6
    assert K.LAUNCHES["sdpa_plain"] == before["sdpa_plain"]
    _close(got, jm(_jt(src), _jt(tgt)))
    mha = pnn.MultiHeadAttention(64, 1, device="cpu")
    mha.eval()
    before = dict(K.LAUNCHES)
    mha(_pt(_x(29, 1, 4, 64)))
    assert K.LAUNCHES["sdpa_dense"] == before["sdpa_dense"]


def test_training_with_dropout_draws_and_is_deterministic():
    """In training the attention probabilities and the activations are
    dropped under ``framework.random``: two runs from one seed are equal,
    and differ from eval."""
    import paddle_tpu_torch as ptt
    pm = pnn.Transformer(D, NH, 1, 1, FF, device="cpu")
    src, tgt = _pt(_x(30, 2, 6, D)), _pt(_x(31, 2, 6, D))
    outs = []
    for _ in range(2):
        ptt.seed(5)
        outs.append(pm(src, tgt))
    assert torch.equal(outs[0], outs[1])
    pm.eval()
    assert not torch.equal(outs[0], pm(src, tgt))
