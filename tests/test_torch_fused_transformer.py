"""``paddle_tpu_torch.incubate.nn``'s fused Transformer functionals and
layers against ``paddle_tpu/incubate/nn`` on the CPU:
``fused_feedforward`` and ``fused_multi_head_attention`` (pre- and
post-LayerNorm, the packed ``[3, H, D, E]`` and the transposed ``[E, 3E]``
QKV weights, ``cache_kv [2, B, H, T, D]``, an attention mask) with their
gradients, and ``FusedMultiHeadAttention``, ``FusedFeedForward``,
``FusedTransformerEncoderLayer`` and ``FusedBiasDropoutResidualLayerNorm``
with the JAX parameter names and initial distributions, the JAX weights
carried across as numpy. The dropouts are 0 (or the layers in eval)
where outputs are compared: the JAX generator's bits are not the port's;
with a dropout in training both packages drop (the outputs differ from
eval) and the port's two runs from one seed are equal.

Tolerances: fp32, outputs within 1e-5 of the largest |value|, gradients
within 1e-4; initial moments within 5 sigma.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn as jinn
import paddle_tpu.incubate.nn.functional as JIF
from paddle_tpu.tensor import Tensor

import paddle_tpu_torch as ptt
import paddle_tpu_torch.incubate.nn as pinn
from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.incubate.nn import functional as PIF
from paddle_tpu_torch.models import load_numpy_state

E, NH = 32, 4


def _jt(a):
    return None if a is None else Tensor(jnp.asarray(a))


def _pt(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _np(t):
    if isinstance(t, Tensor):
        return np.asarray(t._data)
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, want, tol=1e-5):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _r(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("pre", [False, True])
def test_fused_feedforward_and_gradients_match_jax(pre):
    x, w1, w2 = _r(1, 2, 5, E), _r(2, E, 48, scale=0.2), _r(3, 48, E,
                                                           scale=0.2)
    b1, b2 = _r(4, 48), _r(5, E)
    ln = [_r(6, E) + 1, _r(7, E), _r(8, E) + 1, _r(9, E)]
    g = _r(10, 2, 5, E)
    kw = dict(dropout1_rate=0.0, dropout2_rate=0.0, activation="gelu",
              pre_layer_norm=pre)

    def jf(*a):
        return JIF.fused_feedforward(*(Tensor(t) for t in a), **kw)._data
    args = (x, w1, w2, b1, b2, *ln)
    want, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in args))
    ts = [_pt(a).requires_grad_() for a in args]
    got = PIF.fused_feedforward(*ts, **kw)
    _close(got, want)
    grads = torch.autograd.grad(got, ts, _pt(g), allow_unused=True)
    for a, w in zip(grads, vjp(jnp.asarray(g))):
        if a is None:      # the norm the other setting uses
            assert not np.abs(np.asarray(w)).any()
        else:
            _close(a, w, 1e-4)


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("mask", [False, True])
def test_fused_multi_head_attention_and_gradients_match_jax(pre, mask):
    """The packed [3, H, D, E] weight and bias, pre- or post-LN, with and
    without an additive [b, 1, 1, s] mask; every input's gradient."""
    hd = E // NH
    x = _r(11, 2, 6, E)
    qkvw, qkvb = _r(12, 3, NH, hd, E, scale=0.2), _r(13, 3, NH, hd)
    lw, lb = _r(14, E, E, scale=0.2), _r(15, E)
    pls, plb, ls, lbb = _r(16, E) + 1, _r(17, E), _r(18, E) + 1, _r(19, E)
    m = np.where(np.random.default_rng(20).random((2, 1, 1, 6)) > 0.3, 0.0,
                 -1e9).astype(np.float32) if mask else None
    g = _r(21, 2, 6, E)
    kw = dict(pre_layer_norm=pre, dropout_rate=0.0, attn_dropout_rate=0.0)

    def call(mod, cast, *a):
        return mod.fused_multi_head_attention(
            a[0], a[1], a[2], pre_ln_scale=a[3], pre_ln_bias=a[4],
            ln_scale=a[5], ln_bias=a[6], qkv_bias=a[7], linear_bias=a[8],
            attn_mask=cast(m), **kw)
    args = (x, qkvw, lw, pls, plb, ls, lbb, qkvb, lb)
    want, vjp = jax.vjp(lambda *a: call(JIF, _jt, *(Tensor(t) for t in a))
                        ._data, *(jnp.asarray(a) for a in args))
    ts = [_pt(a).requires_grad_() for a in args]
    got = call(PIF, _pt, *ts)
    _close(got, want)
    grads = torch.autograd.grad(got, ts, _pt(g), allow_unused=True)
    for a, w in zip(grads, vjp(jnp.asarray(g))):
        if a is None:      # the norm the other setting uses
            assert not np.abs(np.asarray(w)).any()
        else:
            _close(a, w, 1e-4)


def test_fused_multi_head_attention_cache_kv_matches_jax():
    """``cache_kv [2, B, H, T, D]`` is extended with this call's keys and
    values (returned beside the output) and attended over whole."""
    hd = E // NH
    x, cache = _r(22, 2, 3, E), _r(23, 2, 2, NH, 4, hd)
    qkvw, lw = _r(24, 3, NH, hd, E, scale=0.2), _r(25, E, E, scale=0.2)
    kw = dict(dropout_rate=0.0, attn_dropout_rate=0.0)
    jo, jc = JIF.fused_multi_head_attention(_jt(x), _jt(qkvw), _jt(lw),
                                            cache_kv=_jt(cache), **kw)
    po, pc = PIF.fused_multi_head_attention(_pt(x), _pt(qkvw), _pt(lw),
                                            cache_kv=_pt(cache), **kw)
    assert tuple(pc.shape) == (2, 2, NH, 7, hd)
    _close(po, jo)
    _close(pc, jc)


def test_fused_multi_head_attention_transposed_weight_matches_jax():
    """``transpose_qkv_wb``: an [E, 3E] weight and a [3E] bias with
    ``num_heads``; without ``num_heads`` it raises, as the JAX function."""
    x, w, b = _r(26, 2, 5, E), _r(27, E, 3 * E, scale=0.2), _r(28, 3 * E)
    lw = _r(29, E, E, scale=0.2)
    kw = dict(dropout_rate=0.0, attn_dropout_rate=0.0, transpose_qkv_wb=True)
    want = JIF.fused_multi_head_attention(_jt(x), _jt(w), _jt(lw),
                                          qkv_bias=_jt(b), num_heads=NH, **kw)
    got = PIF.fused_multi_head_attention(_pt(x), _pt(w), _pt(lw),
                                         qkv_bias=_pt(b), num_heads=NH, **kw)
    _close(got, want)
    with pytest.raises(ValueError):
        PIF.fused_multi_head_attention(_pt(x), _pt(w), _pt(lw), **kw)


def _carry(jm, pm):
    assert list(pm.state_dict()) == list(jm.named_state())
    load_numpy_state(pm, {n: np.asarray(t._data)
                          for n, t in jm.named_state().items()})
    return jm, pm


def _layers(seed, kind, pre, **kw):
    paddle.seed(seed)
    if kind == "attention":
        return _carry(jinn.FusedMultiHeadAttention(
            E, NH, dropout_rate=0.1, attn_dropout_rate=0.1,
            normalize_before=pre, **kw), pinn.FusedMultiHeadAttention(
            E, NH, dropout_rate=0.1, attn_dropout_rate=0.1,
            normalize_before=pre, device="cpu", **kw))
    if kind == "feedforward":
        return _carry(jinn.FusedFeedForward(E, 48, normalize_before=pre,
                                            activation="gelu", **kw),
                      pinn.FusedFeedForward(E, 48, normalize_before=pre,
                                            activation="gelu", device="cpu",
                                            **kw))
    return _carry(jinn.FusedTransformerEncoderLayer(
        E, NH, 48, normalize_before=pre, **kw),
        pinn.FusedTransformerEncoderLayer(E, NH, 48, normalize_before=pre,
                                          device="cpu", **kw))


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("kind", ["attention", "feedforward", "encoder"])
def test_fused_layers_match_jax_in_eval(kind, pre):
    """In eval (no dropout) each layer's output equals the JAX layer's
    with its weights; in training it drops (the output differs) and two
    runs from one seed are equal."""
    jm, pm = _layers(30, kind, pre)
    x = _r(31, 2, 6, E)
    mask = np.where(np.random.default_rng(32).random((2, 1, 1, 6)) > 0.3,
                    0.0, -1e9).astype(np.float32)
    extra_j = () if kind == "feedforward" else (_jt(mask),)
    extra_p = () if kind == "feedforward" else (_pt(mask),)
    runs = []
    for _ in range(2):
        ptt.seed(33)
        runs.append(pm(_pt(x), *extra_p))
    assert torch.equal(runs[0], runs[1])
    jm.eval()
    pm.eval()
    got = pm(_pt(x), *extra_p)
    assert not torch.equal(got, runs[0])
    _close(got, jm(_jt(x), *extra_j))


def test_fused_attention_layer_routes_dense_in_eval():
    """``FusedMultiHeadAttention`` passes ``attn_dropout_rate`` in eval too,
    as the JAX layer: a dense route (``sdpa_dense``) without a mask; the
    functional passes 0 in eval, so it takes flash there."""
    _, pm = _layers(34, "attention", False)
    pm.eval()
    x = _pt(_r(35, 1, 4, E))
    before = dict(K.LAUNCHES)
    pm(x)
    assert K.LAUNCHES["sdpa_dense"] - before["sdpa_dense"] == 1
    before = dict(K.LAUNCHES)
    PIF.fused_multi_head_attention(
        x, pm.qkv_weight, pm.linear_weight, training=False)
    assert K.LAUNCHES["sdpa_dense"] == before["sdpa_dense"]


def test_fused_bias_dropout_residual_layer_norm_layer_matches_jax():
    paddle.seed(36)
    jm, pm = _carry(jinn.FusedBiasDropoutResidualLayerNorm(E, 0.2),
                    pinn.FusedBiasDropoutResidualLayerNorm(E, 0.2,
                                                           device="cpu"))
    jm.eval()
    pm.eval()
    x, r = _r(37, 3, E), _r(38, 3, E)
    with torch.no_grad():
        pm.linear_bias.copy_(_pt(_r(39, E)))
        pm.ln_scale.copy_(_pt(_r(40, E) + 1))
    jm.linear_bias._data = jnp.asarray(_r(39, E))
    jm.ln_scale._data = jnp.asarray(_r(40, E) + 1)
    _close(pm(_pt(x), _pt(r)), jm(_jt(x), _jt(r)))


def test_fused_parameters_and_initial_distributions():
    """The JAX names and shapes; weights Xavier-normal (std sqrt(2 / (fan
    in + fan out)) as the port's initializer reads the shape), scales 1,
    biases 0."""
    from paddle_tpu_torch.nn.initializer import _fans
    pm = pinn.FusedMultiHeadAttention(256, 8, device="cpu")
    shapes = {n: tuple(p.shape) for n, p in pm.named_parameters()}
    assert shapes == {"qkv_weight": (3, 8, 32, 256), "qkv_bias": (3, 8, 32),
                      "linear_weight": (256, 256), "linear_bias": (256,),
                      "pre_ln_scale": (256,), "pre_ln_bias": (256,),
                      "ln_scale": (256,), "ln_bias": (256,)}
    for name in ("qkv_weight", "linear_weight"):
        w = getattr(pm, name).detach()
        fi, fo = _fans(tuple(w.shape))
        std = (2.0 / (fi + fo)) ** 0.5
        n = w.numel()
        assert abs(float(w.mean())) <= 5 * std / n ** 0.5
        assert abs(float(w.std()) / std - 1) <= 5 * (0.5 / n) ** 0.5
    assert torch.equal(pm.ln_scale, torch.ones(256))
    assert not pm.qkv_bias.any() and not pm.ln_bias.any()
    ff = pinn.FusedFeedForward(64, 128, device="cpu")
    assert [n for n, _ in ff.named_parameters()] == [
        "linear1_weight", "linear1_bias", "linear2_weight", "linear2_bias",
        "ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias"]
