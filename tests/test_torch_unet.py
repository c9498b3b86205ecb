"""paddle_tpu_torch's Stable Diffusion UNet against paddle_tpu's, on the
CPU: the timestep embedding, each block type, the full denoising forward
in float32. The forward under ``amp.auto_cast(level="O2")`` is in
``test_torch_unet_amp.py``, gradients and trainer steps in
``test_torch_unet_train.py``.

A tiny UNet (``UNetConfig.tiny(ch=(16, 32), cross=16, groups=4)``: two
levels, one ResNet block a level, a spatial transformer at level 0 and in
the middle, 4 heads) is built in paddle_tpu and its weights carried across
with ``load_numpy_state``; the port's plain versions then run the same
model on [2, 4, 8, 8] latents, timesteps [10, 999] and a [2, 5, 16]
context. Inputs are made with numpy from a seed.

Tolerances, float32: the embedding within two fp32 ulps of its largest
argument, 2^-13 absolute (sines and cosines of arguments up to 999,
whose frequencies come from exp, which rounds differently in the two
libraries); each block and the full forward 2e-5 of the largest output
value (fp32 sums in another order through the convs, GroupNorms and
attention).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import unet as junet
from paddle_tpu.tensor import Tensor

from paddle_tpu_torch.models import load_numpy_state
from paddle_tpu_torch.models import unet as punet

CFG = dict(ch=(16, 32), cross=16, groups=4)
# two fp32 ulps of the largest argument of the sines (999 x 1): a 1-ulp
# difference in exp's frequencies moves an argument near 999 by about one
ARG_ULPS = 2 * 2.0 ** -14


def _jt(a):
    return Tensor(jnp.asarray(a))


def _pt(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _state(jm):
    return {n: np.asarray(t._data) for n, t in jm.named_state().items()}


def _rel_close(got, want, rtol=2e-5):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 4, 8, 8)).astype(np.float32),
            np.array([10, 999], np.int64),
            rng.standard_normal((2, 5, 16)).astype(np.float32))


@pytest.fixture(scope="module")
def models():
    paddle.seed(21)
    jm = junet.UNet2DConditionModel(junet.UNetConfig.tiny(**CFG))
    pm = punet.UNet2DConditionModel(punet.UNetConfig.tiny(**CFG),
                                    device="cpu")
    load_numpy_state(pm, _state(jm))
    return jm, pm


def test_config_presets_and_names(models):
    jm, pm = models
    assert punet.UNetConfig.sd15() == punet.UNetConfig(
        **vars(junet.UNetConfig.sd15()))
    assert punet.UNetConfig.tiny(**CFG) == punet.UNetConfig(
        **vars(junet.UNetConfig.tiny(**CFG)))
    assert {n: tuple(p.shape) for n, p in pm.named_parameters()} == {
        n: a.shape for n, a in _state(jm).items()}
    assert pm.num_params() == jm.num_params()
    sd = punet.UNet2DConditionModel(punet.UNetConfig.sd15(), device="meta",
                                    generator=torch.Generator())
    assert 805e6 < sd.num_params() < 815e6


def test_timestep_embedding_matches_jax():
    t = np.array([0, 1, 10, 999, 500], np.int64)
    for dim in (16, 320, 7):
        want = np.asarray(junet.timestep_embedding(_jt(t), dim)._data)
        got = punet.timestep_embedding(_pt(t), dim).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ARG_ULPS)


def _block_pair(name):
    """A JAX block and the port's with its weights, and its inputs."""
    rng = np.random.default_rng(22)
    at = dict(device="cpu", dtype=None, generator=None)
    x = rng.standard_normal((2, 16, 6, 6)).astype(np.float32)
    ctx = rng.standard_normal((2, 5, 12)).astype(np.float32)
    temb = rng.standard_normal((2, 24)).astype(np.float32)
    seq = rng.standard_normal((2, 9, 16)).astype(np.float32)
    if name == "resnet":
        jb = junet.ResnetBlock2D(16, 8, 24, 4)
        pb = punet.ResnetBlock2D(16, 8, 24, 4, **at)
        args = (x, temb)
    elif name == "resnet_same":
        jb = junet.ResnetBlock2D(16, 16, 24, 4)
        pb = punet.ResnetBlock2D(16, 16, 24, 4, **at)
        args = (x, temb)
    elif name == "cross_attention":
        jb = junet.CrossAttention(16, 12, 4, 4)
        pb = punet.CrossAttention(16, 12, 4, 4, **at)
        args = (seq, ctx)
    elif name == "self_attention":
        jb = junet.CrossAttention(16, 16, 4, 4)
        pb = punet.CrossAttention(16, 16, 4, 4, **at)
        args = (seq,)
    elif name == "transformer":
        jb = junet.TransformerBlock(16, 12, 4, 4)
        pb = punet.TransformerBlock(16, 12, 4, 4, **at)
        args = (seq, ctx)
    elif name == "spatial_transformer":
        jb = junet.SpatialTransformer(16, 12, 4, 4)
        pb = punet.SpatialTransformer(16, 12, 4, 4, **at)
        args = (x, ctx)
    elif name == "downsample":
        jb, pb, args = junet.Downsample(16), punet.Downsample(16, **at), (x,)
    elif name == "upsample":
        jb, pb, args = junet.Upsample(16), punet.Upsample(16, **at), (x,)
    else:
        jb = junet.TimestepEmbedding(16, 24)
        pb = punet.TimestepEmbedding(16, 24, **at)
        args = (rng.standard_normal((2, 16)).astype(np.float32),)
    return jb, pb, args


@pytest.mark.parametrize("name", ["resnet", "resnet_same", "cross_attention",
                                  "self_attention", "transformer",
                                  "spatial_transformer", "downsample",
                                  "upsample", "time_embedding"])
def test_each_block_matches_jax(name):
    paddle.seed(23)
    jb, pb, args = _block_pair(name)
    assert sorted(n for n, _ in pb.named_parameters()) == sorted(_state(jb))
    load_numpy_state(pb, _state(jb))
    want = np.asarray(jb(*map(_jt, args))._data)
    with torch.no_grad():
        got = pb(*map(_pt, args)).numpy()
    assert got.shape == want.shape
    _rel_close(got, want)


def test_full_forward_matches_jax(models):
    jm, pm = models
    x, t, ctx = _inputs()
    want = np.asarray(jm(_jt(x), _jt(t), _jt(ctx))._data)
    with torch.no_grad():
        got = pm(_pt(x), _pt(t), _pt(ctx)).numpy()
    assert got.shape == (2, 4, 8, 8)
    _rel_close(got, want)


def test_unet_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        punet.UNet2DConditionModel(punet.UNetConfig.tiny(**CFG))
