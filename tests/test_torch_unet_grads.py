"""paddle_tpu_torch's Stable Diffusion UNet against paddle_tpu's, on the
CPU: the denoising loss and every parameter's gradient.

The tiny UNet of ``test_torch_unet.py`` (``UNetConfig.tiny(ch=(16, 32),
cross=16, groups=4)``) with the JAX weights carried across by
``load_numpy_state``; the loss is ``mean((unet(x, t, ctx) - noise)^2)``
on [2, 4, 8, 8] latents, timesteps [10, 999] and a [2, 5, 16] context,
made with numpy from a seed.

Tolerances, float32: the loss 1e-6 relative; each gradient 1e-4 relative
L2 (sums over the batch and the latent of products through every layer,
in another order).
"""
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu as paddle
from paddle_tpu.models import unet as junet
from paddle_tpu.tensor import Tensor

from paddle_tpu_torch.models import load_numpy_state
from paddle_tpu_torch.models import unet as punet

CFG = dict(ch=(16, 32), cross=16, groups=4)


def _jt(a):
    return Tensor(jnp.asarray(a))


def _pt(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _state(jm):
    return {n: np.asarray(t._data) for n, t in jm.named_state().items()}


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 4, 8, 8)).astype(np.float32),
            np.array([10, 999], np.int64),
            rng.standard_normal((2, 5, 16)).astype(np.float32),
            rng.standard_normal((2, 4, 8, 8)).astype(np.float32))


def _loss(m, x, t, ctx, noise):
    return ((m(x, t, ctx) - noise) ** 2).mean()


def _models(seed):
    paddle.seed(seed)
    jm = junet.UNet2DConditionModel(junet.UNetConfig.tiny(**CFG))
    pm = punet.UNet2DConditionModel(punet.UNetConfig.tiny(**CFG),
                                    device="cpu")
    load_numpy_state(pm, _state(jm))
    return jm, pm


def test_loss_and_every_gradient_match_jax():
    jm, pm = _models(31)
    batch = _batch(1)
    jloss = _loss(jm, *map(_jt, batch))
    jloss.backward()
    loss = _loss(pm, *map(_pt, batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss.numpy()),
                               rtol=1e-6)
    want = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    got = dict(pm.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].grad.numpy()
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= 1e-4, (name, err)
