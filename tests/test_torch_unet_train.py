"""paddle_tpu_torch's Stable Diffusion UNet trained against paddle_tpu's,
on the CPU: 3 SpmdTrainer + AdamW steps (losses and weights) against the
JAX trainer. Every parameter's gradient is in ``test_torch_unet_grads.py``.

The tiny UNet of ``test_torch_unet.py`` (``UNetConfig.tiny(ch=(16, 32),
cross=16, groups=4)``) with the JAX weights carried across by
``load_numpy_state``; the loss is ``mean((unet(x, t, ctx) - noise)^2)``
on [2, 4, 8, 8] latents, timesteps [10, 999] and a [2, 5, 16] context,
made with numpy from a seed.

Tolerances, float32: losses 1e-5 relative, every weight within 1e-5
after 3 steps (AdamW at lr 1e-4 moves each weight by about lr a step, and
the gradients agree to 1e-4 relative: ``test_torch_unet_grads.py``).
"""
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.models import unet as junet
from paddle_tpu.parallel.trainer import SpmdTrainer as JaxTrainer
from paddle_tpu.tensor import Tensor

from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.models import load_numpy_state
from paddle_tpu_torch.models import unet as punet
from paddle_tpu_torch.parallel import SpmdTrainer

CFG = dict(ch=(16, 32), cross=16, groups=4)
LR = 1e-4


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


def test_trainer_steps_match_jax():
    """3 SpmdTrainer + AdamW steps on each side: losses and every
    weight."""
    jm, pm = _models(32)
    batch = _batch(2)
    jtr = JaxTrainer(jm, jopt.AdamW(learning_rate=LR,
                                    parameters=jm.parameters()), _loss,
                     mesh=None)
    ptr = SpmdTrainer(pm, opt.AdamW(learning_rate=LR,
                                    parameters=pm.parameters()), _loss)
    want, got = [], []
    for _ in range(3):
        want.append(float(jtr.train_step(*map(_jt, batch)).numpy()))
        got.append(float(ptr.train_step(*map(_pt, batch))))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    jw = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    for n, p in pm.named_parameters():
        d = np.abs(p.detach().numpy() - jw[n])
        assert d.max() <= 1e-5, (n, float(d.max()))
