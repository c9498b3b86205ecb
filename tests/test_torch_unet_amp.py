"""paddle_tpu_torch's Stable Diffusion UNet against paddle_tpu's under
``amp``, on the CPU: both models decorated at level O2 (bf16 weights) and
run under ``auto_cast(level="O2")``, as the card runs the model in bf16
(the JAX UNet cannot run with bf16 weights outside amp: its float32
timestep embedding promotes the residual stream).

The tiny UNet of ``test_torch_unet.py`` (``UNetConfig.tiny(ch=(16, 32),
cross=16, groups=4)``) with the JAX weights carried across by
``load_numpy_state``, [2, 4, 8, 8] latents, timesteps [10, 999], a [2, 5,
16] context, made with numpy from a seed.

Tolerances (bf16): the port's output within 8 bf16 ulps of the largest
JAX value, and no further from the port's float32 forward than 1.25 times
the JAX O2 output is. Both round at the same ops, in other orders: the
convs' and products' fp32 sums; XLA rounds inside the bf16 SiLU and GELU,
PyTorch once at their end.
"""
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu as paddle
from paddle_tpu.models import unet as junet
from paddle_tpu.tensor import Tensor

from paddle_tpu_torch import amp
from paddle_tpu_torch.models import load_numpy_state
from paddle_tpu_torch.models import unet as punet

CFG = dict(ch=(16, 32), cross=16, groups=4)


def _jt(a):
    return Tensor(jnp.asarray(a))


def _pt(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _state(jm):
    return {n: np.asarray(t._data) for n, t in jm.named_state().items()}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 4, 8, 8)).astype(np.float32),
            np.array([10, 999], np.int64),
            rng.standard_normal((2, 5, 16)).astype(np.float32))


def test_o2_forward_matches_jax_o2():
    """Both models decorated at O2 (bf16 weights) and run under
    ``auto_cast(level="O2")``: bf16 outputs within 8 ulps of the largest
    JAX value, and no further from the float32 forward than the JAX O2
    output (1.25x relative L2)."""
    paddle.seed(24)
    jm = junet.UNet2DConditionModel(junet.UNetConfig.tiny(**CFG))
    pm = punet.UNet2DConditionModel(punet.UNetConfig.tiny(**CFG),
                                    device="cpu")
    load_numpy_state(pm, _state(jm))
    x, t, ctx = _inputs(1)
    with torch.no_grad():
        ref = pm(_pt(x), _pt(t), _pt(ctx)).numpy()
    jm = paddle.amp.decorate(jm, level="O2", dtype="bfloat16")
    with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
        want = jm(_jt(x), _jt(t), _jt(ctx))._data
    assert want.dtype == jnp.bfloat16
    pm = amp.decorate(pm, level="O2", dtype="bfloat16")
    with torch.no_grad(), amp.auto_cast(level="O2", dtype="bfloat16"):
        got = pm(_pt(x), _pt(t), _pt(ctx))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert np.abs(got - want).max() <= 8 * 2.0 ** -7 * np.abs(want).max()
    d_port = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    d_jax = np.linalg.norm(want - ref) / np.linalg.norm(ref)
    assert d_port <= 1.25 * d_jax, (d_port, d_jax)
