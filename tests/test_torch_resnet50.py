"""paddle_tpu_torch's ResNet-50 against paddle_tpu's, on the CPU: the
bottleneck layout (3, 4, 6, 3 blocks; 25.6M parameters and 53 BatchNorms
at 1000 classes) at ``num_classes=5`` on [4, 3, 32, 32]: names, the
training forward with its running statistics, the eval forward.

Weights and BatchNorm buffers go across with ``load_numpy_state``;
inputs are made with numpy from a seed.

Tolerances, float32: at 32 x 32 inputs layer4's maps are 1 x 1, so its
BatchNorms normalise over the batch's 4 values, which magnifies the
rounding differences of the layers before (fp32 sums in another order):
the training forward is held to 5e-3 relative L2 (1e-3 measured) and the
running statistics to 1e-3 of each buffer's largest value; the eval
forward (the running statistics) to 1e-4 of the largest value.
"""
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu as paddle
from paddle_tpu.tensor import Tensor
from paddle_tpu.vision.models import resnet as jres

from paddle_tpu_torch.models import load_numpy_state
from paddle_tpu_torch.nn import BatchNorm2D
from paddle_tpu_torch.vision.models import resnet as pres


def _jt(a):
    return Tensor(jnp.asarray(a))


def _pt(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _state(jm):
    return {n: np.asarray(t._data) for n, t in jm.named_state().items()}


def _rel_close(got, want, rtol):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def test_resnet50_forward_matches_jax():
    """ResNet-50's bottleneck layout (3, 4, 6, 3 blocks, 25.6M parameters
    and 53 BatchNorms at 1000 classes) at 5 classes: names, the training
    forward with its running statistics, the eval forward."""
    paddle.seed(45)
    jm = jres.resnet50(num_classes=5)
    pm = pres.resnet50(num_classes=5, device="cpu")
    assert sorted(pm.state_dict()) == sorted(_state(jm))
    load_numpy_state(pm, _state(jm))
    x = np.random.default_rng(45).standard_normal((4, 3, 32, 32)) \
        .astype(np.float32)
    got = pm(_pt(x)).detach().numpy()
    want = np.asarray(jm(_jt(x))._data)
    assert np.linalg.norm(got - want) <= 5e-3 * np.linalg.norm(want)
    stats = _state(jm)
    for n, b in pm.named_buffers():
        _rel_close(b.numpy(), stats[n], 1e-3)
    jm.eval()
    pm.eval()
    with torch.no_grad():
        _rel_close(pm(_pt(x)).numpy(), jm(_jt(x))._data, 1e-4)
    full = pres.resnet50(device="meta", generator=torch.Generator())
    assert sum(p.numel() for p in full.parameters()) == 25557032
    assert sum(1 for m in full.modules() if isinstance(m, BatchNorm2D)) \
        == 53
