"""paddle_tpu_torch's ResNet-18 against paddle_tpu's, on the CPU: the
cross-entropy loss of ``resnet18(num_classes=5)`` in training on [4, 3,
32, 32] and every parameter's gradient, with the JAX weights and buffers
carried across by ``load_numpy_state``; inputs made with numpy from a
seed.

Tolerances, float32: the loss 1e-4 relative; each gradient 1e-3 relative
L2 (the backward through every BatchNorm's batch statistics, in another
order; layer4's normalise 1 x 1 maps over the batch's 4 values, which
magnifies the rounding differences of the layers before).
"""
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu as paddle
from paddle_tpu.tensor import Tensor
from paddle_tpu.vision.models import resnet as jres

from paddle_tpu_torch.models import load_numpy_state
from paddle_tpu_torch.nn import CrossEntropyLoss
from paddle_tpu_torch.vision.models import resnet as pres


def _jt(a):
    return Tensor(jnp.asarray(a))


def _pt(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _state(jm):
    return {n: np.asarray(t._data) for n, t in jm.named_state().items()}


def test_resnet18_loss_and_every_gradient_match_jax():
    paddle.seed(42)
    jm = jres.resnet18(num_classes=5)
    pm = pres.resnet18(num_classes=5, device="cpu")
    load_numpy_state(pm, _state(jm))
    rng = np.random.default_rng(44)
    x = rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
    y = rng.integers(0, 5, 4)
    jloss = paddle.nn.CrossEntropyLoss()(jm(_jt(x)), _jt(y))
    jloss.backward()
    loss = CrossEntropyLoss()(pm(_pt(x)), _pt(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss.numpy()),
                               rtol=1e-4)
    want = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    for n, p in pm.named_parameters():
        w = want[n]
        err = np.linalg.norm(p.grad.numpy() - w) / max(np.linalg.norm(w),
                                                      1e-30)
        assert err <= 1e-3, (n, err)
