"""paddle_tpu_torch's ResNet trainer against the JAX package's eager
loop, on the CPU: resnet18 at ``num_classes=5`` on [4, 3, 32, 32], 2
steps of ``Momentum(0.01, momentum=0.9)`` with ``L2Decay(1e-4)``; the
BatchNorm running statistics after them against the JAX eager loop
(``loss.backward(); opt.step()``), because the JAX trainer drops them
(F11: ``test_torch_resnet_train.py``). The port's trainer updates them
in place, as a captured step's replay does on the card.

Weights go across with ``load_numpy_state``; inputs are made with numpy
from a seed.

Tolerance, float32: each running statistic within 1e-3 of its buffer's
largest value (those of layer4 are means over the batch's 4 values of
activations that differ by about that much: ``test_torch_resnet.py``).
"""
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.regularizer import L2Decay as JaxL2Decay
from paddle_tpu.tensor import Tensor
from paddle_tpu.vision.models import resnet as jres

from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.models import load_numpy_state
from paddle_tpu_torch.nn import CrossEntropyLoss
from paddle_tpu_torch.parallel import SpmdTrainer
from paddle_tpu_torch.regularizer import L2Decay
from paddle_tpu_torch.vision.models import resnet as pres

LR = 0.01


def _jt(a):
    return Tensor(jnp.asarray(a))


def _state(jm):
    return {n: np.asarray(t._data) for n, t in jm.named_state().items()}


def test_running_statistics_match_the_jax_eager_loop():
    paddle.seed(52)
    je = jres.resnet18(num_classes=5)
    init = _state(je)
    rng = np.random.default_rng(51)
    x = rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
    y = rng.integers(0, 5, 4)
    eager = jopt.Momentum(learning_rate=LR, momentum=0.9,
                          parameters=je.parameters(),
                          weight_decay=JaxL2Decay(1e-4))
    for _ in range(2):
        loss = paddle.nn.CrossEntropyLoss()(je(_jt(x)), _jt(y))
        loss.backward()
        eager.step()
        eager.clear_grad()
    pm = pres.resnet18(num_classes=5, device="cpu")
    load_numpy_state(pm, init)
    tr = SpmdTrainer(pm, opt.Momentum(learning_rate=LR, momentum=0.9,
                                      parameters=pm.parameters(),
                                      weight_decay=L2Decay(1e-4)),
                     lambda m, a, b: CrossEntropyLoss()(m(a), b))
    for _ in range(2):
        tr.train_step(torch.from_numpy(x), torch.from_numpy(y))
    want = _state(je)
    for n, b in pm.named_buffers():
        w = want[n]
        assert np.abs(b.numpy() - w).max() <= 1e-3 * np.abs(w).max(), n
        assert np.abs(w).max() > 0 and np.abs(b.numpy()).max() > 0, n
