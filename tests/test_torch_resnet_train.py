"""paddle_tpu_torch's ResNet trained against paddle_tpu's, on the CPU:
resnet18 at ``num_classes=5`` on [4, 3, 32, 32], 2 SpmdTrainer steps
with ``Momentum(0.01, momentum=0.9)`` and ``L2Decay(1e-4)``: losses and
weights against the JAX trainer, and F11 (the JAX trainer drops the
BatchNorm running statistics; the port's updates them). The running
statistics go against the JAX eager loop in
``test_torch_resnet_running_stats.py``.

Weights and buffers go across with ``load_numpy_state``; inputs are made
with numpy from a seed.

Tolerances, float32: losses 1e-4 relative; each parameter's change over
the 2 steps within 1e-3 relative L2 of the JAX trainer's (the gradients
agree to 1e-3 relative L2 through layer4's BatchNorms over 4 values:
``test_torch_resnet.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.parallel.trainer import SpmdTrainer as JaxTrainer
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


def _pt(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _state(jm):
    return {n: np.asarray(t._data) for n, t in jm.named_state().items()}


def _batch():
    rng = np.random.default_rng(51)
    return (rng.standard_normal((4, 3, 32, 32)).astype(np.float32),
            rng.integers(0, 5, 4))


def _jax_loss(m, x, y):
    return paddle.nn.CrossEntropyLoss()(m(x), y)


def _loss(m, x, y):
    return CrossEntropyLoss()(m(x), y)


def _jax_opt(m):
    return jopt.Momentum(learning_rate=LR, momentum=0.9,
                         parameters=m.parameters(),
                         weight_decay=JaxL2Decay(1e-4))


@pytest.fixture(scope="module")
def runs():
    """(JAX trainer model, port trainer model, the two trainers' losses,
    the initial state) after 2 steps from one set of weights."""
    paddle.seed(52)
    jm = jres.resnet18(num_classes=5)
    init = _state(jm)
    x, y = _batch()
    jtr = JaxTrainer(jm, _jax_opt(jm), _jax_loss, mesh=None)
    want = [float(jtr.train_step(_jt(x), _jt(y)).numpy()) for _ in range(2)]
    pm = pres.resnet18(num_classes=5, device="cpu")
    load_numpy_state(pm, init)
    ptr = SpmdTrainer(pm, opt.Momentum(learning_rate=LR, momentum=0.9,
                                       parameters=pm.parameters(),
                                       weight_decay=L2Decay(1e-4)), _loss)
    got = [float(ptr.train_step(_pt(x), _pt(y))) for _ in range(2)]
    return jm, pm, want, got, init


def test_trainer_steps_match_jax(runs):
    """Losses, and each parameter's change over the 2 steps."""
    jm, pm, want, got, init = runs
    np.testing.assert_allclose(got, want, rtol=1e-4)
    jw = {n: np.asarray(p._data) - init[n] for n, p in jm.named_parameters()}
    for n, p in pm.named_parameters():
        d = p.detach().numpy() - init[n]
        err = np.linalg.norm(d - jw[n]) / np.linalg.norm(jw[n])
        assert err <= 1e-3, (n, err)


def test_f11_jax_trainer_drops_batch_norm_running_statistics(runs):
    """F11: the JAX ``SpmdTrainer`` leaves every running mean at 0 and
    variance at 1 after its steps (``batch_norm`` assigns the buffers
    eagerly, ``paddle_tpu/nn/functional/norm.py:110-117``, and under the
    trainer's jit the assignment never reaches them), while the port's
    trainer updates them (as the JAX eager loop does:
    ``test_torch_resnet_running_stats.py``)."""
    jm, pm, _, _, _ = runs
    trained = _state(jm)
    means = [n for n in trained if n.endswith("._mean")]
    assert len(means) == 20
    for n in means:
        assert not trained[n].any(), n
        assert (trained[n.replace("_mean", "_variance")] == 1).all()
        assert float(getattr(pm.get_submodule(n.rsplit(".", 1)[0]),
                             "_mean").abs().max()) > 0
