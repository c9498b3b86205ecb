"""paddle_tpu_torch's ResNet against paddle_tpu's, on the CPU:
``BasicBlock`` and ``BottleneckBlock`` (with a downsample branch), and
``resnet18`` at ``num_classes=5`` on [4, 3, 32, 32], in training (batch
statistics; the running statistics updated in place) and in eval (the
running statistics). Its gradients are in ``test_torch_resnet_grads.py``,
``resnet50`` in ``test_torch_resnet50.py``; trainer steps and the JAX
trainer's BatchNorm fault (F11) in ``test_torch_resnet_train.py``, the
running statistics against the JAX eager loop in
``test_torch_resnet_running_stats.py``.

Weights and BatchNorm buffers go across with ``load_numpy_state``;
inputs are made with numpy from a seed.

Tolerances, float32: outputs 1e-4 of the largest value (fp32 sums in
another order through up to 50 conv + BatchNorm layers, each batch
statistic a mean over 4 x H x W values); running statistics 1e-4
of each buffer's largest value.
At 32 x 32 inputs layer4's maps are 1 x 1, so its BatchNorms normalise
over the batch's 4 values, which magnifies the rounding differences of
the layers before (``test_torch_resnet50.py`` states what that costs
resnet50).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.tensor import Tensor
from paddle_tpu.vision.models import resnet as jres

from paddle_tpu_torch.models import load_numpy_state
from paddle_tpu_torch.nn import BatchNorm2D, Conv2D
from paddle_tpu_torch.nn import Sequential
from paddle_tpu_torch.vision.models import resnet as pres


def _jt(a):
    return Tensor(jnp.asarray(a))


def _pt(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _state(jm):
    return {n: np.asarray(t._data) for n, t in jm.named_state().items()}


def _rel_close(got, want, rtol=1e-4):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _same_buffers(pm, jm, rtol=1e-4):
    """Every running statistic within ``rtol`` of its buffer's largest
    value."""
    want = _state(jm)
    for n, b in pm.named_buffers():
        _rel_close(b.numpy(), want[n], rtol)


def _block(kind):
    """A JAX block with a downsample branch and the port's, weights and
    buffers carried across."""
    if kind == "basic":
        jb = jres.BasicBlock(8, 16, 2, paddle.nn.Sequential(
            paddle.nn.Conv2D(8, 16, 1, stride=2, bias_attr=False),
            paddle.nn.BatchNorm2D(16)))
        pb = pres.BasicBlock(8, 16, 2, Sequential(
            Conv2D(8, 16, 1, stride=2, bias_attr=False, device="cpu"),
            BatchNorm2D(16, device="cpu")), device="cpu")
    else:
        jb = jres.BottleneckBlock(8, 4, 2, paddle.nn.Sequential(
            paddle.nn.Conv2D(8, 16, 1, stride=2, bias_attr=False),
            paddle.nn.BatchNorm2D(16)))
        pb = pres.BottleneckBlock(8, 4, 2, Sequential(
            Conv2D(8, 16, 1, stride=2, bias_attr=False, device="cpu"),
            BatchNorm2D(16, device="cpu")), device="cpu")
    load_numpy_state(pb, _state(jb))
    return jb, pb


@pytest.mark.parametrize("kind", ["basic", "bottleneck"])
def test_blocks_match_jax_in_train_and_eval(kind):
    paddle.seed(41)
    jb, pb = _block(kind)
    assert sorted(pb.state_dict()) == sorted(_state(jb))
    x = np.random.default_rng(41).standard_normal((4, 8, 10, 10)) \
        .astype(np.float32)
    _rel_close(pb(_pt(x)).detach().numpy(), jb(_jt(x))._data)
    _same_buffers(pb, jb)
    jb.eval()
    pb.eval()
    with torch.no_grad():
        _rel_close(pb(_pt(x)).numpy(), jb(_jt(x))._data)


@pytest.fixture(scope="module")
def resnet18_pair():
    paddle.seed(42)
    jm = jres.resnet18(num_classes=5)
    pm = pres.resnet18(num_classes=5, device="cpu")
    load_numpy_state(pm, _state(jm))
    return jm, pm


def _images(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, 3, 32, 32)).astype(np.float32),
            rng.integers(0, 5, 4))


def test_resnet18_names_forward_and_eval(resnet18_pair):
    jm, pm = resnet18_pair
    assert {n: tuple(t.shape) for n, t in pm.state_dict().items()} == {
        n: a.shape for n, a in _state(jm).items()}
    x, _ = _images(43)
    _rel_close(pm(_pt(x)).detach().numpy(), jm(_jt(x))._data)
    _same_buffers(pm, jm)
    jm.eval()
    pm.eval()
    try:
        with torch.no_grad():
            _rel_close(pm(_pt(x)).numpy(), jm(_jt(x))._data)
    finally:
        jm.train()
        pm.train()


def test_resnet_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pres.resnet18(num_classes=5)
    with pytest.raises(NotImplementedError):
        pres.resnet18(pretrained=True, device="cpu")
