"""The public names of ``paddle_tpu.nn`` and ``paddle_tpu.nn.functional``
that ``paddle_tpu_torch.nn`` / ``.functional`` lack must be exactly the
names still waiting, each tagged with its ROADMAP Queue 1 item: a name
that goes missing from a ported slice (or one ported without leaving this
list) fails here. Also the repairs of names that were missing from ported
slices: the in-place activations (the JAX ``make_inplace``: x takes the
result and is returned) against the JAX functions, and the gradient
clips exported from ``nn``.

Tolerances: fp32 elementwise functions, 1e-6 of the largest |value|.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.tensor import Tensor

import paddle_tpu_torch.nn as pnn
import paddle_tpu_torch.optimizer as popt
from paddle_tpu_torch.nn import functional as F

CONV_POOL_VISION = "Queue 1 item 2b (convolutions, pools, vision.py)"

WAITING_NN = {
    **{n: CONV_POOL_VISION for n in (
        "AdaptiveAvgPool1D", "AdaptiveAvgPool3D", "AdaptiveMaxPool1D",
        "AdaptiveMaxPool2D", "AdaptiveMaxPool3D", "AvgPool1D", "AvgPool2D",
        "AvgPool3D", "Conv1D", "Conv1DTranspose", "Conv2DTranspose",
        "Conv3D", "Conv3DTranspose", "FractionalMaxPool2D",
        "FractionalMaxPool3D", "LPPool1D", "LPPool2D", "MaxPool1D",
        "MaxPool3D", "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D")},
}

WAITING_FUNCTIONAL = {
    **{n: CONV_POOL_VISION for n in (
        "adaptive_avg_pool1d", "adaptive_avg_pool3d", "adaptive_max_pool1d",
        "adaptive_max_pool2d", "adaptive_max_pool3d", "affine_grid",
        "avg_pool1d", "avg_pool2d", "avg_pool3d", "conv1d",
        "conv1d_transpose", "conv2d_transpose", "conv3d", "conv3d_transpose",
        "fractional_max_pool2d", "fractional_max_pool3d", "grid_sample",
        "lp_pool1d", "lp_pool2d", "max_pool1d", "max_pool3d",
        "max_unpool1d", "max_unpool2d", "max_unpool3d", "temporal_shift")},
}


def _public(module):
    return {n for n in dir(module) if not n.startswith("_")
            and not isinstance(getattr(module, n), types.ModuleType)}


@pytest.mark.parametrize("jax_mod,port_mod,waiting", [
    (jnn, pnn, WAITING_NN), (JF, F, WAITING_FUNCTIONAL)],
    ids=["nn", "nn.functional"])
def test_missing_names_are_the_waiting_list(jax_mod, port_mod, waiting):
    missing = _public(jax_mod) - set(dir(port_mod))
    assert missing == set(waiting), (
        f"missing but not waiting: {sorted(missing - set(waiting))}; "
        f"waiting but present: {sorted(set(waiting) - missing)}")


@pytest.mark.parametrize("name", ["MultiHeadAttention", "Transformer",
                                  "TransformerEncoderLayer",
                                  "TransformerDecoder", "LSTM", "GRU",
                                  "SimpleRNN", "LSTMCell", "GRUCell",
                                  "SimpleRNNCell", "RNN", "BiRNN",
                                  "RNNCellBase", "BeamSearchDecoder",
                                  "dynamic_decode"])
def test_this_slices_layers_are_in_nn(name):
    assert name in pnn.__all__ and hasattr(pnn, name)


@pytest.mark.parametrize("name", ["sequence_mask", "gather_tree"])
def test_the_seq2seq_functionals_are_in_nn_functional(name):
    assert name in F.__all__ and hasattr(F, name)


@pytest.mark.parametrize("name,args", [
    ("elu_", (0.7,)), ("hardtanh_", (-0.5, 0.8)), ("leaky_relu_", (0.2,)),
    ("tanh_", ()), ("thresholded_relu_", (0.3,))])
def test_inplace_activations_match_jax(name, args):
    """x takes the JAX result and is returned; a gradient flows to what x
    was before the call (the JAX function rebinds x to its output)."""
    x = np.random.default_rng(1).standard_normal((4, 6)).astype(np.float32)
    want = getattr(JF, name)(Tensor(jnp.asarray(x)), *args)
    t = torch.from_numpy(x.copy())
    out = getattr(F, name)(t, *args)
    assert out is t
    np.testing.assert_allclose(t.numpy(), np.asarray(want._data), rtol=0,
                               atol=1e-6 * max(1.0, np.abs(x).max()))
    leaf = torch.from_numpy(x.copy()).requires_grad_()
    y = getattr(F, name)(leaf * 1.0, *args)
    (g,) = torch.autograd.grad(y.sum(), leaf)
    (w,) = torch.autograd.grad(getattr(F, name[:-1])(
        leaf, *args).sum(), leaf)
    assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["ClipGradByGlobalNorm", "ClipGradByNorm",
                                  "ClipGradByValue"])
def test_gradient_clips_are_exported_from_nn(name):
    """``nn`` exports the clips, the same classes as ``optimizer``'s (the
    JAX ``paddle_tpu/nn/__init__.py:52``)."""
    assert getattr(pnn, name) is getattr(popt, name)
    assert name in pnn.__all__
