"""``paddle_tpu_torch.nn``'s RNN cells, and ``RNN`` / ``BiRNN`` over them,
against ``paddle_tpu/nn/layer/rnn.py`` on the CPU, the JAX weights carried
across as numpy (``load_numpy_state``; ``state_dict`` names equal to the
JAX ``named_state()``): outputs, final states, and the gradients of the
inputs, the given states and every parameter, with ``bias_ih_attr=False``
(both biases dropped), reversed and time-major loops and kwargs handed to
the cell.

The JAX gradients come from ``jax.vjp`` over the JAX layer's forward with
its parameters as traced inputs. The JAX package's own tape carries none
through a cell's given states nor through ``RNN``'s and ``BiRNN``'s
outputs (it reads them as raw arrays: ROADMAP Queue 3); traced, the
forward is the function those layers compute, and the port differentiates
that function.

Tolerances: fp32, outputs within 1e-5 of the largest |value| (sums in
another order, over the steps), gradients within 1e-4 of the largest.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.tensor import Tensor

import paddle_tpu_torch.nn as pnn
from paddle_tpu_torch.models import load_numpy_state

IN, H, B, T = 6, 5, 4, 7


def _r(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _carry(jm, pm):
    assert list(pm.state_dict()) == list(jm.named_state())
    load_numpy_state(pm, {n: np.asarray(t._data)
                          for n, t in jm.named_state().items()})


def _flat(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _flat(t)]
    return [tree]


def _jax_run(jm, fn, arrays, cots):
    """(outputs, input gradients, {name: parameter gradient}) of
    ``fn(*Tensors)`` (a tree of Tensors) by ``jax.vjp``, ``jm``'s
    parameters traced."""
    params = list(jm.named_parameters())
    n = len(arrays)

    def f(*a):
        saved = [p._data for _, p in params]
        try:
            for (_, p), v in zip(params, a[n:]):
                p._data = v
            return tuple(t._data for t in _flat(fn(*(Tensor(v)
                                                      for v in a[:n]))))
        finally:
            for (_, p), v in zip(params, saved):
                p._data = v
    outs, vjp = jax.vjp(f, *[jnp.asarray(a) for a in arrays],
                        *[p._data for _, p in params])
    grads = vjp(tuple(jnp.asarray(c) for c in cots))
    return ([np.asarray(o) for o in outs], [np.asarray(g) for g in grads[:n]],
            {name: np.asarray(g) for (name, _), g in zip(params, grads[n:])})


def _port_run(pm, fn, arrays, cots):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    outs = _flat(fn(*ts))
    params = list(pm.named_parameters())
    grads = torch.autograd.grad(
        outs, ts + [p for _, p in params],
        [torch.from_numpy(c) for c in cots])
    return ([o.detach().numpy() for o in outs],
            [g.numpy() for g in grads[:len(ts)]],
            {name: g.numpy() for (name, _), g in zip(params,
                                                     grads[len(ts):])})


def _compare(jm, pm, jfn, pfn, arrays, seed=50):
    """The port against JAX: outputs, input gradients, parameter
    gradients."""
    _carry(jm, pm)
    cots = _cots(jfn, arrays, seed)
    want = _jax_run(jm, jfn, arrays, cots)
    got = _port_run(pm, pfn, arrays, cots)
    assert len(got[0]) == len(want[0])
    for a, w in zip(got[0], want[0]):
        _close(a, w, 1e-5)
    for a, w in zip(got[1], want[1]):
        _close(a, w, 1e-4)
    assert set(got[2]) == set(want[2])
    for name, w in want[2].items():
        _close(got[2][name], w, 1e-4)


def _cots(jfn, arrays, seed):
    """A seeded cotangent for each output of the JAX forward."""
    outs = _flat(jfn(*(Tensor(jnp.asarray(a)) for a in arrays)))
    return [_r(seed + i, *o.shape) for i, o in enumerate(outs)]


CELLS = {
    "tanh": (lambda **k: jnn.SimpleRNNCell(IN, H, **k),
             lambda **k: pnn.SimpleRNNCell(IN, H, device="cpu", **k)),
    "relu": (lambda **k: jnn.SimpleRNNCell(IN, H, "relu", **k),
             lambda **k: pnn.SimpleRNNCell(IN, H, "relu", device="cpu",
                                           **k)),
    "lstm": (lambda **k: jnn.LSTMCell(IN, H, **k),
             lambda **k: pnn.LSTMCell(IN, H, device="cpu", **k)),
    "gru": (lambda **k: jnn.GRUCell(IN, H, **k),
            lambda **k: pnn.GRUCell(IN, H, device="cpu", **k)),
}


def _cell_pair(kind, seed=0, **kw):
    paddle.seed(seed)
    make_j, make_p = CELLS[kind]
    return make_j(**kw), make_p(**kw)


def _states(kind, seed, batch=B):
    h = _r(seed, batch, H, scale=0.5)
    return [h, _r(seed + 1, batch, H, scale=0.5)] if kind == "lstm" else [h]


def _pack(kind, st):
    return (st[0], st[1]) if kind == "lstm" else st[0]


@pytest.mark.parametrize("kind", list(CELLS))
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("given", [True, False])
def test_cell_matches_jax(kind, bias, given):
    """A step from given states (or from zeros): the output, the new
    states and every gradient."""
    kw = {} if bias else {"bias_ih_attr": False}
    jm, pm = _cell_pair(kind, **kw)
    assert (pm.bias_ih is None) == (not bias) == (jm.bias_ih is None)
    arrays = [_r(1, B, IN)] + (_states(kind, 2) if given else [])

    def call(m):
        return lambda x, *st: m(x, _pack(kind, st) if st else None)
    _compare(jm, pm, call(jm), call(pm), arrays)


@pytest.mark.parametrize("kind", list(CELLS))
def test_cell_state_shape_and_zero_state(kind):
    jm, pm = _cell_pair(kind)
    assert pm.state_shape == jm.state_shape
    out, st = pm(torch.zeros(3, IN))
    assert out.dtype == torch.float32 and tuple(out.shape) == (3, H)
    assert isinstance(pm, pnn.RNNCellBase)


def test_cell_promotes_a_bf16_input_as_jax():
    """A bf16 input to a float32 cell computes in float32 (JAX's
    promotion of the mixed product)."""
    jm, pm = _cell_pair("gru")
    _carry(jm, pm)
    x = _r(3, B, IN)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = jm(Tensor(jnp.asarray(xb.float().numpy()).astype(
        jnp.bfloat16)))[0]
    got = pm(xb)[0]
    assert got.dtype == torch.float32
    _close(got.detach().numpy(), np.asarray(want._data, np.float32), 1e-5)


@pytest.mark.parametrize("kind", list(CELLS))
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("time_major", [False, True])
def test_rnn_over_a_cell_matches_jax(kind, reverse, time_major):
    """``RNN``: the outputs stacked in input order, the final states and
    every gradient (through time, from the given states)."""
    jc, pc = _cell_pair(kind, 3)
    jm = jnn.RNN(jc, is_reverse=reverse, time_major=time_major)
    pm = pnn.RNN(pc, is_reverse=reverse, time_major=time_major)
    shape = (T, B, IN) if time_major else (B, T, IN)
    arrays = [_r(4, *shape)] + _states(kind, 5)

    def call(m):
        return lambda x, *st: m(x, _pack(kind, st))
    _compare(jm, pm, call(jm), call(pm), arrays)


class _JScaled(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.cell = jnn.GRUCell(IN, H)

    def forward(self, x, states, scale=1.0, shift=None):
        return self.cell(x * scale + shift, states)


class _PScaled(pnn.Layer):
    def __init__(self):
        super().__init__()
        self.cell = pnn.GRUCell(IN, H, device="cpu")

    def forward(self, x, states, scale=1.0, shift=None):
        return self.cell(x * scale + shift, states)


def test_rnn_hands_kwargs_to_the_cell():
    paddle.seed(6)
    jm, pm = jnn.RNN(_JScaled()), pnn.RNN(_PScaled())
    shift = _r(7, B, IN)

    def call(m, mk):
        return lambda x: m(x, None, scale=0.5, shift=mk(shift))
    jfn = call(jm, lambda a: Tensor(jnp.asarray(a)))
    pfn = call(pm, torch.from_numpy)
    _compare(jm, pm, jfn, pfn, [_r(8, B, T, IN)])


@pytest.mark.parametrize("kind", ["lstm", "gru"])
@pytest.mark.parametrize("time_major", [False, True])
def test_birnn_matches_jax(kind, time_major):
    """``BiRNN``: both directions concatenated, states ``(s_fw, s_bw)``,
    every gradient."""
    paddle.seed(9)
    make_j, make_p = CELLS[kind]
    jm = jnn.BiRNN(make_j(), make_j(), time_major=time_major)
    pm = pnn.BiRNN(make_p(), make_p(), time_major=time_major)
    shape = (T, B, IN) if time_major else (B, T, IN)
    arrays = [_r(10, *shape)] + _states(kind, 11) + _states(kind, 13)
    n = 2 if kind == "lstm" else 1

    def call(m):
        return lambda x, *st: m(x, (_pack(kind, st[:n]),
                                    _pack(kind, st[n:])))
    _compare(jm, pm, call(jm), call(pm), arrays)
    y, (s_fw, s_bw) = pm(torch.from_numpy(arrays[0]))
    assert y.shape[-1] == 2 * H and len(_flat(s_fw)) == n
