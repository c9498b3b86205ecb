"""``paddle_tpu_torch.nn``'s stacked ``SimpleRNN`` (tanh and relu),
``LSTM`` and ``GRU`` against ``paddle_tpu/nn/layer/rnn.py`` on the CPU, the
JAX weights carried across as numpy (``state_dict`` names equal to the JAX
``named_state()``): 1 and 2 layers, both directions, both layouts, with
and without initial states (the bidirectional cases in
``test_torch_rnn_bidirect.py``); the outputs, final states and every gradient
(``jax.vjp`` over the JAX layer with its parameters traced, as in
``test_torch_rnn_cells.py``). Also the JAX refusals (``sequence_length``,
a stacked ``bias_*_attr=False``) and ``proj_size`` ignored; the dropout
between layers (0.2) by its moments, only in training, and the same bits
under the same ``framework.random.seed``; ``rnn_scan`` on CPU tensors
being the plain loop, the kernels' ``Function`` never entered (the
Function against the plain loop is a card case of
``test_torch_cuda.py``); and the JAX op names under ``amp.auto_cast``.

Tolerances: fp32 against JAX, outputs within 1e-5 of the largest |value|
(sums in another order, over the steps), gradients within 1e-4 of the
largest; ``rnn_scan`` on the CPU equal to the plain loop bit for bit.
"""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
import paddle_tpu.nn as jnn
from paddle_tpu.tensor import Tensor

import paddle_tpu_torch as ptt
import paddle_tpu_torch.amp as pamp
import paddle_tpu_torch.nn as pnn
from paddle_tpu_torch.kernels import rnn as R
from paddle_tpu_torch.models import load_numpy_state
from paddle_tpu_torch.nn.layer import rnn as L
from test_torch_rnn_cells import _close, _flat, _jax_run, _r

IN, H, B, T = 4, 3, 3, 5


MODES = {
    "tanh": ("SimpleRNN", {}), "relu": ("SimpleRNN", {"activation": "relu"}),
    "lstm": ("LSTM", {}), "gru": ("GRU", {}),
}


def _pair(mode, seed=0, **kw):
    cls, extra = MODES[mode]
    paddle.seed(seed)
    jm = getattr(jnn, cls)(IN, H, **extra, **kw)
    pm = getattr(pnn, cls)(IN, H, device="cpu", **extra, **kw)
    assert list(pm.state_dict()) == list(jm.named_state())
    load_numpy_state(pm, {n: np.asarray(t._data)
                          for n, t in jm.named_state().items()})
    return jm, pm


def stacked_case(mode, layers, direction, time_major, given):
    """One stacked layer against JAX: outputs, final states and every
    gradient (``tests/test_torch_rnn_bidirect.py`` runs the bidirectional
    cases)."""
    jm, pm = _pair(mode, num_layers=layers, direction=direction,
                   time_major=time_major)
    nd = 2 if direction == "bidirect" else 1
    shape = (T, B, IN) if time_major else (B, T, IN)
    arrays = [_r(1, *shape)]
    if given:
        arrays += [_r(2, layers * nd, B, H, scale=0.5)]
        if mode == "lstm":
            arrays += [_r(3, layers * nd, B, H, scale=0.5)]

    def call(m):
        def run(x, *st):
            if not st:
                return m(x)
            return m(x, (st[0], st[1]) if mode == "lstm" else st[0])
        return run
    outs = _flat(call(jm)(*(Tensor(jnp.asarray(a)) for a in arrays)))
    cots = [_r(10 + i, *o.shape) for i, o in enumerate(outs)]
    want = _jax_run(jm, call(jm), arrays, cots)
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    got = _flat(call(pm)(*ts))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want[0]]
    assert all(g.dtype == torch.float32 for g in got)
    params = list(pm.named_parameters())
    grads = torch.autograd.grad(got, ts + [p for _, p in params],
                                [torch.from_numpy(c) for c in cots])
    for a, w in zip(got, want[0]):
        _close(a.detach().numpy(), w, 1e-5)
    for a, w in zip(grads[:len(ts)], want[1]):
        _close(a.numpy(), w, 1e-4)
    for (name, _), g in zip(params, grads[len(ts):]):
        _close(g.numpy(), want[2][name], 1e-4)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("time_major,given", [(False, True), (True, False)],
                         ids=["batch_major-states", "time_major-zeros"])
def test_stacked_layer_matches_jax(mode, layers, time_major, given):
    stacked_case(mode, layers, "forward", time_major, given)


def test_parameter_names_and_shapes_match_jax():
    jm, pm = _pair("gru", num_layers=2, direction="bidirectional")
    assert [(n, tuple(p.shape)) for n, p in pm.state_dict().items()] == \
        [(n, tuple(t._data.shape)) for n, t in jm.named_state().items()]
    assert "weight_ih_l1_reverse" in pm.state_dict()


@pytest.mark.parametrize("mode", list(MODES))
def test_sequence_length_is_refused_as_in_jax(mode):
    jm, pm = _pair(mode)
    x = _r(4, B, T, IN)
    with pytest.raises(NotImplementedError):
        jm(Tensor(jnp.asarray(x)), sequence_length=Tensor(jnp.full(B, T)))
    with pytest.raises(NotImplementedError):
        pm(torch.from_numpy(x), sequence_length=torch.full((B,), T))


@pytest.mark.parametrize("attr", ["bias_ih_attr", "bias_hh_attr"])
@pytest.mark.parametrize("cls", ["SimpleRNN", "LSTM", "GRU"])
def test_stacked_bias_false_raises_as_in_jax(cls, attr):
    with pytest.raises(ValueError):
        getattr(jnn, cls)(IN, H, **{attr: False})
    with pytest.raises(ValueError):
        getattr(pnn, cls)(IN, H, device="cpu", **{attr: False})


def test_bad_direction_raises_as_in_jax():
    with pytest.raises(ValueError):
        jnn.LSTM(IN, H, direction="both")
    with pytest.raises(ValueError):
        pnn.LSTM(IN, H, direction="both", device="cpu")


def test_lstm_proj_size_is_ignored_as_in_jax():
    jm, pm = _pair("lstm", proj_size=2)
    x = _r(5, B, T, IN)
    y, (h, c) = pm(torch.from_numpy(x))
    want = jm(Tensor(jnp.asarray(x)))[0]
    assert tuple(y.shape) == tuple(want._data.shape) == (B, T, H)
    _close(y.detach().numpy(), want._data, 1e-5)
    cell = pnn.LSTMCell(IN, H, proj_size=2, device="cpu")
    assert tuple(cell(torch.from_numpy(x[:, 0]))[0].shape) == (B, H)


def _dropout_record():
    """``kernels.dropout.dropout`` as the layer calls it, each (input,
    output) recorded."""
    seen = []
    real = L.D.dropout

    def record(x, key, p, *a, **k):
        y = real(x, key, p, *a, **k)
        seen.append((x.detach(), y.detach(), p))
        return y
    return seen, mock.patch.object(L.D, "dropout", record)


def test_dropout_between_layers_by_its_moments():
    """LSTM(2 layers, dropout 0.2) in training: the first layer's output
    dropped once (between the layers, never after the last), 20% of it
    zeroed (within 0.01 over 30,720 elements), the rest divided by 0.8;
    in eval nothing is dropped."""
    pm = pnn.LSTM(8, 32, num_layers=2, dropout=0.2, device="cpu")
    x = torch.from_numpy(_r(6, 64, 15, 8))
    seen, patch = _dropout_record()
    ptt.seed(7)
    with patch:
        pm(x)
    assert len(seen) == 1
    inp, out, p = seen[0]
    assert p == 0.2 and tuple(inp.shape) == (15, 64, 32)
    dropped = out == 0
    assert abs(float(dropped.float().mean()) - 0.2) < 0.01
    kept = ~dropped
    torch.testing.assert_close(out[kept], inp[kept] / 0.8, rtol=1e-6,
                               atol=0)
    pm.eval()
    seen.clear()
    with patch:
        pm(x)
    assert not seen


def test_dropout_follows_the_framework_seed():
    pm = pnn.GRU(IN, H, num_layers=3, dropout=0.2, device="cpu")
    x = torch.from_numpy(_r(8, B, T, IN))
    runs = []
    for s in (11, 11, 12):
        ptt.seed(s)
        runs.append(pm(x)[0])
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


@pytest.mark.parametrize("mode", list(R.MODES))
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_on_cpu_tensors_is_the_plain_loop(mode, reverse):
    """On CPU tensors ``rnn_scan`` runs ``rnn_scan_plain`` and never the
    kernels' ``Function``: the same outputs and gradients, bit for bit."""
    G = R.GATES[mode]
    rng = np.random.default_rng(13)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).requires_grad_()
    xw, h0, w = t(6, 4, G * 5), t(4, 5), t(G * 5, 5)
    c0 = t(4, 5) if mode == "lstm" else None
    b = t(5) if mode == "gru" else None
    ins = [v for v in (xw, h0, c0, w, b) if v is not None]
    with mock.patch.object(R.RNNScanFunction, "apply",
                           side_effect=AssertionError("kernel path")):
        got = [o for o in R.rnn_scan(mode, xw, h0, c0, w, b, reverse)
               if o is not None]
    want = [o for o in R.rnn_scan_plain(mode, xw, h0, c0, w, b, reverse)
            if o is not None]
    cots = [torch.from_numpy(rng.standard_normal(tuple(o.shape)))
            for o in want]
    for a, e in zip(got + list(torch.autograd.grad(got, ins, cots)),
                    want + list(torch.autograd.grad(want, ins, cots))):
        assert torch.equal(a, e)


def test_scan_refuses_shapes_that_disagree():
    with pytest.raises(ValueError):
        R.rnn_scan("lstm", torch.zeros(2, 3, 12), torch.zeros(3, 4), None,
                   torch.zeros(16, 4))
    with pytest.raises(ValueError):
        R.rnn_scan("gru", torch.zeros(2, 3, 12), torch.zeros(3, 4), None,
                   torch.zeros(12, 4), torch.zeros(5))
    with pytest.raises(ValueError):
        R.rnn_scan("elman", torch.zeros(2, 3, 4), torch.zeros(3, 4), None,
                   torch.zeros(4, 4))


@pytest.mark.parametrize("op,cls", [("lstm_cell", "LSTMCell"),
                                    ("gru_cell", "GRUCell"),
                                    ("simple_rnn_cell", "SimpleRNNCell")])
def test_amp_o2_casts_by_the_jax_op_names(op, cls):
    """Under ``auto_cast(level="O2")`` a cell computes in bf16, as in JAX;
    with the op's name in the custom black list it stays fp32: the dtypes
    equal JAX's."""
    x = _r(15, B, IN)
    paddle.seed(16)
    jm = getattr(jnn, cls)(IN, H)
    pm = getattr(pnn, cls)(IN, H, device="cpu")
    for black in (None, {op}):
        kw = {} if black is None else {"custom_black_list": black}
        with jamp.auto_cast(level="O2", dtype="bfloat16", **kw):
            want = jm(Tensor(jnp.asarray(x)))[0]._data.dtype
        with pamp.auto_cast(level="O2", dtype="bfloat16", **kw):
            got = pm(torch.from_numpy(x))[0].dtype
        assert str(got).replace("torch.", "") == str(want), (black, got,
                                                             want)


def test_stacked_layer_under_amp_o2_computes_in_fp32():
    """The stacked layers cast their input and states to fp32 (the JAX
    layer's code); under O2 the JAX layer's scan then meets bf16 initial
    states and raises (ROADMAP Queue 3), the port runs in fp32."""
    pm = pnn.LSTM(IN, H, device="cpu")
    x = torch.from_numpy(_r(17, B, T, IN))
    want = pm(x)[0]
    with pamp.auto_cast(level="O2", dtype="bfloat16"):
        got = pm(x)[0]
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-2)
