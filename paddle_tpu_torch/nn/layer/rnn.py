"""Recurrent layers (``paddle_tpu/nn/layer/rnn.py``): the cells
``SimpleRNNCell``, ``LSTMCell``, ``GRUCell`` (and their base,
``RNNCellBase``), the generic ``RNN`` / ``BiRNN`` over any cell, and the
stacked ``SimpleRNN``, ``LSTM``, ``GRU``.

The JAX package's semantics and names: gates (i, f, g, o) and (r, z, c)
with the reset gate inside the candidate's hidden term; weights ``[G H,
in]`` and ``[G H, H]``, uniform in ``±1/sqrt(H)``; the stacked layers'
parameters ``weight_ih_l{k}[_reverse]``, ``weight_hh_...``,
``bias_ih_...``, ``bias_hh_...``; initial states ``[L D, B, H]`` indexed
``l D + d``; the stacked layers cast their input to fp32 and start from
fp32 zeros, so their outputs are fp32; dropout between layers only in
training (``kernels/dropout.py`` under ``next_key()``). As in JAX,
``LSTM(proj_size=)`` is accepted and ignored, ``sequence_length=``
raises ``NotImplementedError``, a stacked layer's ``bias_*_attr=False``
raises ``ValueError`` (it would make no parameter) while the cells drop
both biases for ``bias_ih_attr=False``.

The recurrence of every step runs through ``kernels/rnn.py``: the stacked
layers make the input term of all steps one product (``torch.addmm``) and
hand each layer and direction to the recurrence kernel, one launch a step;
a cell call is one product and one launch. ``RNN`` and ``BiRNN`` loop over
their cell eagerly, as JAX's do. Each functional is the JAX op of its name
for ``amp.auto_cast``: ``simple_rnn_cell``, ``lstm_cell``, ``gru_cell``,
``rnn``, ``lstm``, ``gru``.
"""
from __future__ import annotations

import functools
import math

import torch

from ... import amp
from ...framework.random import next_key
from ...kernels import dropout as D
from ...kernels import rnn as R
from ..initializer import Uniform
from .layers import Layer


def _promote(*ts):
    """The tensors (or None) in their promoted dtype, as JAX's products
    promote mixed inputs."""
    dt = functools.reduce(torch.promote_types,
                          [t.dtype for t in ts if t is not None])
    return [None if t is None else t.to(dt) for t in ts]


def _fold(mode, b_ih, b_hh):
    """(the biases folded into the input term, the gru candidate's hidden
    bias kept apart)."""
    if b_ih is None:
        return None, None
    if mode != "gru":
        return b_ih + b_hh, None
    H = b_hh.shape[0] // 3
    return b_ih + torch.cat([b_hh[:2 * H], torch.zeros_like(b_hh[2 * H:])]), \
        b_hh[2 * H:]


def _cell(mode, x, h, c, w_ih, w_hh, b_ih, b_hh):
    x, h, c, w_ih, w_hh, b_ih, b_hh = _promote(x, h, c, w_ih, w_hh, b_ih,
                                               b_hh)
    fold, b_hc = _fold(mode, b_ih, b_hh)
    xw = x @ w_ih.t() if fold is None else torch.addmm(fold, x, w_ih.t())
    _, h2, c2 = R.rnn_scan(mode, xw[None], h, c, w_hh, b_hc)
    return h2, c2


@amp.op("simple_rnn_cell")
def simple_rnn_cell(x, h, w_ih, w_hh, b_ih=None, b_hh=None, activation="tanh"):
    """One step of the simple RNN: ``act(x W_ih^T + h W_hh^T + b_ih +
    b_hh)``."""
    return _cell(f"rnn_{activation}", x, h, None, w_ih, w_hh, b_ih, b_hh)[0]


@amp.op("lstm_cell")
def lstm_cell(x, h, c, w_ih, w_hh, b_ih=None, b_hh=None):
    """One LSTM step: ``(h, c)``."""
    return _cell("lstm", x, h, c, w_ih, w_hh, b_ih, b_hh)


@amp.op("gru_cell")
def gru_cell(x, h, w_ih, w_hh, b_ih=None, b_hh=None):
    """One GRU step."""
    return _cell("gru", x, h, None, w_ih, w_hh, b_ih, b_hh)[0]


class _CellBase(Layer):
    def __init__(self, input_size: int, hidden_size: int, n_gates: int,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype, device=device)
        self.input_size = input_size
        self.hidden_size = hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        init = Uniform(-std, std)
        self.weight_ih = self.create_parameter(
            [n_gates * hidden_size, input_size], attr=weight_ih_attr,
            default_initializer=init)
        self.weight_hh = self.create_parameter(
            [n_gates * hidden_size, hidden_size], attr=weight_hh_attr,
            default_initializer=init)
        if bias_ih_attr is False:
            self.bias_ih = self.bias_hh = None
        else:
            self.bias_ih = self.create_parameter(
                [n_gates * hidden_size], attr=bias_ih_attr, is_bias=True,
                default_initializer=init)
            self.bias_hh = self.create_parameter(
                [n_gates * hidden_size], attr=bias_hh_attr, is_bias=True,
                default_initializer=init)

    def _zero_state(self, x):
        return torch.zeros(x.shape[0], self.hidden_size, dtype=torch.float32,
                           device=x.device)

    @property
    def state_shape(self):
        return [(self.hidden_size,)]


RNNCellBase = _CellBase


class SimpleRNNCell(_CellBase):
    """Parity: paddle.nn.SimpleRNNCell."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None, dtype=None):
        super().__init__(input_size, hidden_size, 1, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, name,
                         device=device, dtype=dtype)
        if activation not in ("tanh", "relu"):
            raise ValueError(f"activation must be tanh/relu, got {activation}")
        self.activation = activation

    def forward(self, inputs, states=None):
        h = states if states is not None else self._zero_state(inputs)
        out = simple_rnn_cell(inputs, h, self.weight_ih, self.weight_hh,
                              self.bias_ih, self.bias_hh,
                              activation=self.activation)
        return out, out


class LSTMCell(_CellBase):
    """Parity: paddle.nn.LSTMCell — gates (i, f, g, o); ``proj_size`` is
    accepted and ignored, as in JAX."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 proj_size=None, name=None, *, device=None, dtype=None):
        super().__init__(input_size, hidden_size, 4, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, name,
                         device=device, dtype=dtype)

    def forward(self, inputs, states=None):
        if states is None:
            h = c = self._zero_state(inputs)
        else:
            h, c = states[0], states[1]
        h2, c2 = lstm_cell(inputs, h, c, self.weight_ih, self.weight_hh,
                           self.bias_ih, self.bias_hh)
        return h2, (h2, c2)

    @property
    def state_shape(self):
        return [(self.hidden_size,), (self.hidden_size,)]


class GRUCell(_CellBase):
    """Parity: paddle.nn.GRUCell — gates (r, z, c), the reset gate applied
    to the candidate's hidden term."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, dtype=None):
        super().__init__(input_size, hidden_size, 3, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, name,
                         device=device, dtype=dtype)

    def forward(self, inputs, states=None):
        h = states if states is not None else self._zero_state(inputs)
        out = gru_cell(inputs, h, self.weight_ih, self.weight_hh,
                       self.bias_ih, self.bias_hh)
        return out, out


class RNN(Layer):
    """Parity: paddle.nn.RNN — ``cell`` run over time, eagerly (a cell is
    any Python); ``**kwargs`` go to every call of the cell; the outputs
    stacked in input order."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, **kwargs):
        axis = 0 if self.time_major else 1
        steps = inputs.shape[axis]
        order = range(steps - 1, -1, -1) if self.is_reverse else range(steps)
        states = initial_states
        outs = []
        for t in order:
            out, states = self.cell(inputs.select(axis, t), states, **kwargs)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        return torch.stack(outs, dim=axis), states


class BiRNN(Layer):
    """Parity: paddle.nn.BiRNN — a forward and a reverse ``RNN``, outputs
    concatenated, states ``(s_fw, s_bw)``."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, **kwargs):
        s_fw, s_bw = (initial_states if initial_states is not None
                      else (None, None))
        o_fw, s_fw = self.rnn_fw(inputs, s_fw, **kwargs)
        o_bw, s_bw = self.rnn_bw(inputs, s_bw, **kwargs)
        return torch.cat([o_fw, o_bw], dim=-1), (s_fw, s_bw)


def _stacked(x, h0, c0, *weights, mode, num_layers, num_directions,
             time_major, dropout):
    """The stacked recurrence: ``(y, h_f, c_f)`` (c_f None but for the
    lstm). Each layer and direction: the input term of all steps as one
    ``torch.addmm``, then ``kernels.rnn.rnn_scan``."""
    lstm = mode == "lstm"
    cur = (x if time_major else x.transpose(0, 1)).float()
    h0 = h0.float()
    c0 = c0.float() if lstm else None
    T, B = cur.shape[:2]
    hs_out, cs_out = [], []
    for li in range(num_layers):
        outs = []
        flat = cur.reshape(T * B, cur.shape[-1])
        for d in range(num_directions):
            idx = li * num_directions + d
            wi, wh, bi, bh = (w.float() for w in weights[4 * idx:4 * idx + 4])
            fold, b_hc = _fold(mode, bi, bh)
            xw = torch.addmm(fold, flat, wi.t()).view(T, B, -1)
            y, hT, cT = R.rnn_scan(mode, xw, h0[idx],
                                   c0[idx] if lstm else None, wh, b_hc,
                                   reverse=d == 1)
            hs_out.append(hT)
            if lstm:
                cs_out.append(cT)
            outs.append(y)
        cur = outs[0] if num_directions == 1 else torch.cat(outs, dim=-1)
        if dropout > 0.0 and li < num_layers - 1:
            cur = D.dropout(cur, next_key(), dropout)
    y = cur if time_major else cur.transpose(0, 1)
    return y, torch.stack(hs_out), (torch.stack(cs_out) if lstm else None)


_STACKED_OPS = {name: amp.op(name)(_stacked) for name in ("rnn", "lstm", "gru")}


class _StackedRNNBase(Layer):
    """Multi-layer (optionally bidirectional) recurrent network: one
    recurrence (``kernels.rnn.rnn_scan``) per layer and direction."""

    MODE = ""
    N_GATES = 1

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 device=None, dtype=None):
        super().__init__(dtype=dtype, device=device)
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError(f"direction must be forward/bidirect, "
                             f"got {direction}")
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bidirect = direction != "forward"
        self.num_directions = 2 if self.bidirect else 1
        self.time_major = time_major
        self.dropout = dropout
        self.activation = activation
        std = 1.0 / math.sqrt(hidden_size)
        init = Uniform(-std, std)
        self._weights = []
        for layer_i in range(num_layers):
            for d in range(self.num_directions):
                in_sz = input_size if layer_i == 0 \
                    else hidden_size * self.num_directions
                sfx = f"l{layer_i}" + ("_reverse" if d else "")
                wi = self.create_parameter(
                    [self.N_GATES * hidden_size, in_sz],
                    attr=weight_ih_attr, default_initializer=init)
                wh = self.create_parameter(
                    [self.N_GATES * hidden_size, hidden_size],
                    attr=weight_hh_attr, default_initializer=init)
                bi = self.create_parameter(
                    [self.N_GATES * hidden_size], attr=bias_ih_attr,
                    is_bias=True, default_initializer=init)
                bh = self.create_parameter(
                    [self.N_GATES * hidden_size], attr=bias_hh_attr,
                    is_bias=True, default_initializer=init)
                setattr(self, f"weight_ih_{sfx}", wi)
                setattr(self, f"weight_hh_{sfx}", wh)
                setattr(self, f"bias_ih_{sfx}", bi)
                setattr(self, f"bias_hh_{sfx}", bh)
                self._weights.append((wi, wh, bi, bh))

    def _mode(self):
        return f"rnn_{self.activation}" if self.MODE == "rnn" else self.MODE

    def forward(self, inputs, initial_states=None, sequence_length=None):
        if sequence_length is not None:
            raise NotImplementedError(
                "variable-length sequences: pre-mask the padded steps "
                "(lax.scan path has static length)")
        n_state = self.num_layers * self.num_directions
        is_lstm = self.MODE == "lstm"
        if initial_states is not None:
            if is_lstm:
                h0, c0 = initial_states[0], initial_states[1]
            else:
                h0, c0 = initial_states, None
        else:
            batch = inputs.shape[1] if self.time_major else inputs.shape[0]
            h0 = torch.zeros(n_state, batch, self.hidden_size,
                             dtype=torch.float32, device=inputs.device)
            c0 = torch.zeros_like(h0) if is_lstm else None
        flat_w = [a for grp in self._weights for a in grp]
        y, h_f, c_f = _STACKED_OPS[self.MODE](
            inputs, h0, c0, *flat_w, mode=self._mode(),
            num_layers=self.num_layers, num_directions=self.num_directions,
            time_major=self.time_major,
            dropout=self.dropout if self.training else 0.0)
        if is_lstm:
            return y, (h_f, c_f)
        return y, h_f


class SimpleRNN(_StackedRNNBase):
    """Parity: paddle.nn.SimpleRNN."""
    MODE = "rnn"
    N_GATES = 1


class LSTM(_StackedRNNBase):
    """Parity: paddle.nn.LSTM; ``proj_size`` is accepted and ignored, as in
    JAX."""
    MODE = "lstm"
    N_GATES = 4

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, proj_size=None, name=None, *, device=None,
                 dtype=None):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, "tanh", weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, name,
                         device=device, dtype=dtype)


class GRU(_StackedRNNBase):
    """Parity: paddle.nn.GRU."""
    MODE = "gru"
    N_GATES = 3

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None, dtype=None):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, "tanh", weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, name,
                         device=device, dtype=dtype)


__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "LSTM", "GRU"]
