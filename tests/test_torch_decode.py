"""``paddle_tpu_torch.nn``'s ``BeamSearchDecoder`` and ``dynamic_decode``,
and ``nn.functional``'s ``gather_tree`` and ``sequence_mask``, against the
JAX package (``paddle_tpu/nn/decode.py``, ``paddle_tpu/ops/special.py``)
on the CPU: beam search over a tiny GRU and a tiny LSTM cell with the JAX
weights carried across as numpy (the sequences, their lengths, the final
cell states, log-probabilities and finished flags, ``output_time_major``,
``return_length``); ties among the candidates (the lower flat index first,
as ``lax.top_k``); a beam that finishes early; ``dynamic_decode``'s kwargs
dropped (a cell that would read them gets none); a decoder other than
beam search; and the two functionals in every form.

Tolerances: tokens, parents, lengths, flags and masks equal; float32
states and log-probabilities within 1e-5 of the largest |value| (sums in
another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.tensor import Tensor

import paddle_tpu_torch.nn as pnn
from paddle_tpu_torch.models import load_numpy_state
from paddle_tpu_torch.nn import functional as F

EMB, H, VOCAB, BATCH = 5, 6, 11, 3
BOS, EOS = 1, 2


def _np(t):
    return np.asarray(t._data) if isinstance(t, Tensor) else \
        t.detach().cpu().numpy()


def _flat(tree):
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _flat(t)]
    return [tree]


def _close(got, want, tol=1e-5):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _model(nn, kind, **dev):
    """A container of the cell, the embedding and the output layer."""
    class Model(nn.Layer):
        def __init__(self):
            super().__init__()
            cls = nn.LSTMCell if kind == "lstm" else nn.GRUCell
            self.cell = cls(EMB, H, **dev)
            self.emb = nn.Embedding(VOCAB, EMB, **dev)
            self.out = nn.Linear(H, VOCAB, **dev)
    return Model()


def _pair(kind, seed=0):
    paddle.seed(seed)
    jm, pm = _model(jnn, kind), _model(pnn, kind, device="cpu")
    assert list(pm.state_dict()) == list(jm.named_state())
    load_numpy_state(pm, {n: np.asarray(t._data)
                          for n, t in jm.named_state().items()})
    return jm, pm


def _inits(kind, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((BATCH, H)).astype(np.float32)
    c = rng.standard_normal((BATCH, H)).astype(np.float32)
    return (h, c) if kind == "lstm" else h


def _wrap(tree, mk):
    if isinstance(tree, tuple):
        return tuple(_wrap(t, mk) for t in tree)
    return mk(tree)


def _decode(nn, m, inits, mk, beam, **kw):
    dec = nn.BeamSearchDecoder(m.cell, BOS, EOS, beam, embedding_fn=m.emb,
                               output_fn=m.out)
    return nn.dynamic_decode(dec, inits=_wrap(inits, mk), **kw)


def _same_decode(got, want):
    seqs, states = got[0], got[1]
    np.testing.assert_array_equal(_np(seqs), _np(want[0]))
    cell_g, lp_g, fin_g = states
    cell_w, lp_w, fin_w = want[1]
    for a, w in zip(_flat(cell_g), _flat(cell_w)):
        _close(a, w)
    _close(lp_g, lp_w)
    np.testing.assert_array_equal(_np(fin_g), _np(fin_w))
    if len(want) == 3:
        np.testing.assert_array_equal(_np(got[2]), _np(want[2]))


@pytest.mark.parametrize("kind", ["gru", "lstm"])
@pytest.mark.parametrize("beam", [1, 4])
@pytest.mark.parametrize("time_major", [False, True])
def test_beam_search_matches_jax(kind, beam, time_major):
    jm, pm = _pair(kind, 1)
    inits = _inits(kind, 2)
    kw = dict(max_step_num=6, output_time_major=time_major,
              return_length=True)
    want = _decode(jnn, jm, inits, lambda a: Tensor(jnp.asarray(a)), beam,
                   **kw)
    with torch.no_grad():
        got = _decode(pnn, pm, inits, torch.from_numpy, beam, **kw)
    _same_decode(got, want)
    shape = (BATCH, beam, got[0].shape[-1 if not time_major else 0])
    assert tuple(got[0].shape) == (shape if not time_major
                                   else (shape[2], BATCH, beam))
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.int32


def test_default_step_limit_and_no_lengths():
    """``max_step_num=None`` is 256 steps, ``return_length=False`` two
    results; the same tokens as JAX."""
    jm, pm = _pair("gru", 3)
    inits = _inits("gru", 4)
    want = _decode(jnn, jm, inits, lambda a: Tensor(jnp.asarray(a)), 2)
    with torch.no_grad():
        got = _decode(pnn, pm, inits, torch.from_numpy, 2)
    assert len(got) == 2
    _same_decode(got, want)
    assert got[0].shape[-1] <= 256


class _Table:
    """An output function that ignores the cell: the same logits row for
    every beam."""

    def __init__(self, row, mk):
        self.row = mk(np.asarray(row, np.float32)[None, :])

    def __call__(self, h):
        if isinstance(self.row, Tensor):
            return Tensor(jnp.broadcast_to(self.row._data,
                                           (h.shape[0], self.row.shape[1])))
        return self.row.expand(h.shape[0], -1)


def _table_decode(nn, m, row, mk, beam, steps):
    dec = nn.BeamSearchDecoder(m.cell, BOS, EOS, beam, embedding_fn=m.emb,
                               output_fn=_Table(row, mk))
    return nn.dynamic_decode(dec, inits=_wrap(_inits("gru", 5), mk),
                             max_step_num=steps, return_length=True)


def test_ties_take_the_lower_flat_index_as_lax_top_k():
    """Three tokens tie at every step: at step 0 beam 0's tokens 3, 4, 5;
    then the nine (beam, token) candidates tie and the lower flat index
    wins, so every beam descends from beam 0 and beam b ends in token
    3 + b; the port equals JAX."""
    jm, pm = _pair("gru", 6)
    row = [0.0] * VOCAB
    row[3] = row[4] = row[5] = 1.0
    want = _table_decode(jnn, jm, row, lambda a: Tensor(jnp.asarray(a)), 3,
                         4)
    with torch.no_grad():
        got = _table_decode(pnn, pm, row, torch.from_numpy, 3, 4)
    _same_decode(got, want)
    seqs = _np(got[0])
    assert (seqs[:, :, :-1] == 3).all()
    assert (seqs[:, :, -1] == np.array([3, 4, 5])).all()


def test_a_beam_that_finishes_early():
    """EOS the likeliest token: beam 0 ends at step 1 and stays frozen on
    EOS (log-probability 0 a step); the others end at step 2; the loop
    stops when all have ended; lengths and flags as JAX's."""
    jm, pm = _pair("gru", 7)
    row = [0.0] * VOCAB
    row[EOS], row[4], row[6] = 3.0, 2.0, 1.5
    want = _table_decode(jnn, jm, row, lambda a: Tensor(jnp.asarray(a)), 3,
                         8)
    with torch.no_grad():
        got = _table_decode(pnn, pm, row, torch.from_numpy, 3, 8)
    _same_decode(got, want)
    assert got[0].shape[-1] < 8
    assert bool(got[1][2].all())
    assert int(got[2].min()) == 1


class _JMemoryCell(jnn.Layer):
    """A GRU cell that adds ``bias`` to its input when given it."""

    def __init__(self):
        super().__init__()
        self.gru = jnn.GRUCell(EMB, H)

    def forward(self, x, states, bias=None):
        return self.gru(x if bias is None else x + bias, states)


class _PMemoryCell(pnn.Layer):
    def __init__(self):
        super().__init__()
        self.gru = pnn.GRUCell(EMB, H, device="cpu")

    def forward(self, x, states, bias=None):
        return self.gru(x if bias is None else x + bias, states)


def test_dynamic_decode_drops_its_kwargs_as_jax():
    """``dynamic_decode(..., bias=...)``: the cell is called without it
    (JAX's behaviour): the same result as with no kwarg, equal to JAX's."""
    paddle.seed(8)
    jc, pc = _JMemoryCell(), _PMemoryCell()
    load_numpy_state(pc, {n: np.asarray(t._data)
                          for n, t in jc.named_state().items()})
    emb_j, out_j = jnn.Embedding(VOCAB, EMB), jnn.Linear(H, VOCAB)
    emb_p = pnn.Embedding(VOCAB, EMB, device="cpu")
    out_p = pnn.Linear(H, VOCAB, device="cpu")
    for j, p in ((emb_j, emb_p), (out_j, out_p)):
        load_numpy_state(p, {n: np.asarray(t._data)
                             for n, t in j.named_state().items()})
    bias = np.full((BATCH * 2, EMB), 5.0, np.float32)
    inits = _inits("gru", 9)

    def run(nn, cell, emb, out, mk, **kw):
        dec = nn.BeamSearchDecoder(cell, BOS, EOS, 2, embedding_fn=emb,
                                   output_fn=out)
        return nn.dynamic_decode(dec, inits=mk(inits), max_step_num=5,
                                 return_length=True, **kw)
    jmk = lambda a: Tensor(jnp.asarray(a))  # noqa: E731
    want = run(jnn, jc, emb_j, out_j, jmk, bias=jmk(bias))
    with torch.no_grad():
        got = run(pnn, pc, emb_p, out_p, torch.from_numpy,
                  bias=torch.from_numpy(bias))
        plain = run(pnn, pc, emb_p, out_p, torch.from_numpy)
    _same_decode(got, want)
    _same_decode(plain, want)


class _JGreedy:
    """A decoder other than beam search: greedy over a GRU cell."""

    def __init__(self, cell, emb, out):
        self.cell, self.emb, self.out = cell, emb, out

    def initialize(self, inits):
        return Tensor(jnp.full((inits.shape[0],), BOS, jnp.int32)), inits

    def step(self, time, inputs, states):
        h, new = self.cell(self.emb(inputs), states)
        tok = Tensor(jnp.argmax(self.out(h)._data, -1).astype(jnp.int32))
        return (tok,), new, tok, Tensor(tok._data == EOS)


class _PGreedy(_JGreedy):
    def initialize(self, inits):
        return torch.full((inits.shape[0],), BOS, dtype=torch.int32), inits

    def step(self, time, inputs, states):
        h, new = self.cell(self.emb(inputs), states)
        tok = self.out(h).argmax(-1).to(torch.int32)
        return (tok,), new, tok, tok == EOS


@pytest.mark.parametrize("time_major", [False, True])
def test_a_decoder_other_than_beam_search(time_major):
    jm, pm = _pair("gru", 10)
    inits = _inits("gru", 11)
    kw = dict(max_step_num=6, output_time_major=time_major,
              return_length=True)
    want = jnn.dynamic_decode(_JGreedy(jm.cell, jm.emb, jm.out),
                              inits=Tensor(jnp.asarray(inits)), **kw)
    with torch.no_grad():
        got = pnn.dynamic_decode(_PGreedy(pm.cell, pm.emb, pm.out),
                                 inits=torch.from_numpy(inits), **kw)
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    _close(got[1], want[1])
    np.testing.assert_array_equal(_np(got[2]), _np(want[2]))


def test_tile_beam_merge_with_batch():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    want = jnn.BeamSearchDecoder.tile_beam_merge_with_batch(
        Tensor(jnp.asarray(x)), 3)
    got = pnn.BeamSearchDecoder.tile_beam_merge_with_batch(
        torch.from_numpy(x), 3)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_tree_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 20, (6, 3, 4))
    parents = rng.integers(0, 4, (6, 3, 4))
    want = JF.gather_tree(Tensor(jnp.asarray(ids)),
                          Tensor(jnp.asarray(parents)))
    got = F.gather_tree(torch.from_numpy(ids), torch.from_numpy(parents))
    np.testing.assert_array_equal(_np(got), _np(want))


def test_gather_tree_follows_the_parents():
    """A hand-made tree: the last step's beams backtracked."""
    ids = torch.tensor([[[2, 2, 2]], [[6, 1, 0]], [[8, 9, 0]]])
    parents = torch.tensor([[[0, 0, 0]], [[1, 1, 0]], [[2, 1, 0]]])
    got = F.gather_tree(ids, parents)
    assert got[:, 0, :].tolist() == [[2, 2, 2], [0, 1, 6], [8, 9, 0]]


@pytest.mark.parametrize("maxlen", [None, 8])
@pytest.mark.parametrize("dtype", ["int64", "int32", "float32", "bool"])
@pytest.mark.parametrize("shape", [(4,), (2, 3)])
def test_sequence_mask_matches_jax(maxlen, dtype, shape):
    lens = np.random.default_rng(12).integers(0, 7, shape)
    want = JF.sequence_mask(Tensor(jnp.asarray(lens)), maxlen=maxlen,
                            dtype=dtype)
    got = F.sequence_mask(torch.from_numpy(lens), maxlen=maxlen, dtype=dtype)
    assert tuple(got.shape) == tuple(_np(want).shape)
    np.testing.assert_array_equal(_np(got).astype(np.float64),
                                  _np(want).astype(np.float64))
    assert str(got.dtype) == f"torch.{dtype}"
