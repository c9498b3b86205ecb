"""Seq2seq decoding (``paddle_tpu/nn/decode.py``): ``BeamSearchDecoder``
and ``dynamic_decode``, the search API of RNN-family models.

The JAX package's semantics: the step loop is driven from the host, which
reads ``finished`` every step (that is its design; the rest of a step
stays on the device); ``initialize`` tiles every state ``beam_size``
times and starts beam 0 at log-probability 0 and the others at -1e9;
``step`` freezes finished beams on ``end_token`` (log-probability 0 for
it, -1e9 for the rest), picks the top ``beam_size`` of each sentence's
``beam_size x vocab`` totals (the lower flat index first among equal
values, as ``lax.top_k``: a stable descending sort, so on every device),
and regathers the cell's states by the chosen beams; ``finalize``
backtracks the chosen tokens through their parents into ``[batch, beam,
T]`` (best first) with ``gather_tree`` on the tokens' device (JAX's runs
on the host; the result is the same). ``dynamic_decode`` stops when every
beam has finished or after ``max_step_num`` steps (256 when None),
carries each beam's length through the same regathering, and, as in
JAX, does not pass its ``**kwargs`` to ``decoder.step``: a cell that
needs the encoder's output holds it itself. State trees are tuples and
lists of tensors (``None`` passes through).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..ops.special import gather_tree


def _map(fn, tree):
    """``fn`` over the tensors of a tree of tuples and lists."""
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t) for t in tree)
    return fn(tree)


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def _tile_beam(x, beam_size):
    """[batch, ...] -> [batch * beam, ...] (each row ``beam_size`` times)."""
    return torch.repeat_interleave(x, beam_size, dim=0)


def _top_k(x, k):
    """``lax.top_k`` over the last axis: the k largest, the lower index
    first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class BeamSearchDecoder:
    """Beam search over an RNN cell: ``cell(inputs, states) -> (outputs,
    new_states)``; ``embedding_fn`` maps token ids to the cell's inputs and
    ``output_fn`` its outputs to logits over the vocabulary (both the
    identity when None)."""

    def __init__(self, cell, start_token: int, end_token: int,
                 beam_size: int, embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """The encoder's outputs in the merged ``[batch * beam, ...]``
        layout."""
        return _tile_beam(x, beam_size)

    def _device(self, leaves):
        if leaves:
            return leaves[0].device
        params = getattr(self.cell, "parameters", None)
        first = next(iter(params()), None) if callable(params) else None
        return first.device if first is not None else resolve_device(None)

    def initialize(self, initial_cell_states):
        k = self.beam_size
        states = _map(lambda t: _tile_beam(t, k), initial_cell_states)
        leaves = _leaves(states)
        merged = leaves[0].shape[0] if leaves else k
        dev = self._device(leaves)
        ids = torch.full((merged,), self.start_token, dtype=torch.int32,
                         device=dev)
        # only beam 0 is live at first (identical beams would collapse)
        lp = torch.where(torch.arange(merged, device=dev) % k == 0,
                         torch.zeros((), device=dev),
                         torch.full((), -1e9, device=dev))
        finished = torch.zeros(merged, dtype=torch.bool, device=dev)
        return ids, (states, lp, finished)

    def step(self, time, inputs, states):
        cell_states, log_probs, finished = states
        k = self.beam_size
        emb = self.embedding_fn(inputs) if self.embedding_fn else inputs
        cell_out, next_cell_states = self.cell(emb, cell_states)
        logits = self.output_fn(cell_out) if self.output_fn else cell_out
        la = logits.float()
        merged, vocab = la.shape
        batch = merged // k
        step_lp = torch.log_softmax(la, dim=-1)
        # finished beams emit only end_token, with probability 1
        frozen = torch.full((vocab,), -1e9, device=la.device)
        frozen[self.end_token] = 0.0
        step_lp = torch.where(finished[:, None], frozen[None, :], step_lp)
        total = log_probs[:, None] + step_lp
        top_lp, top_idx = _top_k(total.reshape(batch, k * vocab), k)
        beam_idx = top_idx // vocab
        tok = (top_idx % vocab).to(torch.int32)
        src = (torch.arange(batch, device=la.device)[:, None] * k
               + beam_idx).reshape(-1)
        next_cell_states = _map(lambda t: t[src], next_cell_states)
        new_fin = finished[src] | (tok.reshape(-1) == self.end_token)
        next_ids = tok.reshape(-1)
        next_states = (next_cell_states, top_lp.reshape(-1), new_fin)
        outputs = (next_ids, src.to(torch.int32))
        return outputs, next_states, next_ids, new_fin

    def finalize(self, step_outputs, final_states, batch):
        """The chosen tokens backtracked through their parents by
        ``gather_tree``: ``[batch, beam, T]`` int32 (best first), on the
        tokens' device. A step's parents are merged rows (``b beam +
        j``), each within its own sentence, so their beam is the row
        modulo ``beam``."""
        k = self.beam_size
        toks = torch.stack([t for t, _ in step_outputs]).view(-1, batch, k)
        parents = torch.stack([p for _, p in step_outputs]).view(-1, batch, k)
        return gather_tree(toks, parents % k).permute(1, 2, 0).contiguous()


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Drive ``decoder`` until every sequence finishes or ``max_step_num``
    steps: ``(outputs, final_states)``, with the lengths when
    ``return_length``. ``kwargs`` are not passed on (the JAX package's
    behaviour)."""
    max_steps = int(max_step_num) if max_step_num is not None else 256
    inputs, states = decoder.initialize(inits)
    step_outputs = []
    lengths = None
    beams = isinstance(decoder, BeamSearchDecoder)
    for t in range(max_steps):
        outputs, states, inputs, finished = decoder.step(t, inputs, states)
        step_outputs.append(outputs)
        fin = finished.cpu().numpy()
        if lengths is None:
            lengths = np.full(fin.shape, max_steps, np.int32)
        elif beams:
            # the beams were regathered this step: a slot's length follows
            # the beam it now holds, which finalize() backtracks
            lengths = lengths[outputs[1].cpu().numpy()]
        newly = fin & (lengths == max_steps)
        lengths[newly] = t + 1
        if bool(fin.all()):
            break
    first = step_outputs[0][0]
    if beams:
        batch = first.shape[0] // decoder.beam_size
        seqs = decoder.finalize(step_outputs, states, batch)
        lengths_t = torch.from_numpy(lengths.reshape(
            batch, decoder.beam_size)).to(seqs.device)
        if output_time_major:                 # [batch, beam, T] -> [T, b, k]
            seqs = torch.movedim(seqs, -1, 0)
    else:
        seqs = torch.stack([o for o, *_ in step_outputs], dim=1)
        lengths_t = torch.from_numpy(lengths).to(seqs.device)
        if output_time_major:                 # [batch, T, ...] -> [T, b, ...]
            seqs = seqs.transpose(0, 1)
    if return_length:
        return seqs, states, lengths_t
    return seqs, states


__all__ = ["BeamSearchDecoder", "dynamic_decode"]
