"""The attention-based LSTM translation model of ``chip_smoke.py``'s phase
18 (PaddleNLP's ``examples/machine_translation/seq2seq``), built in both
packages from their layers at hidden 16, vocabularies 23 / 19 and 7 tokens
a side, against each other on the CPU: the port's model is the smoke's own
(``chip_smoke._seq2seq_model``), the JAX one the same code on
``paddle_tpu.nn``; the JAX weights carried across as numpy (``state_dict``
names equal to the JAX ``named_state()``). The logits, the masked loss and
every parameter's gradient (``jax.vjp`` over the JAX model with its
parameters traced: the JAX package's tape carries no gradient through
``RNN``'s outputs, ROADMAP Queue 3); then two ``SpmdTrainer`` steps (Adam,
global-norm clipping at 5) against two eager JAX steps (the same
gradients, the JAX optimizer), at dropout 0. Also beam search: the port's
phase 18 decode at beam 3 against JAX's ``BeamSearchDecoder`` with the
encoder's output held by the cell.

Tolerances: fp32 (sums in another order, over the steps): logits and loss
within 1e-5 of the largest |value|, gradients within 1e-4 of the largest
|value| of each, parameters after two steps within 1e-5 of their largest
|value|; tokens and lengths equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.tensor import Tensor

import chip_smoke as smoke
import paddle_tpu_torch as ptt
from paddle_tpu_torch.models import load_numpy_state
from paddle_tpu_torch.parallel import SpmdTrainer

D, SRC_V, TRG_V, S, B = 16, 23, 19, 7, 4
PAD, BOS, EOS = smoke.PAD, smoke.BOS, smoke.EOS


def _jax_model(dropout=0.0, layers=2):
    """``chip_smoke._seq2seq_model`` on ``paddle_tpu.nn``."""
    class Attention(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.input_proj = jnn.Linear(D, D, bias_attr=False)
            self.output_proj = jnn.Linear(2 * D, D, bias_attr=False)

        def forward(self, hidden, encoder_output, padding_mask):
            mem = self.input_proj(encoder_output)
            scores = paddle.matmul(paddle.unsqueeze(hidden, [1]), mem,
                                   transpose_y=True)
            probs = JF.softmax(scores + padding_mask, axis=-1)
            ctx = paddle.squeeze(paddle.matmul(probs, mem), [1])
            return self.output_proj(paddle.concat([ctx, hidden], 1))

    class DecoderCell(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.dropout = jnn.Dropout(dropout)
            self.lstm_cells = jnn.LayerList([
                jnn.LSTMCell(2 * D if i == 0 else D, D)
                for i in range(layers)])
            self.attention_layer = Attention()
            self.memory = None

        def forward(self, step_input, states, encoder_output=None,
                    encoder_padding_mask=None):
            if encoder_output is None:
                encoder_output, encoder_padding_mask = self.memory
            lstm_states, input_feed = states
            step_input = paddle.concat([step_input, input_feed], 1)
            new_states = []
            for i, cell in enumerate(self.lstm_cells):
                out, new = cell(step_input, lstm_states[i])
                step_input = self.dropout(out)
                new_states.append(new)
            out = self.attention_layer(step_input, encoder_output,
                                       encoder_padding_mask)
            return out, [new_states, out]

    class Seq2SeqAttn(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.src_embedder = jnn.Embedding(SRC_V, D, padding_idx=PAD)
            self.encoder = jnn.LSTM(D, D, num_layers=layers, dropout=dropout)
            self.trg_embedder = jnn.Embedding(TRG_V, D, padding_idx=PAD)
            self.decoder = jnn.RNN(DecoderCell())
            self.output_layer = jnn.Linear(D, TRG_V, bias_attr=False)

        def encode(self, src):
            out, (h, c) = self.encoder(self.src_embedder(src))
            states = [[(h[i], c[i]) for i in range(layers)],
                      Tensor(jnp.zeros((src.shape[0], D), jnp.float32))]
            mask = ((src != PAD).astype("float32") - 1.0) * 1e9
            return out, states, paddle.unsqueeze(mask, [1])

        def forward(self, src, trg):
            enc, states, mask = self.encode(src)
            dec, _ = self.decoder(self.trg_embedder(trg), states,
                                  encoder_output=enc,
                                  encoder_padding_mask=mask)
            return self.output_layer(dec)
    return Seq2SeqAttn()


def _jax_loss(m, src, trg, labels, trg_len):
    logits = m(src, trg)
    cost = JF.cross_entropy(logits, labels, reduction="none")
    cost = cost.reshape(list(labels.shape))
    mask = JF.sequence_mask(trg_len, maxlen=trg.shape[1], dtype="float32")
    return (cost * mask).mean(0).sum()


def _pair(seed=0, dropout=0.0):
    paddle.seed(seed)
    jm = _jax_model(dropout)
    pm = smoke._seq2seq_model(torch, seed, "cpu", src_vocab=SRC_V,
                              trg_vocab=TRG_V, d=D, dropout=dropout)
    assert list(pm.state_dict()) == list(jm.named_state())
    load_numpy_state(pm, {n: np.asarray(t._data)
                          for n, t in jm.named_state().items()})
    return jm, pm


def _batch(seed=1):
    return tuple(t.numpy() for t in smoke._seq2seq_batch(
        torch, seed, b=B, s=S, src_vocab=SRC_V, trg_vocab=TRG_V, lo=3,
        device="cpu"))


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _jax_value_and_grads(jm, batch, fn):
    """``fn(model, *batch)`` and its gradients by ``jax.vjp``, the
    parameters traced."""
    params = list(jm.named_parameters())

    def f(*ws):
        saved = [p._data for _, p in params]
        try:
            for (_, p), w in zip(params, ws):
                p._data = w
            return fn(jm, *(Tensor(jnp.asarray(a)) for a in batch))._data
        finally:
            for (_, p), w in zip(params, saved):
                p._data = w
    out, vjp = jax.vjp(f, *[p._data for _, p in params])
    grads = vjp(jnp.ones_like(out))
    return np.asarray(out), {n: np.asarray(g)
                             for (n, _), g in zip(params, grads)}


def test_names_logits_loss_and_every_gradient_match_jax():
    jm, pm = _pair()
    batch = _batch()
    logits_j = jm(*(Tensor(jnp.asarray(a)) for a in batch[:2]))
    logits_p = pm(*(torch.from_numpy(a) for a in batch[:2]))
    _close(logits_p.detach().numpy(), np.asarray(logits_j._data), 1e-5)
    want, grads = _jax_value_and_grads(jm, batch, _jax_loss)
    loss = smoke._seq2seq_loss(pm, *(torch.from_numpy(a) for a in batch))
    _close(loss.detach().numpy(), want, 1e-5)
    names = [n for n, _ in pm.named_parameters()]
    got = torch.autograd.grad(loss, [p for _, p in pm.named_parameters()])
    assert set(names) == set(grads)
    for name, g in zip(names, got):
        _close(g.numpy(), grads[name], 1e-4)


def test_two_trainer_steps_match_two_jax_steps():
    """The port's ``SpmdTrainer`` (Adam 1e-3, ClipGradByGlobalNorm(5)) two
    steps against two JAX steps: the gradients by ``jax.vjp``, set on the
    parameters, then the JAX Adam with the same clip."""
    jm, pm = _pair(2)
    batch = _batch(3)
    jo = jopt.Adam(learning_rate=1e-3, parameters=jm.parameters(),
                   grad_clip=jnn.ClipGradByGlobalNorm(5.0))
    jparams = dict(jm.named_parameters())
    want = []
    for _ in range(2):
        loss, grads = _jax_value_and_grads(jm, batch, _jax_loss)
        for n, g in grads.items():
            jparams[n].grad = Tensor(jnp.asarray(g))
        jo.step()
        jo.clear_grad()
        want.append(float(loss))
    trainer = SpmdTrainer(pm, smoke._seq2seq_opt(pm), smoke._seq2seq_loss)
    got = [float(trainer.train_step(*(torch.from_numpy(a) for a in batch)))
           for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for n, p in pm.named_parameters():
        _close(p.detach().numpy(), np.asarray(jparams[n]._data), 1e-5)


def test_beam_search_matches_jax():
    """The smoke's decode (``_seq2seq_decode``: the encoder's output and
    mask tiled into the cell's ``memory``) against JAX's
    ``BeamSearchDecoder`` and ``dynamic_decode`` over the JAX model the
    same way: tokens and lengths equal."""
    jm, pm = _pair(4)
    pm.eval()
    jm.eval()
    src = _batch(5)[0]
    with torch.no_grad():
        seqs, lens = smoke._seq2seq_decode(torch, pm, torch.from_numpy(src),
                                           3, S)
    enc, states, mask = jm.encode(Tensor(jnp.asarray(src)))
    tile = jnn.BeamSearchDecoder.tile_beam_merge_with_batch
    jm.decoder.cell.memory = (tile(enc, 3), tile(mask, 3))
    dec = jnn.BeamSearchDecoder(jm.decoder.cell, BOS, EOS, 3,
                                embedding_fn=jm.trg_embedder,
                                output_fn=jm.output_layer)
    want, _, want_lens = jnn.dynamic_decode(dec, inits=states,
                                            max_step_num=S,
                                            return_length=True)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(want._data))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(want_lens._data))


def test_beam_one_is_the_greedy_chain():
    """At beam 1 the decode is the greedy chain by hand
    (``chip_smoke._seq2seq_greedy``)."""
    _, pm = _pair(6)
    pm.eval()
    src = torch.from_numpy(_batch(7)[0])
    with torch.no_grad():
        seqs, _ = smoke._seq2seq_decode(torch, pm, src, 1, S)
        greedy = smoke._seq2seq_greedy(torch, pm, src, seqs.shape[-1])
    assert torch.equal(seqs[:, 0].long(), greedy)


def test_dropout_draws_the_same_masks_twice():
    """At dropout 0.2 (the encoder between its layers, the decoder after
    each cell) a step under one framework seed is the same twice."""
    _, pm = _pair(8, dropout=0.2)
    batch = [torch.from_numpy(a) for a in _batch(9)]
    runs = []
    for _ in range(2):
        ptt.seed(10)
        runs.append(smoke._seq2seq_loss(pm, *batch))
    assert torch.equal(runs[0], runs[1])
    ptt.seed(11)
    assert not torch.equal(runs[0], smoke._seq2seq_loss(pm, *batch))
