"""ERNIE/BERT-style encoder (BASELINE.json configuration 3): configuration,
parameters, pretraining forward and loss.

Mirrors ``paddle_tpu/models/ernie.py``: a post-LN encoder (token +
position + segment embeddings, LayerNorm, dropout; blocks of self
attention -> Add&LN -> GELU FFN -> Add&LN), the MLM head tied to the word
embeddings and the NSP head over the pooled [CLS]; the same configuration
fields and presets, module and parameter names
(``ernie.encoder.{i}.attention.qkv.weight``, ``...attn_norm.bias``, ...),
layouts (linear weights ``[in, out]``) and initial distributions (the
fleet layers' and ``nn`` layers'), so a state carried across from the JAX
model (``load_numpy_state``) fills this one name for name.

Each block's two Add&LN steps, ``norm(x + dropout(linear(y)))``, run as
``incubate.nn.functional.fused_bias_dropout_residual_layer_norm`` over the
projection without its bias: one Triton kernel adds the bias, drops, adds
the residual and normalises (the ops XLA fuses in the JAX step), with the
parameters under the JAX names. Attention routes as the JAX package's:
flash kernels without a mask and at dropout 0 (eval, or a configuration
without attention dropout), the dense reference with its probabilities
dropped by the dropout kernel while training at the published 0.1. The
token-type table's gradient is one fp32 matmul with the ids' one-hot
matrix (``_OneHotGradRows``), so a captured step equals an eager one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from .. import amp, resolve_device
from ..distributed.fleet.meta_parallel import (ColumnParallelLinear,
                                               RowParallelLinear,
                                               VocabParallelEmbedding)
from ..incubate.nn.functional import fused_bias_dropout_residual_layer_norm
from ..nn import Dropout, Embedding, LayerList, LayerNorm, Linear
from ..nn import functional as F
from ..nn.layer.layers import Layer
from .llama import load_numpy_state


@dataclass
class ErnieConfig:
    vocab_size: int = 18000
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 4
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1

    @staticmethod
    def ernie_base():
        return ErnieConfig()

    @staticmethod
    def tiny(vocab_size=128, hidden_size=64, layers=2, heads=4, seq=32):
        return ErnieConfig(vocab_size=vocab_size, hidden_size=hidden_size,
                           num_hidden_layers=layers,
                           num_attention_heads=heads,
                           intermediate_size=hidden_size * 2,
                           max_position_embeddings=seq,
                           hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0)


def _where(device, dtype, generator):
    return dict(device=device, dtype=dtype, generator=generator)


class _OneHotGradRows(torch.autograd.Function):
    """``weight[ids]`` whose gradient is ``one_hot(ids)^T @ dy``, summed in
    fp32 by one matmul and rounded once to dy's dtype: the same bits every
    run, eager or replayed from a graph. PyTorch's embedding backward on
    the card is not, where one id takes thousands of rows."""

    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.rows = weight.shape[0]
        return torch.nn.functional.embedding(ids, weight)

    @staticmethod
    def backward(ctx, dy):
        (ids,) = ctx.saved_tensors
        n = dy.shape[-1]
        hot = ids.reshape(-1, 1) == torch.arange(ctx.rows, device=ids.device)
        dw = hot.to(torch.float32).T @ dy.reshape(-1, n).to(torch.float32)
        return None, dw.to(dy.dtype)


@amp.op("embedding")
def _segment_rows(ids, weight):
    return _OneHotGradRows.apply(ids.long(), weight)


class _SegmentEmbedding(Embedding):
    """The token-type table: ``Embedding`` with ``_OneHotGradRows``'s
    gradient. Its few rows each take thousands of tokens a batch, which
    made a captured training step differ from an eager one under
    PyTorch's own embedding backward."""

    def forward(self, x):
        return _segment_rows(x, self.weight)


class ErnieEmbeddings(Layer):
    def __init__(self, config: ErnieConfig, device, dtype, generator):
        super().__init__()
        at = _where(device, dtype, generator)
        h = config.hidden_size
        self.max_positions = config.max_position_embeddings
        self.word_embeddings = VocabParallelEmbedding(config.vocab_size, h,
                                                      **at)
        self.position_embeddings = Embedding(config.max_position_embeddings,
                                             h, **at)
        self.token_type_embeddings = _SegmentEmbedding(
            config.type_vocab_size, h, **at)
        self.layer_norm = LayerNorm(h, epsilon=config.layer_norm_eps,
                                    device=device, dtype=dtype)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None):
        s = input_ids.shape[1]
        if s > self.max_positions:
            raise ValueError(f"sequence length {s} exceeds "
                             f"max_position_embeddings {self.max_positions}")
        pos = torch.arange(s, device=input_ids.device)
        emb = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            emb = emb + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(emb))


class ErnieSelfAttention(Layer):
    def __init__(self, config: ErnieConfig, device, dtype, generator):
        super().__init__()
        at = _where(device, dtype, generator)
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = h // self.num_heads
        self.qkv = ColumnParallelLinear(h, 3 * h, has_bias=True, **at)
        self.out = RowParallelLinear(h, h, has_bias=True, **at)
        self.dropout_p = config.attention_probs_dropout_prob

    def context(self, x, attention_mask=None):
        """The heads' outputs ``[b, s, hidden]``, before ``out``."""
        b, s, h = x.shape
        qkv = self.qkv(x).reshape(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attention_mask,
            dropout_p=self.dropout_p if self.training else 0.0,
            is_causal=False)
        return out.reshape(b, s, h)

    def forward(self, x, attention_mask=None):
        return self.out(self.context(x, attention_mask))


class ErnieBlock(Layer):
    """Post-LN encoder block (BERT layout)."""

    def __init__(self, config: ErnieConfig, device, dtype, generator):
        super().__init__()
        at = _where(device, dtype, generator)
        h, eps = config.hidden_size, config.layer_norm_eps
        self.attention = ErnieSelfAttention(config, device, dtype, generator)
        self.attn_norm = LayerNorm(h, epsilon=eps, device=device, dtype=dtype)
        self.ffn_in = ColumnParallelLinear(h, config.intermediate_size,
                                           has_bias=True, **at)
        self.ffn_out = RowParallelLinear(config.intermediate_size, h,
                                         has_bias=True, **at)
        self.ffn_norm = LayerNorm(h, epsilon=eps, device=device, dtype=dtype)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def _add_norm(self, y, x, linear, norm):
        """``norm(x + dropout(linear(y)))`` in one kernel: the product
        without its bias, then bias, dropout, residual and LayerNorm."""
        return fused_bias_dropout_residual_layer_norm(
            F.linear(y, linear.weight), x, bias=linear.bias,
            ln_scale=norm.weight, ln_bias=norm.bias,
            dropout_rate=self.dropout.p, ln_epsilon=norm._epsilon,
            training=self.training, mode=self.dropout.mode)

    def forward(self, x, attention_mask=None):
        x = self._add_norm(self.attention.context(x, attention_mask), x,
                           self.attention.out, self.attn_norm)
        return self._add_norm(F.gelu(self.ffn_in(x)), x, self.ffn_out,
                              self.ffn_norm)


class ErnieModel(Layer):
    def __init__(self, config: ErnieConfig, device, dtype, generator):
        super().__init__()
        self.config = config
        self.embeddings = ErnieEmbeddings(config, device, dtype, generator)
        self.encoder = LayerList([ErnieBlock(config, device, dtype,
                                             generator)
                                  for _ in range(config.num_hidden_layers)])
        self.pooler = Linear(config.hidden_size, config.hidden_size,
                             **_where(device, dtype, generator))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        h = self.embeddings(input_ids, token_type_ids)
        for block in self.encoder:
            h = block(h, attention_mask)
        pooled = F.tanh(self.pooler(h[:, 0]))
        return h, pooled


def _placement(device, dtype, generator):
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return dev, dtype or torch.float32, generator


class ErnieForPretraining(Layer):
    """MLM (tied decoder) + NSP heads; ``compute_loss`` is the pretraining
    criterion (masked positions use ignore_index=-100). Parameters on
    ``device`` (None = the GPU; raises without one), in ``dtype`` (None =
    float32), initialised from ``generator`` (None = a generator seeded
    with 0)."""

    def __init__(self, config: ErnieConfig, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, dt, gen = _placement(device, dtype, generator)
        at = _where(dev, dt, gen)
        self.config = config
        self.ernie = ErnieModel(config, dev, dt, gen)
        self.mlm_transform = Linear(config.hidden_size, config.hidden_size,
                                    **at)
        self.mlm_norm = LayerNorm(config.hidden_size,
                                  epsilon=config.layer_norm_eps, device=dev,
                                  dtype=dt)
        self.nsp_head = Linear(config.hidden_size, 2, **at)

    @property
    def device(self) -> torch.device:
        return self.nsp_head.weight.device

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """(MLM logits [b, s, vocab], NSP logits [b, 2]) in the model's
        dtype."""
        h, pooled = self.ernie(input_ids, token_type_ids, attention_mask)
        h = self.mlm_norm(F.gelu(self.mlm_transform(h)))
        mlm_logits = h @ self.ernie.embeddings.word_embeddings.weight.T
        return mlm_logits, self.nsp_head(pooled)

    def compute_loss(self, mlm_logits, nsp_logits, mlm_labels,
                     nsp_labels=None):
        b, s, v = mlm_logits.shape
        loss = F.cross_entropy(mlm_logits.reshape(b * s, v),
                               mlm_labels.reshape(b * s), ignore_index=-100)
        if nsp_labels is not None:
            loss = loss + F.cross_entropy(nsp_logits, nsp_labels)
        return loss

    def num_params(self):
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self, seq_len: int) -> float:
        """Training FLOPs a token: 6 x the weights every token multiplies
        (each block's four matrices, the MLM transform and the tied
        decoder), the pooler and NSP head once a sequence, and the
        non-causal attention's 12 x layers x hidden x seq."""
        c = self.config
        h = c.hidden_size
        per_block = 4 * h * h + 2 * h * c.intermediate_size
        per_token = c.num_hidden_layers * per_block + h * h \
            + c.vocab_size * h
        per_sequence = h * h + 2 * h
        attn = 12.0 * c.num_hidden_layers * h * seq_len
        return 6.0 * (per_token + per_sequence / seq_len) + attn


class ErnieForSequenceClassification(Layer):
    def __init__(self, config: ErnieConfig, num_classes: int = 2,
                 dropout: Optional[float] = None, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, dt, gen = _placement(device, dtype, generator)
        self.ernie = ErnieModel(config, dev, dt, gen)
        self.dropout = Dropout(config.hidden_dropout_prob
                               if dropout is None else dropout)
        self.classifier = Linear(config.hidden_size, num_classes,
                                 **_where(dev, dt, gen))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.ernie(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled))


def ernie_pretrain_step(model, batch):
    """Loss for one pretraining batch {input_ids, token_type_ids,
    mlm_labels, nsp_labels}; usable as the SpmdTrainer loss_fn via
    ``lambda m, *arrays: ernie_pretrain_step(m, dict(zip(keys,
    arrays)))``."""
    mlm_logits, nsp_logits = model(batch["input_ids"],
                                   batch.get("token_type_ids"))
    return model.compute_loss(mlm_logits, nsp_logits, batch["mlm_labels"],
                              batch.get("nsp_labels"))


__all__ = ["ErnieConfig", "ErnieEmbeddings", "ErnieSelfAttention",
           "ErnieBlock", "ErnieModel", "ErnieForPretraining",
           "ErnieForSequenceClassification", "ernie_pretrain_step",
           "load_numpy_state"]
