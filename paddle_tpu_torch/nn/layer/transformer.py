"""The layers of ``paddle_tpu/nn/layer/transformer.py`` as ``Layer``s:
``MultiHeadAttention`` (``q_proj`` / ``k_proj`` / ``v_proj`` /
``out_proj``, its ``Cache`` and ``StaticCache``),
``TransformerEncoderLayer`` / ``TransformerEncoder``,
``TransformerDecoderLayer`` / ``TransformerDecoder`` and ``Transformer``,
with the JAX parameter names (so ``state_dict`` equals the JAX
``named_state()``), arguments and defaults, on an explicit ``device`` (None
= the GPU) in ``dtype`` (float32).

The attention goes through ``F.scaled_dot_product_attention`` with
``dropout_p=self.dropout`` in training and in eval, as the JAX layer calls
it: a layer built with a dropout (the default 0.1 of the Transformer
classes) never takes the flash kernels, only the dense route
(``kernels/dense_attention.py`` on the card), also in eval; without a
dropout or a mask it takes flash where ``flash_takes`` does.
"""
from __future__ import annotations

import copy

import torch

from ... import resolve_device
from .. import functional as F
from .common import Dropout, Linear
from .layers import Layer, LayerList
from .norm import LayerNorm


class MultiHeadAttention(Layer):
    """Attention of ``[batch, seq, embed_dim]`` queries over keys of
    ``kdim`` and values of ``vdim`` features, in ``num_heads`` heads.
    ``forward(query, key=None, value=None, attn_mask=None, cache=None)``
    (key defaults to the query, value to the key; ``attn_mask`` bool, True
    = visible, or additive, broadcast to ``[b, heads, sq, sk]``) returns
    the output, or ``(out, new_cache)`` when a cache is given: a ``Cache``
    has this call's keys and values appended (the new ``Cache``), a
    ``StaticCache`` is used as the keys and values (the new cache None)."""

    class Cache:
        def __init__(self, k, v):
            self.k = k
            self.v = v

    class StaticCache:
        def __init__(self, k, v):
            self.k = k
            self.v = v

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError(f"embed_dim {embed_dim} not divisible by "
                             f"num_heads {num_heads}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        at = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                  device=device, dtype=dtype)
        self.q_proj = Linear(embed_dim, embed_dim, **at)
        self.k_proj = Linear(self.kdim, embed_dim, **at)
        self.v_proj = Linear(self.vdim, embed_dim, **at)
        self.out_proj = Linear(embed_dim, embed_dim, **at)

    def gen_cache(self, key, value=None, type=None):
        """A ``StaticCache`` of the projected ``key`` and ``value`` (the
        key where None) when ``type`` is ``StaticCache``; else an empty
        ``Cache`` (float32 ``[batch, 0, heads, head_dim]``)."""
        if type is MultiHeadAttention.StaticCache:
            k, v = self._kv(key, value if value is not None else key)
            return MultiHeadAttention.StaticCache(k, v)
        z = torch.zeros(key.shape[0], 0, self.num_heads, self.head_dim,
                        dtype=torch.float32, device=key.device)
        return MultiHeadAttention.Cache(z, z)

    def _split_heads(self, t):
        b, s, _ = t.shape
        return t.reshape(b, s, self.num_heads, self.head_dim)

    def _kv(self, key, value):
        return (self._split_heads(self.k_proj(key)),
                self._split_heads(self.v_proj(value)))

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, MultiHeadAttention.StaticCache):
            k, v = cache.k, cache.v
        else:
            k, v = self._kv(key, value)
        new_cache = None
        if isinstance(cache, MultiHeadAttention.Cache):
            k = torch.cat([cache.k, k], dim=1)
            v = torch.cat([cache.v, v], dim=1)
            new_cache = MultiHeadAttention.Cache(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            is_causal=False, training=self.training)
        b, s = out.shape[0], out.shape[1]
        out = self.out_proj(out.reshape(b, s, self.embed_dim))
        if cache is not None:
            return out, new_cache
        return out


class TransformerEncoderLayer(Layer):
    """Self-attention, then the feed-forward block (``linear1``,
    ``activation``, ``linear2``), each with its dropout and residual, and
    ``norm1`` / ``norm2`` before (``normalize_before``) or after. The
    attention's dropout is ``attn_dropout`` (``dropout`` where None), the
    activation's ``act_dropout`` (likewise)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, name=None, *, device=None, dtype=None):
        super().__init__()
        pl = dict(device=device, dtype=dtype)
        at = dict(weight_attr=weight_attr, bias_attr=bias_attr, **pl)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead,
            dropout=attn_dropout if attn_dropout is not None else dropout,
            **at)
        self.linear1 = Linear(d_model, dim_feedforward, **at)
        self.linear2 = Linear(dim_feedforward, d_model, **at)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps, **pl)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps, **pl)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout_act = Dropout(
            act_dropout if act_dropout is not None else dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        x = self.norm1(src) if self.normalize_before else src
        if cache is None:
            x = self.self_attn(x, attn_mask=src_mask)
        else:
            x, cache = self.self_attn(x, attn_mask=src_mask, cache=cache)
        x = residual + self.dropout1(x)
        if not self.normalize_before:
            x = self.norm1(x)
        residual = x
        y = self.norm2(x) if self.normalize_before else x
        y = self.linear2(self.dropout_act(self.activation(self.linear1(y))))
        y = residual + self.dropout2(y)
        if not self.normalize_before:
            y = self.norm2(y)
        return y if cache is None else (y, cache)


class TransformerEncoder(Layer):
    """``encoder_layer`` and ``num_layers - 1`` deep copies of it, run in
    order, then ``norm`` where given."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer] +
            [copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask=src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class TransformerDecoderLayer(Layer):
    """Self-attention (``tgt_mask``), cross-attention over ``memory``
    (``memory_mask``), then the feed-forward block, each with its dropout,
    residual and norm (``norm1``..``norm3``) before or after. ``cache`` is
    accepted and not used, as the JAX layer does."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, name=None, *, device=None, dtype=None):
        super().__init__()
        pl = dict(device=device, dtype=dtype)
        at = dict(weight_attr=weight_attr, bias_attr=bias_attr, **pl)
        self.normalize_before = normalize_before
        ad = attn_dropout if attn_dropout is not None else dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout=ad, **at)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout=ad, **at)
        self.linear1 = Linear(d_model, dim_feedforward, **at)
        self.linear2 = Linear(dim_feedforward, d_model, **at)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps, **pl)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps, **pl)
        self.norm3 = LayerNorm(d_model, epsilon=layer_norm_eps, **pl)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.dropout_act = Dropout(
            act_dropout if act_dropout is not None else dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        x = self.norm1(tgt) if self.normalize_before else tgt
        x = self.self_attn(x, attn_mask=tgt_mask)
        x = residual + self.dropout1(x)
        if not self.normalize_before:
            x = self.norm1(x)
        residual = x
        y = self.norm2(x) if self.normalize_before else x
        y = self.cross_attn(y, memory, memory, attn_mask=memory_mask)
        y = residual + self.dropout2(y)
        if not self.normalize_before:
            y = self.norm2(y)
        residual = y
        z = self.norm3(y) if self.normalize_before else y
        z = self.linear2(self.dropout_act(self.activation(self.linear1(z))))
        z = residual + self.dropout3(z)
        if not self.normalize_before:
            z = self.norm3(z)
        return z


class TransformerDecoder(Layer):
    """``decoder_layer`` and ``num_layers - 1`` deep copies of it, run in
    order over one ``memory``, then ``norm`` where given."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer] +
            [copy.deepcopy(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None):
        out = tgt
        for layer in self.layers:
            out = layer(out, memory, tgt_mask=tgt_mask,
                        memory_mask=memory_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class Transformer(Layer):
    """The encoder-decoder of Vaswani et al. (2017) as ``paddle.nn.
    Transformer`` builds it: by default d_model 512, 8 heads, 6 + 6 layers,
    feed-forward 2048, dropout 0.1, ReLU, post-norm (with
    ``normalize_before`` a final LayerNorm on each stack);
    ``custom_encoder`` / ``custom_decoder`` replace a stack.
    ``forward(src, tgt, src_mask=None, tgt_mask=None, memory_mask=None)``
    takes embedded ``[batch, seq, d_model]`` inputs."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, name=None, *,
                 device=None, dtype=None):
        super().__init__()
        pl = dict(device=device, dtype=dtype)
        self.d_model = d_model
        self.nhead = nhead
        self._mask_device = device
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args, **pl), num_encoder_layers,
                LayerNorm(d_model, **pl) if normalize_before else None)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args, **pl), num_decoder_layers,
                LayerNorm(d_model, **pl) if normalize_before else None)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    def generate_square_subsequent_mask(self, length):
        """The additive float32 ``[length, length]`` mask of a decoder's
        self-attention: 0 on and below the diagonal, -1e9 above (the JAX
        package's value, not -inf), on the layer's device."""
        m = torch.full((length, length), -1e9, dtype=torch.float32,
                       device=resolve_device(self._mask_device))
        return torch.triu(m, diagonal=1)


__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]
