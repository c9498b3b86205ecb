"""The fused Transformer layers of
``paddle_tpu/incubate/nn/layer/fused_transformer.py`` (``:23``, ``:98``,
``:153``, ``:178``) as ``Layer``s, with the JAX parameter names, shapes and
initializers (weights ``XavierNormal``, LayerNorm scales ``Constant(1)``,
biases zeros), drawn from ``framework.random`` on an explicit ``device``
(None = the GPU) in ``dtype`` (float32). Their forwards are the JAX
compositions of the port's functionals: each LayerNorm and dropout runs
its Triton kernel on CUDA tensors, the attention routes as
``F.scaled_dot_product_attention`` routes it (the dense attention's
kernels with a mask or a dropout)."""
from __future__ import annotations

import torch

from ....nn import functional as F
from ....nn.initializer import Constant, XavierNormal
from ....nn.layer.layers import Layer
from ..functional import fused_bias_dropout_residual_layer_norm


class FusedMultiHeadAttention(Layer):
    """LayerNorm before (``normalize_before``: ``pre_ln_scale`` /
    ``pre_ln_bias``) or after the residual (``ln_scale`` / ``ln_bias``),
    one packed QKV projection (``qkv_weight [3, heads, head_dim,
    embed_dim]``, ``qkv_bias``), attention at ``attn_dropout_rate``, the
    output projection (``linear_weight`` ``[in, out]``, ``linear_bias``)
    and its dropout at ``dropout_rate``."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, name=None, *, device=None,
                 dtype=None):
        super().__init__(dtype=dtype, device=device)
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim ({embed_dim}) must be divisible "
                             f"by num_heads ({num_heads})")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self._epsilon = epsilon
        mk = self.create_parameter
        e = embed_dim
        self.qkv_weight = mk([3, num_heads, self.head_dim, e],
                             attr=qkv_weight_attr,
                             default_initializer=XavierNormal())
        self.qkv_bias = mk([3, num_heads, self.head_dim], attr=qkv_bias_attr,
                           is_bias=True)
        self.linear_weight = mk([e, e], attr=linear_weight_attr,
                                default_initializer=XavierNormal())
        self.linear_bias = mk([e], attr=linear_bias_attr, is_bias=True)
        self.pre_ln_scale = mk([e], attr=pre_ln_scale_attr,
                               default_initializer=Constant(1.0))
        self.pre_ln_bias = mk([e], attr=pre_ln_bias_attr, is_bias=True)
        self.ln_scale = mk([e], attr=ln_scale_attr,
                           default_initializer=Constant(1.0))
        self.ln_bias = mk([e], attr=ln_bias_attr, is_bias=True)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        x = query
        residual = x
        e = self.embed_dim
        if self.normalize_before:
            x = F.layer_norm(x, [e], self.pre_ln_scale, self.pre_ln_bias,
                             self._epsilon)
        b, s, _ = x.shape
        qkv = torch.matmul(x, self.qkv_weight.reshape(3 * e, e).t()) \
            + self.qkv_bias.reshape(3 * e)
        qkv = qkv.reshape(b, s, 3, self.num_heads, self.head_dim)
        out = F.scaled_dot_product_attention(
            qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], attn_mask=attn_mask,
            dropout_p=self.attn_dropout_rate, is_causal=False,
            training=self.training)
        out = torch.matmul(out.reshape(b, s, e), self.linear_weight) \
            + self.linear_bias
        out = residual + F.dropout(out, self.dropout_rate,
                                   training=self.training)
        if not self.normalize_before:
            out = F.layer_norm(out, [e], self.ln_scale, self.ln_bias,
                               self._epsilon)
        return out


class FusedFeedForward(Layer):
    """``residual + dropout(linear2(act_dropout(act(linear1(x)))))`` with
    the LayerNorm before (``ln1_scale`` / ``ln1_bias``) or after
    (``ln2_scale`` / ``ln2_bias``); weights ``[in, out]``."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None, ln2_bias_attr=None,
                 nranks=1, ring_id=-1, name=None, *, device=None,
                 dtype=None):
        super().__init__(dtype=dtype, device=device)
        self.d_model = d_model
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = act_dropout_rate \
            if act_dropout_rate is not None else dropout_rate
        self.activation = activation
        self._epsilon = epsilon
        mk = self.create_parameter
        self.linear1_weight = mk([d_model, dim_feedforward],
                                 attr=linear1_weight_attr,
                                 default_initializer=XavierNormal())
        self.linear1_bias = mk([dim_feedforward], attr=linear1_bias_attr,
                               is_bias=True)
        self.linear2_weight = mk([dim_feedforward, d_model],
                                 attr=linear2_weight_attr,
                                 default_initializer=XavierNormal())
        self.linear2_bias = mk([d_model], attr=linear2_bias_attr,
                               is_bias=True)
        self.ln1_scale = mk([d_model], attr=ln1_scale_attr,
                            default_initializer=Constant(1.0))
        self.ln1_bias = mk([d_model], attr=ln1_bias_attr, is_bias=True)
        self.ln2_scale = mk([d_model], attr=ln2_scale_attr,
                            default_initializer=Constant(1.0))
        self.ln2_bias = mk([d_model], attr=ln2_bias_attr, is_bias=True)

    def forward(self, src, cache=None):
        residual = src
        x = src
        if self.normalize_before:
            x = F.layer_norm(x, [self.d_model], self.ln1_scale,
                             self.ln1_bias, self._epsilon)
        x = F.linear(x, self.linear1_weight, self.linear1_bias)
        x = getattr(F, self.activation)(x)
        x = F.dropout(x, self.act_dropout_rate, training=self.training)
        x = F.linear(x, self.linear2_weight, self.linear2_bias)
        x = residual + F.dropout(x, self.dropout_rate,
                                 training=self.training)
        if not self.normalize_before:
            x = F.layer_norm(x, [self.d_model], self.ln2_scale,
                             self.ln2_bias, self._epsilon)
        return x


class FusedTransformerEncoderLayer(Layer):
    """``fused_attn`` (a ``FusedMultiHeadAttention``) then ``ffn`` (a
    ``FusedFeedForward``); ``cache`` is accepted and not used, as in the
    JAX layer."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False,
                 weight_attr=None, bias_attr=None, name=None, *, device=None,
                 dtype=None):
        super().__init__(dtype=dtype, device=device)
        pl = dict(device=device, dtype=dtype)
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=attn_dropout_rate
            if attn_dropout_rate is not None else dropout_rate,
            normalize_before=normalize_before, **pl)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before, **pl)

    def forward(self, src, src_mask=None, cache=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))


class FusedBiasDropoutResidualLayerNorm(Layer):
    """``LayerNorm(residual + dropout(x + linear_bias))`` with
    ``ln_scale`` / ``ln_bias``: one Triton kernel each way on CUDA
    tensors (``fused_bias_dropout_residual_layer_norm``)."""

    def __init__(self, embed_dim, dropout_rate=0.5, weight_attr=None,
                 bias_attr=None, epsilon=1e-5, name=None, *, device=None,
                 dtype=None):
        super().__init__(dtype=dtype, device=device)
        self.embed_dim = embed_dim
        self.dropout_rate = dropout_rate
        self.epsilon = epsilon
        mk = self.create_parameter
        self.linear_bias = mk((embed_dim,), attr=bias_attr, is_bias=True)
        self.ln_scale = mk((embed_dim,), attr=weight_attr,
                           default_initializer=Constant(1.0))
        self.ln_bias = mk((embed_dim,), is_bias=True)

    def forward(self, x, residual):
        return fused_bias_dropout_residual_layer_norm(
            x, residual, self.linear_bias, self.ln_scale, self.ln_bias,
            self.dropout_rate, self.epsilon, self.training)


__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer",
           "FusedBiasDropoutResidualLayerNorm"]
