"""Stable-Diffusion-style conditional UNet (BASELINE.json configuration
5): configuration, parameters and the denoising forward.

Mirrors ``paddle_tpu/models/unet.py``: conv_in, down blocks (ResNet
blocks, a spatial transformer with self and cross attention at every
level but the last, a stride-2 convolution between levels), the middle
(ResNet, transformer, ResNet), up blocks over the skip connections with
nearest-neighbour upsampling, then GroupNorm, SiLU and conv_out; the
timestep's sinusoidal embedding and 2-layer MLP added in every ResNet
block. The same configuration fields and presets, module and parameter
names (``down_resnets.{i}.norm1.weight``, ``down_attns.{i}.transformer.
attn1.to_q.weight``, ...), layouts (linear weights ``[in, out]``, conv
weights ``[out, in, kh, kw]``) and initial distributions, so a state
carried across from the JAX model (``load_numpy_state``) fills this one
name for name.

Every GroupNorm runs ``kernels/group_norm.py``'s Triton kernels on the
card, with the SiLU after it fused where the model applies one; the norm
before a transformer's ``proj_in`` is written in the dtype the
convolution's ``amp`` cast gives it (``F.group_norm``'s ``then``). The
LayerNorms run kernel 2 of ``kernels/fused.py``. Attention has head_dim
``channels / 8`` (40, 80, 160 for SD 1.5) and 77 context keys, which the
JAX package's flash kernel does not take (``paddle_tpu/kernels/
flash_attention.py:35,40``), so every attention call is the dense
reference (``F.scaled_dot_product_attention`` routes it, counted in
``LAUNCHES["sdpa_plain"]``), on the TPU as here.

The JAX model cannot run with bf16 weights outside ``amp``: its float32
timestep embedding promotes the residual stream. On the card it runs as
the JAX package runs it in bf16: ``amp.decorate(level="O2")`` and
``amp.auto_cast(level="O2")``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from .. import amp, resolve_device
from ..nn import Conv2D, GroupNorm, Identity, LayerList, LayerNorm, Linear
from ..nn import functional as F
from ..nn.layer.layers import Layer


@dataclass
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_head_dim: int = 8
    norm_num_groups: int = 32
    # levels with a spatial transformer (SD: all but the last down level)
    attn_levels: Optional[Tuple[int, ...]] = None

    @staticmethod
    def sd15():
        return UNetConfig()

    @staticmethod
    def tiny(ch=(32, 64), cross=32, groups=8):
        return UNetConfig(in_channels=4, out_channels=4,
                          block_out_channels=tuple(ch), layers_per_block=1,
                          cross_attention_dim=cross, attention_head_dim=4,
                          norm_num_groups=groups)

    def attn_at(self, level: int) -> bool:
        if self.attn_levels is not None:
            return level in self.attn_levels
        return level < len(self.block_out_channels) - 1


@amp.op("timestep_embedding")
def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """Sinusoidal embedding [B] -> [B, dim] in fp32 (diffusers'
    ``get_timestep_embedding``: sines then cosines)."""
    ts = t.reshape(-1).to(torch.float32)
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=ts.device) / half)
    args = ts[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


def _where(device, dtype, generator):
    return dict(device=device, dtype=dtype, generator=generator)


class TimestepEmbedding(Layer):
    def __init__(self, in_dim, time_embed_dim, device, dtype, generator):
        super().__init__()
        at = _where(device, dtype, generator)
        self.linear_1 = Linear(in_dim, time_embed_dim, **at)
        self.linear_2 = Linear(time_embed_dim, time_embed_dim, **at)

    def forward(self, emb):
        return self.linear_2(F.silu(self.linear_1(emb)))


class ResnetBlock2D(Layer):
    def __init__(self, in_ch, out_ch, temb_ch, groups, device, dtype,
                 generator):
        super().__init__()
        at = _where(device, dtype, generator)
        where = dict(device=device, dtype=dtype)
        self.norm1 = GroupNorm(min(groups, in_ch), in_ch, **where)
        self.conv1 = Conv2D(in_ch, out_ch, 3, padding=1, **at)
        self.time_emb_proj = Linear(temb_ch, out_ch, **at)
        self.norm2 = GroupNorm(min(groups, out_ch), out_ch, **where)
        self.conv2 = Conv2D(out_ch, out_ch, 3, padding=1, **at)
        self.conv_shortcut = Conv2D(in_ch, out_ch, 1, **at) \
            if in_ch != out_ch else None

    def forward(self, x, temb):
        h = self.conv1(self.norm1(x, then="silu"))
        t = self.time_emb_proj(F.silu(temb))
        h = h + t.reshape(t.shape[0], t.shape[1], 1, 1)
        h = self.conv2(self.norm2(h, then="silu"))
        skip = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return skip + h


class CrossAttention(Layer):
    def __init__(self, query_dim, context_dim, heads, head_dim, device,
                 dtype, generator):
        super().__init__()
        at = _where(device, dtype, generator)
        inner = heads * head_dim
        self.heads = heads
        self.head_dim = head_dim
        self.to_q = Linear(query_dim, inner, bias_attr=False, **at)
        self.to_k = Linear(context_dim, inner, bias_attr=False, **at)
        self.to_v = Linear(context_dim, inner, bias_attr=False, **at)
        self.to_out = Linear(inner, query_dim, **at)

    def forward(self, x, context=None):
        context = x if context is None else context
        b, s, _ = x.shape
        sk = context.shape[1]
        q = self.to_q(x).reshape(b, s, self.heads, self.head_dim)
        k = self.to_k(context).reshape(b, sk, self.heads, self.head_dim)
        v = self.to_v(context).reshape(b, sk, self.heads, self.head_dim)
        out = F.scaled_dot_product_attention(q, k, v, is_causal=False)
        return self.to_out(out.reshape(b, s, self.heads * self.head_dim))


class TransformerBlock(Layer):
    """Self-attn -> cross-attn -> FF (diffusers BasicTransformerBlock)."""

    def __init__(self, dim, context_dim, heads, head_dim, device, dtype,
                 generator):
        super().__init__()
        at = _where(device, dtype, generator)
        where = dict(device=device, dtype=dtype)
        self.norm1 = LayerNorm(dim, **where)
        self.attn1 = CrossAttention(dim, dim, heads, head_dim, **at)
        self.norm2 = LayerNorm(dim, **where)
        self.attn2 = CrossAttention(dim, context_dim, heads, head_dim, **at)
        self.norm3 = LayerNorm(dim, **where)
        self.ff_in = Linear(dim, 4 * dim, **at)
        self.ff_out = Linear(4 * dim, dim, **at)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff_out(F.gelu(self.ff_in(self.norm3(x))))


class SpatialTransformer(Layer):
    """GroupNorm -> 1x1 in -> transformer over HW tokens -> 1x1 out + skip."""

    def __init__(self, channels, context_dim, heads, groups, device, dtype,
                 generator):
        super().__init__()
        at = _where(device, dtype, generator)
        head_dim = max(channels // heads, 1)
        self.norm = GroupNorm(min(groups, channels), channels, device=device,
                              dtype=dtype)
        self.proj_in = Conv2D(channels, channels, 1, **at)
        self.transformer = TransformerBlock(channels, context_dim, heads,
                                            head_dim, **at)
        self.proj_out = Conv2D(channels, channels, 1, **at)

    def forward(self, x, context):
        b, c, h, w = x.shape
        res = x
        x = self.proj_in(self.norm(x, then="conv2d"))
        x = x.reshape(b, c, h * w).transpose(1, 2)
        x = self.transformer(x, context)
        x = x.transpose(1, 2).reshape(b, c, h, w)
        return res + self.proj_out(x)


class Downsample(Layer):
    def __init__(self, ch, device, dtype, generator):
        super().__init__()
        self.conv = Conv2D(ch, ch, 3, stride=2, padding=1,
                           **_where(device, dtype, generator))

    def forward(self, x):
        return self.conv(x)


class Upsample(Layer):
    def __init__(self, ch, device, dtype, generator):
        super().__init__()
        self.conv = Conv2D(ch, ch, 3, padding=1,
                           **_where(device, dtype, generator))

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class UNet2DConditionModel(Layer):
    """The UNet on an explicit ``device`` (None = the GPU) in ``dtype``
    (float32), its weights drawn from ``generator``."""

    def __init__(self, config: UNetConfig = None, *, device=None, dtype=None,
                 generator=None, **kwargs):
        super().__init__()
        device = resolve_device(device)
        config = config or UNetConfig(**kwargs)
        self.config = config
        at = _where(device, dtype, generator)
        chs = config.block_out_channels
        groups = config.norm_num_groups
        heads = config.attention_head_dim
        cross = config.cross_attention_dim
        temb_ch = chs[0] * 4
        self.conv_in = Conv2D(config.in_channels, chs[0], 3, padding=1, **at)
        self.time_embedding = TimestepEmbedding(chs[0], temb_ch, **at)

        def attn(level, ch):
            return SpatialTransformer(ch, cross, heads, groups, **at) \
                if config.attn_at(level) else Identity()

        self.down_resnets = LayerList()
        self.down_attns = LayerList()
        self.downsamplers = LayerList()
        ch = chs[0]
        for level, out_ch in enumerate(chs):
            for _ in range(config.layers_per_block):
                self.down_resnets.append(
                    ResnetBlock2D(ch, out_ch, temb_ch, groups, **at))
                self.down_attns.append(attn(level, out_ch))
                ch = out_ch
            if level < len(chs) - 1:
                self.downsamplers.append(Downsample(ch, **at))

        self.mid_res1 = ResnetBlock2D(ch, ch, temb_ch, groups, **at)
        self.mid_attn = SpatialTransformer(ch, cross, heads, groups, **at)
        self.mid_res2 = ResnetBlock2D(ch, ch, temb_ch, groups, **at)

        self.up_resnets = LayerList()
        self.up_attns = LayerList()
        self.upsamplers = LayerList()
        skip_chs = [chs[0]]
        for level, out_c in enumerate(chs):
            skip_chs.extend([out_c] * config.layers_per_block)
            if level < len(chs) - 1:
                skip_chs.append(out_c)  # downsample output
        for level in reversed(range(len(chs))):
            out_ch = chs[level]
            for _ in range(config.layers_per_block + 1):
                skip = skip_chs.pop()
                self.up_resnets.append(
                    ResnetBlock2D(ch + skip, out_ch, temb_ch, groups, **at))
                self.up_attns.append(attn(level, out_ch))
                ch = out_ch
                if not skip_chs:
                    break
            if level > 0:
                self.upsamplers.append(Upsample(ch, **at))

        self.conv_norm_out = GroupNorm(min(groups, ch), ch, device=device,
                                       dtype=dtype)
        self.conv_out = Conv2D(ch, config.out_channels, 3, padding=1, **at)

    def forward(self, sample, timestep, encoder_hidden_states):
        """sample [B, C, H, W]; timestep [B] (or a scalar); context [B, L,
        D]. Returns the predicted noise, the shape of sample."""
        cfg = self.config
        levels = len(cfg.block_out_channels)
        temb = self.time_embedding(
            timestep_embedding(timestep, cfg.block_out_channels[0]))
        h = self.conv_in(sample)
        skips = [h]
        di = 0
        for level in range(levels):
            for _ in range(cfg.layers_per_block):
                h = self.down_resnets[di](h, temb)
                attn = self.down_attns[di]
                if not isinstance(attn, Identity):
                    h = attn(h, encoder_hidden_states)
                skips.append(h)
                di += 1
            if level < levels - 1:
                h = self.downsamplers[level](h)
                skips.append(h)

        h = self.mid_res1(h, temb)
        h = self.mid_attn(h, encoder_hidden_states)
        h = self.mid_res2(h, temb)

        ui = 0
        us = 0
        for level in reversed(range(levels)):
            for _ in range(cfg.layers_per_block + 1):
                if not skips:
                    break
                h = torch.cat([h, skips.pop()], dim=1)
                h = self.up_resnets[ui](h, temb)
                attn = self.up_attns[ui]
                if not isinstance(attn, Identity):
                    h = attn(h, encoder_hidden_states)
                ui += 1
            if level > 0:
                h = self.upsamplers[us](h)
                us += 1

        return self.conv_out(self.conv_norm_out(h, then="silu"))

    def num_params(self):
        return sum(p.numel() for p in self.parameters())


__all__ = ["UNetConfig", "UNet2DConditionModel", "timestep_embedding",
           "TimestepEmbedding", "ResnetBlock2D", "CrossAttention",
           "TransformerBlock", "SpatialTransformer", "Downsample",
           "Upsample"]
