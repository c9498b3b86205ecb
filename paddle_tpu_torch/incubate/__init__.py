"""Counterpart of ``paddle_tpu.incubate``: the MoE models,
``incubate.nn.functional``'s fused LayerNorm, feed-forward and multi-head
attention, and ``incubate.nn``'s fused Transformer layers."""
from . import distributed  # noqa: F401
from . import nn  # noqa: F401
