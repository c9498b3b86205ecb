"""Counterpart of ``paddle_tpu.incubate``: the MoE models and
``incubate.nn.functional``'s fused LayerNorm."""
from . import distributed  # noqa: F401
from . import nn  # noqa: F401
