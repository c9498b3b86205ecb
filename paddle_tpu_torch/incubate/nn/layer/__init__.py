"""``paddle_tpu.incubate.nn``'s fused Transformer layers."""
from .fused_transformer import (  # noqa: F401
    FusedBiasDropoutResidualLayerNorm, FusedFeedForward,
    FusedMultiHeadAttention, FusedTransformerEncoderLayer,
)

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer",
           "FusedBiasDropoutResidualLayerNorm"]
