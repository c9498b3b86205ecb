from . import functional  # noqa: F401
from . import layer  # noqa: F401
from .layer import (  # noqa: F401
    FusedBiasDropoutResidualLayerNorm, FusedFeedForward,
    FusedMultiHeadAttention, FusedTransformerEncoderLayer,
)
