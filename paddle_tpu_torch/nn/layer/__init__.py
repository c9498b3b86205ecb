"""The ``paddle_tpu.nn`` layers the ERNIE encoder is built from."""
from .common import Dropout, Embedding, Linear
from .layers import LayerList
from .norm import LayerNorm

__all__ = ["Dropout", "Embedding", "Linear", "LayerList", "LayerNorm"]
