from . import functional
from .layer import Dropout, Embedding, LayerList, LayerNorm, Linear

__all__ = ["functional", "Dropout", "Embedding", "LayerList", "LayerNorm",
           "Linear"]
