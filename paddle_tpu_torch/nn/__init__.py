from . import functional
from .layer import (GELU, AdaptiveAvgPool2D, BatchNorm2D, Conv2D,
                    CrossEntropyLoss, Dropout, Embedding, Flatten, GroupNorm,
                    Identity, LayerList, LayerNorm, Linear, MaxPool2D, ReLU,
                    Sequential)

__all__ = ["functional", "GELU", "AdaptiveAvgPool2D", "BatchNorm2D",
           "Conv2D", "CrossEntropyLoss", "Dropout", "Embedding", "Flatten",
           "GroupNorm", "Identity", "LayerList", "LayerNorm", "Linear",
           "MaxPool2D", "ReLU", "Sequential"]
