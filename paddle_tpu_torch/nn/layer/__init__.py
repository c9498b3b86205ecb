"""The ``paddle_tpu.nn`` layers the ERNIE encoder, the Stable Diffusion
UNet and ResNet are built from."""
from .activation import GELU, ReLU
from .common import Dropout, Embedding, Flatten, Identity, Linear
from .conv import Conv2D
from .layers import LayerList, Sequential
from .loss import CrossEntropyLoss
from .norm import BatchNorm2D, GroupNorm, LayerNorm
from .pooling import AdaptiveAvgPool2D, MaxPool2D

__all__ = ["GELU", "ReLU", "Dropout", "Embedding", "Flatten",
           "Identity", "Linear", "Conv2D", "LayerList", "Sequential",
           "CrossEntropyLoss", "BatchNorm2D", "GroupNorm", "LayerNorm",
           "AdaptiveAvgPool2D", "MaxPool2D"]
