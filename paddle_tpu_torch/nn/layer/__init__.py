"""The ``paddle_tpu.nn`` layers ported so far: those the ERNIE encoder, the
Stable Diffusion UNet and ResNet are built from, the rest of ``norm.py``
and of ``activation.py``."""
from . import activation as _activation
from . import norm as _norm
from .activation import *  # noqa: F401,F403
from .common import Dropout, Embedding, Flatten, Identity, Linear
from .conv import Conv2D
from .layers import LayerList, Sequential
from .loss import CrossEntropyLoss
from .norm import *  # noqa: F401,F403
from .pooling import AdaptiveAvgPool2D, MaxPool2D

__all__ = (list(_activation.__all__) + list(_norm.__all__)
           + ["Dropout", "Embedding", "Flatten", "Identity", "Linear",
              "Conv2D", "LayerList", "Sequential", "CrossEntropyLoss",
              "AdaptiveAvgPool2D", "MaxPool2D"])
