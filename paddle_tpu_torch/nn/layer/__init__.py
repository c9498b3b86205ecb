"""The ``paddle_tpu.nn`` layers ported so far: ``Layer`` and its
containers, those the ERNIE encoder, the Stable Diffusion UNet and ResNet
are built from, and the whole of ``norm.py``, ``activation.py``,
``loss.py``, ``common.py``, ``transformer.py`` and ``rnn.py``."""
from . import activation as _activation
from . import common as _common
from . import layers as _layers
from . import loss as _loss
from . import norm as _norm
from . import rnn as _rnn
from . import transformer as _transformer
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import Conv2D
from .layers import (  # noqa: F401
    HookRemoveHelper, Layer, LayerDict, LayerList, ParameterDict,
    ParameterList, Sequential, disable_static, enable_static,
    in_dynamic_mode)
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import AdaptiveAvgPool2D, MaxPool2D
from .rnn import *  # noqa: F401,F403
from .transformer import *  # noqa: F401,F403

__all__ = (list(_activation.__all__) + list(_norm.__all__)
           + list(_common.__all__) + list(_loss.__all__)
           + list(_transformer.__all__) + list(_rnn.__all__)
           + [n for n in _layers.__all__
              if n not in ("placement", "make_parameter")]
           + ["Conv2D", "AdaptiveAvgPool2D", "MaxPool2D"])
