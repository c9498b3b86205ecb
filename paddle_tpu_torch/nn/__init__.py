from . import functional, initializer
from .decode import BeamSearchDecoder, dynamic_decode
from ..optimizer import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .initializer import ParamAttr
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layers

__all__ = ["functional", "initializer", "ParamAttr", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "BeamSearchDecoder",
           "dynamic_decode"] + list(_layers)
