from . import random
from .io import load

__all__ = ["load", "random"]
