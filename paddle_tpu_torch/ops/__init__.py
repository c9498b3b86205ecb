"""The ``paddle_tpu/ops`` functions the port has so far (``special.py``)."""
from . import special

__all__ = ["special"]
