"""``paddle_tpu.vision``'s models, ported: ResNet."""
from . import models

__all__ = ["models"]
