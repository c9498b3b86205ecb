"""Counterpart of ``paddle_tpu.incubate.distributed``."""
from . import models  # noqa: F401
