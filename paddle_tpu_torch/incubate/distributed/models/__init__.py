"""Counterpart of ``paddle_tpu.incubate.distributed.models``."""
from . import moe  # noqa: F401
