"""Counterpart of ``paddle_tpu.distributed``: the fleet tensor-parallel
layers, on one device."""
from . import fleet  # noqa: F401
