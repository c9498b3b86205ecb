"""Counterpart of ``paddle_tpu.incubate``: the MoE models."""
from . import distributed  # noqa: F401
