"""Mixture-of-experts layer and gates (counterpart of
``paddle_tpu.incubate.distributed.models.moe``)."""
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate  # noqa: F401
from .moe_layer import MoELayer  # noqa: F401
