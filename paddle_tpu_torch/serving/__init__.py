"""Continuous-batching serving over ragged paged attention (PyTorch)."""
from .engine import (EngineConfig, EnginePredictor, ServingEngine,
                     engine_from_config)
from .kv_pool import KVBlockPool, PoolExhausted
from .ragged import make_attend, ragged_paged_attention
from .scheduler import Request, Scheduler, StepEntry, StepPlan

__all__ = ["EngineConfig", "ServingEngine", "EnginePredictor",
           "engine_from_config", "KVBlockPool", "PoolExhausted",
           "make_attend", "ragged_paged_attention", "Request", "Scheduler",
           "StepEntry", "StepPlan"]
