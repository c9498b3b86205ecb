"""Continuous-batching serving over ragged paged attention (PyTorch)."""
from .engine import EngineConfig, ServingEngine
from .kv_pool import KVBlockPool, PoolExhausted
from .ragged import make_attend, ragged_paged_attention
from .scheduler import Request, Scheduler, StepEntry, StepPlan

__all__ = ["EngineConfig", "ServingEngine", "KVBlockPool", "PoolExhausted",
           "make_attend", "ragged_paged_attention", "Request", "Scheduler",
           "StepEntry", "StepPlan"]
