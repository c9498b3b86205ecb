"""paddle_tpu_torch.inference — the serving front door.

Mirrors ``paddle_tpu/inference/__init__.py``'s engine-backed half:
``Config`` with its routed serving knobs, ``create_llm_predictor`` (one
continuous-batching ``ServingEngine`` over a live causal LM, behind the
``Predictor`` duck type) and ``PredictorPool`` over such a predictor,
whose clones share the engine; ``set_speculative_config`` routes
speculative decoding to that engine. The artifact ``Predictor`` and
``create_predictor`` (over ``jit.save``), ``BatchingServer`` and tensor
parallelism are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional

_warned_noops = set()


def _warn_noop(knob: str, why: str):
    if knob not in _warned_noops:
        _warned_noops.add(knob)
        warnings.warn(f"inference.Config.{knob} has no effect here: {why}",
                      stacklevel=3)


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet (see ROADMAP.md)")


class Config:
    """Parity: paddle.inference.Config (AnalysisConfig). The serving knobs
    route to the engine; graph-optimization and device knobs are accepted
    for API compatibility but have no effect, and each warns ONCE so a
    misconfiguration is visible instead of silent."""

    def __init__(self, model_path: Optional[str] = None,
                 params_path: Optional[str] = None):
        if model_path and model_path.endswith(".pdmodel"):
            model_path = model_path[:-len(".pdmodel")]
        self.model_path = model_path
        self.params_path = params_path
        self._ir_optim = True
        self._memory_optim = True
        # serving knobs routed to paddle_tpu_torch.serving (NOT no-ops):
        # batch and KV-cache sizing feed ServingEngine via
        # serving_options()
        self._serving = {"max_seqs": None, "block_size": None,
                         "num_blocks": None}
        self._speculative = {"spec_method": None, "num_draft_tokens": None,
                             "draft_model": None, "spec_options": None}

    # -- serving knobs (routed, not warned) -----------------------------------
    def set_max_batch_size(self, n: int):
        """Max concurrently running sequences for the serving engine
        (ServingEngine max_seqs)."""
        if int(n) < 1:
            raise ValueError(f"max_batch_size must be >= 1, got {n}")
        self._serving["max_seqs"] = int(n)

    def set_kv_cache_block_size(self, tokens: int):
        """Token slots per KV page (ServingEngine block_size)."""
        if int(tokens) < 1:
            raise ValueError(f"kv block size must be >= 1, got {tokens}")
        self._serving["block_size"] = int(tokens)

    def set_kv_cache_capacity(self, blocks: int):
        """Total pages in the shared KV pool (ServingEngine num_blocks)."""
        if int(blocks) < 1:
            raise ValueError(f"kv capacity must be >= 1, got {blocks}")
        self._serving["num_blocks"] = int(blocks)

    def set_tensor_parallel_degree(self, mp: int):
        raise _not_ported("tensor-parallel serving "
                          "(Config.set_tensor_parallel_degree)")

    def serving_options(self) -> Dict[str, Optional[int]]:
        """The routed serving knobs (serving.engine_from_config reads
        this; None = engine default)."""
        return dict(self._serving)

    def set_speculative_config(self, method: str, num_draft_tokens: int = 4,
                               draft_model=None, **options):
        """Speculative decoding for the serving engine: ``method`` "ngram"
        (model-free self-drafting; options max_match, min_match, lookback)
        or "draft_model" (needs ``draft_model``, a small causal LM; options
        context_width, quant), or "none"; ``num_draft_tokens`` is the
        per-sequence draft budget k. Routed to the engine; greedy output
        stays that of plain decoding."""
        if method not in ("ngram", "draft_model", "none", None):
            raise ValueError(
                f"unknown speculative method {method!r}: expected 'ngram',"
                f" 'draft_model', or 'none'")
        if int(num_draft_tokens) < 1:
            raise ValueError(
                f"num_draft_tokens must be >= 1, got {num_draft_tokens}")
        if method == "draft_model" and draft_model is None:
            raise ValueError("method='draft_model' needs draft_model=")
        self._speculative = {
            "spec_method": None if method == "none" else method,
            "num_draft_tokens": int(num_draft_tokens),
            "draft_model": draft_model,
            "spec_options": dict(options) if options else None}

    def speculative_options(self) -> Dict[str, object]:
        """The routed speculative knobs (serving.engine_from_config reads
        this; None = engine default, speculation off)."""
        return dict(self._speculative)

    def set_model(self, model_path, params_path=None):
        self.__init__(model_path, params_path)

    def model_dir(self):
        return self.model_path

    # accepted no-ops: keep the reference surface working, but never
    # silently — one warning per knob per process. Enabling the
    # optimizations is the default (nothing to say); DISABLING them is a
    # request that cannot be honored, which warrants the warning.
    def switch_ir_optim(self, flag=True):
        self._ir_optim = flag
        if not flag:
            _warn_noop("switch_ir_optim(False)",
                       "the engine always runs its captured CUDA graph")

    def enable_memory_optim(self, flag=True):
        self._memory_optim = flag
        if not flag:
            _warn_noop("enable_memory_optim(False)",
                       "PyTorch's caching allocator owns buffer assignment")

    def disable_glog_info(self):
        pass  # logging verbosity: harmless, genuinely nothing to do

    def enable_use_gpu(self, *a, **k):
        _warn_noop("enable_use_gpu",
                   "the device is the engine's (device=, the GPU unless "
                   "'cpu')")

    def disable_gpu(self):
        _warn_noop("disable_gpu",
                   "the device is the engine's (device=, the GPU unless "
                   "'cpu')")

    def enable_xpu(self, *a, **k):
        _warn_noop("enable_xpu",
                   "the device is the engine's (device=, the GPU unless "
                   "'cpu')")

    def enable_tensorrt_engine(self, workspace_size=1 << 30,
                               max_batch_size=None, *a, **k):
        """TRT subgraphs are replaced by the port's own kernels (warned
        once), but the max_batch_size the reference buries in this call
        IS routed to the serving engine instead of being dropped."""
        if max_batch_size is not None:
            self.set_max_batch_size(max_batch_size)
        _warn_noop("enable_tensorrt_engine",
                   "hand-written CUDA kernels in a captured CUDA graph "
                   "replace the TRT subgraph engine (its max_batch_size is "
                   "routed to the serving engine)")

    def set_cpu_math_library_num_threads(self, n):
        _warn_noop("set_cpu_math_library_num_threads",
                   "PyTorch owns its own thread pool")


def create_predictor(config: Config):
    """Parity: paddle.inference.create_predictor, over a ``jit.save``
    artifact: not ported."""
    raise _not_ported("the artifact Predictor (create_predictor over "
                      "jit.save)")


def create_llm_predictor(model, config: Optional[Config] = None,
                         max_new_tokens: int = 32,
                         eos_id: Optional[int] = None, device=None):
    """Engine-backed predictor over a live causal LM: builds ONE
    continuous-batching ServingEngine honoring the Config's routed
    serving knobs (set_max_batch_size / set_kv_cache_*) and wraps it in
    the Predictor duck type, so PredictorPool clones share the engine.
    ``device`` None means the GPU (raises without one)."""
    from ..serving import EnginePredictor, engine_from_config
    eng = engine_from_config(model, config, device=device)
    pred = EnginePredictor(eng, max_new_tokens=max_new_tokens,
                           eos_id=eos_id)
    pred._config = config if config is not None else Config()
    return pred


class PredictorPool:
    """Parity: paddle.inference.PredictorPool over ``predictor=`` (e.g. a
    ``create_llm_predictor`` result): the first is the predictor given,
    the rest are its clones, and engine-backed clones share ONE scheduler
    and KV pool, not per-predictor state."""

    def __init__(self, config: Optional[Config] = None, size: int = 1,
                 predictor=None):
        if size < 1:
            raise ValueError(f"pool size must be >= 1, got {size}")
        if predictor is None:
            if config is None:
                raise ValueError("PredictorPool needs a config or a "
                                 "predictor")
            predictor = create_predictor(config)
        self._preds: List = [predictor] + [predictor.clone()
                                           for _ in range(size - 1)]

    def __len__(self):
        return len(self._preds)

    def retrieve(self, idx: int):
        return self._preds[idx]


__all__ = ["Config", "PredictorPool", "create_predictor",
           "create_llm_predictor"]
