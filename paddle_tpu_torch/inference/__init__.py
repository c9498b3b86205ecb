"""paddle_tpu_torch.inference — the serving front door.

Mirrors ``paddle_tpu/inference/__init__.py``:

  * ``Config`` with its routed serving knobs;
  * the artifact ``Predictor`` (``create_predictor``) over a ``jit.save``
    artifact loaded by ``jit.load``, with zero-copy style handles
    (``copy_from_cpu`` / ``copy_to_cpu``); ``clone`` shares the loaded
    program and weights and keeps its own handles. It runs on the GPU
    (``Config.enable_use_gpu``, the default) or, after
    ``Config.disable_gpu()``, on the CPU;
  * ``create_llm_predictor``: one continuous-batching ``ServingEngine``
    over a live causal LM behind the ``Predictor`` duck type, whose
    clones share the engine; ``set_speculative_config`` routes
    speculative decoding to that engine;
  * ``PredictorPool`` over a config or a predictor;
  * ``BatchingServer``: request-queue micro-batching that stacks
    compatible requests into one artifact run, or, over an engine-backed
    predictor, hands each request to the shared engine, which its worker
    thread drives.

Tensor parallelism (``set_tensor_parallel_degree``) is not ported yet
(ROADMAP.md).
"""
from __future__ import annotations

import queue
import threading
import time
import warnings
from concurrent.futures import Future, InvalidStateError
from typing import Dict, List, Optional

import numpy as np
import torch

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
    route to the engine and ``enable_use_gpu`` / ``disable_gpu`` pick the
    Predictors' device; graph-optimization knobs and ``enable_xpu`` are
    accepted for API compatibility but have no effect, and each warns
    ONCE so a misconfiguration is visible instead of silent."""

    def __init__(self, model_path: Optional[str] = None,
                 params_path: Optional[str] = None):
        if model_path and model_path.endswith(".pdmodel"):
            model_path = model_path[:-len(".pdmodel")]
        self.model_path = model_path
        self.params_path = params_path
        self._ir_optim = True
        self._memory_optim = True
        self._device = None            # the Predictors'; None = the GPU
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

    # -- the device (routed: the Predictors run where it says) ----------------
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0,
                       *a, **k):
        """Run the Predictors on GPU ``device_id`` (the default is the
        GPU; a Predictor raises without one). The memory pool is PyTorch's
        caching allocator's to size."""
        self._device = f"cuda:{int(device_id)}"

    def disable_gpu(self):
        """Run the Predictors on the CPU, through the kernels' plain
        versions."""
        self._device = "cpu"

    def use_gpu(self) -> bool:
        return self._device != "cpu"

    def gpu_device_id(self) -> int:
        return torch.device(self._device or "cuda:0").index or 0

    def device(self):
        """The Predictors' device: "cpu", "cuda:N", or None for the GPU."""
        return self._device

    def set_model(self, model_path, params_path=None):
        device = self._device
        self.__init__(model_path, params_path)
        self._device = device

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

    def enable_xpu(self, *a, **k):
        _warn_noop("enable_xpu",
                   "the port runs on the GPU, or on the CPU after "
                   "disable_gpu()")

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


class _Handle:
    """Parity: the predictor's input/output tensor handle
    (``copy_from_cpu`` / ``copy_to_cpu``). Holds a tensor on the
    predictor's device."""

    def __init__(self, device=None):
        self._device = device
        self._array = None

    def copy_from_cpu(self, arr):
        t = arr if isinstance(arr, torch.Tensor) \
            else torch.from_numpy(np.array(arr))
        self._array = t.to(self._device) if self._device is not None else t

    def copy_to_cpu(self) -> np.ndarray:
        t = self._array.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    def reshape(self, shape):
        if self._array is not None:
            self._array = self._array.reshape(shape)

    @property
    def shape(self):
        return None if self._array is None else list(self._array.shape)


class Predictor:
    """Parity: paddle.inference.Predictor (AnalysisPredictor::Run) over a
    ``jit.save`` artifact, loaded on the device that ``config`` names."""

    def __init__(self, config: Config, _layer=None):
        if _layer is None:
            from ..jit import load
            if not config.model_path:
                raise ValueError(
                    "Config needs a model path (jit.save artifact)")
            _layer = load(config.model_path, device=config.device())
        self._config = config
        self._layer = _layer
        self._inputs: Dict[str, _Handle] = {
            n: _Handle(_layer.device) for n in self._layer.input_names()}
        self._outputs: List[torch.Tensor] = []

    def clone(self) -> "Predictor":
        """Share the loaded program and weights; private handles (parity:
        AnalysisPredictor::Clone)."""
        return Predictor(self._config, _layer=self._layer)

    def get_input_names(self) -> List[str]:
        return list(self._inputs)

    def get_input_handle(self, name: str) -> _Handle:
        return self._inputs[name]

    def run(self, inputs: Optional[List[np.ndarray]] = None):
        """Either positional ``inputs`` (returns the outputs, the
        ``predictor.run(list)`` form) or through the handles
        (``copy_from_cpu`` then ``run()``). Returns numpy arrays."""
        if inputs is not None:
            if len(inputs) != len(self._inputs):
                raise ValueError(
                    f"predictor expects {len(self._inputs)} inputs "
                    f"({list(self._inputs)}), got {len(inputs)}")
            for h, a in zip(self._inputs.values(), inputs):
                h.copy_from_cpu(a)
        args = [h._array for h in self._inputs.values()]
        if any(a is None for a in args):
            missing = [n for n, h in self._inputs.items() if h._array is None]
            raise ValueError(f"inputs not set: {missing}")
        out = self._layer.forward(*args)
        if not isinstance(out, (list, tuple)):
            out = [out]
        self._outputs = list(out)
        return [self.get_output_handle(n).copy_to_cpu()
                for n in self.get_output_names()]

    def get_output_names(self) -> List[str]:
        return [f"output_{i}" for i in range(len(self._outputs))]

    def get_output_handle(self, name: str) -> _Handle:
        h = _Handle()
        h._array = self._outputs[int(name.rsplit("_", 1)[1])]
        return h


def create_predictor(config: Config) -> Predictor:
    """Parity: paddle.inference.create_predictor, over a ``jit.save``
    artifact."""
    return Predictor(config)


def create_llm_predictor(model, config: Optional[Config] = None,
                         max_new_tokens: int = 32,
                         eos_id: Optional[int] = None, device=None):
    """Engine-backed predictor over a live causal LM: builds ONE
    continuous-batching ServingEngine honoring the Config's routed
    serving knobs (set_max_batch_size / set_kv_cache_*) and wraps it in
    the Predictor duck type, so PredictorPool clones share the engine.
    ``device`` None means the config's (``disable_gpu``), else the GPU
    (raises without one)."""
    from ..serving import EnginePredictor, engine_from_config
    if device is None and config is not None:
        device = config.device()
    eng = engine_from_config(model, config, device=device)
    pred = EnginePredictor(eng, max_new_tokens=max_new_tokens,
                           eos_id=eos_id)
    pred._config = config if config is not None else Config()
    return pred


class PredictorPool:
    """Parity: paddle.inference.PredictorPool: ``size`` predictors over ONE
    loaded artifact (``config``) or over ``predictor=`` (e.g. a
    ``create_llm_predictor`` result): the first is the main predictor,
    the rest are its clones, so concurrent server threads each own their
    handles while sharing the program and weights; engine-backed clones
    share ONE scheduler and KV pool."""

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


class BatchingServer:
    """Request-queue micro-batching over one predictor.

    ``submit()`` enqueues one request (one array per model input) and
    returns a Future; a worker thread drains the queue, groups up to
    ``max_batch_size`` requests of identical shapes and dtypes, stacks
    them along a new axis 0, runs ONE forward and splits the outputs back
    per request. A request of another shape flushes the group first.

    Over an engine-backed predictor (``serving.EnginePredictor``, which
    has an ``engine``), the server DELEGATES: each request goes straight
    into the shared continuous-batching engine, and the worker thread
    drives it (``step`` while it has work, else ``wait_for_work``). A step
    that raises fails every live request through ``engine.abort_all``, so
    no Future hangs."""

    def __init__(self, predictor, max_batch_size: Optional[int] = None,
                 max_delay_ms: float = 2.0):
        self._pred = predictor
        self._engine = getattr(predictor, "engine", None)
        if max_batch_size is None:
            cfg = getattr(predictor, "_config", None)
            routed = cfg.serving_options().get("max_seqs") \
                if isinstance(cfg, Config) else None
            if routed is None and self._engine is not None:
                routed = self._engine.config.max_seqs
            max_batch_size = routed or 8
        self.max_batch_size = int(max_batch_size)
        self.max_delay = float(max_delay_ms) / 1000.0
        self._q: "queue.Queue" = queue.Queue()
        self._stop = False
        self._submit_lock = threading.Lock()
        self._inflight: List = []     # engine mode: (Request, Future)
        self.batches_run = 0
        self.requests_served = 0
        self._worker = threading.Thread(
            target=self._loop_engine if self._engine is not None
            else self._loop, daemon=True, name="inference-batcher")
        self._worker.start()

    # -- client side ----------------------------------------------------------
    def submit(self, inputs) -> Future:
        """Enqueue one request; returns a Future whose ``result()`` is the
        output list of THIS request."""
        fut: Future = Future()
        # the lock closes the submit-vs-close race: nothing enqueues after
        # the close sentinel, so no Future is left undrained
        with self._submit_lock:
            if self._stop:
                raise RuntimeError("BatchingServer is closed")
            if self._engine is not None:
                (ids,) = inputs
                req = self._engine.submit(
                    np.asarray(ids).reshape(-1).tolist(),
                    max_new_tokens=getattr(self._pred, "max_new_tokens", 32),
                    eos_id=getattr(self._pred, "eos_id", None))
                self._inflight.append((req, fut))
                return fut
            # a copy: the caller may reuse its buffer before the worker
            # drains the queue
            self._q.put(([np.array(a) for a in inputs], fut))
        return fut

    def close(self):
        with self._submit_lock:
            if self._stop:
                return
            self._stop = True
            self._q.put(None)
        self._worker.join(timeout=60.0)

    # -- delegation: the worker steps the shared engine -----------------------
    def _resolve_finished(self):
        with self._submit_lock:
            live = []
            for req, fut in self._inflight:
                if not req.done:
                    live.append((req, fut))
                elif req.error is not None:
                    self._deliver(fut, exc=req.error)
                else:
                    self.requests_served += 1
                    self._deliver(fut,
                                  result=[np.asarray(req.output, np.int32)])
            self._inflight = live

    def _loop_engine(self):
        eng = self._engine
        while True:
            self._resolve_finished()
            # a shared engine may always have work from other front doors:
            # this server owes only its own requests
            if self._stop and not self._inflight:
                return
            if eng.has_work():
                try:
                    eng.step()
                except BaseException as e:  # noqa: BLE001
                    # fail every live request (its Future raises) rather
                    # than leave this thread dead and its clients parked
                    eng.abort_all(e)
                self.batches_run += 1
            else:
                eng.wait_for_work(timeout=0.02)

    # -- stacking --------------------------------------------------------------
    @staticmethod
    def _signature(arrays):
        return tuple((a.shape, str(a.dtype)) for a in arrays)

    def _loop(self):
        pending = []   # [(arrays, fut)] of one signature
        sig = None
        deadline = None
        while True:
            timeout = None if not pending else \
                max(0.0, deadline - time.monotonic())
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                item = False          # the delay expired: flush
            if item is None:          # close()
                if pending:
                    self._run_batch(pending)
                return
            if item is not False:
                arrays, _ = item
                s = self._signature(arrays)
                if pending and s != sig:
                    self._run_batch(pending)   # another shape: flush first
                    pending = []
                if not pending:
                    sig = s
                    deadline = time.monotonic() + self.max_delay
                pending.append(item)
                if len(pending) < self.max_batch_size and \
                        time.monotonic() < deadline:
                    continue
            if pending:
                self._run_batch(pending)
                pending = []

    @staticmethod
    def _deliver(fut, result=None, exc=None):
        # a client may have cancelled its Future; that must not poison the
        # requests batched with it
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)
        except InvalidStateError:
            pass

    def _run_batch(self, batch):
        try:
            n_inputs = len(batch[0][0])
            stacked = [np.stack([req[0][i] for req in batch])
                       for i in range(n_inputs)]
            outs = self._pred.run(stacked)
            self.batches_run += 1
            self.requests_served += len(batch)
            for j, (_, fut) in enumerate(batch):
                self._deliver(fut, result=[o[j] for o in outs])
        except BaseException as e:  # noqa: BLE001
            for _, fut in batch:
                self._deliver(fut, exc=e)


__all__ = ["Config", "Predictor", "PredictorPool", "BatchingServer",
           "create_predictor", "create_llm_predictor"]
