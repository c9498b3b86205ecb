"""ServingEngine: continuous batching over ragged paged attention.

Mirrors ``paddle_tpu/serving/engine.py`` for one model on one device:

  * ``generation._LlamaDecoder.step_ragged`` runs one packed mixed-phase
    batch per step (fixed token budget, slot count and page-table width);
  * ``kv_pool.KVBlockPool`` owns the shared fixed-size pages, ref-counted,
    with hash-chain prefix reuse across requests;
  * ``scheduler.Scheduler`` admits and evicts requests at every step under
    the token budget;
  * ``serving.ragged`` is the attention: the CUDA kernel on the GPU, its
    plain version on the CPU;
  * ``quant`` serves weight-only int8 / int4 / fp8 matrices through the
    weight-only GEMM (``generation._quant_weights_cached``);
  * ``spec_method`` drafts tokens (``serving.speculative``) that ride the
    same packed step as prefill-like rows, verifies them against the
    step's argmax rows and rolls rejected ones back
    (``KVBlockPool.truncate``, copy-on-write of a shared boundary page).

The JAX engine serves through one compiled program, built at construction.
Here, on the card, the step is one CUDA graph captured at construction for
the engine's fixed shapes: a step stages its inputs in one pinned host
buffer, copies it to the card, replays the graph (the greedy tokens are
taken inside it), copies the tokens back and synchronizes once, as the JAX
engine fetches its sampled tokens. The pools are updated in place where
the JAX program donates them, at addresses fixed for the engine's life. On
the CPU the same step runs op by op. ``EnginePredictor`` and
``engine_from_config`` are the ``inference`` front door's engine side.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..generation import _decoder_for, _quant_weights_cached
from ..kernels import LAUNCHES, uncount_since
from ..quantization._kernels import ALGO_BITS
from . import ragged as _ragged
from .kv_pool import KVBlockPool
from .scheduler import Request, Scheduler
from .speculative import make_drafter, verify_greedy

# options of the JAX engine that later slices of the port bring
_LATER = ("aot_cache", "obs", "memwatch", "resilience", "mesh", "role")


class EngineConfig:
    """Static shapes and policy for one engine.

    ``quant``: None or one of ``quantization.ALGO_BITS``
    ("weight_only_int8", "weight_only_int4", "weight_only_fp8").
    Speculative decoding: ``spec_method`` None (off), "ngram" or
    "draft_model" (needs ``draft_model``); ``num_draft_tokens`` is k, the
    drafts a sequence may feed a step; ``spec_options`` are the drafter's
    keyword arguments. Greedy output stays that of plain decoding."""

    def __init__(self, max_seqs: int = 8, token_budget: int = 64,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 max_model_len: Optional[int] = None,
                 enable_prefix_cache: bool = True,
                 policy: str = "continuous", quant: Optional[str] = None,
                 spec_method: Optional[str] = None,
                 num_draft_tokens: int = 4, draft_model=None,
                 spec_options: Optional[dict] = None,
                 aot_cache=None, obs=None, memwatch=None, resilience=None,
                 mesh=None, role=None):
        given = dict(aot_cache=aot_cache, obs=obs, memwatch=memwatch,
                     resilience=resilience, mesh=mesh, role=role)
        later = [k for k in _LATER if given[k] is not None]
        if later:
            raise NotImplementedError(
                f"EngineConfig options {later} are not ported to "
                "paddle_tpu_torch yet (see ROADMAP.md)")
        if quant is not None and quant not in ALGO_BITS:
            raise NotImplementedError(
                f"EngineConfig(quant={quant!r}): supported algos are "
                f"{sorted(ALGO_BITS)}")
        self.max_seqs = int(max_seqs)
        self.token_budget = int(token_budget)
        self.block_size = int(block_size)
        self.num_blocks = num_blocks
        self.max_model_len = max_model_len
        self.enable_prefix_cache = bool(enable_prefix_cache)
        self.policy = policy
        self.quant = quant
        self.spec_method = spec_method
        self.num_draft_tokens = int(num_draft_tokens)
        self.draft_model = draft_model
        self.spec_options = dict(spec_options) if spec_options else {}
        if spec_method not in (None, "none", "ngram", "draft_model"):
            raise ValueError(
                f"unknown speculative method {spec_method!r}: expected "
                "'ngram' or 'draft_model' (or None to disable)")
        if spec_method is not None and self.num_draft_tokens < 1:
            raise ValueError(
                f"speculative decoding needs num_draft_tokens >= 1, "
                f"got {self.num_draft_tokens}")


def _argmax_rows(logits):
    """Greedy token for every packed row."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _engine_step_impl(dec, w, tokens, slot_ids, positions, valid, tables,
                      k_pools, v_pools):
    """One serving step: scatter targets from the page tables, ragged
    attention over the pools (written in place), logits for every packed
    token. The pools hold one spare page past the ``KVBlockPool``'s
    (``[L, P + 1, ...]``): rows the JAX program drops write there."""
    bs = k_pools.shape[3]
    spare = k_pools.shape[1] - 1
    mp = tables.shape[1]
    col = positions // bs
    page = torch.take_along_dim(tables[slot_ids],
                                col.clamp(0, mp - 1)[:, None].long(), 1)[:, 0]
    # invalid rows write to the spare page, which no page table names
    bad = (~valid) | (col >= mp) | (page < 0)
    pages = torch.where(bad, spare, page)
    offs = positions % bs
    attend = _ragged.make_attend(tables, slot_ids, positions, valid,
                                 dec.n_heads // dec.n_kv)
    return dec.step_ragged(w, tokens, positions, k_pools, v_pools,
                           (pages.long(), offs.long()), attend)


class ServingEngine:
    """Continuous-batching LLM serving over one model on one device.

    ``device`` None means the GPU (raises without one); the model must
    live there. On the GPU the step is captured in a CUDA graph here, and
    the engine raises if capture fails (it never falls back to the eager
    step). Thread-safe: ``submit`` may be called from client threads while
    one thread drives ``step()`` (``wait_for_work`` blocks that thread
    until there is work; ``abort_all`` fails every live request). A step
    runs on the engine's stream, whichever thread drives it. ``seed`` is
    the JAX engine's third argument, kept as it keeps it (a generator that
    nothing draws from); ``device`` is keyword-only."""

    def __init__(self, model, config: Optional[EngineConfig] = None,
                 seed: int = 0, *, device=None):
        cfg = config or EngineConfig()
        self._rng = np.random.default_rng(seed)
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"the model lives on {model.device}, the "
                             f"engine was asked for {self.device}")
        self.model = model
        self.config = cfg
        self.dec = _decoder_for(model)
        mco = getattr(self.dec, "min_capacity_override", None)
        if mco is not None and mco < cfg.token_budget:
            raise ValueError(
                f"MoE _capacity_override={mco} < token_budget "
                f"{cfg.token_budget}: a full step could drop tokens, which "
                "the no-drop decode contract forbids; raise the override "
                "or shrink the budget")
        # the engine holds the quantized leaves for its life: its captured
        # graph reads them where they lie
        self._w = (_quant_weights_cached(self.dec, model, cfg.quant)
                   if cfg.quant else self.dec.weights(model))
        max_len = cfg.max_model_len or model.config.max_position_embeddings
        self.max_model_len = int(min(max_len,
                                     model.config.max_position_embeddings))
        bs = cfg.block_size
        self.max_pages_per_seq = -(-self.max_model_len // bs)
        num_blocks = cfg.num_blocks
        if num_blocks is None:
            num_blocks = cfg.max_seqs * self.max_pages_per_seq
        dtype = self._w[self.dec.embed_key].dtype
        # one spare page past the pool's (see _engine_step_impl)
        shape = (self.dec.n_layers, num_blocks + 1, self.dec.n_kv, bs,
                 self.dec.hd)
        self._kp = torch.zeros(shape, dtype=dtype, device=model.device)
        self._vp = torch.zeros(shape, dtype=dtype, device=model.device)
        self.pool = KVBlockPool(num_blocks, bs,
                                enable_prefix_cache=cfg.enable_prefix_cache)
        spec_opts = dict(cfg.spec_options)
        if cfg.spec_method == "draft_model":
            if cfg.draft_model is None:
                raise ValueError(
                    "spec_method='draft_model' needs a draft_model")
            d_cap = cfg.draft_model.config.max_position_embeddings
            if d_cap <= cfg.num_draft_tokens:
                raise ValueError(
                    f"draft model caps at {d_cap} positions, cannot draft "
                    f"{cfg.num_draft_tokens} tokens per step")
            # every propose padded to (max_seqs, width, num_draft_tokens):
            # one captured draft graph however the decode batch changes
            spec_opts.setdefault("batch_pad", cfg.max_seqs)
            spec_opts.setdefault("draft_k", cfg.num_draft_tokens)
        self.drafter = make_drafter(cfg.spec_method,
                                    draft_model=cfg.draft_model, **spec_opts)
        self.sched = Scheduler(self.pool, cfg.max_seqs, cfg.token_budget,
                               self.max_pages_per_seq, policy=cfg.policy,
                               drafter=self.drafter,
                               num_draft_tokens=cfg.num_draft_tokens
                               if self.drafter is not None else 0)
        # a step's inputs, int32, staged on the host in one buffer (pinned
        # on the GPU) that one copy moves to the device: tokens, slot ids,
        # positions and valid [token_budget], then the page tables
        # [max_seqs, max_pages_per_seq] (-1 = unassigned)
        t_max = cfg.token_budget
        n = 4 * t_max + cfg.max_seqs * self.max_pages_per_seq
        pin = self.device.type == "cuda"
        self._stage = torch.zeros(n, dtype=torch.int32, pin_memory=pin)
        self._inputs = torch.zeros(n, dtype=torch.int32, device=self.device)
        self._sampled = torch.zeros(t_max, dtype=torch.int32, pin_memory=pin)
        host = self._stage.numpy()
        self._tokens, self._slots, self._positions, self._valid = (
            host[i * t_max:(i + 1) * t_max] for i in range(4))
        self._tables = host[4 * t_max:].reshape(cfg.max_seqs,
                                                self.max_pages_per_seq)
        self._tables[:] = -1
        self._lock = threading.RLock()
        self._work = threading.Event()     # set while requests wait or run
        self.requests_failed = 0
        self.steps = 0
        self.tokens_fed = 0            # packed tokens run through the model
        self.tokens_generated = 0
        self.spec_proposed = 0         # draft tokens fed to verify steps
        self.spec_accepted = 0
        self.spec_rollback_pages = 0   # pages released by rollbacks
        # host seconds of every step, summed: scheduling, staging the
        # inputs, the device step (copies, launch or replay, the one
        # synchronize) and handing tokens to the requests
        self.host_seconds = dict.fromkeys(("schedule", "pack", "device",
                                           "emit"), 0.0)
        self._logits = None            # the latest step's [T, V] logits
        self._graph = None
        self.capture_seconds = None
        self.graph_pool_bytes = None
        self._step = self._step_eager
        self._stream = torch.cuda.current_stream(self.device) \
            if self.device.type == "cuda" else None
        if self.device.type == "cuda":
            self._capture()
            self._step = self._replay

    # -- the device step --------------------------------------------------------
    def _step_body(self):
        """The step over the device buffer of inputs: the greedy token of
        every row [T] int32 (the logits [T, V] stay in ``_logits``)."""
        t = self.config.token_budget
        x = self._inputs
        self._logits = _engine_step_impl(
            self.dec, self._w, x[:t].long(), x[t:2 * t], x[2 * t:3 * t],
            x[3 * t:4 * t] != 0, x[4 * t:].view(self._tables.shape),
            self._kp, self._vp)
        return _argmax_rows(self._logits)

    def _on_stream(self):
        """The engine's stream (the one current where it was built) as the
        calling thread's current stream: a step's staging copy, replay and
        synchronize stay on one stream whichever thread drives it."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _step_eager(self):
        """The step op by op: the CPU engine's path, and on the GPU the
        yardstick of the captured step. Returns the sampled tokens."""
        self._inputs.copy_(self._stage, non_blocking=True)
        with torch.inference_mode():
            self._sampled.copy_(self._step_body(), non_blocking=True)
        self._sync()
        return self._sampled.numpy()

    def _replay(self):
        self._inputs.copy_(self._stage, non_blocking=True)
        self._graph.replay()
        for name, n in self._tally.items():
            LAUNCHES[name] += n
        self._sampled.copy_(self._graph_tokens, non_blocking=True)
        self._sync()
        return self._sampled.numpy()

    def _capture(self):
        """Capture the step in a CUDA graph for the engine's fixed shapes
        (the port of the JAX engine's jitted step and its warm start).
        A warm-up on a side stream first builds the kernels, compiles the
        Triton ones and makes cuBLAS's handles, over padding rows only,
        which write nothing but the spare page. Every replay adds the
        launches the capture counted."""
        t0 = time.perf_counter()
        dev = self.device
        self._inputs.copy_(self._stage)
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side), torch.inference_mode():
            self._step_body()
        cur.wait_stream(side)
        # what the capture adds to the memory PyTorch holds is the graph's
        # pool (torch.cuda.graph frees the cached blocks as it starts)
        gc.collect()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        before = dict(LAUNCHES)
        try:
            with torch.inference_mode(), torch.cuda.graph(graph):
                self._graph_tokens = self._step_body()
        finally:
            self._tally = uncount_since(before)
        self._graph = graph
        self.graph_pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.capture_seconds = time.perf_counter() - t0

    # -- client side ----------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               eos_id: Optional[int] = None, on_token=None,
               stream: bool = False) -> Request:
        """Enqueue one request; returns the Request handle (``result()``
        blocks for the token list, ``stream()`` yields tokens live)."""
        req = Request(prompt, max_new_tokens=max_new_tokens, eos_id=eos_id,
                      on_token=on_token, stream=stream)
        total = len(req.prompt) + req.max_new_tokens
        if total > self.max_model_len:
            raise ValueError(
                f"prompt {len(req.prompt)} + max_new_tokens "
                f"{req.max_new_tokens} exceeds max_model_len "
                f"{self.max_model_len}")
        # the last fed position is total-2 (the final sampled token is
        # never fed), so the worst case is (total-2)//bs + 1 pages
        if (total - 2) // self.pool.block_size + 1 > self.pool.num_blocks:
            raise ValueError(
                f"request needs more pages than the whole pool "
                f"({self.pool.num_blocks} x {self.pool.block_size})")
        with self._lock:
            self.sched.submit(req)
            self._work.set()
        return req

    # -- stepping side --------------------------------------------------------
    def step(self) -> bool:
        """Run one continuous-batching step: schedule, one device step,
        sample, evict. Returns True while work remains."""
        with self._lock:
            t0 = time.perf_counter()
            plan = self.sched.schedule()
            self.host_seconds["schedule"] += time.perf_counter() - t0
            if plan.entries:
                self._run_plan(plan)
                self.steps += 1
                self.tokens_fed += plan.total_tokens
            if not self.sched.has_work():
                self._work.clear()
            return self.sched.has_work()

    def _run_plan(self, plan) -> None:
        t0 = time.perf_counter()
        sample_points = []             # (entry, row of its LAST seq token)
        idx = 0
        for e in plan.entries:
            n, k = e.n, len(e.draft)
            self._tokens[idx:idx + n] = e.req.seq[e.start:e.start + n]
            # the verify chunk: drafts ride the same packed step at the
            # positions they would hold if accepted
            self._tokens[idx + n:idx + n + k] = e.draft
            self._slots[idx:idx + n + k] = e.req.slot
            self._positions[idx:idx + n + k] = np.arange(e.start,
                                                         e.start + n + k)
            self._valid[idx:idx + n + k] = 1
            row = self._tables[e.req.slot]
            row[:] = -1
            row[:len(e.req.pages)] = e.req.pages
            if e.samples:
                sample_points.append((e, idx + n - 1))
            idx += n + k
        for rows in (self._tokens, self._slots, self._positions,
                     self._valid):
            rows[idx:] = 0             # padding rows
        t1 = time.perf_counter()
        with self._on_stream():
            all_tok = self._step()
        t2 = time.perf_counter()
        for e in plan.entries:
            e.req.pos = e.start + e.n  # draft positions confirmed below
        finished = []
        accepted = rolled_back = 0
        now = time.monotonic()
        for e, i in sample_points:
            req = e.req
            k = len(e.draft)
            targets = [int(t) for t in all_tok[i:i + k + 1]]
            emitted = verify_greedy(e.draft, targets)[1] if k \
                else targets[:1]
            used = 0
            for tok in emitted:
                if req.first_token_at is None:
                    req.first_token_at = now
                req.emit(tok)
                self.tokens_generated += 1
                used += 1
                hit_eos = req.eos_id is not None and tok == req.eos_id
                if len(req.output) >= req.max_new_tokens or hit_eos:
                    req.finish_reason = "eos" if hit_eos \
                        else "max_new_tokens"
                    finished.append(req)
                    break
            # used - 1 drafts were confirmed (eos or the output cap may cut
            # the emission short of the accepted prefix)
            consumed = used - 1
            accepted += consumed
            req.pos = e.start + e.n + consumed
            if consumed < k:
                # rejected drafts left K/V past the accepted frontier: roll
                # the page list back, copying a shared boundary page first
                # (a page another holder can read is never written)
                kept, released, cow = self.pool.truncate(req.pages, req.pos)
                req.pages = kept
                rolled_back += released
                if cow is not None:
                    self._copy_page(*cow)
        for req in finished:
            self.sched.evict_finished(req)
        self.spec_proposed += plan.drafted
        self.spec_accepted += accepted
        self.spec_rollback_pages += rolled_back
        t3 = time.perf_counter()
        for key, dt in (("pack", t1 - t0), ("device", t2 - t1),
                        ("emit", t3 - t2)):
            self.host_seconds[key] += dt

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy one page across every layer of both pools (the device half
        of a copy-on-write rollback), on the engine's stream between two
        steps; the pools keep their addresses."""
        with torch.inference_mode(), self._on_stream():
            self._kp[:, dst].copy_(self._kp[:, src])
            self._vp[:, dst].copy_(self._vp[:, src])

    def spec_stats(self) -> dict:
        """Lifetime speculative-decoding counters (zeros when off)."""
        p, a = self.spec_proposed, self.spec_accepted
        return {"proposed": p, "accepted": a,
                "accept_rate": a / p if p else 0.0,
                "rollback_pages": self.spec_rollback_pages}

    def run_until_idle(self, max_steps: Optional[int] = None) -> int:
        """Drive step() until no work remains; returns steps taken."""
        n = 0
        while self.step():
            n += 1
            if max_steps is not None and n >= max_steps:
                break
        return n

    def has_work(self) -> bool:
        with self._lock:
            return self.sched.has_work()

    def wait_for_work(self, timeout: Optional[float] = None) -> bool:
        """Block until a request is submitted, at most ``timeout``
        seconds; True if there is work."""
        return self._work.wait(timeout)

    def abort_all(self, exc: Optional[BaseException] = None) -> int:
        """Fail EVERY live request (running and waiting) with a
        RuntimeError caused by ``exc`` and release their pages: the
        cleanup a front door (``inference.BatchingServer``) runs when a
        step raised, so that no client waits forever. Returns how many
        requests were failed."""
        with self._lock:
            live = list(self.sched.running) + list(self.sched.waiting)
            for req in live:
                err = RuntimeError(f"request {req.rid} failed: the engine "
                                   f"aborted ({exc!r})")
                err.__cause__ = exc
                self.sched.fail_request(req, err)
            self.requests_failed += len(live)
            self._tables[:] = -1
            if not self.sched.has_work():
                self._work.clear()
        return len(live)

    def generate_batch(self, prompts: Sequence[Sequence[int]],
                       max_new_tokens: int = 32,
                       eos_id: Optional[int] = None) -> List[List[int]]:
        """Submit a batch, drain the engine, return outputs in submission
        order."""
        reqs = [self.submit(p, max_new_tokens=max_new_tokens, eos_id=eos_id)
                for p in prompts]
        self.run_until_idle()
        return [r.result(timeout=0) for r in reqs]


class EnginePredictor:
    """``inference.Predictor``-compatible front door over ONE shared
    engine. ``clone()`` returns another handle to the same engine, so a
    ``PredictorPool`` of these shares the scheduler and KV pool instead
    of holding per-predictor caches."""

    def __init__(self, engine: ServingEngine, max_new_tokens: int = 32,
                 eos_id: Optional[int] = None):
        self.engine = engine
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id

    def clone(self) -> "EnginePredictor":
        return EnginePredictor(self.engine, self.max_new_tokens,
                               self.eos_id)

    def get_input_names(self) -> List[str]:
        return ["input_ids"]

    def run(self, inputs) -> List[np.ndarray]:
        """inputs: [token_ids] where token_ids is one 1-D prompt or a list
        of 1-D prompts (ragged). Returns [outputs] padded with -1."""
        (ids,) = inputs
        if isinstance(ids, (list, tuple)) and len(ids) and \
                isinstance(ids[0], (list, tuple, np.ndarray)):
            prompts = [list(map(int, p)) for p in ids]     # ragged list
        else:
            arr = np.asarray(ids)
            if arr.ndim == 1:
                prompts = [arr.astype(np.int64).tolist()]
            elif arr.ndim == 2:
                prompts = [row.astype(np.int64).tolist() for row in arr]
            else:
                raise ValueError(
                    f"input_ids must be 1-D, 2-D, or a list of 1-D "
                    f"prompts; got ndim={arr.ndim}")
        outs = self.engine.generate_batch(prompts, self.max_new_tokens,
                                          eos_id=self.eos_id)
        width = max(len(o) for o in outs)
        padded = np.full((len(outs), width), -1, np.int32)
        for i, o in enumerate(outs):
            padded[i, :len(o)] = o
        return [padded]


def engine_from_config(model, config=None, device=None,
                       **overrides) -> ServingEngine:
    """Build a ServingEngine honoring ``inference.Config`` serving knobs
    (max_batch_size -> max_seqs, kv-cache block size/capacity -> pool
    geometry, set_speculative_config -> drafter and k); keyword overrides
    win. ``device`` as ServingEngine's: None is the GPU."""
    kw = {}
    if config is not None:
        for opts in (config.serving_options(),
                     config.speculative_options()):
            kw.update((k, v) for k, v in opts.items() if v is not None)
    kw.update(overrides)
    if "max_seqs" in kw and "token_budget" not in kw:
        kw["token_budget"] = max(8 * kw["max_seqs"], 64)
    return ServingEngine(model, EngineConfig(**kw), device=device)


__all__ = ["EngineConfig", "ServingEngine", "EnginePredictor",
           "engine_from_config"]
