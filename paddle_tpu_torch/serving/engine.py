"""ServingEngine: continuous batching over ragged paged attention.

Mirrors ``paddle_tpu/serving/engine.py`` for one model on one device:

  * ``generation._LlamaDecoder.step_ragged`` runs one packed mixed-phase
    batch per step (fixed token budget, slot count and page-table width);
  * ``kv_pool.KVBlockPool`` owns the shared fixed-size pages, ref-counted,
    with hash-chain prefix reuse across requests;
  * ``scheduler.Scheduler`` admits and evicts requests at every step under
    the token budget;
  * ``serving.ragged`` is the attention: the CUDA kernel on the GPU, its
    plain version on the CPU.

Sampling is greedy and runs on the host, so requests stream tokens as
they land. The pools are updated in place where the JAX program donates
them.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..generation import _decoder_for
from . import ragged as _ragged
from .kv_pool import KVBlockPool
from .scheduler import Request, Scheduler

# options of the JAX engine that later slices of the port bring
_LATER = ("quant", "spec_method", "aot_cache", "obs", "memwatch",
          "resilience", "mesh", "role")


class EngineConfig:
    """Static shapes and policy for one engine."""

    def __init__(self, max_seqs: int = 8, token_budget: int = 64,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 max_model_len: Optional[int] = None,
                 enable_prefix_cache: bool = True,
                 policy: str = "continuous", quant=None, spec_method=None,
                 aot_cache=None, obs=None, memwatch=None, resilience=None,
                 mesh=None, role=None):
        given = dict(quant=quant, spec_method=spec_method,
                     aot_cache=aot_cache, obs=obs, memwatch=memwatch,
                     resilience=resilience, mesh=mesh, role=role)
        later = [k for k in _LATER if given[k] is not None]
        if later:
            raise NotImplementedError(
                f"EngineConfig options {later} are not ported to "
                "paddle_tpu_torch yet (see ROADMAP.md)")
        self.max_seqs = int(max_seqs)
        self.token_budget = int(token_budget)
        self.block_size = int(block_size)
        self.num_blocks = num_blocks
        self.max_model_len = max_model_len
        self.enable_prefix_cache = bool(enable_prefix_cache)
        self.policy = policy


def _argmax_rows(logits):
    """Greedy token for every packed row."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _engine_step_impl(dec, w, tokens, slot_ids, positions, valid, tables,
                      k_pools, v_pools):
    """One serving step: scatter targets from the page tables, ragged
    attention over the pools (written in place), logits for every packed
    token."""
    bs = k_pools.shape[3]
    p_total = k_pools.shape[1]
    mp = tables.shape[1]
    col = positions // bs
    page = torch.take_along_dim(tables[slot_ids],
                                col.clamp(0, mp - 1)[:, None].long(), 1)[:, 0]
    # invalid rows get page index p_total, which step_ragged writes nowhere
    bad = (~valid) | (col >= mp) | (page < 0)
    pages = torch.where(bad, p_total, page)
    offs = positions % bs
    attend = _ragged.make_attend(tables, slot_ids, positions, valid,
                                 dec.n_heads // dec.n_kv)
    return dec.step_ragged(w, tokens, positions, k_pools, v_pools,
                           (pages.long(), offs.long()), attend)


class ServingEngine:
    """Continuous-batching LLM serving over one model on one device.

    ``device`` None means the GPU (raises without one); the model must
    live there. Thread-safe: ``submit`` may be called from client threads
    while one thread drives ``step()``."""

    def __init__(self, model, config: Optional[EngineConfig] = None,
                 device=None):
        cfg = config or EngineConfig()
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"the model lives on {model.device}, the "
                             f"engine was asked for {self.device}")
        self.model = model
        self.config = cfg
        self.dec = _decoder_for(model)
        self._w = self.dec.weights(model)
        max_len = cfg.max_model_len or model.config.max_position_embeddings
        self.max_model_len = int(min(max_len,
                                     model.config.max_position_embeddings))
        bs = cfg.block_size
        self.max_pages_per_seq = -(-self.max_model_len // bs)
        num_blocks = cfg.num_blocks
        if num_blocks is None:
            num_blocks = cfg.max_seqs * self.max_pages_per_seq
        dtype = self._w[self.dec.embed_key].dtype
        shape = (self.dec.n_layers, num_blocks, self.dec.n_kv, bs,
                 self.dec.hd)
        self._kp = torch.zeros(shape, dtype=dtype, device=model.device)
        self._vp = torch.zeros(shape, dtype=dtype, device=model.device)
        self.pool = KVBlockPool(num_blocks, bs,
                                enable_prefix_cache=cfg.enable_prefix_cache)
        self.sched = Scheduler(self.pool, cfg.max_seqs, cfg.token_budget,
                               self.max_pages_per_seq, policy=cfg.policy)
        self._tables = np.full((cfg.max_seqs, self.max_pages_per_seq), -1,
                               np.int32)
        self._lock = threading.RLock()
        self.steps = 0
        self.tokens_fed = 0            # packed tokens run through the model
        self.tokens_generated = 0

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
        return req

    # -- stepping side --------------------------------------------------------
    def step(self) -> bool:
        """Run one continuous-batching step: schedule, one device step,
        sample, evict. Returns True while work remains."""
        with self._lock:
            plan = self.sched.schedule()
            if plan.entries:
                self._run_plan(plan)
                self.steps += 1
                self.tokens_fed += plan.total_tokens
            return self.sched.has_work()

    def _run_plan(self, plan) -> None:
        t_max = self.config.token_budget
        tokens = np.zeros(t_max, np.int32)
        slots = np.zeros(t_max, np.int32)
        positions = np.zeros(t_max, np.int32)
        valid = np.zeros(t_max, bool)
        sample_points = []             # (entry, row of its LAST seq token)
        idx = 0
        for e in plan.entries:
            n = e.n
            tokens[idx:idx + n] = e.req.seq[e.start:e.start + n]
            slots[idx:idx + n] = e.req.slot
            positions[idx:idx + n] = np.arange(e.start, e.start + n)
            valid[idx:idx + n] = True
            row = self._tables[e.req.slot]
            row[:] = -1
            row[:len(e.req.pages)] = e.req.pages
            if e.samples:
                sample_points.append((e, idx + n - 1))
            idx += n
        dev = self.device
        with torch.inference_mode():
            logits = _engine_step_impl(
                self.dec, self._w,
                torch.from_numpy(tokens).to(dev).long(),
                torch.from_numpy(slots).to(dev),
                torch.from_numpy(positions).to(dev),
                torch.from_numpy(valid).to(dev),
                torch.from_numpy(self._tables).to(dev), self._kp, self._vp)
            all_tok = _argmax_rows(logits).cpu().numpy() \
                if sample_points else None
        for e in plan.entries:
            e.req.pos = e.start + e.n
        if not sample_points:
            return
        finished = []
        for e, i in sample_points:
            req = e.req
            tok = int(all_tok[i])
            req.emit(tok)
            self.tokens_generated += 1
            hit_eos = req.eos_id is not None and tok == req.eos_id
            if len(req.output) >= req.max_new_tokens or hit_eos:
                req.finish_reason = "eos" if hit_eos else "max_new_tokens"
                finished.append(req)
        for req in finished:
            self.sched.evict_finished(req)

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

    def generate_batch(self, prompts: Sequence[Sequence[int]],
                       max_new_tokens: int = 32,
                       eos_id: Optional[int] = None) -> List[List[int]]:
        """Submit a batch, drain the engine, return outputs in submission
        order."""
        reqs = [self.submit(p, max_new_tokens=max_new_tokens, eos_id=eos_id)
                for p in prompts]
        self.run_until_idle()
        return [r.result(timeout=0) for r in reqs]


__all__ = ["EngineConfig", "ServingEngine"]
