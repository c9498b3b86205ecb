"""Continuous-batching scheduler: admit and evict at every step.

Mirrors ``paddle_tpu/serving/scheduler.py`` without the disaggregated
prefill role. The batch is rebuilt EVERY step under one token budget:

  * running sequences in their decode phase get one token slot each,
    first (a decode step is never starved by prefill);
  * leftover budget feeds prefill CHUNKS of running-but-not-yet-prefilled
    and freshly admitted requests, strictly FIFO by arrival — so prefill
    and decode share one packed ragged batch and no request waits behind
    a later arrival;
  * finished sequences are evicted at the step boundary and their pages
    released to the pool (prompt pages parked for prefix reuse);
  * when the pool cannot grow a decode sequence, the MOST RECENTLY
    admitted running request is preempted (pages released, re-queued at
    the waiting front for recompute with its generated tokens appended);
  * with a drafter (speculative decoding), the budget left after all of
    that goes to draft tokens of the decode sequences, proposed in one
    ``propose_batch`` call a step.

``policy="static"`` degrades this to gang admission (admit only into an
empty batch, run it dry), the static batcher to compare against.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
import warnings
from typing import Callable, List, Optional, Sequence

from .kv_pool import KVBlockPool, PoolExhausted

_req_ids = itertools.count()

WAITING, RUNNING, FINISHED = "waiting", "running", "finished"


class Request:
    """One generation request inside the engine.

    ``seq`` is the token stream fed to the model: the prompt, then each
    sampled token as it is accepted. ``pos`` counts how many of those are
    already in the KV cache; the request is in its decode phase once
    ``pos == len(seq) - 1``. After a preemption ``pos`` rolls back to the
    prefix-cached depth and the generated tokens ride along in ``seq`` for
    recompute."""

    def __init__(self, prompt: Sequence[int], max_new_tokens: int = 32,
                 eos_id: Optional[int] = None,
                 on_token: Optional[Callable[[int], None]] = None,
                 stream: bool = False):
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        self.rid = next(_req_ids)
        self.prompt: List[int] = [int(t) for t in prompt]
        self.seq: List[int] = list(self.prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.on_token = on_token
        self.output: List[int] = []
        self.state = WAITING
        self.slot: Optional[int] = None
        self.pages: List[int] = []
        self.pos = 0                  # tokens already in the KV cache
        self.n_prefix = 0             # of which reused from the prefix cache
        self.preemptions = 0
        self.finish_reason: Optional[str] = None
        # time.monotonic() at submit, at the first token's arrival on the
        # host and at the finish: time to first token and request latency
        self.arrival = time.monotonic()
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.error: Optional[BaseException] = None
        self._done = threading.Event()
        self._stream: Optional["queue.Queue"] = queue.Queue() if stream \
            else None

    # -- client-side API ------------------------------------------------------
    def result(self, timeout: Optional[float] = None) -> List[int]:
        """The full output token list once the request has finished; raises
        the request's error if the engine failed it."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.rid} not finished")
        if self.error is not None:
            raise self.error
        return list(self.output)

    def stream(self):
        """Yield tokens as they are generated (requires stream=True); a
        failed request's stream raises its error after the tokens it
        delivered."""
        if self._stream is None:
            raise ValueError("request was not created with stream=True")
        while True:
            tok = self._stream.get()
            if tok is None:
                return
            if isinstance(tok, BaseException):
                raise tok
            yield tok

    @property
    def done(self) -> bool:
        return self._done.is_set()

    # -- engine-side helpers --------------------------------------------------
    def emit(self, tok: int) -> None:
        self.output.append(int(tok))
        self.seq.append(int(tok))
        if self.on_token is not None:
            self.on_token(int(tok))
        if self._stream is not None:
            self._stream.put(int(tok))

    def finish(self) -> None:
        self.state = FINISHED
        self.finished_at = time.monotonic()
        if self._stream is not None:
            self._stream.put(None)
        self._done.set()

    def fail(self, exc: BaseException) -> None:
        """Resolve this request with an error: ``result()`` raises it,
        ``stream()`` raises it after the tokens it delivered. The first
        terminal state wins."""
        if self._done.is_set():
            return
        self.error = exc
        self.finish_reason = "error"
        self.state = FINISHED
        self.finished_at = time.monotonic()
        if self._stream is not None:
            self._stream.put(exc)
        self._done.set()


class StepEntry:
    """One request's part of a packed step: feed ``seq[start:start+n]`` at
    positions ``start..start+n-1``, then any ``draft`` tokens (speculative
    proposals, not part of ``seq``) at ``start+n..start+n+len(draft)-1``:
    the verify chunk."""

    __slots__ = ("req", "start", "n", "draft")

    def __init__(self, req: Request, start: int, n: int,
                 draft: Sequence[int] = ()):
        self.req = req
        self.start = start
        self.n = n
        self.draft = tuple(draft)

    @property
    def samples(self) -> bool:
        """Does this entry's last token produce a next-token sample? True
        exactly when it feeds the sequence's current last token."""
        return self.start + self.n == len(self.req.seq)


class StepPlan:
    __slots__ = ("entries", "admitted", "preempted", "drafted")

    def __init__(self, entries, admitted, preempted, drafted=0):
        self.entries: List[StepEntry] = entries
        self.admitted: int = admitted
        self.preempted: int = preempted
        self.drafted: int = drafted

    @property
    def total_tokens(self) -> int:
        return sum(e.n + len(e.draft) for e in self.entries)


class Scheduler:
    """Builds one StepPlan per engine step. Not thread-safe by itself —
    the engine serializes submit/step under its lock."""

    def __init__(self, pool: KVBlockPool, max_seqs: int, token_budget: int,
                 max_pages_per_seq: int, policy: str = "continuous",
                 drafter=None, num_draft_tokens: int = 0):
        if policy not in ("continuous", "static"):
            raise ValueError(f"unknown scheduling policy {policy!r}")
        if token_budget < max_seqs:
            raise ValueError(
                f"token_budget {token_budget} < max_seqs {max_seqs}: a "
                "full decode batch would not fit one step")
        if num_draft_tokens < 0:
            raise ValueError(
                f"num_draft_tokens must be >= 0, got {num_draft_tokens}")
        self.pool = pool
        self.max_seqs = int(max_seqs)
        self.token_budget = int(token_budget)
        self.max_pages_per_seq = int(max_pages_per_seq)
        self.policy = policy
        self.waiting: List[Request] = []
        self.running: List[Request] = []   # admission order
        self._free_slots = list(range(self.max_seqs - 1, -1, -1))
        self.drafter = drafter
        self.num_draft_tokens = int(num_draft_tokens)
        self._drafter_warned = False

    # -- queue side -----------------------------------------------------------
    def submit(self, req: Request) -> None:
        max_len = len(req.prompt) + req.max_new_tokens
        cap = self.max_pages_per_seq * self.pool.block_size
        if max_len - 1 > cap:
            raise ValueError(
                f"request needs up to {max_len - 1} cached tokens but a "
                f"sequence caps at {cap} "
                f"({self.max_pages_per_seq} pages x "
                f"{self.pool.block_size})")
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # -- page bookkeeping -----------------------------------------------------
    def _grow_pages(self, req: Request, upto_pos: int) -> bool:
        """Ensure pages cover positions [0, upto_pos]; False on exhaustion
        (the caller decides: shrink the chunk, defer, or preempt)."""
        need = upto_pos // self.pool.block_size + 1 - len(req.pages)
        if need <= 0:
            return True
        try:
            req.pages.extend(self.pool.allocate(need))
        except PoolExhausted:
            return False
        return True

    def _release(self, req: Request, cache_prefix: bool) -> None:
        if cache_prefix and req.pos >= len(req.prompt):
            # the prompt's full pages are valid reusable prefix content
            self.pool.register_prefix(req.prompt, req.pages)
        if req.pages:
            self.pool.release(req.pages)
        req.pages = []
        if req.slot is not None:
            self._free_slots.append(req.slot)
            req.slot = None

    def evict_finished(self, req: Request) -> None:
        """Remove a finished request at the step boundary, caching its
        prompt pages for prefix reuse."""
        self.running.remove(req)
        self._release(req, cache_prefix=True)
        req.finish()

    def fail_request(self, req: Request, exc: BaseException) -> None:
        """Fail one request (an engine abort): take it out of the running
        or waiting list, release its pages without caching them (their
        K/V is not trusted) and resolve it with ``exc``."""
        if req in self.running:
            self.running.remove(req)
            self._release(req, cache_prefix=False)
        elif req in self.waiting:
            self.waiting.remove(req)
        req.fail(exc)

    def _preempt_youngest(self) -> Optional[Request]:
        """Pool pressure relief: kick the most recently admitted running
        request back to the waiting front for recompute."""
        if not self.running:
            return None
        victim = self.running.pop()
        self._release(victim, cache_prefix=False)
        victim.state = WAITING
        victim.pos = 0
        victim.n_prefix = 0
        victim.preemptions += 1
        self.waiting.insert(0, victim)
        return victim

    # -- the per-step planner -------------------------------------------------
    def schedule(self) -> StepPlan:
        entries: List[StepEntry] = []
        decode_entries: List[StepEntry] = []
        budget = self.token_budget
        admitted = preempted = drafted = 0

        # 1) one decode token per running sequence in its decode phase —
        #    grown pages first; exhaustion preempts the youngest (possibly
        #    the grower itself) and retries.
        for req in list(self.running):
            if req.pos != len(req.seq) - 1 or budget <= 0:
                continue
            while not self._grow_pages(req, req.pos):
                victim = self._preempt_youngest()
                preempted += 1
                if victim is None or victim is req:
                    break
            if req.state is not RUNNING or req not in self.running:
                continue                      # preempted itself
            if len(req.pages) * self.pool.block_size <= req.pos:
                continue                      # still no page: sit out
            e = StepEntry(req, req.pos, 1)
            entries.append(e)
            decode_entries.append(e)
            budget -= 1

        # 2) prefill chunks for running requests still inside their prompt
        for req in self.running:
            if budget <= 0:
                break
            if req.pos >= len(req.seq) - 1:
                continue                      # decode phase: handled above
            chunk = self._fit_chunk(req, min(len(req.seq) - req.pos, budget))
            if chunk <= 0:
                continue
            entries.append(StepEntry(req, req.pos, chunk))
            budget -= chunk

        # 3) admission, strictly FIFO. Static policy: gang admission into
        #    an empty batch only.
        can_admit = not self.running if self.policy == "static" else True
        while self.waiting and can_admit and self._free_slots and budget > 0:
            req = self.waiting[0]
            pages, n_cached = self.pool.match_prefix(
                req.seq, max_tokens=len(req.seq) - 1)
            req.pages = pages
            req.pos = req.n_prefix = n_cached
            chunk = self._fit_chunk(req, min(len(req.seq) - req.pos, budget))
            if chunk <= 0:
                # pool pressure: roll the prefix hit back and stop
                # admitting (FIFO: nobody behind may jump the queue)
                if req.pages:
                    self.pool.release(req.pages)
                req.pages = []
                req.pos = req.n_prefix = 0
                break
            self.waiting.pop(0)
            req.slot = self._free_slots.pop()
            req.state = RUNNING
            self.running.append(req)
            entries.append(StepEntry(req, req.pos, chunk))
            budget -= chunk
            admitted += 1

        # 4) speculation LAST: draft tokens take only the budget left after
        #    every decode token, prefill chunk and admission, one budget
        #    slot each (one more row of the same packed step), so under
        #    load speculation yields to real work.
        if self.drafter is not None and self.num_draft_tokens > 0 \
                and budget > 0:
            drafted = self._draft(decode_entries, budget)
        return StepPlan(entries, admitted, preempted, drafted)

    def _draft(self, decode_entries, budget: int) -> int:
        """Attach drafts to the decode entries within ``budget``; returns
        the tokens drafted. Each candidate is capped to its request's
        remaining output (a verify step emits at most len(draft) + 1
        tokens) and to the leftover budget, so a device-backed drafter
        computes no draft that could not be fed; all are proposed in one
        ``propose_batch`` call. A drafter that raises degrades the step to
        plain decode, with one warning for the scheduler's life."""
        cands = []
        avail = budget
        for e in decode_entries:
            if avail <= 0:
                break
            room = e.req.max_new_tokens - len(e.req.output) - 1
            d_max = min(self.num_draft_tokens, room, avail)
            if d_max > 0:
                cands.append((e, d_max))
                avail -= d_max
        try:
            proposals = self.drafter.propose_batch(
                [e.req for e, _ in cands], [d for _, d in cands]) \
                if cands else []
        except Exception as exc:
            if not self._drafter_warned:
                warnings.warn(f"drafter propose_batch failed ({exc!r}); "
                              "skipping speculation: decode continues "
                              "unspeculated")
                self._drafter_warned = True
            proposals = []
        drafted = 0
        for (e, d_max), prop in zip(cands, proposals):
            if budget <= 0:
                break
            drafts = list(prop)[:min(d_max, budget)]
            # pages must cover the drafted positions too; under pool
            # pressure the proposal shrinks (speculation never preempts)
            while drafts and not self._grow_pages(
                    e.req, e.start + e.n - 1 + len(drafts)):
                drafts.pop()
            if not drafts:
                continue
            e.draft = tuple(int(t) for t in drafts)
            budget -= len(drafts)
            drafted += len(drafts)
        return drafted

    def _fit_chunk(self, req: Request, chunk: int) -> int:
        """Shrink a prefill chunk to the pages actually obtainable.
        allocate() is all-or-nothing, so on failure retry with the chunk
        the currently AVAILABLE pages could cover."""
        bs = self.pool.block_size
        while chunk > 0 and not self._grow_pages(req, req.pos + chunk - 1):
            cap = (len(req.pages) + self.pool.available_blocks()) * bs \
                - req.pos
            chunk = min(chunk - 1, max(cap, 0))
        return chunk


__all__ = ["Request", "Scheduler", "StepPlan", "StepEntry", "WAITING",
           "RUNNING", "FINISHED"]
