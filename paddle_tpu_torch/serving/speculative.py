"""Speculative decoding for the serving engine: draft, verify, roll back.

Mirrors ``paddle_tpu/serving/speculative.py``. A decode step reads every
weight to produce one token a sequence. A cheap DRAFTER proposes k
continuation tokens; the engine feeds them beside the sequence's pending
token as one more prefill-like chunk of the same packed step (the captured
step does not change), and greedy verification keeps the longest prefix of
drafts that match the model's own argmax chain:

    drafts   d1  d2  d3 ... dk          (from the drafter)
    targets  t0  t1  t2 ... tk          (argmax at each fed position)
    accept a = longest prefix with d_{j+1} == t_j
    emit     t0 .. ta                   (a accepted drafts + 1 bonus)

Every emitted token is an argmax over logits whose inputs (the cache below
the position plus accepted, hence correct, draft K/V) are those of the
non-speculative run, so the output is plain greedy decoding's; a full
rejection still emits t0. Rejected drafts leave K/V past the accepted
frontier: pages past it go back through ``KVBlockPool.truncate``
(copy-on-write when the boundary page is shared), and stale slots inside
the kept page stay invisible, hidden by the position compare until a later
feed overwrites them.

Two drafters:

  * ``NgramDrafter``: model-free prompt lookup: the longest recent n-gram
    suffix of the sequence is searched earlier in it and its continuation
    proposed (host only, no second model);
  * ``DraftModelDrafter``: a small causal LM drafts greedily through
    ``generation.draft_greedy_batch`` (the same decoders, left-padded to a
    fixed window, one captured decode graph per signature).

Drafters only PROPOSE: a wrong or stale draft costs throughput, never
correctness.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


class Drafter:
    """Interface: propose up to ``k`` draft tokens continuing ``req.seq``
    (the prompt plus every token emitted so far). May return fewer, or
    ``[]`` to skip speculation for this sequence this step; must not
    change the request. The scheduler calls ``propose_batch`` once a step
    with every draft-eligible decode sequence; drafters backed by a device
    program override it to draft the whole batch in one call."""

    def propose(self, req, k: int) -> List[int]:
        raise NotImplementedError

    def propose_batch(self, reqs, ks) -> List[List[int]]:
        return [self.propose(req, k) for req, k in zip(reqs, ks)]

    def describe(self) -> dict:
        return {"drafter": type(self).__name__}


class NgramDrafter(Drafter):
    """Self-drafting by prompt lookup. Finds the longest match
    (``max_match`` down to ``min_match`` tokens) of the sequence's suffix
    at an EARLIER offset, the most recent occurrence first, and proposes
    the tokens that followed it there. The search runs on the host for
    every decode sequence every step, so it looks back ``lookback``
    tokens at most."""

    def __init__(self, max_match: int = 4, min_match: int = 1,
                 lookback: int = 256):
        if not 1 <= int(min_match) <= int(max_match):
            raise ValueError(
                f"need 1 <= min_match <= max_match, got "
                f"({min_match}, {max_match})")
        if int(lookback) < 2:
            raise ValueError(f"lookback must be >= 2, got {lookback}")
        self.max_match = int(max_match)
        self.min_match = int(min_match)
        self.lookback = int(lookback)

    def describe(self) -> dict:
        return {"drafter": type(self).__name__,
                "max_match": self.max_match, "min_match": self.min_match,
                "lookback": self.lookback}

    def propose(self, req, k: int) -> List[int]:
        seq = req.seq[-self.lookback:]
        n = len(seq)
        if k < 1 or n < self.min_match + 1:
            return []
        for m in range(min(self.max_match, n - 1), self.min_match - 1, -1):
            tail = seq[n - m:]
            for i in range(n - m - 1, -1, -1):
                if seq[i:i + m] == tail:
                    # the continuation may run into the tail itself: those
                    # are real tokens too (a period shorter than m)
                    return [int(t) for t in seq[i + m:i + m + k]]
        return []


class DraftModelDrafter(Drafter):
    """Draft with a small causal LM: ``generation.draft_greedy_batch``
    left-pads every sequence into a FIXED ``context_width`` window and
    runs greedy generate() once for the whole decode batch each step.
    With ``batch_pad`` and ``draft_k`` set (the engine pins them to its
    max_seqs and num_draft_tokens) every call has one (batch_pad, width,
    draft_k) signature, so one captured decode graph serves them all.
    Context beyond the window slides off the left."""

    def __init__(self, draft_model, context_width: int = 64,
                 quant: Optional[str] = None,
                 batch_pad: Optional[int] = None,
                 draft_k: Optional[int] = None):
        if draft_model is None:
            raise ValueError("DraftModelDrafter needs a draft model")
        if int(context_width) < 1:
            raise ValueError(
                f"context_width must be >= 1, got {context_width}")
        self.model = draft_model
        self.context_width = int(context_width)
        self.quant = quant
        self.batch_pad = None if batch_pad is None else int(batch_pad)
        self.draft_k = None if draft_k is None else int(draft_k)

    def describe(self) -> dict:
        return {"drafter": type(self).__name__,
                "context_width": self.context_width, "quant": self.quant,
                "batch_pad": self.batch_pad, "draft_k": self.draft_k}

    def propose(self, req, k: int) -> List[int]:
        if k < 1:
            return []
        from ..generation import draft_greedy
        return draft_greedy(self.model, req.seq, k,
                            width=self.context_width, quant=self.quant)

    def propose_batch(self, reqs, ks) -> List[List[int]]:
        """One batched draft for the whole decode batch, each row sliced
        back to its own budget. Rows are padded to ``batch_pad`` and the
        draft length pinned to ``draft_k`` when set."""
        ks = list(ks)
        live = [(i, req) for i, (req, k) in enumerate(zip(reqs, ks))
                if k >= 1]
        if not live:
            return [[] for _ in ks]
        from ..generation import draft_greedy_batch
        seqs = [req.seq for _, req in live]
        k = max(ks) if self.draft_k is None else max(self.draft_k, max(ks))
        if self.batch_pad is not None and len(seqs) < self.batch_pad:
            seqs = seqs + [[0]] * (self.batch_pad - len(seqs))
        rows = draft_greedy_batch(self.model, seqs, k,
                                  width=self.context_width, quant=self.quant)
        out: List[List[int]] = [[] for _ in ks]
        for (i, _), row in zip(live, rows):
            out[i] = row[:ks[i]]
        return out


def make_drafter(method: Optional[str], draft_model=None,
                 **options) -> Optional[Drafter]:
    """The drafter of ``EngineConfig.spec_method``: None / "none" (off),
    "ngram" (options max_match, min_match, lookback) or "draft_model"
    (needs ``draft_model``; options context_width, quant, batch_pad,
    draft_k)."""
    if method in (None, "none"):
        return None
    if method == "ngram":
        return NgramDrafter(**options)
    if method == "draft_model":
        return DraftModelDrafter(draft_model, **options)
    raise ValueError(
        f"unknown speculative method {method!r}: expected 'ngram' or "
        "'draft_model' (or None to disable)")


def verify_greedy(drafts: Sequence[int], targets: Sequence[int]
                  ) -> Tuple[int, List[int]]:
    """Longest-accepted-prefix greedy verification. ``targets[j]`` is the
    model's argmax at the j-th fed position of the verify chunk
    (``len(drafts) + 1`` of them: the pending token's row first). Returns
    ``(accepted, emitted)`` with ``emitted == targets[:accepted + 1]``:
    the accepted drafts plus the bonus token, the tokens plain greedy
    decoding gives one step at a time."""
    if len(targets) != len(drafts) + 1:
        raise ValueError(
            f"verify needs len(drafts)+1 targets, got {len(drafts)} "
            f"drafts and {len(targets)} targets")
    a = 0
    while a < len(drafts) and int(drafts[a]) == int(targets[a]):
        a += 1
    return a, [int(t) for t in targets[:a + 1]]


__all__ = ["Drafter", "NgramDrafter", "DraftModelDrafter", "make_drafter",
           "verify_greedy"]
