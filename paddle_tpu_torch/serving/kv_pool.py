"""Shared KV block pool: fixed-size pages, refcounts, prefix-cache reuse.

Mirrors ``paddle_tpu/serving/kv_pool.py``. The device pools
(``[L, P, kvh, bs, D]`` tensors owned by the engine) are plain storage;
THIS object owns the page accounting — which physical page belongs to
whom, how many requests share it, and which freed pages still hold
reusable prefix content:

  * pages are ref-counted: prefix-shared pages are held by several
    sequences at once and return to the free list only at refcount 0;
  * freed pages registered as prompt-prefix content park in a CACHED
    state (refcount 0, content kept in the device pool, found again by
    hash) and are evicted LRU only under pressure, so a repeated prompt
    prefix is not prefilled again;
  * the prefix key is a hash CHAIN over full pages of token ids (page c's
    key commits to every token before it), so a hit of depth k reuses
    exactly the first k pages of an identical prefix at identical
    positions — the only case where cached K/V is valid (rope bakes the
    absolute position into K).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple


class PoolExhausted(RuntimeError):
    """No free page and nothing evictable — callers defer or preempt."""


class KVBlockPool:
    """Page accounting for one engine's shared KV pools."""

    def __init__(self, num_blocks: int, block_size: int,
                 enable_prefix_cache: bool = True):
        if num_blocks < 1 or block_size < 1:
            raise ValueError(
                f"KVBlockPool needs num_blocks >= 1 and block_size >= 1 "
                f"(got {num_blocks}, {block_size})")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.enable_prefix_cache = bool(enable_prefix_cache)
        self._free: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self._ref: List[int] = [0] * self.num_blocks
        # hash-chain key -> page id for reusable prefix pages; _cached is
        # the LRU of refcount-0 pages still holding registered content
        self._by_key: Dict[Tuple, int] = {}
        self._key_of: Dict[int, Tuple] = {}
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        self.stats = {"allocated": 0, "released": 0, "evicted": 0,
                      "prefix_queries": 0, "prefix_hits": 0,
                      "prefix_hit_tokens": 0}

    # -- core accounting ------------------------------------------------------
    def used_blocks(self) -> int:
        """Pages held by live sequences (refcount > 0)."""
        return sum(1 for r in self._ref if r > 0)

    def cached_blocks(self) -> int:
        return len(self._cached)

    def free_blocks(self) -> int:
        """Pages allocatable without evicting cached prefix content."""
        return len(self._free)

    def available_blocks(self) -> int:
        return len(self._free) + len(self._cached)

    def utilization(self) -> float:
        return self.used_blocks() / self.num_blocks

    def allocate(self, n: int = 1) -> List[int]:
        """Take n pages (refcount 1 each), evicting LRU cached prefix pages
        under pressure. Raises PoolExhausted if fewer than n are
        obtainable."""
        if self.available_blocks() < n:
            raise PoolExhausted(
                f"KV pool exhausted: want {n} pages, "
                f"{len(self._free)} free + {len(self._cached)} cached of "
                f"{self.num_blocks}")
        return [self._take_page() for _ in range(n)]

    def _take_page(self) -> int:
        """One page off the free list (LRU-evicting a cached prefix page
        under pressure), refcount 1. The caller has proven availability."""
        if self._free:
            blk = self._free.pop()
        else:
            blk, _ = self._cached.popitem(last=False)   # LRU evict
            self._drop_key(blk)
            self.stats["evicted"] += 1
        self._ref[blk] = 1
        self.stats["allocated"] += 1
        return blk

    def incref(self, blocks: Sequence[int]) -> None:
        """One more reference to each page (another holder shares it)."""
        for blk in blocks:
            if self._ref[blk] <= 0:
                raise ValueError(f"incref on free page {blk}")
            self._ref[blk] += 1

    def release(self, blocks: Sequence[int]) -> None:
        """Drop one reference per page; at 0 the page returns to the free
        list, or parks in the prefix cache if its content is registered."""
        for blk in blocks:
            if self._ref[blk] <= 0:
                raise ValueError(f"release of free page {blk}")
            self._ref[blk] -= 1
            self.stats["released"] += 1
            if self._ref[blk] == 0:
                if blk in self._key_of and self.enable_prefix_cache:
                    self._cached[blk] = None
                    self._cached.move_to_end(blk)
                else:
                    self._drop_key(blk)
                    self._free.append(blk)

    def _drop_key(self, blk: int) -> None:
        key = self._key_of.pop(blk, None)
        if key is not None and self._by_key.get(key) == blk:
            del self._by_key[key]

    def truncate(self, pages: Sequence[int], n_tokens: int
                 ) -> Tuple[List[int], int, Optional[Tuple[int, int]]]:
        """Roll one sequence's page list back so it covers exactly
        ``n_tokens`` cached positions; pages past it return to the pool.
        Returns ``(kept_pages, released, cow)``, where ``cow`` is None or
        ``(old, new)`` when the kept, partly covered boundary page is
        shared (refcount > 1 or registered in the prefix cache): the
        caller then owns ``new`` and must copy ``old``'s device content
        into it before writing, so a page someone else can read is never
        changed. Raises PoolExhausted, before changing anything, when no
        page is obtainable for that copy."""
        if n_tokens < 0:
            raise ValueError(f"truncate to negative coverage {n_tokens}")
        keep = -(-n_tokens // self.block_size)
        if keep > len(pages):
            raise ValueError(
                f"truncate to {n_tokens} tokens needs {keep} pages but "
                f"the sequence holds only {len(pages)}")
        kept = list(pages[:keep])
        tail = list(pages[keep:])
        blk = kept[-1] if n_tokens % self.block_size and kept else None
        need_cow = blk is not None and (self._ref[blk] > 1
                                        or blk in self._key_of)
        if need_cow:
            obtainable = self.available_blocks() \
                + sum(1 for t in tail if self._ref[t] == 1)
            if obtainable < 1:
                raise PoolExhausted(
                    "KV pool exhausted: no page obtainable for the "
                    "copy-on-write rollback of a shared boundary page")
        if tail:
            self.release(tail)
        cow = None
        if need_cow:
            new = self._take_page()
            self.release([blk])
            kept[-1] = new
            cow = (blk, new)
        return kept, len(tail), cow

    # -- prefix cache ---------------------------------------------------------
    @staticmethod
    def _chain_keys(token_ids: Sequence[int], block_size: int):
        """Hash-chain keys for each FULL page of token_ids (hashes of ints
        and tuples only, so stable across processes)."""
        keys = []
        parent = ()
        for c in range(len(token_ids) // block_size):
            page = tuple(token_ids[c * block_size:(c + 1) * block_size])
            parent = (hash((parent, page)), page[0], c)
            keys.append(parent)
        return keys

    def match_prefix(self, token_ids: Sequence[int],
                     max_tokens: Optional[int] = None
                     ) -> Tuple[List[int], int]:
        """Longest cached full-page prefix of token_ids. Returns (pages,
        n_tokens); the pages are increfed (the caller owns a reference).
        ``max_tokens`` caps the hit (the engine keeps at least one prompt
        token uncached so prefill still yields last-token logits)."""
        self.stats["prefix_queries"] += 1
        if not self.enable_prefix_cache:
            return [], 0
        limit = len(token_ids) if max_tokens is None else max_tokens
        pages: List[int] = []
        for i, key in enumerate(self._chain_keys(token_ids,
                                                 self.block_size)):
            if (i + 1) * self.block_size > limit:
                break
            blk = self._by_key.get(key)
            if blk is None:
                break
            pages.append(blk)
        for blk in pages:
            if self._ref[blk] == 0:
                self._cached.pop(blk, None)
            self._ref[blk] += 1
        n = len(pages) * self.block_size
        if pages:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_hit_tokens"] += n
        return pages, n

    def register_prefix(self, token_ids: Sequence[int],
                        pages: Sequence[int]) -> None:
        """Record that ``pages[c]`` holds the K/V of token_ids' c-th full
        page, making them reusable after release. The first registration
        of a key wins."""
        if not self.enable_prefix_cache:
            return
        for key, blk in zip(self._chain_keys(token_ids, self.block_size),
                            pages):
            if key in self._by_key:
                continue
            if blk in self._key_of:      # page re-registered under new key
                self._drop_key(blk)
            self._by_key[key] = blk
            self._key_of[blk] = key


__all__ = ["KVBlockPool", "PoolExhausted"]
