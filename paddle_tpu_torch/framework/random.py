"""The global random state and the keys the port's random ops draw, as
``paddle_tpu/framework/random.py`` keeps them: ``seed``,
``get_rng_state`` / ``set_rng_state`` over ``(seed_value, counter)``,
``key_context`` and ``next_key``.

The JAX package's keys are threefry keys; the port's are keys of the
counter-based Philox4x32-10 generator that ``kernels/dropout.py`` runs
(on the card in its Triton kernels, on the CPU in its plain version; the
two give the same bits). The streams cannot match JAX's; the contract is
the same. A key is a pair of 32-bit words, the seed's two halves or a pair
folded from them. ``next_key()`` draws ``RandomKey(base, site)``: outside
any ``key_context`` the base is the seed's key and the site the global
counter, which each draw advances (JAX: ``fold_in(PRNGKey(seed),
counter)``); inside one, the context's base and its own counter. A random
value is a pure function of (base, site, element index): word ``e % 4``
of Philox4x32-10 with counter ``(e // 4 low, e // 4 high, site, 0)`` and
the base as key. So a mask can be drawn again, by a backward or a remat
recompute, from its key alone, and it is the same bits on the card and on
the CPU.

A context's base may be a device tensor (int64 ``[2]``, each word in [0,
2**32)): the trainer keeps its step's key there, so the CUDA graph of its
step reads each step's key from memory (``parallel/trainer.py``), as the
JAX trainer passes its key to the compiled step as an argument.
"""
from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple, Tuple, Union

import torch

M32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)      # the round multipliers
PHILOX_W = (0x9E3779B9, 0xBB67AE85)      # the key schedule's increments
PHILOX_ROUNDS = 10
_FOLD = 1          # counter word 3 of a fold-in (0 for a mask's bits)


def philox4x32(counter, key) -> Tuple[int, int, int, int]:
    """Philox4x32-10 of four 32-bit counter words under a two-word key,
    in Python integers (the kernels' rounds, one block)."""
    c0, c1, c2, c3 = (int(c) & M32 for c in counter)
    k0, k1 = (int(k) & M32 for k in key)
    for _ in range(PHILOX_ROUNDS):
        p0 = PHILOX_M[0] * c0
        p1 = PHILOX_M[1] * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & M32,
                          (p0 >> 32) ^ c3 ^ k1, p0 & M32)
        k0 = (k0 + PHILOX_W[0]) & M32
        k1 = (k1 + PHILOX_W[1]) & M32
    return c0, c1, c2, c3


def fold_in(key, data: int) -> Tuple[int, int]:
    """A new key from ``key`` (two words) and a non-negative integer: the
    first two words of the Philox block at counter ``(data low, data
    high, 0, 1)`` (a mask's counters end in 0, so the two never meet)."""
    data = int(data)
    return philox4x32((data & M32, (data >> 32) & M32, 0, _FOLD), key)[:2]


def seed_key(value: int) -> Tuple[int, int]:
    """The key of a seed: its low and high 32 bits."""
    value = int(value) & ((1 << 64) - 1)
    return value & M32, value >> 32


Key = Union[Tuple[int, int], torch.Tensor]


class RandomKey(NamedTuple):
    """What one random op draws: the ``base`` key (two ints, or an int64
    ``[2]`` tensor on the device the op runs on) and its ``site``."""
    base: Key
    site: int


class _GeneratorState(threading.local):
    def __init__(self):
        self.seed_value = 0
        self.counter = 0


_state = _GeneratorState()


def seed(value: int):
    """Seed the global generator (parity: paddle.seed); its counter
    restarts."""
    _state.seed_value = int(value)
    _state.counter = 0
    return _state


def get_rng_state():
    return (_state.seed_value, _state.counter)


def set_rng_state(state):
    seed_value, counter = state
    seed(seed_value)
    _state.counter = int(counter)


class _Contexts(threading.local):
    def __init__(self):
        self.stack = []


_contexts = _Contexts()


class key_context:
    """Draw keys from ``base_key`` (two ints, or an int64 ``[2]`` device
    tensor) with a counter of the context's own, from 1, instead of the
    global state: the trainer runs each step's loss under its step's key,
    as the JAX trainer runs its loss under ``key_context(key)``."""

    def __init__(self, base_key: Key):
        self.base_key = base_key
        self.counter = 0

    def __enter__(self):
        _contexts.stack.append(self)
        return self

    def __exit__(self, *exc):
        _contexts.stack.pop()
        return False


def next_key() -> RandomKey:
    """The key of one random op: the innermost ``key_context``'s base at
    its next site, or, outside any, the seed's key at the global
    counter's next value."""
    if _contexts.stack:
        ctx = _contexts.stack[-1]
        ctx.counter += 1
        return RandomKey(ctx.base_key, ctx.counter)
    _state.counter += 1
    return RandomKey(seed_key(_state.seed_value), _state.counter)


def position():
    """Where the next key comes from: (the innermost ``key_context`` or
    the global state, its counter). ``replaying`` takes it."""
    src = _contexts.stack[-1] if _contexts.stack else _state
    return src, src.counter


@contextlib.contextmanager
def replaying(pos):
    """Draw the keys from ``pos`` (a ``position()``) again: its source is
    made the innermost one and its counter set back, so a layer run a
    second time (a remat recompute in the backward) draws the keys it drew
    the first time. On exit the counter is the larger of the two runs'
    ends: a first run leaves it advanced, a recompute as it found it."""
    src, counter = pos
    pushed = src is not _state and (not _contexts.stack
                                    or _contexts.stack[-1] is not src)
    if pushed:
        _contexts.stack.append(src)
    found = src.counter
    src.counter = counter
    try:
        yield
    finally:
        src.counter = max(found, src.counter)
        if pushed:
            _contexts.stack.pop()


__all__ = ["seed", "get_rng_state", "set_rng_state", "key_context",
           "next_key", "RandomKey", "fold_in", "seed_key", "philox4x32",
           "position", "replaying"]
