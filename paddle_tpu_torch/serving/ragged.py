"""Ragged paged attention — the mixed-phase serving attention path.

Mirrors ``paddle_tpu/serving/ragged.py``. One call serves prefill chunks
and decode tokens together over ragged page tables, which is the
attention shape a continuous batcher emits. Layout contract:

  * pools: ``[P, kvh, bs, D]`` — P fixed-size pages of ``bs`` token slots;
  * ``page_tables [S, MP]``: page ids per sequence slot, position-ordered
    (table column c covers absolute positions ``c*bs .. c*bs+bs-1``), -1
    for unassigned;
  * queries arrive PACKED: ``q [T, H, D]`` with ``slot_ids [T]`` (row into
    the page table) and ``positions [T]`` (absolute position of each query
    token). Token t sees its slot's cache positions ``<= positions[t]`` —
    the pools already hold this step's K/V (the engine scatters before
    attending), so causality inside a chunk falls out of the position
    compare with no separate mask.
"""
from __future__ import annotations

from ..kernels import LAUNCHES
from ..kernels.ragged_attention import (kernel_takes, ragged_attention,
                                        ragged_attention_plain)

# the plain version under the JAX package's name
ragged_paged_attention = ragged_attention_plain


def make_attend(page_tables, slot_ids, positions, valid, rep):
    """Bind the ragged metadata into the ``attend(q, kp, vp)`` callable
    ``generation.step_ragged`` expects. A (head_dim, rep) the kernel takes
    goes to ``ragged_attention``, which launches the kernel on CUDA
    tensors and runs the plain version on CPU tensors; any other goes to
    ``ragged_attention_plain`` on either device, counted in
    ``LAUNCHES["ragged_plain"]``, as the JAX package's ``make_attend``
    takes its jnp path wherever its kernel is off.

    The bf16 kernels' work plan depends on the metadata alone, so the
    first call makes it and every later call (the step's other layers)
    reuses it, as the JAX ``make_attend`` builds its metadata once a
    step."""
    plan = {}

    def attend(q, kp, vp):
        if not kernel_takes(q.shape[-1], rep):
            LAUNCHES["ragged_plain"] += 1
            return ragged_attention_plain(q, kp, vp, page_tables, slot_ids,
                                          positions, valid, rep)
        return ragged_attention(q, kp, vp, page_tables, slot_ids, positions,
                                valid, rep, plan=plan)

    return attend


__all__ = ["ragged_paged_attention", "make_attend"]
