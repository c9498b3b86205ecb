"""``sequence_mask`` and ``gather_tree`` of ``paddle_tpu/ops/special.py``
(``:130``, ``:240``), the two that seq2seq models need; both re-exported by
``nn.functional``. The rest of that module waits for ROADMAP Queue 1 item
8.

Plain PyTorch, as the JAX functions are jnp and ``lax`` ops: no kernel.
"""
from __future__ import annotations

import torch

from .. import amp


def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).lower()
    if name == "bool":
        return torch.bool
    return getattr(torch, name)


@amp.op("sequence_mask")
def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """``mask[..., j] = j < x[...]`` over ``j < maxlen``, in ``dtype``.
    With ``maxlen=None`` it is ``x.max()``, read on the host (as the JAX
    function reads it): a step captured in a CUDA graph passes
    ``maxlen``."""
    m = int(maxlen) if maxlen is not None else int(x.max())
    mask = torch.arange(m, device=x.device)[None, :] < x.reshape(-1, 1)
    return mask.reshape(tuple(x.shape) + (m,)).to(_torch_dtype(dtype))


@amp.op("gather_tree")
def gather_tree(ids, parents, name=None):
    """The beam-search backtrace of ``ids`` and ``parents`` ``[max_time,
    batch, beam]``: from the last step back, each beam's token at its own
    index, then through its parent, one gather a step."""
    T = ids.shape[0]
    beam = torch.arange(ids.shape[2], device=ids.device)
    parent = beam[None, :].expand(ids.shape[1:])
    toks = [None] * T
    par = parents.long()
    for t in range(T - 1, -1, -1):
        toks[t] = torch.gather(ids[t], 1, parent)
        parent = torch.gather(par[t], 1, parent)
    return torch.stack(toks)


__all__ = ["sequence_mask", "gather_tree"]
