"""The initial distributions of ``paddle_tpu/nn/initializer``, drawn from
an explicit ``torch.Generator``.

The draws differ from the JAX package's (another generator); the
distributions are the same: Xavier fans of a 2-D ``[in, out]`` weight are
its two dims, and a caller may give them (the MoE expert banks do).
"""
from __future__ import annotations

import math

import torch


def _fans(shape):
    if len(shape) < 2:
        return (shape[0] if shape else 1,) * 2
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


@torch.no_grad()
def xavier_uniform_(t, generator, fan_in=None, fan_out=None, gain=1.0):
    fi, fo = _fans(tuple(t.shape))
    fi = fi if fan_in is None else fan_in
    fo = fo if fan_out is None else fan_out
    limit = gain * math.sqrt(6.0 / (fi + fo))
    return t.uniform_(-limit, limit, generator=generator)


@torch.no_grad()
def xavier_normal_(t, generator, fan_in=None, fan_out=None, gain=1.0):
    fi, fo = _fans(tuple(t.shape))
    fi = fi if fan_in is None else fan_in
    fo = fo if fan_out is None else fan_out
    return t.normal_(0.0, gain * math.sqrt(2.0 / (fi + fo)),
                     generator=generator)


__all__ = ["xavier_uniform_", "xavier_normal_"]
