"""Scalars on the device for the update: constants made once, and the rate
and step of each step as 0-d tensors.

The JAX package compiles its update with the rate and the step as traced
arguments and its constants (betas, eps, decay, a regularizer's
coefficient) folded into the program. The port's counterparts: ``const``
makes a constant's tensor at its first use and keeps it, and ``scalar``
gives the rate or the step as a float32 0-d tensor. A step that reads only
these and tensors already on the device copies nothing from the host, so
it can be captured in a CUDA graph (a ``torch.tensor`` made inside the
capture would be a host copy, which capture refuses).
"""
from __future__ import annotations

import numpy as np
import torch

_CONSTS: dict = {}            # (device, dtype, value) -> 0-d tensor


def const(value, device, dtype=torch.float32):
    """A constant scalar tensor on ``device``, made at its first use and
    kept."""
    key = (torch.device(device), dtype, float(value))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(float(value), dtype=dtype,
                                        device=device)
    return t


def scalar(x, device):
    """A float32 0-d tensor of a step's rate or count ``x``: the tensor
    itself, or a number rounded to float32 (as ``jnp.float32(x)``) and
    copied to ``device`` (the eager paths; a trainer passes its device
    tensors)."""
    if torch.is_tensor(x):
        return x.to(torch.float32).reshape(())
    return torch.tensor(float(np.float32(x)), dtype=torch.float32,
                        device=device)


__all__ = ["const", "scalar"]
