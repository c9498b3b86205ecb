"""SpmdTrainer on one device: forward, loss, backward, clip and update.

Mirrors ``paddle_tpu/parallel/trainer.py`` for ``mesh=None``: the same
constructor, ``train_step(*batch)`` with the step semantics of its
``_build`` (the loss in fp32; with ``accumulate_steps=k`` the batch splits
into k micro-batches whose gradients are summed in fp32, divided by k and
cast to the parameter dtype; then gradient clipping; then the optimizer
update with bias correction from the trainer's own step count) and
``block()``. PyTorch runs the step eagerly: autograd takes the place of
``jax.value_and_grad`` and ``torch.utils.checkpoint`` that of
``jax.checkpoint``. Meshes, ZeRO, context parallelism, the AOT program
cache and the memory watcher are not ported and raise.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..optimizer import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                         Optimizer)

REMAT_POLICIES = ("full", "off")


def _clip_grads_functional(grad_clip, params: Dict, grads: Dict) -> Dict:
    """Gradient clipping over {name: grad}, as the JAX trainer's."""
    if grad_clip is None:
        return grads
    if not isinstance(grad_clip, (ClipGradByValue, ClipGradByNorm,
                                  ClipGradByGlobalNorm)):
        raise TypeError(f"unsupported grad clip {type(grad_clip)}")
    names = list(grads)
    clipped = grad_clip([(params[n], grads[n]) for n in names])
    return {n: g for n, (_, g) in zip(names, clipped)}


def _wrap_remat(layer, policy: str = "full"):
    """Recompute ``layer``'s activations in the backward instead of keeping
    them: its forward runs under ``torch.utils.checkpoint`` (non-reentrant),
    saving only its inputs. Only the policy "full" is ported ("dots", which
    keeps the matmul outputs, is ROADMAP work)."""
    if policy != "full":
        raise NotImplementedError(
            f"remat policy {policy!r} is not ported (only 'full' and 'off'; "
            f"ROADMAP Queue 1)")
    if getattr(layer, "_remat_wrapped", False):
        return
    orig = layer.forward

    @functools.wraps(orig)
    def remat_forward(*args, **kwargs):
        return checkpoint(orig, *args, use_reentrant=False, **kwargs)

    layer.forward = remat_forward
    layer._remat_wrapped = True


def _refuse(what, value, item):
    if value not in (None, False):
        raise NotImplementedError(
            f"SpmdTrainer({what}=...) is not ported: the port trains on one "
            f"device ({item})")


class SpmdTrainer:
    """One device's training step: ``loss_fn(model, *batch) -> scalar``."""

    def __init__(self, model, optimizer: Optimizer, loss_fn: Callable,
                 mesh=None, remat_layers=None, donate: bool = True,
                 batch_axes=("dp", "sharding"), seq_axis: Optional[str] = None,
                 zero_stage: Optional[int] = None,
                 remat_policy: Optional[str] = None, accumulate_steps: int = 1,
                 aot_cache=None, memwatch=None):
        _refuse("mesh", mesh, "ROADMAP Queue 1, distributed")
        _refuse("seq_axis", seq_axis, "ROADMAP Queue 1, distributed")
        _refuse("zero_stage", zero_stage, "ROADMAP Queue 1, distributed")
        _refuse("aot_cache", aot_cache, "ROADMAP Queue 1, AOT program cache")
        _refuse("memwatch", memwatch, "ROADMAP Queue 1, profiler/memwatch")
        self.model = model
        self.opt = optimizer
        self.loss_fn = loss_fn
        self.accumulate_steps = int(accumulate_steps)
        if self.accumulate_steps < 1:
            raise ValueError("accumulate_steps must be >= 1")
        self.remat_policy = remat_policy or "full"
        if self.remat_policy not in REMAT_POLICIES:
            raise NotImplementedError(
                f"remat policy {self.remat_policy!r} is not ported (only "
                f"{REMAT_POLICIES}; ROADMAP Queue 1)")
        if remat_layers and self.remat_policy != "off":
            for layer in remat_layers:
                _wrap_remat(layer, self.remat_policy)
        self._params = dict(model.named_parameters())
        self._param_list = list(self._params)
        self._grads: Optional[Dict[str, torch.Tensor]] = None
        self._step_count = 0

    def _grads_of(self, batch):
        """(fp32 loss, {name: grad}) of one (micro-)batch."""
        loss = self.loss_fn(self.model, *batch).float()
        params = [self._params[n] for n in self._param_list]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), {
            n: torch.zeros_like(p) if g is None else g
            for n, p, g in zip(self._param_list, params, grads)}

    def train_step(self, *batch) -> torch.Tensor:
        """One forward + backward + update. batch: tensors on the model's
        device; returns the (fp32) loss."""
        k = self.accumulate_steps
        if k > 1:
            for b in batch:
                if b.dim() < 1 or b.shape[0] % k:
                    raise ValueError(
                        f"accumulate_steps={k} must divide the batch dim of "
                        f"every input (got shape {tuple(b.shape)})")
        self._step_count += 1
        if k == 1:
            loss, grads = self._grads_of(batch)
        else:
            micro = [b.chunk(k, dim=0) for b in batch]
            loss = torch.zeros((), dtype=torch.float32)
            acc = None
            for i in range(k):
                l, g = self._grads_of([m[i] for m in micro])
                loss = loss.to(l.device) + l
                if acc is None:
                    acc = {n: x.float() for n, x in g.items()}
                else:
                    for n, x in g.items():
                        acc[n] += x.float()
            loss = loss / k
            grads = {n: acc[n] / k for n in acc}
        self._store_grads(grads)
        self._store_grads(_clip_grads_functional(
            self.opt._grad_clip, self._params, self._grads))
        self.opt._update([self._params[n] for n in self._param_list],
                         [self._grads[n] for n in self._param_list],
                         self._step_count)
        self.opt._global_step = self._step_count
        return loss

    @torch.no_grad()
    def _store_grads(self, grads):
        """Cast the gradients to each parameter's dtype into buffers kept
        from step to step (clipped gradients too), so the optimizer sees the
        same pointers every step and its kernel's table of (tensor, chunk)
        pointers is built once. The cost: a resident buffer the size of the
        parameters and one pass over the gradients a step (two with
        clipping); a table rebuilt every step would cost host time and a
        host-to-device copy instead."""
        if self._grads is None:
            self._grads = {n: torch.empty_like(self._params[n])
                           for n in self._param_list}
        for n in self._param_list:
            if grads[n] is not self._grads[n]:
                self._grads[n].copy_(grads[n])

    def block(self):
        """Wait for every step launched so far, the last update included."""
        if self._param_list:
            p = self._params[self._param_list[0]]
            if p.device.type == "cuda":
                torch.cuda.synchronize(p.device)


__all__ = ["SpmdTrainer", "_clip_grads_functional", "_wrap_remat",
           "REMAT_POLICIES"]
