"""SpmdTrainer on one device: forward, loss, backward, clip and update.

Mirrors ``paddle_tpu/parallel/trainer.py`` for ``mesh=None``: the same
constructor, ``train_step(*batch)`` with the step semantics of its
``_build`` (the loss in fp32; with ``accumulate_steps=k`` the batch splits
into k micro-batches whose gradients are summed in fp32, divided by k and
cast to the parameter dtype; then gradient clipping, which, as the JAX
trainer's, ignores ``need_clip``; then, per parameter as in its
``_update_loop``, the regularizer's penalty on the gradient and the
optimizer's rule at the rate ``float32(get_lr()) * multiplier`` read at
every step, with bias correction from the trainer's own step count),
``block()`` and ``sync_optimizer_state()``. PyTorch runs the step eagerly:
autograd takes the place of ``jax.value_and_grad`` and
``torch.utils.checkpoint`` that of ``jax.checkpoint``, with the remat
policies "full", "dots", "dots_no_batch" and "nothing". Meshes, ZeRO,
context parallelism, the AOT program cache and the memory watcher are not
ported and raise.

The optimizer's state is the trainer's: the update writes the optimizer's
own moments, and the step count starts at the optimizer's
``_global_step``, so a trainer built on an optimizer that
``set_state_dict`` loaded resumes where the saved run stopped. (The JAX
trainer starts its state afresh whatever its optimizer holds.)
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import amp
from ..optimizer import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                         Optimizer, _lr_mult)

_aten = torch.ops.aten
_UNBATCHED_PRODUCTS = {_aten.mm.default, _aten.addmm.default, _aten.mv.default,
                       _aten.dot.default}
_BATCHED_PRODUCTS = {_aten.bmm.default, _aten.baddbmm.default}

# what a remat'd layer keeps for the backward, as the JAX trainer's
# REMAT_POLICIES pick a jax.checkpoint policy: None keeps nothing (every
# activation is recomputed); otherwise the outputs of these aten products
# are kept and the rest recomputed. "dots" keeps every matrix product (the
# ones behind torch.matmul, F.linear and einsum), "dots_no_batch" those
# without batch dims. A kernel's op (ptt::flash_fwd, ...) is recomputed, as
# dots_saveable keeps no Pallas call's output.
REMAT_POLICIES = {
    "full": None,
    "dots": _UNBATCHED_PRODUCTS | _BATCHED_PRODUCTS,
    "dots_no_batch": _UNBATCHED_PRODUCTS,
    "nothing": None,
}


def _clip_grads_functional(grad_clip, params: Dict, grads: Dict) -> Dict:
    """Gradient clipping over {name: grad}, as the JAX trainer's: the
    global norm takes every gradient, whatever its parameter's
    ``need_clip``."""
    if grad_clip is None:
        return grads
    if not isinstance(grad_clip, (ClipGradByValue, ClipGradByNorm,
                                  ClipGradByGlobalNorm)):
        raise TypeError(f"unsupported grad clip {type(grad_clip)}")
    names = list(grads)
    clipped = grad_clip([(None, grads[n]) for n in names])
    return {n: g for n, (_, g) in zip(names, clipped)}


def _saving(ops):
    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return functools.partial(create_selective_checkpoint_contexts, policy)


def _wrap_remat(layer, policy: str = "full"):
    """Recompute ``layer``'s activations in the backward instead of keeping
    them: its forward runs under ``torch.utils.checkpoint``
    (non-reentrant), which keeps its inputs and what ``policy`` saves
    (``REMAT_POLICIES``). The recompute runs under the ``amp.auto_cast``
    state of the forward, so it casts as the forward did."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy must be one of "
                         f"{list(REMAT_POLICIES)}, got {policy!r}")
    if getattr(layer, "_remat_wrapped", False):
        return
    orig = layer.forward
    saved = REMAT_POLICIES[policy]
    extra = {} if saved is None else {"context_fn": _saving(saved)}

    @functools.wraps(orig)
    def remat_forward(*args, **kwargs):
        cast = amp.current_state()

        def run(*a, **kw):
            with amp.restored_state(cast):
                return orig(*a, **kw)
        return checkpoint(run, *args, use_reentrant=False, **extra, **kwargs)

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
        if remat_layers and self.remat_policy != "off":
            for layer in remat_layers:
                _wrap_remat(layer, self.remat_policy)
        self._params = dict(model.named_parameters())
        self._param_list = list(self._params)
        self._grads: Optional[Dict[str, torch.Tensor]] = None
        self._step_count = optimizer._global_step

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
        params = [self._params[n] for n in self._param_list]
        grads = [self._grads[n] for n in self._param_list]
        with torch.no_grad():
            for p, g in zip(params, grads):
                if self.opt._needs_grad_transform(p):
                    g.copy_(self.opt._reg_grad(p, g))
        self.opt._update_all(params, grads, self.opt.get_lr(),
                             [_lr_mult(p) for p in params], self._step_count)
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

    def sync_optimizer_state(self):
        """Give every parameter's optimizer state the trainer's step count
        (the state itself is already the optimizer's)."""
        for n in self._param_list:
            self.opt._state_of(self._params[n])["_step"] = self._step_count

    def block(self):
        """Wait for every step launched so far, the last update included."""
        if self._param_list:
            p = self._params[self._param_list[0]]
            if p.device.type == "cuda":
                torch.cuda.synchronize(p.device)


__all__ = ["SpmdTrainer", "_clip_grads_functional", "_wrap_remat",
           "REMAT_POLICIES"]
