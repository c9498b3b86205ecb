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
``block()`` and ``sync_optimizer_state()``. Autograd takes the place of
``jax.value_and_grad`` and ``torch.utils.checkpoint`` that of
``jax.checkpoint``, with the remat policies "full", "dots",
"dots_no_batch" and "nothing". Meshes, ZeRO, context parallelism, the AOT
program cache and the memory watcher are not ported and raise.

**The step as one program.** The JAX trainer traces its step once per
batch signature and runs it compiled (``_build``, ``_jit_step``), with the
rate, the step count and the random key as traced arguments. On a CUDA
model this trainer captures its step in one CUDA graph per batch
signature (shapes and dtypes) and replays it: ``_step_body`` reads only
static buffers (the batch, staged by ``copy_``; the rate and the step
count, float32 0-d tensors the driver fills from ``opt.get_lr()`` and its
own count before each step; the step's random keys, ``_key``, which the
dropout kernels read) and writes only persistent tensors (parameters, the
optimizer's state, the kept gradient buffers, the loss slot). The first
call of a signature runs the body eagerly on a side stream (the real step:
it compiles the Triton kernels and makes cuBLAS's handles) and then
captures it; later calls stage, fill and replay. A replay runs no Python,
so the launches the capture counted are taken back out and added at each
replay (``kernels.uncount_since``). A step that cannot be captured raises;
a CUDA model is never trained op by op behind the caller's back. On a CPU
model the body runs eagerly (``_step_eager``), which on the card is the
captured step's yardstick.

The optimizer's state is the trainer's: the update writes the optimizer's
own moments (in place, so a captured step keeps updating them), and each
step is numbered one past the optimizer's ``_global_step``, so a trainer
whose optimizer ``set_state_dict`` loaded, before or after the trainer
captured its step, resumes where the saved run stopped. (The JAX trainer
starts its state afresh whatever its optimizer holds.)
"""
from __future__ import annotations

import functools
import gc
import time
from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import amp
from ..framework import random as rnd
from ..kernels import LAUNCHES, uncount_since
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
    state of the forward, so it casts as the forward did, and from the
    random key position of the forward's entry (``framework.random.
    replaying``), so it draws the forward's dropout masks again."""
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
        pos = rnd.position()

        def run(*a, **kw):
            with amp.restored_state(cast), rnd.replaying(pos):
                return orig(*a, **kw)
        return checkpoint(run, *args, use_reentrant=False, **extra, **kwargs)

    layer.forward = remat_forward
    layer._remat_wrapped = True


class _Captured:
    """One batch signature's captured step (it reads the signature's
    static batch buffers, ``SpmdTrainer._staged``): the CUDA graph, the
    launches a replay makes (``tally``), the device tensors the update
    reads besides the model's and optimizer's (``kept``: the AdamW
    kernel's tables), and the capture's cost (``seconds``; ``pool_bytes``,
    what the capture added to the trainer's graph pool, and so to the
    memory PyTorch holds)."""

    def __init__(self):
        self.graph = None
        self.tally: Dict[str, int] = {}
        self.kept = []
        self.seconds = 0.0
        self.pool_bytes = 0


def _signature(batch):
    return tuple((tuple(b.shape), b.dtype) for b in batch)


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
        self._graphs: Dict[tuple, _Captured] = {}
        self._pool = None          # the memory pool all its graphs share
        self._staged: Dict[tuple, tuple] = {}
        # the static scalars the body reads: rate, step count, loss slot
        self._lr = self._step = self._loss = None
        # the step's random keys, one a micro-batch (int64 [k, 2])
        self._key = None

    @property
    def _device(self) -> torch.device:
        return self._params[self._param_list[0]].device

    def _grads_of(self, batch):
        """(fp32 loss, {name: grad}) of one (micro-)batch."""
        loss = self.loss_fn(self.model, *batch).float()
        params = [self._params[n] for n in self._param_list]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), {
            n: torch.zeros_like(p) if g is None else g
            for n, p, g in zip(self._param_list, params, grads)}

    def train_step(self, *batch) -> torch.Tensor:
        """One forward + backward + update. batch: tensors (staged into the
        signature's buffers on the model's device); returns the (fp32)
        loss, a tensor of its own. On a CUDA model the step is the
        signature's captured graph (captured at the signature's first
        call, which runs the step eagerly); on a CPU model it runs
        eagerly."""
        if self._device.type != "cuda":
            return self._step_eager(*batch)
        self._check_batch(batch)
        sig = _signature(batch)
        cap = self._graphs.get(sig)
        if cap is None:
            return self._capture(batch)
        self._stage(batch)
        self._begin_step()
        cap.graph.replay()
        for name, n in cap.tally.items():
            LAUNCHES[name] += n
        self._end_step(replayed=True)
        return self._loss.clone()

    def _step_eager(self, *batch) -> torch.Tensor:
        """The same step op by op: the CPU's path, and on the card the
        captured step's yardstick (the same body on the same buffers)."""
        self._check_batch(batch)
        static = self._stage(batch)
        self._begin_step()
        self._step_body(static)
        self._end_step()
        return self._loss.clone()

    def _check_batch(self, batch):
        k = self.accumulate_steps
        for b in batch:
            if not torch.is_tensor(b):
                raise TypeError(f"train_step takes tensors, got {type(b)}")
            if k > 1 and (b.dim() < 1 or b.shape[0] % k):
                raise ValueError(
                    f"accumulate_steps={k} must divide the batch dim of "
                    f"every input (got shape {tuple(b.shape)})")

    def _stage(self, batch) -> tuple:
        """Copy the batch into its signature's static buffers (made at the
        signature's first call) on the model's device."""
        sig = _signature(batch)
        static = self._staged.get(sig)
        if static is None:
            static = tuple(torch.empty(b.shape, dtype=b.dtype,
                                       device=self._device) for b in batch)
            self._staged[sig] = static
        for dst, src in zip(static, batch):
            dst.copy_(src, non_blocking=True)
        return static

    def _begin_step(self):
        """The host's part of a step before the device's: count it (one
        past the optimizer's ``_global_step``, which the trainer keeps at
        its count, so an optimizer state loaded in place resumes the
        count too), write the rate (float32, as the JAX trainer's
        ``jnp.float32(get_lr())``) and the count into the static scalars,
        and give every parameter's state the count (``_step``). Draw the
        step's key (``next_key()`` once a step, as the JAX trainer's
        ``train_step``), folded into one key a micro-batch (the JAX
        trainer splits its key over the micro-batches), into
        ``self._key``, which the random ops of the step read on the
        device."""
        k = self.accumulate_steps
        if self._lr is None:
            dev = self._device
            self._lr, self._step, self._loss = (
                torch.zeros((), dtype=torch.float32, device=dev)
                for _ in range(3))
            self._key = torch.zeros((k, 2), dtype=torch.int64, device=dev)
        self._step_count = self.opt._global_step + 1
        self._lr.fill_(self.opt.get_lr())
        self._step.fill_(float(self._step_count))
        drawn = rnd.next_key()
        key = rnd.fold_in(drawn.base, drawn.site)
        for i in range(k):
            words = key if k == 1 else rnd.fold_in(key, i)
            for j in range(2):
                self._key[i, j].fill_(words[j])
        for n in self._param_list:
            self.opt._state_of(self._params[n])["_step"] = self._step_count

    def _end_step(self, replayed=False):
        self.opt._global_step = self._step_count
        if replayed:
            # a replay writes the parameters without autograd seeing it:
            # bump their version counters as the eager update does, so
            # what keys on them (the quantized decode weights) sees it
            for n in self._param_list:
                torch.autograd.graph.increment_version(self._params[n])

    def _step_body(self, batch) -> list:
        """The device's part of a step, reading only ``batch`` (static
        buffers), ``self._lr``, ``self._step`` and ``self._key`` (each
        micro-batch's loss and backward run under its key's
        ``key_context``, whose sites restart each step), writing only the
        parameters, the optimizer's state, ``self._grads`` and
        ``self._loss``. Returns the device tensors the update reads that a
        CUDA graph of it must keep (``Optimizer._update_all``)."""
        k = self.accumulate_steps
        if k == 1:
            with rnd.key_context(self._key[0]):
                loss, grads = self._grads_of(batch)
        else:
            micro = [b.chunk(k, dim=0) for b in batch]
            loss = torch.zeros((), dtype=torch.float32, device=self._device)
            acc = None
            for i in range(k):
                with rnd.key_context(self._key[i]):
                    l, g = self._grads_of([m[i] for m in micro])
                loss = loss + l
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
            self._loss.copy_(loss)
        return self.opt._update_all(params, grads, self._lr,
                                    [_lr_mult(p) for p in params], self._step)

    def _capture(self, batch) -> torch.Tensor:
        """A new signature's first call: the step run eagerly on a side
        stream (the real step, which also compiles every Triton kernel it
        reaches and makes cuBLAS's handles), then the same body captured
        in a CUDA graph (the capture runs no kernel). Returns the eager
        step's loss."""
        t0 = time.perf_counter()
        dev = self._device
        static = self._stage(batch)
        self._begin_step()
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._step_body(static)
        cur.wait_stream(side)
        self._end_step()
        loss = self._loss.clone()
        # what the capture adds to the memory PyTorch holds is what it adds
        # to the pool (a remat'd layer and its wrapped forward form a cycle
        # that only the collector frees)
        gc.collect()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        cap = _Captured()
        cap.graph = torch.cuda.CUDAGraph()
        before = dict(LAUNCHES)
        try:
            with torch.cuda.graph(cap.graph, pool=self._shared_pool()):
                cap.kept = self._step_body(static)
        except RuntimeError as exc:
            raise RuntimeError(
                f"SpmdTrainer: the training step cannot be captured in a "
                f"CUDA graph (the operation that refused is named above): "
                f"{exc}") from exc
        finally:
            cap.tally = uncount_since(before)
        cap.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        cap.seconds = time.perf_counter() - t0
        self._graphs[_signature(batch)] = cap
        return loss

    def _shared_pool(self):
        """The memory pool every graph of this trainer is captured into, so
        a second signature reuses the first one's activation memory
        (``jit`` keeps one program per signature, not its memory). The
        sharing is safe because the replays run one at a time on one
        stream and a replay reads, of what lives in the pool, only what it
        wrote itself earlier in the same replay: every tensor that one
        step leaves for the next (parameters, state, gradient buffers,
        the loss slot, the staged batches, the update's tables) was made
        by an eager step, outside the pool."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def _drop_graphs(self):
        """Free every captured step (and so their memory pool): the next
        call of each signature captures anew."""
        self._graphs.clear()
        self._pool = None

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
