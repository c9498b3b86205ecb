"""Optimizers: gradient clipping, Adam and AdamW.

Mirrors ``paddle_tpu/optimizer/__init__.py``: ``ClipGradByValue``,
``ClipGradByNorm``, ``ClipGradByGlobalNorm``, the ``Optimizer`` base and
``Adam``/``AdamW`` with ``_adam_update``'s math (fp32 moments, bias
correction, decoupled or coupled weight decay). The update goes through
``kernels.optimizer.multi_tensor_adamw``: one kernel launch per dtype group
on CUDA tensors, the plain version on CPU tensors. It is in place: the
parameters and the moments are overwritten (the JAX optimizer makes new
arrays). Learning-rate schedulers, regularizer objects and
``multi_precision`` are not ported and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..kernels.optimizer import multi_tensor_adamw

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "Optimizer", "Adam", "AdamW"]


# -- gradient clipping ---------------------------------------------------------

class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        return [(p, g.clamp(self.min, self.max)) for p, g in params_grads]


def _scaled(g, scale):
    return (g.float() * scale).to(g.dtype)


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            n = torch.sqrt((g.float() ** 2).sum())
            scale = torch.clamp(self.clip_norm / n.clamp(min=1e-12), max=1.0)
            out.append((p, _scaled(g, scale)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        if not params_grads:
            return params_grads
        total = sum((g.float() ** 2).sum() for _, g in params_grads)
        scale = self.clip_norm / torch.sqrt(total).clamp(min=self.clip_norm)
        return [(p, _scaled(g, scale)) for p, g in params_grads]


# -- optimizers ----------------------------------------------------------------

def _unported(what):
    return NotImplementedError(f"{what} is not ported to paddle_tpu_torch yet "
                               f"(ROADMAP Queue 1)")


class Optimizer:
    """Holds the parameters (a list of tensors), the learning rate (a
    float) and the weight decay (a float or None)."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if not isinstance(learning_rate, (int, float)):
            raise _unported("an LRScheduler learning rate")
        if weight_decay is not None and \
                not isinstance(weight_decay, (int, float)):
            raise _unported("a regularizer object as weight_decay")
        self._lr = float(learning_rate)
        self._parameter_list: List[torch.Tensor] = \
            list(parameters) if parameters is not None else []
        if any(isinstance(p, dict) for p in self._parameter_list):
            raise _unported("parameter groups")
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._state: Dict[int, Dict[str, torch.Tensor]] = {}
        self._global_step = 0

    def get_lr(self) -> float:
        return self._lr

    def _wd_coeff(self, param) -> float:
        return 0.0 if self._weight_decay is None else float(self._weight_decay)

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._parameter_list:
            if p.grad is not None:
                if set_to_zero:
                    p.grad.zero_()
                else:
                    p.grad = None

    def _collect_params_grads(self):
        pgs = [(p, p.grad) for p in self._parameter_list
               if p.grad is not None and p.requires_grad]
        if self._grad_clip is not None:
            pgs = self._grad_clip(pgs)
        return pgs


class Adam(Optimizer):
    _decoupled_wd = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        if multi_precision:
            raise _unported("multi_precision (fp32 master weights)")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)

    def _moments(self, p):
        st = self._state.get(id(p))
        if st is None:
            st = {"moment1": torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device),
                  "moment2": torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device),
                  "step": 0}
            self._state[id(p)] = st
        return st

    @torch.no_grad()
    def _update(self, params, grads, step):
        """One update of ``params`` (in place) from ``grads`` already in
        each parameter's dtype, with bias correction for update ``step``."""
        states = [self._moments(p) for p in params]
        multi_tensor_adamw(
            [p.data for p in params], [g.detach().contiguous() for g in grads],
            [s["moment1"] for s in states], [s["moment2"] for s in states],
            lr=self.get_lr(), beta1=self._beta1,
            beta2=self._beta2, eps=self._epsilon,
            wds=[self._wd_coeff(p) for p in params], step=float(step),
            decoupled=self._decoupled_wd)
        for p in params:
            # the update writes through p.data (and, on the card, a raw
            # pointer), which leaves p's version counter alone: bump it, so
            # what keys on it (the quantized decode weights) sees the step
            torch.autograd.graph.increment_version(p)
        for s in states:
            s["step"] = step

    def step(self):
        """Update every parameter that has a gradient. Each parameter's
        bias correction counts the updates it has seen, as in the JAX
        optimizer; parameters at the same count update together."""
        self._global_step += 1
        buckets = {}
        for p, g in self._collect_params_grads():
            step = self._moments(p)["step"] + 1
            buckets.setdefault(step, []).append((p, g.to(p.dtype)))
        for step, items in buckets.items():
            self._update([p for p, _ in items], [g for _, g in items], step)


class AdamW(Adam):
    """Adam with decoupled weight decay."""
    _decoupled_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        if lr_ratio is not None or apply_decay_param_fun is not None:
            raise _unported("lr_ratio / apply_decay_param_fun")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name)
