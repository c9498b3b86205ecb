"""Optimizers: gradient clipping, the ``Optimizer`` base, its thirteen
update rules and LBFGS.

Mirrors ``paddle_tpu/optimizer/__init__.py``: ``ClipGradByValue``,
``ClipGradByNorm``, ``ClipGradByGlobalNorm`` (which skips parameters whose
``need_clip`` is False), the ``Optimizer`` base (a learning rate or an
``lr.LRScheduler``, parameter-group dicts flattened, a float or a
``regularizer`` object as weight decay, per-parameter step counts and
rates, ``state_dict`` / ``set_state_dict``, ``minimize``) and ``SGD``,
``Momentum``, ``Adam``, ``AdamW``, ``Adagrad``, ``Adadelta``, ``Adamax``,
``RMSProp``, ``Lamb``, ``NAdam``, ``RAdam``, ``Rprop``, ``ASGD`` and
``LBFGS``.

The port's parameters are plain ``nn.Parameter``s. What the JAX
``Parameter`` carries is read with defaults: ``name`` (None),
``optimize_attr["learning_rate"]`` (1.0), ``regularizer`` (None; False
turns decay off) and ``need_clip`` (True), so an un-annotated parameter
acts as a default JAX one (``nn.initializer.set_param_attr`` sets the
first two from a ``ParamAttr``).

Each rule computes in float32 with its jnp function's order of operations
and writes the parameter and its state in place (the JAX optimizer makes
new arrays): a CUDA graph that captured a step (``parallel.trainer``)
reads and writes the same tensors at every replay. The rate and the update
count enter a rule as float32 0-d tensors on the parameter's device, as
the JAX trainer traces them; the constants (betas, eps, decay) are tensors
made once (``_scalars.const``), so an update copies nothing from
the host.
``Adam`` and ``AdamW`` go through ``kernels.optimizer.multi_tensor_adamw``:
one kernel launch per (rate, step, dtype) group on CUDA tensors, the plain
version on CPU tensors. The other rules are PyTorch tensor operations, as
they are jitted jnp functions (not Pallas kernels) in the JAX package.

As in the JAX package, ``multi_precision`` and ``lr_ratio`` are accepted
and ignored (no fp32 master weights), a group dict's own keys other than
``params`` are ignored, and ``apply_decay_param_fun`` sees
``param.name or ""``. The eager ``step()`` rounds a parameter's rate once,
``float32(get_lr() * multiplier)`` with the product in double precision;
the trainer multiplies in float32 (``parallel.trainer``).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .._scalars import const, scalar
from ..kernels.optimizer import multi_tensor_adamw
from ..regularizer import L2Decay, WeightDecayRegularizer
from . import lr
from .lr import LRScheduler

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "Adadelta", "Adamax", "RMSProp", "Lamb", "NAdam", "RAdam",
           "Rprop", "ASGD", "LBFGS", "lr"]


def _as_f32(v) -> float:
    """A Python number rounded to float32, as ``jnp.asarray(v, float32)``
    rounds it."""
    return float(np.float32(v))


def _lr_mult(p) -> float:
    return (getattr(p, "optimize_attr", None) or {}).get("learning_rate",
                                                         1.0)


def _key(p, i) -> str:
    return getattr(p, "name", None) or f"param_{i}"


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
    """Scales every gradient by clip_norm / max(global norm, clip_norm);
    the norm and the scaling leave out parameters whose ``need_clip`` is
    False."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        clipped = [getattr(p, "need_clip", True) for p, _ in params_grads]
        sq = [(g.float() ** 2).sum()
              for (_, g), c in zip(params_grads, clipped) if c]
        if not sq:
            return params_grads
        scale = self.clip_norm / torch.sqrt(sum(sq)).clamp(min=self.clip_norm)
        return [(p, _scaled(g, scale) if c else g)
                for (p, g), c in zip(params_grads, clipped)]


# -- base ----------------------------------------------------------------------

class Optimizer:
    """The parameters (tensors, or group dicts whose ``params`` are
    flattened in order), the learning rate (a number or an
    ``LRScheduler``), the weight decay (None, a number or a regularizer)
    and each parameter's state (``_accumulators``, keyed by the
    parameter's id: tensors, and ``_step``, the updates it has seen)."""

    _decoupled_wd = False

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        self._lr = learning_rate
        params = list(parameters) if parameters is not None else []
        self._param_groups = None
        if params and isinstance(params[0], dict):
            self._param_groups = params
            params = [p for group in self._param_groups
                      for p in group["params"]]
        self._parameter_list: List[torch.Tensor] = params
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._name = name
        self._accumulators: Dict[int, Dict] = {}
        self._global_step = 0

    # learning rate -------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, value):
        self._lr = float(value)

    def set_lr_scheduler(self, scheduler):
        self._lr = scheduler

    @property
    def _learning_rate(self):
        return self._lr

    # state ---------------------------------------------------------------------
    def state_dict(self) -> Dict:
        """{"global_step", "accumulators": {key: {name: tensor, "_step":
        int}}, and "LR_Scheduler" when the rate is a scheduler}, keyed by
        ``param.name or f"param_{i}"``. The tensors are copies: later steps
        leave a taken state as it was, as the JAX arrays do."""
        state = {"global_step": self._global_step, "accumulators": {}}
        for i, p in enumerate(self._parameter_list):
            acc = self._accumulators.get(id(p))
            if acc is not None:
                state["accumulators"][_key(p, i)] = {
                    k: v.detach().clone() if torch.is_tensor(v) else v
                    for k, v in acc.items()}
        if isinstance(self._lr, LRScheduler):
            state["LR_Scheduler"] = self._lr.state_dict()
        return state

    def set_state_dict(self, state):
        """Load a ``state_dict()`` (its tensors, or numpy arrays) IN PLACE:
        each value is copied into the parameter's live state tensor of that
        name (created first where the parameter has none), so a CUDA graph
        captured before the load updates the loaded state."""
        self._global_step = int(state.get("global_step", 0))
        accs = state.get("accumulators", {})
        for i, p in enumerate(self._parameter_list):
            key = _key(p, i)
            if key in accs:
                acc = self._state_of(p)
                for k, v in accs[key].items():
                    _load_into(acc, k, v, p.device)
        if "LR_Scheduler" in state and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(state["LR_Scheduler"])

    # weight decay --------------------------------------------------------------
    def _effective_decay(self, param):
        """The parameter's regularizer wins over the optimizer's weight
        decay; ``regularizer=False`` disables decay."""
        r = getattr(param, "regularizer", None)
        if r is False:
            return None
        return r if r is not None else self._weight_decay

    def _wd_coeff(self, param) -> float:
        """The coefficient of the update's own weight-decay term. A
        regularizer object is coupled: an ``L2Decay`` under a coupled rule
        rides that term (the same math); any other (L1, or any regularizer
        under a decoupled rule, whose decoupled term is then skipped) goes
        through the gradient in ``_reg_grad``."""
        wd = self._effective_decay(param)
        if wd is None:
            return 0.0
        if isinstance(wd, WeightDecayRegularizer):
            if isinstance(wd, L2Decay) and not self._decoupled_wd:
                return wd.coeff
            return 0.0
        return float(wd)

    def _needs_grad_transform(self, param) -> bool:
        wd = self._effective_decay(param)
        if not isinstance(wd, WeightDecayRegularizer):
            return False
        return not (isinstance(wd, L2Decay) and not self._decoupled_wd)

    def _reg_grad(self, param, grad, param_arr=None):
        """The gradient with the regularizer's penalty, where ``_wd_coeff``
        leaves it to the gradient."""
        if not self._needs_grad_transform(param):
            return grad
        arr = param.detach() if param_arr is None else param_arr
        return self._effective_decay(param).apply(grad, arr)

    # gradients -----------------------------------------------------------------
    def _collect_params_grads(self):
        pgs = [(p, p.grad) for p in self._parameter_list
               if p.grad is not None and p.requires_grad]
        if self._grad_clip is not None:
            pgs = self._grad_clip(pgs)
        return pgs

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._parameter_list:
            if p.grad is not None:
                if set_to_zero:
                    p.grad = torch.zeros_like(p)
                else:
                    p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()`` then ``step()``."""
        loss.backward()
        self.step()
        return None, []

    # updates -------------------------------------------------------------------
    def _state_of(self, p) -> Dict:
        acc = self._accumulators.get(id(p))
        if acc is None:
            acc = self._init_state(p)
            acc["_step"] = 0
            self._accumulators[id(p)] = acc
        return acc

    def _resolve_param_step(self, p):
        """(state, this parameter's update count, its rate in double
        precision): bias corrections count the updates each parameter has
        seen, not the optimizer's steps."""
        acc = self._state_of(p)
        return acc, int(acc["_step"]) + 1, self.get_lr() * _lr_mult(p)

    @torch.no_grad()
    def _apply_one(self, p, g, acc, lr_t, step_t):
        """One rule's update of ``p`` in place at the rate ``lr_t`` and
        update count ``step_t`` (float32 0-d tensors on p's device); the new
        state is copied into ``acc``'s tensors."""
        state = {k: v for k, v in acc.items() if k != "_step"}
        new_p, new_state = self._update(p.detach(), g, state, lr_t,
                                        self._wd_coeff(p), step_t)
        p.copy_(new_p)
        for k, v in new_state.items():
            if v is not acc[k]:
                acc[k].copy_(v)

    @torch.no_grad()
    def step(self):
        """Update every parameter that has a gradient: clipped, cast to the
        parameter's dtype, regularized, then the rule at the parameter's
        own rate and update count."""
        self._global_step += 1
        for p, g in self._collect_params_grads():
            acc, step, lr_val = self._resolve_param_step(p)
            self._apply_one(p, self._reg_grad(p, g.to(p.dtype)), acc,
                            scalar(lr_val, p.device), scalar(step, p.device))
            acc["_step"] = step

    @torch.no_grad()
    def _update_all(self, params, grads, lr, mults, step):
        """The trainer's update: every parameter at the rate ``lr *
        float32(mult)`` (the JAX trainer's float32 product) and update
        count ``step``, both float32 0-d tensors on the parameters' device
        (the trainer's buffers; what it writes in them before each step is
        what the update reads, also from a CUDA graph); ``grads`` are
        already in each parameter's dtype and regularized. The trainer
        keeps each parameter's ``_step``. Returns the device tensors that a
        captured update reads besides the parameters, gradients and state
        (none here; the AdamW kernel's tables)."""
        for p, g, mult in zip(params, grads, mults):
            self._apply_one(p, g, self._state_of(p),
                            lr * const(_as_f32(mult), p.device), step)
        return []

    def _init_state(self, param) -> Dict:
        return {}

    def _update(self, param, grad, state, lr_val, wd, step):
        """(new param in its dtype, new state) of one tensor."""
        raise NotImplementedError


def _load_into(acc, key, v, device):
    """Load one saved state value into ``acc``: ``_step`` as an int, a
    tensor into the live tensor of that name when shapes agree (in place),
    else as a new tensor on ``device``."""
    if key == "_step":
        acc[key] = int(v)
        return
    t = v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
    live = acc.get(key)
    if torch.is_tensor(live) and live.shape == t.shape:
        live.copy_(t)
    else:
        acc[key] = t.to(device=device, copy=True).contiguous()


def _consts(p, *values):
    """float32 scalars on p's device, each made once and kept: the JAX
    rules' ``_f32`` operands (``_scalars.const``)."""
    return [const(v, p.device) for v in values]


# -- the rules -------------------------------------------------------------------

class SGD(Optimizer):
    def _update(self, param, grad, state, lr_val, wd, step):
        lr_, (wd_,) = lr_val, _consts(param, wd)
        g = grad.float() + wd_ * param.float()
        return (param.float() - lr_ * g).to(param.dtype), state


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _init_state(self, param):
        return {"velocity": torch.zeros_like(param.detach())}

    def _update(self, param, grad, state, lr_val, wd, step):
        lr_, (mu, wd_) = lr_val, _consts(param, self._momentum, wd)
        g = grad.float() + wd_ * param.float()
        v = mu * state["velocity"].float() + g
        upd = g + mu * v if self._use_nesterov else v
        return (param.float() - lr_ * upd).to(param.dtype), {"velocity": v}


class Adam(Optimizer):
    """Adam (``_adam_update``): float32 moments, bias correction, coupled
    weight decay; through ``multi_tensor_adamw``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _init_state(self, param):
        return {"moment1": torch.zeros(param.shape, dtype=torch.float32,
                                       device=param.device),
                "moment2": torch.zeros(param.shape, dtype=torch.float32,
                                       device=param.device)}

    @torch.no_grad()
    def _adam(self, params, grads, lr, mults, step):
        """One ``multi_tensor_adamw`` call (a kernel launch per dtype group
        on the card) over ``params`` at update ``step``: tensor i at the
        float32 rate ``lr * mults[i]`` (``lr`` and ``step`` numbers, or
        0-d device tensors). Returns what the launches read."""
        states = [self._state_of(p) for p in params]
        read = multi_tensor_adamw(
            [p.data for p in params], [g.detach().contiguous() for g in grads],
            [s["moment1"] for s in states], [s["moment2"] for s in states],
            lr=lr, lr_mults=mults, beta1=self._beta1, beta2=self._beta2,
            eps=self._epsilon, wds=[self._wd_coeff(p) for p in params],
            step=step, decoupled=self._decoupled_wd)
        for p in params:
            # the update writes through p.data (and, on the card, a raw
            # pointer), which leaves p's version counter alone: bump it, so
            # what keys on it (the quantized decode weights) sees the step
            torch.autograd.graph.increment_version(p)
        return read

    @torch.no_grad()
    def step(self):
        """The base ``step()`` with one ``_adam`` call per (float32 rate,
        update count) bucket, every multiplier 1.0: each parameter's rate
        is ``float32(get_lr() * multiplier)``, as the JAX eager path
        rounds it."""
        self._global_step += 1
        buckets = {}
        for p, g in self._collect_params_grads():
            _, step, lr_val = self._resolve_param_step(p)
            buckets.setdefault((_as_f32(lr_val), step), []).append(
                (p, self._reg_grad(p, g.to(p.dtype))))
        for (lr32, step), items in buckets.items():
            self._adam([p for p, _ in items], [g for _, g in items], lr32,
                       [1.0] * len(items), float(step))
            for p, _ in items:
                self._state_of(p)["_step"] = step

    def _update_all(self, params, grads, lr, mults, step):
        """One ``_adam`` call at the base rate ``lr`` (a float32 0-d
        tensor) with each parameter's multiplier: the kernel forms the
        float32 product."""
        return self._adam(params, grads, lr, [_as_f32(m) for m in mults],
                          step)


class AdamW(Adam):
    """Adam with decoupled weight decay; ``apply_decay_param_fun(name)``
    False turns decay off for a parameter."""
    _decoupled_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, name=name)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _wd_coeff(self, param):
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(
                    getattr(param, "name", None) or ""):
            return 0.0
        return super()._wd_coeff(param)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_val = initial_accumulator_value

    def _init_state(self, param):
        return {"moment": torch.full(param.shape, self._init_val,
                                     dtype=torch.float32,
                                     device=param.device)}

    def _update(self, param, grad, state, lr_val, wd, step):
        lr_, (eps, wd_) = lr_val, _consts(param, self._epsilon, wd)
        pf = param.float()
        g = grad.float() + wd_ * pf
        mom = state["moment"] + g * g
        new_p = pf - lr_ * g / (torch.sqrt(mom) + eps)
        return new_p.to(param.dtype), {"moment": mom}


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._rho = rho

    def _init_state(self, param):
        z = torch.zeros(param.shape, dtype=torch.float32, device=param.device)
        return {"avg_squared_grad": z, "avg_squared_update": z.clone()}

    def _update(self, param, grad, state, lr_val, wd, step):
        lr_, (rho, eps, wd_) = lr_val, _consts(param, self._rho,
                                               self._epsilon, wd)
        pf = param.float()
        g = grad.float() + wd_ * pf
        sq = rho * state["avg_squared_grad"] + (1 - rho) * g * g
        upd = torch.sqrt(state["avg_squared_update"] + eps) \
            / torch.sqrt(sq + eps) * g
        up = rho * state["avg_squared_update"] + (1 - rho) * upd * upd
        return (pf - lr_ * upd).to(param.dtype), \
            {"avg_squared_grad": sq, "avg_squared_update": up}


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_state(self, param):
        z = torch.zeros(param.shape, dtype=torch.float32, device=param.device)
        return {"moment": z, "inf_norm": z.clone()}

    def _update(self, param, grad, state, lr_val, wd, step):
        lr_, st = lr_val, step
        b1, b2, eps, wd_ = _consts(param, self._beta1, self._beta2,
                                   self._epsilon, wd)
        pf = param.float()
        g = grad.float() + wd_ * pf
        m = b1 * state["moment"] + (1 - b1) * g
        inf = torch.maximum(b2 * state["inf_norm"], torch.abs(g))
        upd = m / (1 - b1 ** st) / (inf + eps)
        return (pf - lr_ * upd).to(param.dtype), {"moment": m, "inf_norm": inf}


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_state(self, param):
        z = torch.zeros(param.shape, dtype=torch.float32, device=param.device)
        return {"mean_square": z, "mean_grad": z.clone(), "momentum": z.clone()}

    def _update(self, param, grad, state, lr_val, wd, step):
        lr_ = lr_val
        rho, eps, mom_, wd_ = _consts(param, self._rho, self._epsilon,
                                      self._momentum, wd)
        pf = param.float()
        g = grad.float() + wd_ * pf
        ms = rho * state["mean_square"] + (1 - rho) * g * g
        if self._centered:
            mg = rho * state["mean_grad"] + (1 - rho) * g
            denom = ms - mg * mg
        else:
            mg = state["mean_grad"]
            denom = ms - 0.0
        mom = mom_ * state["momentum"] + lr_ * g / torch.sqrt(denom + eps)
        return (pf - mom).to(param.dtype), \
            {"mean_square": ms, "mean_grad": mg, "momentum": mom}


class Lamb(Optimizer):
    """Lamb: Adam's moments, the update scaled by the trust ratio
    ||p|| / ||r|| of the whole tensor (so it needs every element of it);
    ``exclude_from_weight_decay_fn(param)`` True turns decay off."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_state(self, param):
        z = torch.zeros(param.shape, dtype=torch.float32, device=param.device)
        return {"moment1": z, "moment2": z.clone()}

    def _wd_coeff(self, param):
        if self._exclude_fn is not None and self._exclude_fn(param):
            return 0.0
        return super()._wd_coeff(param)

    def _update(self, param, grad, state, lr_val, wd, step):
        lr_, st = lr_val, step
        b1, b2, eps, wd_ = _consts(param, self._beta1, self._beta2,
                                   self._epsilon, wd)
        gf, pf = grad.float(), param.float()
        m = b1 * state["moment1"] + (1 - b1) * gf
        v = b2 * state["moment2"] + (1 - b2) * gf * gf
        mhat = m / (1 - b1 ** st)
        vhat = v / (1 - b2 ** st)
        r = mhat / (torch.sqrt(vhat) + eps) + wd_ * pf
        w_norm = torch.linalg.vector_norm(pf)
        r_norm = torch.linalg.vector_norm(r)
        ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        return (pf - lr_ * ratio * r).to(param.dtype), \
            {"moment1": m, "moment2": v}


class NAdam(Optimizer):
    """NAdam; the momentum-decay power 0.96**step is recomputed from the
    step count, as in the JAX rule."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._momentum_decay = momentum_decay

    def _init_state(self, param):
        z = torch.zeros(param.shape, dtype=torch.float32, device=param.device)
        return {"moment1": z, "moment2": z.clone(),
                "mu_product": torch.ones((), dtype=torch.float32,
                                         device=param.device)}

    def _update(self, param, grad, state, lr_val, wd, step):
        lr_, st = lr_val, step
        b1, b2, eps, psi, wd_, c96 = _consts(
            param, self._beta1, self._beta2, self._epsilon,
            self._momentum_decay, wd, 0.96)
        pf = param.float()
        g = grad.float() + wd_ * pf
        md_pow = c96 ** st
        beta2_pow = b2 ** st
        mu_t = b1 * (1.0 - 0.5 * md_pow ** psi)
        mu_t1 = b1 * (1.0 - 0.5 * md_pow ** psi * c96 ** psi)
        mu_prod = state["mu_product"] * mu_t
        mu_prod_t1 = mu_prod * mu_t1
        m = b1 * state["moment1"] + (1 - b1) * g
        v = b2 * state["moment2"] + (1 - b2) * g * g
        m_hat = mu_t1 * m / (1 - mu_prod_t1) + (1 - mu_t) * g / (1 - mu_prod)
        v_hat = v / (1 - beta2_pow)
        new_p = pf - lr_ * m_hat / (torch.sqrt(v_hat) + eps)
        return new_p.to(param.dtype), \
            {"moment1": m, "moment2": v, "mu_product": mu_prod}


class RAdam(Optimizer):
    """RAdam; rho_t is the closed form of the step count."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_state(self, param):
        z = torch.zeros(param.shape, dtype=torch.float32, device=param.device)
        return {"moment1": z, "moment2": z.clone()}

    def _update(self, param, grad, state, lr_val, wd, step):
        lr_, st = lr_val, step
        b1, b2, eps, wd_ = _consts(param, self._beta1, self._beta2,
                                   self._epsilon, wd)
        pf = param.float()
        g = grad.float() + wd_ * pf
        beta1_pow = b1 ** st
        beta2_pow = b2 ** st
        rho_inf = 2.0 / (1.0 - b2) - 1.0
        rho_t = rho_inf - 2.0 * st * beta2_pow / (1.0 - beta2_pow)
        m = b1 * state["moment1"] + (1 - b1) * g
        v = b2 * state["moment2"] + (1 - b2) * g * g
        m_hat = m / (1 - beta1_pow)
        l_t = torch.sqrt(1.0 - beta2_pow) / (torch.sqrt(v) + eps)
        r_t = torch.sqrt(((rho_t - 4.0) * (rho_t - 2.0) * rho_inf)
                         / ((rho_inf - 4.0) * (rho_inf - 2.0)
                            * torch.clamp(rho_t, min=4.5)))
        upd = torch.where(rho_t > 5.0, m_hat * r_t * l_t, m_hat)
        return (pf - lr_ * upd).to(param.dtype), {"moment1": m, "moment2": v}


class Rprop(Optimizer):
    """Rprop: a step size per element, grown or shrunk by the sign of
    successive gradients (full-batch training)."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._lr_min, self._lr_max = map(float, learning_rate_range)
        self._eta_neg, self._eta_pos = map(float, etas)

    def _init_state(self, param):
        return {"prev": torch.zeros(param.shape, dtype=torch.float32,
                                    device=param.device),
                "learning_rates": torch.full(param.shape,
                                             float(self.get_lr()),
                                             dtype=torch.float32,
                                             device=param.device)}

    def _update(self, param, grad, state, lr_val, wd, step):
        lo, hi, eta_neg, eta_pos, one, zero = _consts(
            param, self._lr_min, self._lr_max, self._eta_neg, self._eta_pos,
            1.0, 0.0)
        gf = grad.float()
        prod = gf * state["prev"]
        eta = torch.where(prod > 0, eta_pos, torch.where(prod < 0, eta_neg,
                                                         one))
        gf = torch.where(prod < 0, zero, gf)
        lrs = torch.minimum(torch.maximum(state["learning_rates"] * eta, lo),
                            hi)
        new_p = param.float() - torch.sign(gf) * lrs
        return new_p.to(param.dtype), {"prev": gf, "learning_rates": lrs}


class ASGD(Optimizer):
    """Averaged SGD over the last ``batch_num`` gradients, kept in a
    rotating history (written in place)."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        if not batch_num or batch_num <= 0:
            raise ValueError("batch_num should be greater than 0")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._n = int(batch_num)

    def _init_state(self, param):
        return {"d": torch.zeros(param.shape, dtype=torch.float32,
                                 device=param.device),
                "ys": torch.zeros((self._n,) + tuple(param.shape),
                                  dtype=torch.float32, device=param.device)}

    def _update(self, param, grad, state, lr_val, wd, step):
        # the history slot (step - 1) % n and min(step, n), on the device
        # from the update count (exact in float32 below 2**24)
        n, (wd_,) = self._n, _consts(param, wd)
        idx = torch.remainder(step - 1, n).long().reshape(1)
        n_eff = torch.clamp(step, max=float(n))
        pf = param.float()
        g = grad.float() + wd_ * pf
        ys = state["ys"]
        d = state["d"] - ys.index_select(0, idx)[0] + g
        ys.index_copy_(0, idx, g[None])
        return (pf - (lr_val / n_eff) * d).to(param.dtype), \
            {"d": d, "ys": ys}


from .lbfgs import LBFGS  # noqa: E402  (lbfgs imports nothing from here)
