"""Automatic mixed precision: ``auto_cast``, ``decorate``, ``GradScaler``.

Mirrors ``paddle_tpu/amp/__init__.py``. The JAX package casts at its op
dispatch: every op it dispatches has a name, and under ``auto_cast`` an
op on the white list takes float32 inputs in the low dtype, one on the
black list takes low-dtype inputs in float32, and at level "O2" every op
off the black list takes float32 inputs in the low dtype
(``_maybe_cast``). The port has no dispatch layer, so the cast happens at
two places above autograd (so the backward sees each cast and carries the
gradient back to the float32 parameter):

- a ``torch.overrides.TorchFunctionMode``, pushed by ``auto_cast``, that
  names the torch calls the port's models make after the JAX op they
  stand for (``x @ w`` is "matmul", ``+`` "add", ``torch.softmax``
  "softmax", ...: ``_TORCH_OPS``) and casts their inputs;
- ``op(name)``, which marks a function of the port as the JAX op ``name``
  (``nn.functional.rms_norm`` is "rms_norm", the flash entry
  "flash_attention", the model's chunked loss "chunked_causal_ce", ...).

The calls an op makes inside itself are not ops (a JAX op's body is raw
jnp), so neither place casts them. ``torch.autocast`` and a dispatch mode
are not ports of this: their lists are not the JAX package's, and a
dispatch mode sits below autograd. ``amp.debugging`` counts and checks ops
by the same names, through the same places.

``GradScaler`` implements dynamic loss scaling; ``unscale_`` checks every
gradient for inf/nan with one device reduction and one host read.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch
from torch.overrides import TorchFunctionMode

# Ops cast to the low dtype under auto_cast (the JAX package's white list).
WHITE_LIST = {"matmul", "linear", "conv1d", "conv2d", "conv3d", "bmm", "mm",
              "mv", "einsum", "flash_attention", "sdpa", "addmm",
              "sp_overlap_column", "sp_overlap_row"}
# Ops kept in float32 (its black list).
BLACK_LIST = {"exp", "log", "log2", "log10", "mean", "sum", "softmax",
              "log_softmax", "cross_entropy", "layer_norm", "batch_norm",
              "group_norm", "instance_norm", "rms_norm", "norm", "cumsum",
              "logsumexp", "erfinv", "pow"}

# the JAX op each torch call of the port's models stands for, by the
# callable's __name__ (a TorchFunctionMode sees ``x @ w`` as Tensor.matmul,
# ``x + y`` as Tensor.add, F.linear as torch._C._nn.linear)
_TORCH_OPS = {
    "matmul": "matmul", "__matmul__": "matmul", "__rmatmul__": "matmul",
    "linear": "linear", "bmm": "bmm", "mm": "mm", "mv": "mv",
    "einsum": "einsum", "addmm": "addmm", "conv1d": "conv1d",
    "conv2d": "conv2d", "conv3d": "conv3d",
    "softmax": "softmax", "log_softmax": "log_softmax", "sum": "sum",
    "mean": "mean", "exp": "exp", "log": "log", "log2": "log2",
    "log10": "log10", "cumsum": "cumsum", "logsumexp": "logsumexp",
    "pow": "pow", "__pow__": "pow", "norm": "norm", "erfinv": "erfinv",
    "cross_entropy": "cross_entropy", "layer_norm": "layer_norm",
    "batch_norm": "batch_norm", "group_norm": "group_norm",
    "instance_norm": "instance_norm", "rms_norm": "rms_norm",
    "add": "add", "__add__": "add", "__radd__": "add",
    "sub": "subtract", "__sub__": "subtract", "__rsub__": "subtract",
    "mul": "multiply", "__mul__": "multiply", "__rmul__": "multiply",
    "div": "divide", "__truediv__": "divide", "__rtruediv__": "divide",
    "silu": "silu", "gelu": "gelu", "relu": "relu", "tanh": "tanh",
    "sigmoid": "sigmoid", "embedding": "embedding", "reshape": "reshape",
    "view": "reshape", "repeat_interleave": "repeat_interleave",
    "transpose": "transpose", "cat": "concat", "stack": "stack",
    "flatten": "flatten",
}

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()
        self.depth = 0          # > 0 inside an op: its calls are not ops
        self.modes = 0          # _OpMode instances pushed in this thread
        self.observers = []     # f(name, tensors) on every op (debugging)
        self.checker = None     # f(name, outputs) after every op (debugging)


amp_state = _AmpState()


def cast_dtype(op_name, dtype):
    """The dtype a tensor of ``dtype`` has as an input of the op
    ``op_name`` under the current ``auto_cast``: ``_maybe_cast`` without
    the cast (a kernel that computes in fp32 anyway reads the input as it
    is and writes the dtype the casts would give)."""
    if not amp_state.enabled:
        return dtype
    white = (WHITE_LIST | amp_state.custom_white) - amp_state.custom_black
    black = BLACK_LIST | amp_state.custom_black
    low = amp_state.dtype
    if op_name in white or (amp_state.level == "O2" and op_name not in black):
        return low if dtype == torch.float32 else dtype
    if op_name in black:
        return torch.float32 if dtype == low else dtype
    return dtype


def _maybe_cast(op_name, tensors):
    """``tensors`` as the op ``op_name`` takes them under the current
    ``auto_cast`` (the JAX package's ``_maybe_cast``)."""
    if not amp_state.enabled:
        return tuple(tensors)

    def one(t):
        if not isinstance(t, torch.Tensor):
            return t
        dt = cast_dtype(op_name, t.dtype)
        return t if dt == t.dtype else t.to(dt)
    return tuple(one(t) for t in tensors)


def _cast_args(name, args, kwargs, n):
    """args and kwargs with their tensors cast for the op ``name``: the
    first ``n`` positional arguments (every argument when None), tensors
    in lists and tuples included."""
    def one(a):
        if isinstance(a, torch.Tensor):
            return _maybe_cast(name, (a,))[0]
        if isinstance(a, (list, tuple)) and any(
                isinstance(x, torch.Tensor) for x in a):
            return type(a)(_maybe_cast(name, a))
        return a
    k = len(args) if n is None else n
    args = tuple(one(a) for a in args[:k]) + tuple(args[k:])
    if n is None:
        kwargs = {key: one(v) for key, v in kwargs.items()}
    return args, kwargs


def _tensors(args, kwargs):
    out = []
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


def _run_op(name, fn, args, kwargs, n=None):
    """Run ``fn`` as the op ``name``: observed, its inputs cast, its body
    not an op, its outputs checked."""
    for observe in amp_state.observers:
        observe(name, _tensors(args, kwargs))
    if amp_state.enabled:
        args, kwargs = _cast_args(name, args, kwargs, n)
    amp_state.depth += 1
    try:
        out = fn(*args, **kwargs)
    finally:
        amp_state.depth -= 1
    if amp_state.checker is not None:
        amp_state.checker(name, out)
    return out


def _active():
    return amp_state.enabled or amp_state.observers \
        or amp_state.checker is not None


class FusedOps:
    """How ``amp`` sees one kernel that does the work of several ops one
    after the other: call ``op`` (or ``cast``) for each of those ops in
    order, then ``run`` the kernel. Outside any op and with amp active,
    each observer sees every op, each op takes its inputs in the dtypes
    its casts give (the kernel reads them as they are: their fp32 casts
    are exact) and the checker sees the kernel's output as the last op's;
    the kernel's own calls are not ops."""

    def __init__(self):
        self.active = not amp_state.depth and _active()
        self.last = None

    def op(self, name, inputs):
        """The dtypes in which the op ``name`` takes ``inputs`` (tensors,
        or meta tensors standing for an earlier op's output), after the
        observers have seen them."""
        if not self.active:
            return tuple(t.dtype for t in inputs)
        for observe in amp_state.observers:
            observe(name, list(inputs))
        self.last = name
        return tuple(cast_dtype(name, t.dtype) for t in inputs)

    def cast(self, name, dtype):
        """The dtype in which the op ``name``, which observes itself, takes
        an input of ``dtype``."""
        return cast_dtype(name, dtype) if self.active else dtype

    def run(self, launch):
        """``launch()``, its calls not ops, its output checked."""
        amp_state.depth += 1
        try:
            out = launch()
        finally:
            amp_state.depth -= 1
        if self.active and amp_state.checker is not None:
            amp_state.checker(self.last, out)
        return out


class _OpMode(TorchFunctionMode):
    """Runs each torch call named in ``_TORCH_OPS``, made outside any op,
    as that op."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _TORCH_OPS.get(getattr(func, "__name__", None))
        if name is None or amp_state.depth or not _active():
            return func(*args, **kwargs)
        return _run_op(name, func, args, kwargs)


def op(name, n=None):
    """Mark a function of the port as the JAX op ``name``: under
    ``auto_cast`` its first ``n`` positional tensor arguments (all of its
    tensor arguments when None) are cast as the op's, and the calls it
    makes are not ops."""
    def wrap(fn):
        @functools.wraps(fn)
        def as_op(*args, **kwargs):
            if amp_state.depth or not _active():
                return fn(*args, **kwargs)
            return _run_op(name, fn, args, kwargs, n)
        return as_op
    return wrap


@contextlib.contextmanager
def _op_mode():
    """Push the ``_OpMode`` in this thread unless it is there already."""
    if amp_state.modes:
        yield
        return
    amp_state.modes += 1
    try:
        with _OpMode():
            yield
    finally:
        amp_state.modes -= 1


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """Cast the inputs of the ops run inside, as ``paddle.amp.auto_cast``:
    level "O1" casts the white list's float32 inputs to ``dtype`` and the
    black list's ``dtype`` inputs to float32; "O2" casts every op's
    float32 inputs to ``dtype`` but the black list's."""
    prev = current_state(), amp_state.depth
    amp_state.enabled = bool(enable)
    amp_state.dtype = _DTYPES[dtype] if isinstance(dtype, str) else dtype
    amp_state.level = level
    amp_state.custom_white = set(custom_white_list or ())
    amp_state.custom_black = set(custom_black_list or ())
    amp_state.depth = 0
    try:
        with _op_mode():
            yield
    finally:
        _set_state(prev[0])
        amp_state.depth = prev[1]


amp_guard = auto_cast


def current_state():
    """The ``auto_cast`` settings in force (None when off): what a remat'd
    layer's recompute needs to cast as its forward did."""
    if not amp_state.enabled:
        return None
    return (amp_state.dtype, amp_state.level,
            frozenset(amp_state.custom_white),
            frozenset(amp_state.custom_black))


def _set_state(state):
    amp_state.enabled = state is not None
    if state is not None:
        (amp_state.dtype, amp_state.level, white, black) = state
        amp_state.custom_white, amp_state.custom_black = set(white), \
            set(black)


@contextlib.contextmanager
def restored_state(state):
    """Run under the settings ``current_state()`` returned, outside any op
    (the recompute of a layer runs in the backward, where neither the
    thread's settings nor its mode need be the forward's)."""
    if state is None and not amp_state.enabled:
        yield
        return
    with auto_cast(enable=state is not None,
                   **({} if state is None else dict(
                       dtype=state[0], level=state[1],
                       custom_white_list=state[2],
                       custom_black_list=state[3]))):
        yield


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """As ``paddle.amp.decorate``: at level "O2" the models' parameters are
    cast to ``dtype``; the optimizers are returned as they are (no fp32
    master weights, as in the JAX package)."""
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        dt = _DTYPES[dtype] if isinstance(dtype, str) else dtype
        for m in model_list:
            m.to(dtype=dt)
    if optimizers is None:
        return models if single_model else model_list
    return (models if single_model else model_list), optimizers


class GradScaler:
    """Dynamic loss scaling, as ``paddle_tpu.amp.GradScaler``: the loss is
    multiplied by the scale; ``unscale_`` divides the gradients by it and
    notes whether any is inf or nan; ``step`` skips the update then, and
    ``update`` halves the scale after ``decr_every_n_nan_or_inf`` bad steps
    (never below 1) or multiplies it by ``incr_ratio`` after
    ``incr_every_n_steps`` good ones."""

    def __init__(self, enable=True, init_loss_scaling=65536.0,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled_opts = set()

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Multiply every gradient by 1 / scale (once a step, however often
        called) and note whether one holds an inf or a nan: one reduction
        over all of them, read once."""
        if not self._enable or id(optimizer) in self._unscaled_opts:
            return
        self._unscaled_opts.add(id(optimizer))
        inv = 1.0 / self._scale
        flags = []
        for p in optimizer._parameter_list:
            if p.grad is not None:
                # the JAX weak-typed product: 1/scale in the grad's dtype
                p.grad = p.grad * torch.tensor(inv, dtype=p.grad.dtype,
                                               device=p.grad.device)
                flags.append(torch.isfinite(p.grad).all())
        self._found_inf = bool(flags) and not bool(torch.stack(flags).all())

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._unscaled_opts.discard(id(optimizer))
        self.update()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)

    def update(self):
        if not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state["scale"]
        self._good_steps = state["good_steps"]
        self._bad_steps = state["bad_steps"]


def is_float16_supported(device=None):
    return True


def is_bfloat16_supported(device=None):
    return True


from . import debugging  # noqa: E402,F401  (debugging reads amp_state)

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler", "op",
           "cast_dtype", "FusedOps",
           "WHITE_LIST", "BLACK_LIST", "is_float16_supported",
           "is_bfloat16_supported", "debugging"]
