"""Numerical debugging: ``check_numerics``, operator statistics, the
tensor checker, ``check_layer_numerics`` and ``compare_accuracy``.

Mirrors ``paddle_tpu/amp/debugging.py``. The JAX package counts and checks
ops at its dispatch; the port counts and checks the same op names where
``amp`` casts them (its ``TorchFunctionMode`` and the functions marked
with ``amp.op``), so a count reads ``"matmul(float32)"`` in both packages
for the same call of the same model.
"""
from __future__ import annotations

import contextlib
import csv
import functools
import os
from enum import Enum

import numpy as np
import torch

from . import _op_mode, amp_state


class DebugMode(Enum):
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL_FOR_OVERFLOW = 2
    CHECK_ALL = 3
    CHECK_ALL_AND_ABORT = 4
    DUMP_ALL = 5


class TensorCheckerConfig:
    def __init__(self, enable=True,
                 debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir=None, checked_op_list=None,
                 skipped_op_list=None, debug_step=None, stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = checked_op_list
        self.skipped_op_list = skipped_op_list
        self.debug_step = debug_step
        self.stack_height_limit = stack_height_limit


def check_numerics(tensor, op_type="", var_name="", debug_mode=None):
    """(nan count, inf count, zero count) of ``tensor`` as int64 tensors;
    raises FloatingPointError on a nan or an inf when the mode aborts
    (None, CHECK_NAN_INF_AND_ABORT, CHECK_ALL_AND_ABORT)."""
    a = torch.as_tensor(tensor).detach().float()
    n_nan = int(torch.isnan(a).sum())
    n_inf = int(torch.isinf(a).sum())
    n_zero = int((a == 0).sum())
    if debug_mode in (None, DebugMode.CHECK_NAN_INF_AND_ABORT,
                      DebugMode.CHECK_ALL_AND_ABORT) and (n_nan or n_inf):
        raise FloatingPointError(
            f"check_numerics: {op_type}:{var_name} has {n_nan} nan / "
            f"{n_inf} inf values")
    return tuple(torch.tensor(v, dtype=torch.int64)
                 for v in (n_nan, n_inf, n_zero))


# the hooks turned on by the enable_* functions, each with the op mode it
# pushed
_stats = [None]
_checker = [None]


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def enable_operator_stats_collection():
    """Count every op from here on by name and first input's dtype."""
    if _stats[0] is not None:
        return
    stats = {}

    def count(name, tensors):
        key = f"{name}({_dtype_name(tensors[0]) if tensors else None})"
        stats[key] = stats.get(key, 0) + 1

    mode = contextlib.ExitStack()
    mode.enter_context(_op_mode())
    amp_state.observers.append(count)
    _stats[0] = (stats, count, mode)


def disable_operator_stats_collection():
    """Stop counting; print and return the counts."""
    if _stats[0] is None:
        return None
    stats, count, mode = _stats[0]
    _stats[0] = None
    amp_state.observers.remove(count)
    mode.close()
    print("<------------------- op list ------------------->")
    for k in sorted(stats):
        print(f"  {k}: {stats[k]} calls")
    print("<----------------------------------------------->")
    return stats


@contextlib.contextmanager
def collect_operator_stats():
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()


def _nan_check(name, out):
    outs = out if isinstance(out, (tuple, list)) else (out,)
    for t in outs:
        if isinstance(t, torch.Tensor) and t.is_floating_point() \
                and not bool(torch.isfinite(t).all()):
            raise FloatingPointError(
                f"NaN/Inf detected in output of op '{name}'")


def enable_tensor_checker(checker_config: TensorCheckerConfig):
    """Check every op's output for nan and inf from here on, raising
    FloatingPointError at the first (the JAX package's
    ``FLAGS_check_nan_inf``)."""
    disable_tensor_checker()
    if checker_config.enable:
        mode = contextlib.ExitStack()
        mode.enter_context(_op_mode())
        amp_state.checker = _nan_check
        _checker[0] = mode


def disable_tensor_checker():
    if _checker[0] is not None:
        amp_state.checker = None
        _checker[0].close()
        _checker[0] = None


def compare_accuracy(dump_path, another_dump_path, output_filename,
                     loss_scale=1, dump_all_tensors=False):
    """Diff the ``.npy`` dumps two directories share into a CSV report
    (tensor, status, max and mean absolute difference); returns the
    rows."""
    rows = []
    names = sorted(set(os.listdir(dump_path))
                   & set(os.listdir(another_dump_path)))
    for n in names:
        if not n.endswith(".npy"):
            continue
        a = np.load(os.path.join(dump_path, n))
        b = np.load(os.path.join(another_dump_path, n))
        if a.shape != b.shape:
            rows.append([n, "shape mismatch", a.shape, b.shape])
            continue
        d = np.abs(a.astype(np.float64) - b.astype(np.float64))
        rows.append([n, "ok", float(d.max()), float(d.mean())])
    with open(output_filename, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["tensor", "status", "max_abs_diff", "mean_abs_diff"])
        w.writerows(rows)
    return rows


def check_layer_numerics(func):
    """Decorator of a layer's forward: ``check_numerics`` on its tensor
    inputs and its output."""
    @functools.wraps(func)
    def wrapper(self, *args, **kwargs):
        for i, a in enumerate(args):
            if isinstance(a, torch.Tensor):
                check_numerics(a, type(self).__name__, f"input{i}")
        out = func(self, *args, **kwargs)
        if isinstance(out, torch.Tensor):
            check_numerics(out, type(self).__name__, "output")
        return out
    return wrapper


__all__ = ["DebugMode", "TensorCheckerConfig", "check_numerics",
           "enable_operator_stats_collection",
           "disable_operator_stats_collection", "collect_operator_stats",
           "enable_tensor_checker", "disable_tensor_checker",
           "compare_accuracy", "check_layer_numerics"]
