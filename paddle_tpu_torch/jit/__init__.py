"""paddle_tpu_torch.jit: export a module's forward into an artifact and
load it back (``InputSpec``, ``save``, ``TranslatedLayer``, ``load``).

Mirrors ``paddle_tpu/jit/__init__.py``'s export path. The JAX package
serializes a StableHLO program of the pure function ``(state arrays,
*inputs) -> outputs``; here the same pure function, built with
``torch.func.functional_call``, goes through ``torch.export``. The
artifact keeps the JAX package's three file names, in the port's own
formats:

  * ``path.pdmodel``: the ``torch.export`` archive. The state enters as
    arguments, so the weights are on disk once, in
  * ``path.pdiparams``: the state (parameters and buffers) in
    ``framework/io.py``'s format;
  * ``path.meta.json``: ``param_names``, ``inputs`` and ``out_spec``, the
    keys the JAX package writes.

The port's kernels enter the program as ``torch.library`` ops
(``kernels/fused.py``, ``kernels/flash_attention.py``) whose CPU
implementation is the plain version and whose CUDA implementation
launches the kernel: an artifact saved on the CPU runs the kernels when
it is loaded on the card, as the JAX package exports for cpu and tpu at
once. Not ported: ``to_static`` and its AST transform (ROADMAP.md), and
the weight-only GEMM (the models' forward never runs quantized weights,
and ``save`` refuses a state that holds them).
"""
from __future__ import annotations

import json
import os
from typing import List

import numpy as np
import torch

from .. import resolve_device
from ..framework import io as _io
from ..kernels import fused as _fused  # noqa: F401  (registers the ops)
from ..kernels import flash_attention as _fa  # noqa: F401
from ..nn.layer.layers import Layer

_QUANT_DTYPES = (torch.int8, torch.uint8, torch.float8_e4m3fn)
_DIM_MAX = 1 << 20      # the bound of a symbolic dim that nothing else bounds


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _torch_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name).replace("torch.", ""), None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"unknown dtype {name!r}")
    return dt


class InputSpec:
    """Parity: paddle.static.InputSpec. A dim of None or -1 is symbolic
    (the artifact takes any size there); a string dim names a symbol that
    every dim of that name shares."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = list(shape)
        self.dtype = _dtype_name(dtype)
        self.name = name

    @staticmethod
    def from_tensor(t, name=None):
        return InputSpec(list(t.shape), _dtype_name(t.dtype), name)

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")


def _state(module):
    """{name: tensor} of the module's parameters and buffers (the
    non-persistent ones too: the forward reads them)."""
    st = {n: p.detach() for n, p in module.named_parameters()}
    st.update((n, b.detach()) for n, b in module.named_buffers())
    return st


def _spec_of(spec):
    """The JAX package's out_spec of a pytree ``TreeSpec``: ("t", i) per
    tensor, ("seq", type, [...]) and ("dict", keys, [...])."""
    counter = iter(range(spec.num_leaves))

    def walk(node):
        if node.is_leaf():
            return ("t", next(counter))
        kids = [walk(c) for c in node.children_specs]
        if node.type in (list, tuple):
            return ("seq", node.type.__name__, kids)
        if node.type is dict:
            return ("dict", list(node.context), kids)
        raise TypeError(f"jit.save: an output of type {node.type} is not "
                        f"a tensor, list, tuple or dict")
    return walk(spec)


class _Pure(torch.nn.Module):
    """``(state list, *inputs) -> outputs``: the module's forward with its
    state swapped in through ``functional_call``. The module is held
    outside the registered submodules, so the export lifts no weights of
    its own: the state enters only as arguments."""

    def __init__(self, module, names):
        super().__init__()
        self.__dict__["_target"] = module
        self._names = names

    def forward(self, state, *inputs):
        return torch.func.functional_call(
            self._target, dict(zip(self._names, state)), inputs)


def _symbol(i, j, d):
    """The symbol's name of dim ``j`` of input ``i`` (None if concrete):
    None and -1 get one of their own, a string names a shared one."""
    if isinstance(d, str):
        return d
    return f"d{i}_{j}" if d is None or d == -1 else None


def _dims(module, specs):
    """Each spec's dynamic_shapes entry and example shape. A symbolic dim
    past the first (a sequence) is bounded by the module's
    ``config.max_position_embeddings`` where it has one: the forward
    slices its position tables to it."""
    cap = getattr(getattr(module, "config", None),
                  "max_position_embeddings", None)
    bounds = {}
    for i, s in enumerate(specs):
        for j, d in enumerate(s.shape):
            key = _symbol(i, j, d)
            if key is not None:
                top = int(cap) if (cap and j > 0) else _DIM_MAX
                bounds[key] = min(bounds.get(key, _DIM_MAX), top)
    symbols = {k: torch.export.Dim(k, min=1, max=v) for k, v in bounds.items()}
    dyn, shapes = [], []
    for i, s in enumerate(specs):
        entry, shape = {}, []
        for j, d in enumerate(s.shape):
            key = _symbol(i, j, d)
            if key is None:
                shape.append(int(d))
            else:
                entry[j] = symbols[key]
                shape.append(min(2, bounds[key]))
        dyn.append(entry or None)
        shapes.append(shape)
    return dyn, shapes


def save(module, path, input_spec=None):
    """Parity: paddle.jit.save. Exports ``module``'s forward, in eval mode
    under ``no_grad`` (the training flag is restored), as the pure
    function of its state and inputs, and writes ``path.pdmodel``,
    ``path.pdiparams`` and ``path.meta.json``. ``input_spec``: a list of
    ``InputSpec`` (None / -1 / a shared name for a symbolic dim) or of
    example tensors; required."""
    if not isinstance(module, torch.nn.Module):
        raise TypeError("jit.save expects a torch.nn.Module")
    if input_spec is None:
        raise ValueError("jit.save requires input_spec (InputSpec list or "
                         "example tensors) to trace the export")
    specs = [s if isinstance(s, InputSpec) else InputSpec.from_tensor(s)
             for s in input_spec]
    state = _state(module)
    quant = [n for n, t in state.items() if t.dtype in _QUANT_DTYPES]
    if quant:
        raise NotImplementedError(
            f"jit.save: the state holds quantized weights ({quant[:4]}); "
            f"the weight-only GEMM is not exported")
    names = list(state)
    device = next(iter(state.values())).device if state \
        else torch.device("cpu")
    dyn, shapes = _dims(module, specs)
    examples = [torch.zeros(shape, dtype=_torch_dtype(s.dtype),
                            device=device)
                for s, shape in zip(specs, shapes)]
    pure = _Pure(module, names)
    was_training = module.training
    module.eval()
    try:
        with torch.no_grad():
            program = torch.export.export(
                pure, ([state[n] for n in names], *examples),
                dynamic_shapes=([None] * len(names), tuple(dyn)))
    finally:
        module.train(was_training)
    program.example_inputs = None      # the state: written once, below
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path + ".pdmodel", "wb") as f:
        torch.export.save(program, f)
    _io.save(state, path + ".pdiparams")
    meta = {"param_names": names,
            "inputs": [{"shape": s.shape, "dtype": s.dtype,
                        "name": s.name or f"input_{i}"}
                       for i, s in enumerate(specs)],
            "out_spec": _spec_of(program.call_spec.out_spec),
            "device": device.type}
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)


class TranslatedLayer(Layer):
    """Parity: paddle.jit.TranslatedLayer: a loaded artifact, its program
    and its state on one device; ``forward`` runs the program. An
    ``nn.Layer`` as the JAX class is, with its own ``state_dict`` (the
    program's state, by name), which the ``Layer`` methods read: so
    ``set_state_dict`` copies into that state in place."""

    def __init__(self, program, state, param_names, meta, device):
        super().__init__(device=device)
        self._program = program
        self._run = program.module()     # outputs in the forward's structure
        self._state = state
        self._param_names = list(param_names)
        self._meta = meta
        self.device = device

    def forward(self, *inputs):
        args = [x.to(self.device) if isinstance(x, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
                for x in inputs]
        with torch.no_grad():
            return self._run([self._state[n] for n in self._param_names],
                             *args)

    def state_dict(self, *args, **kwargs):
        return dict(self._state)

    def input_names(self) -> List[str]:
        return [i["name"] for i in self._meta["inputs"]]

    def input_specs(self):
        return self._meta["inputs"]


def load(path, device=None) -> TranslatedLayer:
    """Parity: paddle.jit.load. The artifact at ``path`` with its program
    and state on ``device`` (None means the GPU; raises without one),
    wherever it was saved."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with open(path + ".pdmodel", "rb") as f:
        program = torch.export.load(f)
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    if meta.get("device", "cpu") != dev.type:
        from torch.export.passes import move_to_device_pass
        program = move_to_device_pass(program, dev)
    state = {n: t.to(dev) for n, t in
             _io.load(path + ".pdiparams").items()}
    missing = [n for n in meta["param_names"] if n not in state]
    if missing:
        raise KeyError(f"{path}.pdiparams lacks {missing[:8]}")
    return TranslatedLayer(program, state, meta["param_names"], meta, dev)


__all__ = ["InputSpec", "save", "load", "TranslatedLayer"]
