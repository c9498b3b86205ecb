"""``Layer``, the base of every layer of the port, and the containers
(``paddle_tpu/nn/layer/layers.py:23-553``), and what the layers of
``nn/layer`` share: where a parameter is made and how its attribute is
read.

``Layer`` is an ``nn.Module`` that also answers to the JAX ``Layer``'s
names: ``add_sublayer``, ``add_parameter``, ``register_buffer(...,
persistable=)``, ``create_parameter`` (through ``make_parameter``, so a
``ParamAttr`` and the global initializers apply), ``create_tensor``,
``named_sublayers`` / ``sublayers``, ``parameters`` and ``buffers``
(lists, ``include_sublayers=``), ``state_dict``
(``structured_name_prefix=``; parameters first, then persistable buffers,
by the structured names JAX's ``named_state()`` gives the same tree; like
the JAX one it reads no ``include_sublayers``),
``set_state_dict`` (copies in place; returns the missing and unexpected
names), ``named_state``, ``swap_state``, ``to(device=, dtype=)``,
``astype``, and forward hooks that return a ``HookRemoveHelper``.
PyTorch's own forms of these calls keep working (``state_dict(prefix=,
keep_vars=)``, ``named_parameters(recurse=)``, ``register_buffer(...,
persistent=)``), so the module machinery (export, hooks, autograd) sees a
plain module. ``state_dict`` returns detached tensors that share the
parameters' storage (PyTorch's ``keep_vars=False``), where JAX returns the
``Tensor`` objects themselves.
"""
from __future__ import annotations

import contextlib
from collections import OrderedDict

import numpy as np
import torch
from torch import nn
from torch.utils.hooks import RemovableHandle

from ... import resolve_device
from ..initializer import (Constant, XavierUniform, _dt, _resolve_attr,
                           set_param_attr)

_dygraph_mode = [True]


def in_dynamic_mode():
    return _dygraph_mode[0]


def enable_static():
    _dygraph_mode[0] = False


def disable_static():
    _dygraph_mode[0] = True


# What a forward hook's registration returns: ``remove()`` takes the hook
# out (PyTorch's handle, under the JAX package's name).
HookRemoveHelper = RemovableHandle


def _as_dtype(dtype):
    return None if dtype is None else _dt(dtype)


class Layer(nn.Module):
    """The JAX ``Layer`` as an ``nn.Module``. ``device`` (the port's own
    argument; None = the GPU, as every entry point) is where
    ``create_parameter`` and ``create_tensor`` put what they make."""

    def __init__(self, name_scope=None, dtype=None, *, device=None):
        super().__init__()
        self._dtype = _as_dtype(dtype) or torch.float32
        self._name_scope = name_scope or type(self).__name__.lower()
        self._device = device

    # -- building -------------------------------------------------------------
    def add_sublayer(self, name, sublayer):
        self.__dict__.pop(str(name), None)
        self.add_module(str(name), sublayer)
        return sublayer

    def add_parameter(self, name, parameter):
        self.__dict__.pop(str(name), None)
        self.register_parameter(str(name), parameter)
        return parameter

    def register_buffer(self, name, tensor, persistable=True, *,
                        persistent=None):
        if persistent is not None:
            persistable = persistent
        self.__dict__.pop(str(name), None)
        super().register_buffer(str(name), tensor, persistent=persistable)

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, *, device=None):
        """A parameter of ``shape`` (not yet registered: assign it or
        ``add_parameter`` it), its values from ``attr``'s initializer,
        else the global one, else ``default_initializer``, else zeros for
        a bias and Xavier-uniform for a weight, drawn from
        ``framework.random``."""
        if attr is False:
            raise ValueError("attr=False means no parameter; caller must "
                             "handle it")
        dev, dt = placement(self._device if device is None else device,
                            _as_dtype(dtype) or self._dtype)
        init = default_initializer or (Constant(0.0) if is_bias
                                       else XavierUniform())
        shape = tuple(int(s) for s in shape)
        return make_parameter(shape, attr, dev, dt,
                              lambda t: t.copy_(init(shape, dt, dev)),
                              is_bias)

    def create_tensor(self, name=None, dtype=None, persistable=False, *,
                      device=None):
        dev, dt = placement(self._device if device is None else device,
                            _as_dtype(dtype) or self._dtype)
        t = torch.zeros((), dtype=dt, device=dev)
        t.persistable = persistable
        return t

    # -- walking the tree -----------------------------------------------------
    def named_sublayers(self, prefix="", include_self=False, layers_set=None):
        if layers_set is None:
            layers_set = set()
        if id(self) in layers_set:
            return
        layers_set.add(id(self))
        if include_self:
            yield prefix, self
        for name, layer in self._modules.items():
            if layer is None:
                continue
            p = prefix + ("." if prefix else "") + name
            if isinstance(layer, Layer):
                yield from layer.named_sublayers(p, True, layers_set)
            else:
                for q, m in layer.named_modules(prefix=p):
                    if id(m) not in layers_set:
                        layers_set.add(id(m))
                        yield q, m

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_parameters(self, prefix="", include_sublayers=True,
                         remove_duplicate=True, *, recurse=None):
        return super().named_parameters(
            prefix=prefix, recurse=include_sublayers if recurse is None
            else recurse, remove_duplicate=remove_duplicate)

    def parameters(self, include_sublayers=True, *, recurse=None):
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers, recurse=recurse)]

    def named_buffers(self, prefix="", include_sublayers=True,
                      remove_duplicate=True, *, recurse=None):
        return super().named_buffers(
            prefix=prefix, recurse=include_sublayers if recurse is None
            else recurse, remove_duplicate=remove_duplicate)

    def buffers(self, include_sublayers=True, *, recurse=None):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers, recurse=recurse)]

    # -- state ----------------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *, prefix="",
                   keep_vars=False):
        if destination is not None or prefix:
            # PyTorch's recursion from a parent module
            return super().state_dict(destination=destination, prefix=prefix,
                                      keep_vars=keep_vars)
        # the JAX names join the prefix with a dot, as named_parameters does
        prefix = structured_name_prefix + "." if structured_name_prefix \
            else ""
        flat = super().state_dict(prefix=prefix, keep_vars=keep_vars)
        params = {k for k, _ in self.named_parameters(structured_name_prefix)}
        out = OrderedDict((k, v) for k, v in flat.items() if k in params)
        out.update((k, v) for k, v in flat.items() if k not in params)
        return out

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``state_dict``'s values (tensors or arrays) into the
        parameters and persistable buffers of the same names, in place;
        returns (missing, unexpected) names."""
        own = self.state_dict(keep_vars=True)
        missing = [k for k in own if k not in state_dict]
        unexpected = [k for k in state_dict if k not in own]
        with torch.no_grad():
            for name, target in own.items():
                if name not in state_dict:
                    continue
                value = state_dict[name]
                if not torch.is_tensor(value):
                    value = torch.from_numpy(np.asarray(value))
                if tuple(value.shape) != tuple(target.shape):
                    raise ValueError(f"{name}: shape {tuple(value.shape)}, "
                                     f"the layer has {tuple(target.shape)}")
                target.copy_(value)
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    def named_state(self):
        """Every parameter and buffer (persistable or not), by structured
        name: parameters first."""
        out = OrderedDict(self.named_parameters())
        out.update(self.named_buffers())
        return out

    @contextlib.contextmanager
    def swap_state(self, arrays):
        """Run with the named parameters and buffers holding ``arrays``
        (tensors of their shapes) in place of their values."""
        state = self.named_state()
        saved = {}
        try:
            for name, arr in arrays.items():
                saved[name] = state[name].data
                state[name].data = arr
            yield
        finally:
            for name, old in saved.items():
                state[name].data = old

    # -- modes, placement -----------------------------------------------------
    def to(self, *args, device=None, dtype=None, blocking=None, **kwargs):
        """PyTorch's ``to`` in any of its forms, positional and keyword
        mixed; ``dtype`` may be a name, and ``blocking`` (JAX's) is
        ignored. A floating dtype becomes every sublayer's ``_dtype``."""
        if device is not None:
            kwargs["device"] = device
        if dtype is not None:
            kwargs["dtype"] = _as_dtype(dtype)
        if not args and not kwargs:
            return self
        dtype = torch._C._nn._parse_to(*args, **kwargs)[1]
        moved = super().to(*args, **kwargs)
        if dtype is not None:
            for m in self.modules():
                if isinstance(m, Layer):
                    m._dtype = dtype
        return moved

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype=torch.float32)

    def half(self):
        return self.to(dtype=torch.float16)

    def bfloat16(self):
        return self.to(dtype=torch.bfloat16)

    # -- hooks ----------------------------------------------------------------
    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)`` after each forward; a value it
        returns replaces the outputs."""
        return self.register_forward_hook(hook)


class LayerList(Layer, nn.ModuleList):
    """Sublayers held in order and named "0", "1", ...: the JAX
    ``LayerList``'s indexing, slicing, ``append``, ``insert``,
    ``extend`` and iteration are ``nn.ModuleList``'s."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.extend(sublayers)


class Sequential(Layer, nn.Sequential):
    """Sublayers run in order, named "0", "1", ... (or the names of
    ``(name, layer)`` pairs, given one by one or as one list), as the JAX
    ``Sequential`` names them, so parameter names match. A slice is a new
    ``Sequential`` of those layers, named from "0" again."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) \
                and len(layers[0]) and isinstance(layers[0][0],
                                                  (list, tuple)):
            layers = tuple(layers[0])
        for i, layer in enumerate(layers):
            if isinstance(layer, tuple):
                self.add_module(layer[0], layer[1])
            else:
                self.add_module(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return super().__getitem__(idx)


class LayerDict(Layer, nn.ModuleDict):
    """Sublayers by name (``nn.ModuleDict``'s mapping methods: the JAX
    ``LayerDict``'s ``[]``, ``del``, ``in``, ``keys``, ``values``,
    ``items``, ``pop``, ``clear``, ``update``)."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)


class ParameterList(Layer, nn.ParameterList):
    """Parameters held in order and named "0", "1", ..."""

    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for p in parameters:
                self.append(p)


class ParameterDict(Layer, nn.ParameterDict):
    """Parameters by name."""

    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            self.update(parameters)


def placement(device, dtype):
    """(device, dtype) of a layer's parameters: None = the GPU (raises
    without one) and float32."""
    return resolve_device(device), dtype or torch.float32


def make_parameter(shape, attr, device, dtype, init, is_bias=False):
    """A parameter of ``shape`` carrying ``attr``'s name and learning rate
    (a ``ParamAttr``, a name or an ``Initializer``); None where ``attr`` is
    False. Its values come from the attribute's initializer, else the
    global one of weights or biases (``is_bias``;
    ``initializer.set_global_initializer``), else ``init(tensor)`` (under
    no_grad), the layer's own: the JAX ``create_parameter``'s order."""
    if attr is False:
        return None
    chosen = _resolve_attr(attr, None, is_bias)[0]
    p = nn.Parameter(torch.empty(shape, device=device, dtype=dtype))
    with torch.no_grad():
        if chosen is None:
            init(p)
        else:
            p.copy_(chosen(tuple(shape), dtype, device))
    if attr is not None:
        set_param_attr(p, attr)
    return p


__all__ = ["Layer", "LayerList", "Sequential", "LayerDict", "ParameterList",
           "ParameterDict", "HookRemoveHelper", "in_dynamic_mode",
           "enable_static", "disable_static", "placement", "make_parameter"]
