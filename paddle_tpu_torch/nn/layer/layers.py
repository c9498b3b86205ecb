"""``LayerList`` and ``Sequential`` (``paddle_tpu/nn/layer/layers.py:398,
:364``), and what the
layers of ``nn/layer`` share: where a parameter is made and how its
attribute is read."""
from __future__ import annotations

import torch
from torch import nn

from ... import resolve_device
from ..initializer import _resolve_attr, set_param_attr


class LayerList(nn.ModuleList):
    """Sublayers held in order and named "0", "1", ...: the JAX
    ``LayerList``'s indexing, slicing, ``append``, ``insert``,
    ``extend`` and iteration are ``nn.ModuleList``'s."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)


class Sequential(nn.Sequential):
    """Sublayers run in order, named "0", "1", ... (or the names of
    ``(name, layer)`` pairs, given one by one or as one list), as the JAX
    ``Sequential`` names them, so parameter names match."""

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


__all__ = ["LayerList", "Sequential", "placement", "make_parameter"]
