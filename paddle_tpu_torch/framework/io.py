"""Read ``.pdparams`` files written by ``paddle_tpu.save`` into numpy.

The file is a pickled nested structure in which every tensor was stored
as ``{"__tensor__": True, "data": <numpy array>, ...}``; this reader
returns the same structure with each such record replaced by its array.
Unpickling can run code, so load only files this project wrote.
"""
from __future__ import annotations

import pickle


def _from_storable(obj):
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            return obj["data"]
        return {k: _from_storable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_storable(v) for v in obj)
    return obj


def load(path):
    """The object saved at ``path``, with every tensor as a numpy array."""
    with open(path, "rb") as f:
        return _from_storable(pickle.load(f))


__all__ = ["load"]
