"""Save and load nested structures of tensors in the ``.pdparams`` /
``.pdiparams`` format that ``paddle_tpu.save`` writes.

The file is a pickled nested structure in which every tensor is stored
as ``{"__tensor__": True, "data": <numpy array>, ...}``. numpy has no
bfloat16: the port stores a bf16 tensor's bits as uint16 with
``"dtype": "bfloat16"`` beside them (the JAX package pickles an
``ml_dtypes`` bfloat16 array, which ``load`` also reads where
``ml_dtypes`` is installed). Unpickling can run code, so load only files
this project wrote.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch


def _from_storable(obj, as_torch=False):
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            data = obj["data"]
            if not as_torch:
                return data
            if obj.get("dtype") == "bfloat16" \
                    or data.dtype.name == "bfloat16":
                return torch.from_numpy(np.ascontiguousarray(
                    data).view(np.uint16).copy()).view(torch.bfloat16)
            return torch.from_numpy(np.array(data))
        return {k: _from_storable(v, as_torch) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_storable(v, as_torch) for v in obj)
    return obj


def _to_storable(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return {"__tensor__": True, "data": t.view(torch.uint16).numpy(),
                    "dtype": "bfloat16", "stop_gradient": True, "name": None}
        return {"__tensor__": True, "data": t.numpy(), "stop_gradient": True,
                "name": None}
    if isinstance(obj, dict):
        return {k: _to_storable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_storable(v) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    """Write ``obj`` (nested dicts, lists and tensors) to ``path``, every
    tensor copied to the CPU."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_storable(obj), f, protocol=protocol)


def load(path, return_numpy=False, **configs):
    """The object saved at ``path``, as the JAX package's ``load``: every
    tensor a CPU ``torch.Tensor`` of its own dtype (the JAX package's
    ``Tensor``), or with ``return_numpy`` a numpy array (a bf16 tensor the
    port wrote as its uint16 bits). ``configs`` are accepted and ignored,
    as there."""
    with open(path, "rb") as f:
        return _from_storable(pickle.load(f), as_torch=not return_numpy)


__all__ = ["save", "load"]
