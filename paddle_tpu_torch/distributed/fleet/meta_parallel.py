"""The fleet tensor-parallel layers (``paddle_tpu/distributed/fleet/
meta_parallel.py:36 ColumnParallelLinear``, ``:61 RowParallelLinear``,
``:85 VocabParallelEmbedding``) on one device.

The JAX layers carry the mp-axis sharding of their parameters for the
compiled step's partitioner and compute as dense layers, which is their
mp degree 1 semantics; these are those dense layers, with the JAX names,
layouts (weight ``[in, out]``) and initial distributions (Xavier-normal
weights, zero biases, the vocabulary table Normal(0, 0.02)). An
``mp_group`` of more than one rank raises: tensor parallelism is not
ported (ROADMAP Queue 1, distributed)."""
from __future__ import annotations

import torch
from torch import nn

from ...nn import functional as F
from ...nn.initializer import xavier_normal_
from ...nn.layer.layers import Layer, make_parameter, placement


def _one_device(layer, mp_group):
    ranks = getattr(mp_group, "nranks", 1) if mp_group is not None else 1
    if ranks > 1:
        raise NotImplementedError(
            f"{layer} over an mp group of {ranks} ranks is not ported: the "
            f"port runs on one device (ROADMAP Queue 1, distributed)")


class ColumnParallelLinear(Layer):
    """Weight ``[in, out]`` (sharded on out over mp in the JAX package)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        _one_device("ColumnParallelLinear", mp_group)
        dev, dt = placement(device, dtype)
        self._in_features = in_features
        self._out_features = out_features
        self.gather_output = gather_output
        self.weight = make_parameter((in_features, out_features), weight_attr,
                                     dev, dt,
                                     lambda t: xavier_normal_(t, generator))
        self.bias = make_parameter((out_features,), None if has_bias
                                   else False, dev, dt, torch.Tensor.zero_,
                                   True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class RowParallelLinear(Layer):
    """Weight ``[in, out]`` (sharded on in over mp in the JAX package)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        _one_device("RowParallelLinear", mp_group)
        dev, dt = placement(device, dtype)
        self._in_features = in_features
        self._out_features = out_features
        self.input_is_parallel = input_is_parallel
        self.weight = make_parameter((in_features, out_features), weight_attr,
                                     dev, dt,
                                     lambda t: xavier_normal_(t, generator))
        self.bias = make_parameter((out_features,), None if has_bias
                                   else False, dev, dt, torch.Tensor.zero_,
                                   True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class VocabParallelEmbedding(Layer):
    """Embedding table ``[num_embeddings, embedding_dim]``, Normal(0,
    0.02) (sharded on the vocabulary over mp in the JAX package)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        _one_device("VocabParallelEmbedding", mp_group)
        dev, dt = placement(device, dtype)
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self.weight = make_parameter(
            (num_embeddings, embedding_dim), weight_attr, dev, dt,
            lambda t: t.normal_(0.0, 0.02, generator=generator))

    def forward(self, x):
        return F.embedding(x, self.weight)


__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding"]
