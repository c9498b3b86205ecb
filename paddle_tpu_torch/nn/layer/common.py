"""The layers of ``paddle_tpu/nn/layer/common.py`` as ``Layer``s: the
JAX layers' arguments, parameter names, layouts and initial
distributions. ``Linear`` (weight ``[in, out]`` Xavier-normal, bias zeros)
and ``Embedding`` (Normal(0, 1), the padding row zeros) draw on an
explicit ``device`` (None = the GPU) in ``dtype`` (float32) from
``generator`` (None = torch's default generator of the device);
``Bilinear`` (weight ``[out, in1, in2]`` Xavier-uniform, bias ``[1, out]``
zeros) and ``SpectralNorm``'s ``weight_u`` / ``weight_v`` buffers (unit
normals) from ``framework.random``, as the JAX layers draw from its key.
The others hold no state and call the functionals."""
from __future__ import annotations

import math

import torch

from .. import functional as F
from ..initializer import Normal, xavier_normal_
from .layers import Layer, make_parameter, placement


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Linear(Layer):
    """y = xW + b, weight ``[in_features, out_features]``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        dev, dt = placement(device, dtype)
        self._in_features = in_features
        self._out_features = out_features
        self.weight = make_parameter(
            (in_features, out_features), weight_attr, dev, dt,
            lambda t: xavier_normal_(t, generator))
        self.bias = make_parameter((out_features,), bias_attr, dev, dt,
                                   torch.Tensor.zero_, True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        dev, dt = placement(device, dtype)
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._sparse = sparse
        self._padding_idx = (padding_idx if padding_idx is None
                             or padding_idx >= 0
                             else num_embeddings + padding_idx)

        def init(t):
            t.normal_(0.0, 1.0, generator=generator)
            if self._padding_idx is not None:
                t[self._padding_idx] = 0.0
        self.weight = make_parameter((num_embeddings, embedding_dim),
                                     weight_attr, dev, dt, init)

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx,
                           sparse=self._sparse)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    """``F.dropout`` with the module's ``training`` flag."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Flatten(Layer):
    """``torch.flatten`` of the axes ``start_axis`` to ``stop_axis``."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, p=self.p, training=self.training)


class FeatureAlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.feature_alpha_dropout(x, self.p, self.training)


class Unflatten(Layer):
    """Axis ``axis`` reshaped to ``shape``."""

    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis = axis
        self.shape = shape

    def forward(self, x):
        return x.reshape(list(x.shape[:self.axis]) + list(self.shape)
                         + list(x.shape[self.axis + 1:]))


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0, data_format)


class UpsamplingBilinear2D(Upsample):
    """Bilinear with ``align_corners``: the JAX function's two-tap
    gather."""

    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0, data_format)


class Pad1D(Layer):
    """``F.pad``; an int ``padding`` pads both sides of every spatial
    axis."""

    def __init__(self, padding, mode="constant", value=0.0, data_format="NCL",
                 name=None):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        pad = self.padding
        if isinstance(pad, int):
            pad = [pad] * (2 * (len(self.data_format) - 2))
        return F.pad(x, pad, self.mode, self.value, self.data_format)


class Pad2D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCHW",
                 name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad1D(Pad1D):
    def __init__(self, padding, data_format="NCL", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class ZeroPad3D(Pad3D):
    def __init__(self, padding, data_format="NCDHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups
        self.data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class Bilinear(Layer):
    """``out[n, o] = x1[n] @ weight[o] @ x2[n] + bias[0, o]``."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *, device=None,
                 dtype=None):
        super().__init__(dtype=dtype, device=device)
        self.weight = self.create_parameter(
            (out_features, in1_features, in2_features), attr=weight_attr)
        self.bias = (None if bias_attr is False else
                     self.create_parameter((1, out_features), attr=bias_attr,
                                           is_bias=True))

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.kernel_sizes = kernel_sizes
        self.strides = strides
        self.paddings = paddings
        self.dilations = dilations

    def forward(self, x):
        return F.fold(x, self.output_sizes, self.kernel_sizes, self.strides,
                      self.paddings, self.dilations)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.kernel_sizes = kernel_sizes
        self.strides = strides
        self.paddings = paddings
        self.dilations = dilations

    def forward(self, x):
        return F.unfold(x, self.kernel_sizes, self.strides, self.paddings,
                        self.dilations)


class Softmax2D(Layer):
    """Softmax over the channels of CHW or NCHW inputs (axis -3)."""

    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        if x.dim() not in (3, 4):
            raise ValueError(
                f"Softmax2D expects a 3D or 4D tensor, got {x.dim()}D")
        return F.softmax(x, axis=-3)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class SpectralNorm(Layer):
    """``forward(weight) = weight / sigma``, sigma the largest singular
    value of the weight as a ``[shape[dim], -1]`` matrix, estimated by
    ``power_iters`` (at least one) rounds of power iteration from the
    persistable buffers ``weight_u`` and ``weight_v`` (unit vectors), which
    each call moves to its estimate, in place (a captured call's replay
    moves them too). The gradient runs through the iteration, as the JAX
    layer's does (not PyTorch's ``spectral_norm``, which detaches u and v).
    """

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32", name=None, *, device=None):
        super().__init__(dtype=dtype, device=device)
        self.dim = dim
        self.power_iters = power_iters
        self.eps = eps
        shape = tuple(int(s) for s in weight_shape)
        h = shape[dim]
        w = math.prod(shape) // h
        dev, dt = placement(device, self._dtype)
        for name_, n in (("weight_u", h), ("weight_v", w)):
            v = Normal(0.0, 1.0)((n,), dt, dev)
            self.register_buffer(name_, v / (torch.linalg.vector_norm(v)
                                             + eps))

    def forward(self, x):
        wm = torch.movedim(x.float(), self.dim, 0)
        mat = wm.reshape(wm.shape[0], -1)
        u, v = self.weight_u.clone(), self.weight_v.clone()
        for _ in range(max(1, self.power_iters)):
            v = mat.T @ u
            v = v / (torch.linalg.vector_norm(v) + self.eps)
            u = mat @ v
            u = u / (torch.linalg.vector_norm(u) + self.eps)
        sigma = u @ mat @ v
        with torch.no_grad():
            self.weight_u.copy_(u)
            self.weight_v.copy_(v)
        return (x.float() / sigma).to(x.dtype)


__all__ = ["Identity", "Linear", "Embedding", "Dropout", "Flatten",
           "Dropout2D", "Dropout3D", "AlphaDropout", "FeatureAlphaDropout",
           "Unflatten", "Upsample", "UpsamplingNearest2D",
           "UpsamplingBilinear2D", "Pad1D", "Pad2D", "Pad3D", "ZeroPad1D",
           "ZeroPad2D", "ZeroPad3D", "CosineSimilarity", "PixelShuffle",
           "PixelUnshuffle", "ChannelShuffle", "Bilinear", "Fold", "Unfold",
           "Softmax2D", "PairwiseDistance", "SpectralNorm"]
