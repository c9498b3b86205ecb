"""The loss layers of ``paddle_tpu/nn/layer/loss.py`` over the
functionals: ``CrossEntropyLoss`` with all of its arguments and the 22
others. ``HSigmoidLoss`` (its tree's weight ``[C - 1, feature]`` and bias
``[C - 1, 1]``) and ``AdaptiveLogSoftmaxWithLoss`` (``head_weight``,
``head_bias``, ``tail_{i}_proj``, ``tail_{i}_cls``) hold parameters, under
the JAX names, Xavier-uniform (biases zeros) from ``framework.random``
unless a ``ParamAttr`` or a global initializer says otherwise, on an
explicit ``device`` (None = the GPU) in ``dtype`` (float32)."""
from __future__ import annotations

import inspect

import torch

from .. import functional as F
from .layers import Layer


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(input, label, weight=self.weight,
                               ignore_index=self.ignore_index,
                               reduction=self.reduction,
                               soft_label=self.soft_label, axis=self.axis,
                               use_softmax=self.use_softmax,
                               label_smoothing=self.label_smoothing)


def _reduction_loss(name, fn_name, args=(), defaults=(), inputs=2):
    """A loss layer whose constructor takes ``args`` (with ``defaults``,
    then ``name``: the JAX class's signature, which ``inspect`` reports)
    and whose forward passes its ``inputs`` tensors then those arguments,
    in order, to ``F.<fn_name>``."""
    fn = getattr(F, fn_name)
    sig = inspect.Signature(
        [inspect.Parameter("self", inspect.Parameter.POSITIONAL_OR_KEYWORD)]
        + [inspect.Parameter(k, inspect.Parameter.POSITIONAL_OR_KEYWORD,
                             default=d)
           for k, d in zip(args + ("name",), defaults + (None,))])

    def __init__(self, *a, **kw):
        Layer.__init__(self)
        values = sig.bind(self, *a, **kw)
        values.apply_defaults()
        for k in args:
            setattr(self, k, values.arguments[k])

    __init__.__signature__ = sig

    def forward(self, *tensors):
        if len(tensors) != inputs:
            raise TypeError(f"{name} takes {inputs} inputs, got "
                            f"{len(tensors)}")
        return fn(*tensors, *(getattr(self, k) for k in args))

    return type(name, (Layer,), {"__init__": __init__, "forward": forward,
                                 "__doc__": f"``F.{fn_name}`` as a layer."})


MSELoss = _reduction_loss("MSELoss", "mse_loss", ("reduction",), ("mean",))
L1Loss = _reduction_loss("L1Loss", "l1_loss", ("reduction",), ("mean",))
NLLLoss = _reduction_loss("NLLLoss", "nll_loss",
                          ("weight", "ignore_index", "reduction"),
                          (None, -100, "mean"))
BCELoss = _reduction_loss("BCELoss", "binary_cross_entropy",
                          ("weight", "reduction"), (None, "mean"))
BCEWithLogitsLoss = _reduction_loss(
    "BCEWithLogitsLoss", "binary_cross_entropy_with_logits",
    ("weight", "reduction", "pos_weight"), (None, "mean", None))
SmoothL1Loss = _reduction_loss("SmoothL1Loss", "smooth_l1_loss",
                               ("reduction", "delta"), ("mean", 1.0))
HuberLoss = _reduction_loss("HuberLoss", "huber_loss",
                            ("delta", "reduction"), (1.0, "mean"))
KLDivLoss = _reduction_loss("KLDivLoss", "kl_div",
                            ("reduction", "log_target"), ("mean", False))
MarginRankingLoss = _reduction_loss("MarginRankingLoss",
                                    "margin_ranking_loss",
                                    ("margin", "reduction"), (0.0, "mean"), 3)
CosineEmbeddingLoss = _reduction_loss("CosineEmbeddingLoss",
                                      "cosine_embedding_loss",
                                      ("margin", "reduction"), (0.0, "mean"),
                                      3)
TripletMarginLoss = _reduction_loss(
    "TripletMarginLoss", "triplet_margin_loss",
    ("margin", "p", "epsilon", "swap", "reduction"),
    (1.0, 2.0, 1e-06, False, "mean"), 3)
HingeEmbeddingLoss = _reduction_loss("HingeEmbeddingLoss",
                                     "hinge_embedding_loss",
                                     ("margin", "reduction"), (1.0, "mean"))
GaussianNLLLoss = _reduction_loss("GaussianNLLLoss", "gaussian_nll_loss",
                                  ("full", "epsilon", "reduction"),
                                  (False, 1e-6, "mean"), 3)
PoissonNLLLoss = _reduction_loss("PoissonNLLLoss", "poisson_nll_loss",
                                 ("log_input", "full", "epsilon",
                                  "reduction"), (True, False, 1e-8, "mean"))
SoftMarginLoss = _reduction_loss("SoftMarginLoss", "soft_margin_loss",
                                 ("reduction",), ("mean",))
MultiLabelSoftMarginLoss = _reduction_loss(
    "MultiLabelSoftMarginLoss", "multi_label_soft_margin_loss",
    ("weight", "reduction"), (None, "mean"))
MultiMarginLoss = _reduction_loss("MultiMarginLoss", "multi_margin_loss",
                                  ("p", "margin", "weight", "reduction"),
                                  (1, 1.0, None, "mean"))
TripletMarginWithDistanceLoss = _reduction_loss(
    "TripletMarginWithDistanceLoss", "triplet_margin_with_distance_loss",
    ("distance_function", "margin", "swap", "reduction"),
    (None, 1.0, False, "mean"), 3)


class CTCLoss(Layer):
    """``F.ctc_loss``: on CUDA tensors the CTC kernels."""

    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction, norm_by_times)


class RNNTLoss(Layer):
    """``F.rnnt_loss``: on CUDA tensors the RNN-T kernels."""

    def __init__(self, blank=0, fastemit_lambda=0.001, reduction="mean",
                 name=None):
        super().__init__()
        self.blank = blank
        self.fastemit_lambda = fastemit_lambda
        self.reduction = reduction

    def forward(self, input, label, input_lengths, label_lengths):
        return F.rnnt_loss(input, label, input_lengths, label_lengths,
                           self.blank, self.fastemit_lambda, self.reduction)


class HSigmoidLoss(Layer):
    """The hierarchical sigmoid's tree classifier: ``weight [C - 1,
    feature_size]``, ``bias [C - 1, 1]`` (none with ``bias_attr=False``)."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False, name=None,
                 *, device=None, dtype=None):
        super().__init__(dtype=dtype, device=device)
        if num_classes < 2:
            raise ValueError("num_classes must not be less than 2")
        self.num_classes = num_classes
        self.is_custom = is_custom
        self.is_sparse = is_sparse
        c = num_classes - 1
        self.weight = self.create_parameter((c, feature_size),
                                            attr=weight_attr)
        self.bias = (None if bias_attr is False else
                     self.create_parameter((c, 1), attr=bias_attr,
                                           is_bias=True))

    def forward(self, input, label, path_table=None, path_code=None):
        if self.is_custom and (path_table is None or path_code is None):
            raise ValueError("is_custom=True requires path_table/path_code")
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               self.bias, path_table, path_code,
                               self.is_sparse)


class AdaptiveLogSoftmaxWithLoss(Layer):
    """The adaptive softmax: a head over the ``cutoffs[0]`` most frequent
    classes and one token a cluster, and a low-rank tail a cluster (its
    hidden size ``in_features / div_value^(i + 1)``)."""

    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0,
                 head_bias=False, name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype, device=device)
        cutoffs = [int(c) for c in cutoffs]
        if (not cutoffs or any(cutoffs[i] >= cutoffs[i + 1]
                               for i in range(len(cutoffs) - 1))
                or cutoffs[-1] > n_classes - 1):
            raise ValueError("cutoffs must be increasing ints < n_classes")
        self.in_features = in_features
        self.n_classes = n_classes
        self.cutoffs = cutoffs + [n_classes]
        self.div_value = div_value
        self.shortlist_size = cutoffs[0]
        self.n_clusters = len(self.cutoffs) - 1
        head_size = self.shortlist_size + self.n_clusters
        self.head_weight = self.create_parameter((in_features, head_size))
        self.head_bias = (self.create_parameter((head_size,), is_bias=True)
                          if head_bias else None)
        self.tail_weights = []
        for i in range(self.n_clusters):
            hsz = max(1, int(in_features / (div_value ** (i + 1))))
            osz = self.cutoffs[i + 1] - self.cutoffs[i]
            w1 = self.create_parameter((in_features, hsz))
            w2 = self.create_parameter((hsz, osz))
            self.add_parameter(f"tail_{i}_proj", w1)
            self.add_parameter(f"tail_{i}_cls", w2)
            self.tail_weights.append((w1, w2))

    def forward(self, input, label):
        return F.adaptive_log_softmax_with_loss(
            input, label, self.head_weight, self.tail_weights, self.cutoffs,
            self.head_bias)

    def log_prob(self, input):
        """Every class's log-probability, ``[N, n_classes]``, in fp32."""
        x = input.float()
        head_logp = F._loss._head_log_probs(x, self.head_weight,
                                            self.head_bias)
        parts = [head_logp[:, :self.shortlist_size]]
        for i, (w1, w2) in enumerate(self.tail_weights):
            tail = torch.log_softmax((x @ w1.float()) @ w2.float(), dim=-1)
            k = self.shortlist_size + i
            parts.append(head_logp[:, k:k + 1] + tail)
        return torch.cat(parts, dim=-1)

    def predict(self, input):
        return torch.argmax(self.log_prob(input), dim=-1)


__all__ = ["CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
           "BCEWithLogitsLoss", "SmoothL1Loss", "HuberLoss", "KLDivLoss",
           "MarginRankingLoss", "CosineEmbeddingLoss", "TripletMarginLoss",
           "HingeEmbeddingLoss", "CTCLoss", "RNNTLoss", "HSigmoidLoss",
           "GaussianNLLLoss", "PoissonNLLLoss", "SoftMarginLoss",
           "MultiLabelSoftMarginLoss", "MultiMarginLoss",
           "TripletMarginWithDistanceLoss", "AdaptiveLogSoftmaxWithLoss"]
