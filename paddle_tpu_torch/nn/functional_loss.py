"""The loss functionals of ``paddle_tpu/nn/functional/loss.py``, part of
``nn.functional`` (which re-exports every name here).

Each is the JAX function's formula in PyTorch ops: the same dtypes (most
compute in fp32 from the inputs as they are; ``mse_loss`` and the other
elementwise ones in the inputs' dtype), the same clips and floors, the
same reductions (``"mean"``, ``"sum"``, anything else none), and under
``amp.auto_cast`` the JAX op name each dispatches as. XLA fuses them into
single passes; no model of the repo times them, so they are plain
PyTorch. ``ctc_loss`` and ``rnnt_loss`` are the exception: their
recursions run in the CUDA kernels of ``kernels/seq_loss.py`` on CUDA
tensors (the plain loops on CPU tensors).

``cross_entropy`` takes every JAX argument: class weights, soft labels
(also float labels of the logits' rank), ``use_softmax=False`` (the input
read as probabilities, floored at 1e-30), ``label_smoothing``, any axis
and reduction. A soft label's class weights lie along the last axis
whatever ``axis`` says, as in the JAX function.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from .. import amp
from ..kernels import seq_loss as SL


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def _one_hot(idx, n, dtype=torch.float32):
    """``jax.nn.one_hot``: rows of zeros for indices outside [0, n)."""
    return (idx.long()[..., None] == torch.arange(n, device=idx.device)) \
        .to(dtype)


def _softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


@amp.op("cross_entropy")
def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Cross entropy of ``input`` over ``axis`` in fp32. Hard labels: the
    rows labelled ``ignore_index`` count for nothing; "mean" divides by
    the valid rows (at least one), or with ``weight`` by the sum of their
    weights (at least 1e-12)."""
    ax = axis % input.dim()
    x = input.float()
    logp = torch.log_softmax(x, dim=ax) if use_softmax \
        else torch.log(torch.clamp_min(x, 1e-30))
    n = input.shape[ax]
    if soft_label or (label.is_floating_point()
                      and label.dim() == input.dim()):
        soft = label.float()
        if label_smoothing > 0:
            soft = soft * (1 - label_smoothing) + label_smoothing / n
        loss = -(soft * logp).sum(dim=ax)
        if weight is not None:
            w = weight.reshape((1,) * (logp.dim() - 1) + (-1,))
            loss = loss * (soft * w).sum(dim=ax)
        return _reduce(loss, reduction)
    lab = label.long()
    if lab.dim() == input.dim():
        lab = lab.squeeze(ax)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    if label_smoothing > 0:
        soft = _one_hot(safe, n).movedim(-1, ax) * (1 - label_smoothing) \
            + label_smoothing / n
        loss = -(soft * logp).sum(dim=ax)
    else:
        loss = -logp.gather(ax, safe.unsqueeze(ax)).squeeze(ax)
    zero = torch.zeros((), dtype=torch.float32, device=loss.device)
    loss = torch.where(valid, loss, zero)
    if weight is not None:
        wsel = torch.where(valid, weight.float()[safe], zero)
        loss = loss * wsel
        if reduction == "mean":
            return loss.sum() / torch.clamp_min(wsel.sum(), 1e-12)
    if reduction == "mean":
        return loss.sum() / torch.clamp_min(valid.float().sum(), 1.0)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """``cross_entropy(reduction="none")`` with the class axis kept (size
    1); with ``return_softmax`` also the softmax of the logits."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        from .functional import softmax
        return loss, softmax(logits, axis=axis)
    return loss


@amp.op("nll_loss")
def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """Negative log-likelihood of log-probabilities ``input [N, C, ...]``
    in fp32; "mean" divides by the valid rows' weights (at least
    1e-12)."""
    logp = input.float()
    lab = label.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    loss = -logp.gather(1, safe.unsqueeze(1)).squeeze(1)
    wsel = torch.ones_like(loss) if weight is None else weight.float()[safe]
    wsel = torch.where(valid, wsel, torch.zeros_like(wsel))
    loss = loss * wsel
    if reduction == "mean":
        return loss.sum() / torch.clamp_min(wsel.sum(), 1e-12)
    return _reduce(loss, reduction)


@amp.op("mse_loss")
def mse_loss(input, label, reduction="mean", name=None):
    return _reduce((input - label) ** 2, reduction)


@amp.op("l1_loss")
def l1_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.abs(input - label), reduction)


@amp.op("smooth_l1_loss")
def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    """``0.5 d^2 / delta`` below ``delta``, ``d - 0.5 delta`` above (d =
    |input - label|)."""
    d = torch.abs(input - label)
    return _reduce(torch.where(d < delta, 0.5 * d * d / delta,
                               d - 0.5 * delta), reduction)


@amp.op("huber_loss")
def huber_loss(input, label, delta=1.0, reduction="mean", name=None):
    d = torch.abs(input - label)
    return _reduce(torch.where(d <= delta, 0.5 * d * d,
                               delta * (d - 0.5 * delta)), reduction)


@amp.op("binary_cross_entropy")
def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    """BCE of probabilities in fp32, clipped to [1e-12, 1 - 1e-12]."""
    p = torch.clamp(input.float(), 1e-12, 1.0 - 1e-12)
    y = label.float()
    loss = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
    if weight is not None:
        loss = loss * weight.float()
    return _reduce(loss, reduction)


@amp.op("bce_with_logits")
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """BCE of logits in fp32: ``max(z, 0) - z y + log1p(exp(-|z|))``, or
    with ``pos_weight`` ``-(pw y log_sigmoid(z) + (1 - y)
    log_sigmoid(-z))``."""
    z, y = logit.float(), label.float()
    loss = torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-z.abs()))
    if pos_weight is not None:
        loss = -(pos_weight.float() * y * TF.logsigmoid(z)
                 + (1 - y) * TF.logsigmoid(-z))
    if weight is not None:
        loss = loss * weight.float()
    return _reduce(loss, reduction)


@amp.op("kl_div")
def kl_div(input, label, reduction="mean", log_target=False, name=None):
    """``label * (log(label) - input)`` (0 where label <= 0), or with
    ``log_target`` ``exp(label) * (label - input)``, in fp32;
    "batchmean" divides the sum by the batch."""
    a, b = input.float(), label.float()
    if log_target:
        loss = torch.exp(b) * (b - a)
    else:
        loss = torch.where(b > 0, b * (torch.log(torch.clamp_min(b, 1e-30))
                                       - a), torch.zeros_like(a))
    if reduction == "batchmean":
        return loss.sum() / a.shape[0]
    return _reduce(loss, reduction)


@amp.op("margin_ranking_loss")
def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _reduce(torch.clamp_min(-label * (input - other) + margin, 0.0),
                   reduction)


@amp.op("cosine_embedding_loss")
def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    cos = (input1 * input2).sum(-1) / torch.clamp_min(
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1), 1e-12)
    return _reduce(torch.where(label == 1, 1 - cos,
                               torch.clamp_min(cos - margin, 0.0)), reduction)


@amp.op("triplet_margin_loss")
def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-06, swap=False, reduction="mean",
                        name=None):
    def dist(a, b):
        return torch.linalg.vector_norm(a - b + epsilon, ord=p, dim=-1)
    dp, dn = dist(input, positive), dist(input, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    return _reduce(torch.clamp_min(dp - dn + margin, 0.0), reduction)


@amp.op("hinge_embedding_loss")
def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return _reduce(torch.where(label == 1, input,
                               torch.clamp_min(margin - input, 0.0)),
                   reduction)


@amp.op("square_error_cost")
def square_error_cost(input, label):
    return (input - label) ** 2


@amp.op("log_loss")
def log_loss(input, label, epsilon=1e-4, name=None):
    return -label * torch.log(input + epsilon) \
        - (1 - label) * torch.log(1 - input + epsilon)


@amp.op("sigmoid_focal_loss")
def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    z, y = logit.float(), label.float()
    p = torch.sigmoid(z)
    ce = torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-z.abs()))
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer.float()
    return _reduce(loss, reduction)


@amp.op("ctc_loss")
def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False, name=None):
    """CTC of ``log_probs [T, B, C]`` (logits, log-softmaxed inside) and
    ``labels [B, L]`` in fp32: each sample read at ``input_len - 1``;
    "mean" is ``mean(nll / max(label_len, 1))``; ``norm_by_times`` scales
    only the gradient, by ``1 / max(input_len, 1)``. The kernels of
    ``kernels.seq_loss`` on CUDA tensors, the plain loops on CPU tensors."""
    nll = SL.ctc_nll(log_probs, labels, input_lengths, label_lengths, blank,
                     norm_by_times)
    if reduction == "mean":
        nll = nll / torch.clamp_min(
            label_lengths.to(nll.device).float(), 1.0)
    return _reduce(nll, reduction)


@amp.op("rnnt_loss")
def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.001, reduction="mean", name=None):
    """RNN-T of the joint ``input [B, T, U+1, V]`` (logits) and ``label
    [B, U]`` in fp32; "mean" over the batch; ``fastemit_lambda`` scales
    only the emissions' gradient, by ``1 + lambda``. The kernels of
    ``kernels.seq_loss`` on CUDA tensors, the plain loops on CPU tensors."""
    nll = SL.rnnt_nll(input, label, input_lengths, label_lengths, blank,
                      fastemit_lambda)
    return _reduce(nll, reduction)


@amp.op("margin_cross_entropy")
def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """ArcFace's combined margin on cosines ``logits [N, C]``: the
    target's cosine clipped to +-(1 - 1e-6) (so the gradient stays finite
    at a cosine of 1), ``cos(m1 theta + m2) - m3``, times ``scale``, then
    cross entropy; the loss is ``[N, 1]`` before the reduction. One device:
    ``group`` must be None."""
    if group is not None:
        raise NotImplementedError("margin_cross_entropy(group=...): the "
                                  "port runs on one device")
    cos = logits.float()
    c = cos.shape[1]
    y = label.reshape(-1).long()
    onehot = _one_hot(y, c, torch.bool)
    lim = 1.0 - 1e-6
    target = torch.clamp(cos.gather(1, y[:, None]), -lim, lim)
    m_cos = torch.cos(margin1 * torch.arccos(target) + margin2) - margin3
    logp = torch.log_softmax(torch.where(onehot, m_cos, cos) * scale, dim=-1)
    loss = _reduce(-logp.gather(1, y[:, None]), reduction)
    if return_softmax:
        return loss, torch.exp(logp)
    return loss


@amp.op("hsigmoid_loss")
def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid in fp32, ``[N, 1]``: on the default tree
    class c's path is ``c + num_classes``'s bits (node ``(code >> (d +
    1)) - 1``, bit ``(code >> d) & 1``), or ``path_table`` / ``path_code``
    (nodes < 0 off the path)."""
    x = input.float()
    y = label.reshape(-1).long()
    last = weight.shape[0] - 1
    if path_table is not None and path_code is not None:
        table = path_table.long()
        valid = table >= 0
        idx = table.clamp(0, last)
        bits = path_code.long().float()
    else:
        max_len = math.floor(math.log2(max(num_classes * 2 - 1, 2)))
        code = (y + num_classes)[:, None]
        d = torch.arange(max_len, device=x.device)
        valid = (code >> (d + 1)) >= 1
        idx = ((code >> (d + 1)) - 1).clamp(0, last)
        bits = ((code >> d) & 1).float()
    pre = torch.einsum("nd,nld->nl", x, weight.float()[idx])
    if bias is not None:
        pre = pre + bias.float().reshape(-1)[idx]
    per_node = _softplus(pre) - bits * pre
    return torch.where(valid, per_node, torch.zeros_like(per_node)) \
        .sum(1, keepdim=True)


@amp.op("dice_loss")
def dice_loss(input, label, epsilon=1e-5, name=None):
    """``mean(1 - (2 |X n Y| + eps) / (|X| + |Y| + eps))`` over the
    samples; ``input [N, ..., C]`` probabilities, ``label [N, ..., 1]``
    class ids."""
    n = input.shape[-1]
    lab = label.reshape(label.shape[:-1]) if label.shape[-1] == 1 else label
    oh = _one_hot(lab, n, input.dtype)
    red = tuple(range(1, input.dim()))
    inter = (input * oh).sum(red)
    union = input.sum(red) + oh.sum(red)
    return (1.0 - (2.0 * inter + epsilon) / (union + epsilon)).mean()


@amp.op("gaussian_nll_loss")
def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    var = torch.clamp_min(variance.float(), epsilon)
    loss = 0.5 * (torch.log(var)
                  + (label.float() - input.float()) ** 2 / var)
    if full:
        loss = loss + 0.5 * math.log(2.0 * math.pi)
    return _reduce(loss, reduction)


@amp.op("poisson_nll_loss")
def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None):
    x, y = input.float(), label.float()
    loss = torch.exp(x) - y * x if log_input \
        else x - y * torch.log(x + epsilon)
    if full:
        stir = y * torch.log(y) - y + 0.5 * torch.log(2.0 * math.pi * y)
        loss = loss + torch.where(y > 1, stir, torch.zeros_like(stir))
    return _reduce(loss, reduction)


@amp.op("soft_margin_loss")
def soft_margin_loss(input, label, reduction="mean", name=None):
    return _reduce(_softplus(-label.float() * input.float()), reduction)


@amp.op("multi_label_soft_margin_loss")
def multi_label_soft_margin_loss(input, label, weight=None, reduction="mean",
                                 name=None):
    x, y = input.float(), label.float()
    term = y * TF.logsigmoid(x) + (1 - y) * TF.logsigmoid(-x)
    if weight is not None:
        term = term * weight
    return _reduce(-term.mean(-1), reduction)


@amp.op("multi_margin_loss")
def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    x = input.float()
    c = x.shape[1]
    y = label.long()
    hinge = torch.clamp_min(margin - x.gather(1, y[:, None]) + x, 0.0) ** p
    if weight is not None:
        hinge = hinge * weight[y][:, None]
    loss = (hinge * (1.0 - _one_hot(y, c, x.dtype))).sum(1) / c
    return _reduce(loss, reduction)


@amp.op("pairwise_distance")
def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """``||x - y + eps||_p`` over the last axis, in fp32."""
    return torch.linalg.vector_norm(x.float() - y.float() + epsilon, ord=p,
                                    dim=-1, keepdim=keepdim)


@amp.op("tmwd_min")
def _tmwd_min(a, b):
    return torch.minimum(a, b)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    """The triplet loss under ``distance_function`` (default
    ``pairwise_distance``), in fp32."""
    dist = distance_function or pairwise_distance
    d_pos, d_neg = dist(input, positive), dist(input, negative)
    if swap:
        d_neg = _tmwd_min(d_neg, dist(positive, negative))
    return _triplet_with_distance(d_pos, d_neg, margin, reduction)


@amp.op("triplet_margin_with_distance_loss")
def _triplet_with_distance(d_pos, d_neg, margin, reduction):
    return _reduce(torch.clamp_min(d_pos.float() - d_neg.float() + margin,
                                   0.0), reduction)


@amp.op("npair_loss")
def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    """Cross entropy over ``anchor @ positive^T`` with the same-label
    columns as the target, plus ``l2_reg / 4`` times the embeddings' mean
    squared norms."""
    a, p = anchor.float(), positive.float()
    lab = labels.reshape(-1)
    same = (lab[:, None] == lab[None, :]).float()
    tgt = same / same.sum(1, keepdim=True)
    xe = -(tgt * torch.log_softmax(a @ p.T, dim=1)).sum(1)
    reg = l2_reg * ((a * a).sum(1).mean() + (p * p).sum(1).mean()) * 0.25
    return xe.mean() + reg


def _head_log_probs(x, head_weight, head_bias):
    head = x @ head_weight.float()
    if head_bias is not None:
        head = head + head_bias.float()
    return torch.log_softmax(head, dim=-1)


@amp.op("adaptive_log_softmax_with_loss")
def adaptive_log_softmax_with_loss(input, label, head_weight, tail_weights,
                                   cutoffs, head_bias=None, name=None):
    """(each sample's target log-probability, their negated mean) under
    the adaptive softmax: a head over the shortlist and one token a
    cluster, a low-rank tail a cluster; ``cutoffs`` ends with the class
    count."""
    cutoffs = [int(c) for c in cutoffs]
    shortlist = cutoffs[0]
    x = input.float()
    head_logp = _head_log_probs(x, head_weight, head_bias)
    y = label.reshape(-1).long()
    out = head_logp.gather(1, y.clamp(0, shortlist - 1)[:, None])[:, 0]
    for i, (w_proj, w_cls) in enumerate(tail_weights):
        lo, hi = cutoffs[i], cutoffs[i + 1]
        tail_logp = torch.log_softmax((x @ w_proj.float()) @ w_cls.float(),
                                      dim=-1)
        rel = (y - lo).clamp(0, hi - lo - 1)
        cand = head_logp[:, shortlist + i] \
            + tail_logp.gather(1, rel[:, None])[:, 0]
        out = torch.where((y >= lo) & (y < hi), cand, out)
    return out, -out.mean()


__all__ = ["cross_entropy", "softmax_with_cross_entropy", "nll_loss",
           "mse_loss", "l1_loss", "smooth_l1_loss", "huber_loss",
           "binary_cross_entropy", "binary_cross_entropy_with_logits",
           "kl_div", "margin_ranking_loss", "cosine_embedding_loss",
           "triplet_margin_loss", "hinge_embedding_loss",
           "square_error_cost", "log_loss", "sigmoid_focal_loss", "ctc_loss",
           "rnnt_loss", "margin_cross_entropy", "hsigmoid_loss", "dice_loss",
           "gaussian_nll_loss", "poisson_nll_loss", "soft_margin_loss",
           "multi_label_soft_margin_loss", "multi_margin_loss",
           "pairwise_distance", "triplet_margin_with_distance_loss",
           "npair_loss", "adaptive_log_softmax_with_loss"]
