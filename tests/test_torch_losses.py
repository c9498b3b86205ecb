"""paddle_tpu_torch's loss functionals and layers against paddle_tpu's, on
the CPU: the functionals of ``loss.py`` (``cross_entropy`` with class
weights, soft and float labels, ``use_softmax=False``, label smoothing,
another axis, every reduction; the 27 others but CTC and RNN-T, which
``test_torch_seq_losses.py`` holds), outputs and the gradients of every
float input (the JAX package's autograd, ``jax.vjp`` of each op, against
PyTorch's), and the 23 loss layers, ``HSigmoidLoss`` and
``AdaptiveLogSoftmaxWithLoss`` with the JAX layer's parameters carried
across by ``load_numpy_state``.

Inputs are made with numpy from a seed and handed to both sides.

Tolerance: within 1e-5 of the largest reference value (at least 1), for
outputs and gradients: both evaluate the same formula in float32, and
exp, log, the norms and the sums differ in their last ulps.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.tensor import Tensor

import paddle_tpu_torch.nn as pnn
from paddle_tpu_torch.models import load_numpy_state
from paddle_tpu_torch.nn import functional as F

JF = paddle.nn.functional


def _np(t):
    if isinstance(t, Tensor):
        return np.asarray(t._data.astype(jnp.float32))
    return t.detach().float().numpy()


def _close(got, want, tol=1e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _pair(arrays, diff):
    """JAX Tensors and torch tensors of the same arrays; those at the
    indices ``diff`` carry gradients."""
    jts = [Tensor(jnp.asarray(a), stop_gradient=i not in diff)
           if isinstance(a, np.ndarray) else a for i, a in enumerate(arrays)]
    pts = [torch.from_numpy(a.copy()).requires_grad_(i in diff)
           if isinstance(a, np.ndarray) else a for i, a in enumerate(arrays)]
    return jts, pts


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _check(jfn, pfn, arrays, diff, seed=0):
    """Outputs (dtype, shape, values) and the gradients of the inputs at
    ``diff`` under a random cotangent of every float output."""
    jts, pts = _pair(arrays, diff)
    jo, po = _flat(jfn(*jts)), _flat(pfn(*pts))
    assert len(jo) == len(po)
    rng = np.random.default_rng(seed + 100)
    jsum = psum = None
    for j, p in zip(jo, po):
        assert str(p.dtype).replace("torch.", "") == str(j._data.dtype)
        _close(p, j)
        if not p.is_floating_point():
            continue
        ct = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        jt = (j * Tensor(jnp.asarray(ct))).sum()
        pt = (p * torch.from_numpy(ct)).sum()
        jsum = jt if jsum is None else jsum + jt
        psum = pt if psum is None else psum + pt
    if diff:
        jsum.backward()
        psum.backward()
        for i in diff:
            _close(pts[i].grad, jts[i].grad)


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# -- cross_entropy -------------------------------------------------------------

def _ce_case(case):
    rng = _rng(1)
    logits = _f32(rng, 6, 5, scale=2)
    hard = rng.integers(0, 5, 6)
    hard[[1, 4]] = -100
    soft = np.exp(_f32(rng, 6, 5))
    soft = (soft / soft.sum(-1, keepdims=True)).astype(np.float32)
    w = rng.uniform(0.2, 2.0, 5).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return {
        "hard": ([logits, hard], {}),
        "hard_col": ([logits, hard[:, None]], {}),
        "weight": ([logits, hard], {"weight": w}),
        "soft_label": ([logits, soft], {"soft_label": True}),
        "float_label": ([logits, soft], {}),
        "soft_weight": ([logits, soft], {"soft_label": True, "weight": w}),
        "no_softmax": ([probs.astype(np.float32), hard],
                       {"use_softmax": False}),
        "smoothing": ([logits, hard], {"label_smoothing": 0.1}),
        "soft_smoothing": ([logits, soft], {"soft_label": True,
                                            "label_smoothing": 0.2}),
        "axis1": ([_f32(rng, 4, 5, 3), rng.integers(0, 5, (4, 3))],
                  {"axis": 1}),
        "axis1_smoothing": ([_f32(rng, 4, 5, 3), rng.integers(0, 5, (4, 3))],
                            {"axis": 1, "label_smoothing": 0.1}),
        "ignore_all_weight": ([logits, np.full(6, -100)], {"weight": w}),
    }[case]


_CE_CASES = ["hard", "hard_col", "weight", "soft_label", "float_label",
             "soft_weight", "no_softmax", "smoothing", "soft_smoothing",
             "axis1", "axis1_smoothing", "ignore_all_weight"]


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("case", _CE_CASES)
def test_cross_entropy_matches_jax(case, reduction):
    """Every JAX argument (raised on the parent tree but for hard labels,
    mean reduction and the last axis), every reduction."""
    arrays, kw = _ce_case(case)
    kw = dict(kw, reduction=reduction)
    w = kw.pop("weight", None)

    def run(fn, weight_of):
        return lambda x, y: fn(x, y, weight=weight_of(w), **kw)
    _check(run(JF.cross_entropy, lambda a: None if a is None
               else paddle.to_tensor(a)),
           run(F.cross_entropy, lambda a: None if a is None
               else torch.from_numpy(a)), arrays, [0])


@pytest.mark.parametrize("return_softmax", [False, True])
@pytest.mark.parametrize("soft", [False, True])
def test_softmax_with_cross_entropy_matches_jax(soft, return_softmax):
    arrays, _ = _ce_case("soft_label" if soft else "hard")
    kw = dict(soft_label=soft, return_softmax=return_softmax)
    _check(lambda x, y: JF.softmax_with_cross_entropy(x, y, **kw),
           lambda x, y: F.softmax_with_cross_entropy(x, y, **kw), arrays,
           [0])


# -- the other functionals -----------------------------------------------------

def _cases():
    """case -> (functional, arrays, differentiable indices, keyword
    arguments)."""
    rng = _rng(2)
    x, y = _f32(rng, 4, 5), _f32(rng, 4, 5)
    logp = np.log(np.exp(x) / np.exp(x).sum(-1, keepdims=True)) \
        .astype(np.float32)
    lab = rng.integers(0, 5, 4)
    lab[2] = -100
    p = rng.uniform(0.05, 0.95, (4, 5)).astype(np.float32)
    bits = rng.integers(0, 2, (4, 5)).astype(np.float32)
    w5 = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    sign = np.where(rng.random(6) < 0.5, -1.0, 1.0).astype(np.float32)
    a, b = _f32(rng, 6), _f32(rng, 6)
    e1, e2, e3 = _f32(rng, 5, 4), _f32(rng, 5, 4), _f32(rng, 5, 4)
    kl_t = rng.uniform(0, 1, (4, 5)).astype(np.float32)
    kl_t[0, :2] = 0.0
    cos = rng.uniform(-0.95, 0.95, (6, 5)).astype(np.float32)
    clab = rng.integers(0, 5, 6)
    cos[0, clab[0]] = 1.0
    var = rng.uniform(0.1, 2.0, (4, 5)).astype(np.float32)
    var[0, 0] = 1e-8
    counts = rng.integers(0, 6, (4, 5)).astype(np.float32)
    dice_x = np.exp(_f32(rng, 3, 4, 4, 5))
    dice_x = (dice_x / dice_x.sum(-1, keepdims=True)).astype(np.float32)
    big = np.concatenate([_f32(rng, 2, 3, 5), _f32(rng, 2, 3, 5) * 0])
    nll3 = np.log(np.exp(big) / np.exp(big).sum(1, keepdims=True)) \
        .astype(np.float32)
    return {
        "nll_loss": ("nll_loss", [logp, lab], [0], {}),
        "nll_loss_weight": ("nll_loss", [logp, lab], [0], {"weight": w5}),
        "nll_loss_3d": ("nll_loss",
            [nll3, rng.integers(0, 3, (4, 5))], [0], {}),
        "mse_loss": ("mse_loss", [x, y], [0, 1], {}),
        "l1_loss": ("l1_loss", [x, y], [0, 1], {}),
        "smooth_l1_loss": ("smooth_l1_loss", [x, y], [0, 1], {"delta": 0.7}),
        "huber_loss": ("huber_loss", [x, y], [0, 1], {"delta": 0.7}),
        "binary_cross_entropy": ("binary_cross_entropy", [p, bits], [0], {}),
        "binary_cross_entropy_weight": ("binary_cross_entropy",
            [p, bits], [0], {"weight": w5}),
        "binary_cross_entropy_with_logits": ("binary_cross_entropy_with_logits",
            [x, bits], [0], {}),
        "bce_with_logits_weights": ("binary_cross_entropy_with_logits",
            [x, bits], [0], {"weight": w5,
                                                      "pos_weight": w5 * 2}),
        "bce_with_logits_pos_weight": ("binary_cross_entropy_with_logits",
            [x, bits], [0], {"pos_weight": w5}),
        "kl_div": ("kl_div", [logp, kl_t], [0], {}),
        "kl_div_batchmean": ("kl_div", [logp, kl_t], [0],
                             {"reduction": "batchmean"}),
        "kl_div_log_target": ("kl_div",
            [logp, np.log(kl_t + 0.1).astype(np.float32)],
                              [0], {"log_target": True}),
        "margin_ranking_loss": ("margin_ranking_loss",
            [a, b, sign], [0, 1], {"margin": 0.3}),
        "cosine_embedding_loss": ("cosine_embedding_loss",
            [e1, e2, np.where(sign[:5] > 0, 1, -1)],
                                  [0, 1], {"margin": 0.2}),
        "triplet_margin_loss": ("triplet_margin_loss",
            [e1, e2, e3], [0, 1, 2], {}),
        "triplet_margin_loss_p1_swap": ("triplet_margin_loss",
            [e1, e2, e3], [0, 1, 2],
                                        {"p": 1.0, "swap": True,
                                         "margin": 2.0}),
        "hinge_embedding_loss": ("hinge_embedding_loss",
            [a, sign], [0], {"margin": 0.5}),
        "square_error_cost": ("square_error_cost", [x, y], [0, 1], {}),
        "log_loss": ("log_loss", [p, bits], [0], {}),
        "sigmoid_focal_loss": ("sigmoid_focal_loss", [x, bits], [0], {}),
        "sigmoid_focal_loss_norm": ("sigmoid_focal_loss",
            [x, bits, np.float32([3.0])], [0],
                                    {"alpha": 0.4, "gamma": 1.5}),
        "margin_cross_entropy": ("margin_cross_entropy", [cos, clab], [0], {}),
        "margin_cross_entropy_softmax": ("margin_cross_entropy",
            [cos, clab], [0],
                                         {"return_softmax": True,
                                          "margin1": 0.9, "margin3": 0.1}),
        "dice_loss": ("dice_loss",
            [dice_x, rng.integers(0, 5, (3, 4, 4, 1))], [0], {}),
        "gaussian_nll_loss": ("gaussian_nll_loss", [x, y, var], [0, 2], {}),
        "gaussian_nll_loss_full": ("gaussian_nll_loss",
            [x, y, var], [0, 2], {"full": True}),
        "poisson_nll_loss": ("poisson_nll_loss", [x, counts], [0], {}),
        "poisson_nll_loss_rate": ("poisson_nll_loss", [p * 3, counts], [0],
                                  {"log_input": False, "full": True}),
        "soft_margin_loss": ("soft_margin_loss", [x, np.sign(y)], [0], {}),
        "multi_label_soft_margin_loss": ("multi_label_soft_margin_loss",
            [x, bits], [0], {}),
        "multi_label_soft_margin_loss_weight": ("multi_label_soft_margin_loss",
            [x, bits], [0],
                                                {"weight": w5}),
        "multi_margin_loss": ("multi_margin_loss",
            [x, rng.integers(0, 5, 4)], [0], {}),
        "multi_margin_loss_p2_weight": ("multi_margin_loss",
            [x, rng.integers(0, 5, 4)], [0],
                                        {"p": 2, "margin": 0.5,
                                         "weight": w5}),
        "pairwise_distance": ("pairwise_distance", [e1, e2], [0, 1], {}),
        "pairwise_distance_p1_keepdim": ("pairwise_distance", [e1, e2], [0, 1],
                                         {"p": 1.0, "keepdim": True}),
        "pairwise_distance_inf": ("pairwise_distance",
            [e1, e2], [0, 1], {"p": float("inf")}),
        "triplet_margin_with_distance_loss": ("triplet_margin_with_distance_loss",
            [e1, e2, e3], [0, 1, 2], {}),
        "triplet_margin_with_distance_loss_swap": ("triplet_margin_with_distance_loss",
            [e1, e2, e3], [0, 1, 2],
                                                   {"swap": True,
                                                    "margin": 3.0}),
        "npair_loss": ("npair_loss",
            [e1, e2, np.array([0, 1, 0, 2, 1])], [0, 1],
                       {"l2_reg": 0.01}),
    }


_REDUCED = {"mse_loss", "l1_loss", "smooth_l1_loss", "huber_loss",
            "binary_cross_entropy", "binary_cross_entropy_with_logits",
            "kl_div", "margin_ranking_loss", "cosine_embedding_loss",
            "triplet_margin_loss", "hinge_embedding_loss",
            "sigmoid_focal_loss", "margin_cross_entropy",
            "gaussian_nll_loss", "poisson_nll_loss", "soft_margin_loss",
            "multi_label_soft_margin_loss", "multi_margin_loss",
            "triplet_margin_with_distance_loss", "nll_loss"}


_WEIGHT_KW = ("weight", "pos_weight")


def _bind(fn, kw, to):
    def call(*ts):
        k = {n: (to(v) if n in _WEIGHT_KW else v) for n, v in kw.items()}
        return fn(*ts, **k)
    return call


_CASES = list(_cases())


@pytest.mark.parametrize("case", _CASES)
def test_loss_functionals_match_jax(case):
    """Each functional's value and gradients, its default reduction."""
    name, arrays, diff, kw = _cases()[case]
    _check(_bind(getattr(JF, name), kw, paddle.to_tensor),
           _bind(getattr(F, name), kw, torch.from_numpy), arrays, diff)


@pytest.mark.parametrize("reduction", ["sum", "none"])
@pytest.mark.parametrize("name", sorted(_REDUCED))
def test_loss_functionals_reductions_match_jax(name, reduction):
    """The other reductions."""
    _, arrays, diff, kw = _cases()[name]
    kw = dict(kw, reduction=reduction)
    _check(_bind(getattr(JF, name), kw, paddle.to_tensor),
           _bind(getattr(F, name), kw, torch.from_numpy), arrays, diff)


def test_margin_cross_entropy_gradient_is_finite_at_cosine_one():
    """The target's cosine is clipped inside (-1, 1), so a cosine of
    exactly 1 gives a finite gradient (zero there), as in JAX."""
    cos = np.full((2, 3), 0.5, np.float32)
    cos[:, 1] = 1.0
    x = torch.from_numpy(cos).requires_grad_()
    F.margin_cross_entropy(x, torch.tensor([1, 1])).backward()
    assert torch.isfinite(x.grad).all() and float(x.grad[:, 1].abs().max()) == 0


def test_margin_cross_entropy_refuses_a_group():
    with pytest.raises(NotImplementedError, match="one device"):
        F.margin_cross_entropy(torch.zeros(2, 3), torch.tensor([0, 1]),
                               group=object())


@pytest.mark.parametrize("custom", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_hsigmoid_loss_matches_jax(custom, bias):
    """The default tree (7 classes) and a custom ``path_table`` /
    ``path_code`` (paths of ragged length, -1 past their end)."""
    rng = _rng(3)
    x = _f32(rng, 5, 4)
    lab = rng.integers(0, 7, 5)
    w = _f32(rng, 6, 4)
    b = _f32(rng, 6, 1)
    arrays = [x, lab, w] + ([b] if bias else [])
    kw = {}
    if custom:
        table = rng.integers(0, 6, (5, 3))
        table[1, 2] = table[3, 1:] = -1
        kw = dict(path_table=table, path_code=rng.integers(0, 2, (5, 3)))

    def run(fn, to):
        def call(x, y, w, *rest):
            k = {n: to(v) for n, v in kw.items()}
            return fn(x, y, 7, w, rest[0] if rest else None, **k)
        return call
    _check(run(JF.hsigmoid_loss, paddle.to_tensor),
           run(F.hsigmoid_loss, torch.from_numpy), arrays,
           [0, 2, 3] if bias else [0, 2])


@pytest.mark.parametrize("head_bias", [False, True])
def test_adaptive_log_softmax_with_loss_matches_jax(head_bias):
    rng = _rng(4)
    x = _f32(rng, 6, 8)
    y = np.array([0, 2, 3, 5, 8, 11])
    hw = _f32(rng, 8, 5)
    tails = [(_f32(rng, 8, 2), _f32(rng, 2, 3)),
             (_f32(rng, 8, 1), _f32(rng, 1, 6))]
    hb = _f32(rng, 5)
    flat = [x, y, hw] + ([hb] if head_bias else []) + [a for t in tails
                                                       for a in t]
    cut = [3, 6, 12]

    def run(fn):
        def call(x, y, hw, *rest):
            hb_ = rest[0] if head_bias else None
            r = rest[1:] if head_bias else rest
            return fn(x, y, hw, [(r[0], r[1]), (r[2], r[3])], cut,
                      head_bias=hb_)
        return call
    _check(run(JF.adaptive_log_softmax_with_loss),
           run(F.adaptive_log_softmax_with_loss), flat,
           list(range(len(flat))[2:]) + [0])


# -- the layers ----------------------------------------------------------------

_LAYER_CASES = {
    "MSELoss": ((), "mse_loss"), "L1Loss": (("sum",), "l1_loss"),
    "NLLLoss": ((), "nll_loss"), "BCELoss": ((), "binary_cross_entropy"),
    "BCEWithLogitsLoss": ((), "binary_cross_entropy_with_logits"),
    "SmoothL1Loss": (("mean", 0.5), "smooth_l1_loss"),
    "HuberLoss": ((0.5,), "huber_loss"),
    "KLDivLoss": (("batchmean",), "kl_div"),
    "MarginRankingLoss": ((0.3,), "margin_ranking_loss"),
    "CosineEmbeddingLoss": ((0.2, "sum"), "cosine_embedding_loss"),
    "TripletMarginLoss": ((1.5, 1.0, 1e-6, True), "triplet_margin_loss"),
    "HingeEmbeddingLoss": ((0.5,), "hinge_embedding_loss"),
    "GaussianNLLLoss": ((True,), "gaussian_nll_loss"),
    "PoissonNLLLoss": ((False, True), "poisson_nll_loss_rate"),
    "SoftMarginLoss": (("none",), "soft_margin_loss"),
    "MultiLabelSoftMarginLoss": ((), "multi_label_soft_margin_loss"),
    "MultiMarginLoss": ((2, 0.5), "multi_margin_loss"),
    "TripletMarginWithDistanceLoss": ((None, 2.0, True),
                                      "triplet_margin_with_distance_loss"),
}


@pytest.mark.parametrize("layer", sorted(_LAYER_CASES))
def test_loss_layers_match_jax(layer):
    """Each layer with positional constructor arguments in the JAX
    order, on its functional's inputs; every port layer is a ``Layer``."""
    args, case = _LAYER_CASES[layer]
    _, arrays, diff, _ = _cases()[case]
    pl = getattr(pnn, layer)(*args)
    assert isinstance(pl, pnn.Layer)
    _check(getattr(paddle.nn, layer)(*args), pl, arrays, diff)


@pytest.mark.parametrize("case", ["weight", "soft_smoothing", "axis1"])
def test_cross_entropy_layer_matches_jax(case):
    arrays, kw = _ce_case(case)
    w = kw.pop("weight", None)
    jl = paddle.nn.CrossEntropyLoss(
        weight=None if w is None else paddle.to_tensor(w), **kw)
    pl = pnn.CrossEntropyLoss(
        weight=None if w is None else torch.from_numpy(w), **kw)
    _check(jl, pl, arrays, [0])


def _state(jl):
    return {n: np.asarray(t._data) for n, t in jl.named_state().items()}


def test_hsigmoid_layer_carries_the_jax_parameters():
    """``HSigmoidLoss``'s parameters carried from the JAX layer: the same
    names, then the same loss and gradients (weights included)."""
    rng = _rng(5)
    jl = paddle.nn.HSigmoidLoss(4, 7)
    pl = pnn.HSigmoidLoss(4, 7, device="cpu")
    assert list(pl.state_dict()) == list(jl.named_state())
    load_numpy_state(pl, _state(jl))
    x, y = _f32(rng, 5, 4), rng.integers(0, 7, 5)
    _check(lambda a, b: jl(a, b), lambda a, b: pl(a, b), [x, y], [0])
    jx = Tensor(jnp.asarray(x))
    jl(jx, paddle.to_tensor(y)).sum().backward()
    pl(torch.from_numpy(x), torch.from_numpy(y)).sum().backward()
    _close(pl.weight.grad, jl.weight.grad)
    _close(pl.bias.grad, jl.bias.grad)


@pytest.mark.parametrize("head_bias", [False, True])
def test_adaptive_log_softmax_layer_carries_the_jax_parameters(head_bias):
    """``AdaptiveLogSoftmaxWithLoss``: names, forward, ``log_prob`` and
    ``predict`` after the carry-over."""
    rng = _rng(6)
    jl = paddle.nn.AdaptiveLogSoftmaxWithLoss(8, 12, [3, 6], div_value=2.0,
                                              head_bias=head_bias)
    pl = pnn.AdaptiveLogSoftmaxWithLoss(8, 12, [3, 6], div_value=2.0,
                                        head_bias=head_bias, device="cpu")
    assert list(pl.state_dict()) == list(jl.named_state())
    load_numpy_state(pl, _state(jl))
    x, y = _f32(rng, 6, 8), np.array([0, 2, 3, 5, 8, 11])
    _check(lambda a, b: jl(a, b), lambda a, b: pl(a, b), [x, y], [0])
    _close(pl.log_prob(torch.from_numpy(x)), jl.log_prob(paddle.to_tensor(x)))
    assert np.array_equal(pl.predict(torch.from_numpy(x)).numpy(),
                          np.asarray(jl.predict(paddle.to_tensor(x))._data))


def test_loss_layers_with_parameters_take_attributes():
    """A ``ParamAttr`` initializer and ``bias_attr=False``."""
    from paddle_tpu_torch.nn.initializer import Constant, ParamAttr
    pl = pnn.HSigmoidLoss(3, 4, weight_attr=ParamAttr(
        initializer=Constant(0.5)), bias_attr=False, device="cpu")
    assert pl.bias is None and torch.equal(pl.weight, torch.full((3, 3), 0.5))
    with pytest.raises(ValueError):
        pnn.HSigmoidLoss(3, 1, device="cpu")
    with pytest.raises(ValueError):
        pnn.AdaptiveLogSoftmaxWithLoss(4, 5, [3, 2], device="cpu")
