"""paddle_tpu_torch's common functionals and layers against paddle_tpu's,
on the CPU: ``one_hot``, ``pad`` in every mode and layout, ``interpolate``
in every mode (nearest, linear, bilinear, trilinear, bicubic, area) with
and without ``align_corners``, downsampling (JAX antialiases), channel-last
and 3-D to 5-D inputs, ``unfold`` / ``fold``, the shuffles,
``cosine_similarity``, ``label_smooth``, ``bilinear``, outputs and input
gradients, and the layers of ``common.py`` (``Bilinear`` and
``SpectralNorm`` with the JAX layer's parameters and buffers carried
across by ``load_numpy_state``). The random ones (``dropout2d`` /
``dropout3d``, ``alpha_dropout``, ``feature_alpha_dropout``,
``class_center_sample``, ``SpectralNorm``'s initial vectors) draw from the
port's generator, whose bits cannot be JAX's: they are held to their
distributions and to determinism.

Inputs are made with numpy from a seed and handed to both sides.

Tolerance: within 1e-5 of the largest reference value (at least 1), for
outputs and gradients: both evaluate the same formula in float32 (the
resize weights are built by the same steps; the products sum in another
order). Moments: within 5 standard errors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.tensor import Tensor

import paddle_tpu_torch as ptt
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


def _check(jfn, pfn, arrays, diff=(0,), seed=0):
    """Output and the gradients of the inputs at ``diff``."""
    jts = [Tensor(jnp.asarray(a), stop_gradient=i not in diff)
           for i, a in enumerate(arrays)]
    pts = [torch.from_numpy(a.copy()).requires_grad_(i in diff)
           for i, a in enumerate(arrays)]
    jo, po = jfn(*jts), pfn(*pts)
    assert str(po.dtype).replace("torch.", "") == str(jo._data.dtype)
    _close(po, jo)
    if diff:
        ct = np.random.default_rng(seed).standard_normal(tuple(po.shape)) \
            .astype(np.float32)
        (jo * Tensor(jnp.asarray(ct))).sum().backward()
        (po * torch.from_numpy(ct)).sum().backward()
        for i in diff:
            _close(pts[i].grad, jts[i].grad)


def _x(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def test_one_hot_matches_jax():
    """fp32 rows; an index outside the classes gives a row of zeros."""
    ids = np.array([[0, 3, 4], [2, 5, -1]])
    _close(F.one_hot(torch.from_numpy(ids), 5),
           JF.one_hot(paddle.to_tensor(ids), 5))
    assert F.one_hot(torch.from_numpy(ids), 5).dtype == torch.float32


_PADS = {
    "nchw_2": ((2, 3, 4, 5), [1, 2, 2, 1], None),
    "nhwc_2": ((2, 4, 5, 3), [1, 2, 2, 1], "NHWC"),
    "ncl_1": ((2, 3, 6), [2, 1], "NCL"),
    "nlc_1": ((2, 6, 3), [2, 1], "NLC"),
    "ncdhw_3": ((1, 2, 3, 4, 5), [1, 1, 2, 0, 0, 2], "NCDHW"),
    "full_rank": ((2, 3, 4, 5), [0, 1, 1, 0, 2, 1, 1, 2], None),
}


@pytest.mark.parametrize("mode", ["constant", "reflect", "replicate",
                                  "circular"])
@pytest.mark.parametrize("case", sorted(_PADS))
def test_pad_matches_jax(case, mode):
    """Every mode on the spatial axes from the last (channels first or
    last) and on every axis given 2 * ndim values."""
    shape, pad, fmt = _PADS[case]
    kw = dict(mode=mode, value=0.5, data_format=fmt)
    _check(lambda x: JF.pad(x, pad, **kw), lambda x: F.pad(x, pad, **kw),
           [_x(*shape)])


def test_zeropad2d_and_pad_from_left_axis():
    """``zeropad2d`` is constant 0; ``pad_from_left_axis`` is accepted and
    not read, as in the JAX function."""
    x = _x(2, 3, 4, 4)
    _check(lambda t: JF.zeropad2d(t, [1, 0, 2, 1]),
           lambda t: F.zeropad2d(t, [1, 0, 2, 1]), [x])
    t = torch.from_numpy(x)
    assert torch.equal(F.pad(t, [1, 0, 2, 1], pad_from_left_axis=False),
                       F.pad(t, [1, 0, 2, 1]))


_RESIZES = {
    "bilinear_up": ((2, 3, 5, 6), dict(scale_factor=2, mode="bilinear")),
    "bilinear_down": ((2, 3, 12, 10), dict(size=[5, 4], mode="bilinear")),
    "bilinear_odd": ((1, 2, 7, 5), dict(size=[9, 3], mode="bilinear")),
    "bicubic_up": ((2, 3, 5, 6), dict(scale_factor=[1.6, 2.5],
                                      mode="bicubic")),
    "bicubic_down": ((2, 3, 12, 11), dict(size=[5, 4], mode="bicubic")),
    "area_down": ((2, 3, 12, 10), dict(size=[3, 5], mode="area")),
    "linear_ncl": ((2, 3, 9), dict(size=[4], mode="linear",
                                   data_format="NCL")),
    "linear_nlc": ((2, 9, 3), dict(size=[14], mode="linear",
                                   data_format="NLC")),
    "trilinear": ((1, 2, 3, 4, 5), dict(size=[5, 2, 7], mode="trilinear",
                                        data_format="NCDHW")),
    "trilinear_ndhwc": ((1, 3, 4, 5, 2), dict(scale_factor=2,
                                              mode="trilinear",
                                              data_format="NDHWC")),
    "bilinear_nhwc": ((2, 5, 6, 3), dict(size=[8, 3], mode="bilinear",
                                         data_format="NHWC")),
    "bilinear_corners": ((2, 3, 5, 6), dict(size=[9, 4], mode="bilinear",
                                            align_corners=True)),
    "bicubic_corners": ((2, 3, 5, 6), dict(scale_factor=2, mode="bicubic",
                                           align_corners=True)),
    "corners_to_one": ((1, 2, 5, 6), dict(size=[1, 4], mode="bilinear",
                                          align_corners=True)),
    "nearest_nhwc": ((2, 5, 6, 3), dict(size=[8, 3], data_format="NHWC")),
    "nearest_5d": ((1, 2, 3, 4, 5), dict(scale_factor=2,
                                         data_format="NCDHW")),
    "nearest_3d_odd": ((2, 3, 7), dict(size=[10], data_format="NCL")),
}


@pytest.mark.parametrize("case", sorted(_RESIZES))
def test_interpolate_matches_jax(case):
    """Every mode: ``jax.image.resize``'s weights (antialiased when
    shrinking; Keys' cubic with a = -0.5; "area" as linear), the two-tap
    gather with ``align_corners``, nearest's index rule; channel-first and
    channel-last, 3-D to 5-D."""
    shape, kw = _RESIZES[case]
    _check(lambda x: JF.interpolate(x, **kw),
           lambda x: F.interpolate(x, **kw), [_x(*shape)])


def test_interpolate_differs_from_torch_where_jax_does():
    """Downsampling antialiases and bicubic uses a = -0.5: neither is
    ``torch.nn.functional.interpolate``'s result."""
    x = torch.from_numpy(_x(1, 1, 12, 12))
    for kw in (dict(size=[4, 4], mode="bilinear"),
               dict(size=[20, 20], mode="bicubic")):
        ours = F.interpolate(x, **kw)
        theirs = torch.nn.functional.interpolate(x, **kw)
        assert float((ours - theirs).abs().max()) > 1e-2


def test_upsample_layers_match_jax():
    x = _x(2, 3, 4, 5)
    for name, args in (("Upsample", dict(scale_factor=2, mode="bicubic")),
                       ("UpsamplingNearest2D", dict(size=[7, 9])),
                       ("UpsamplingBilinear2D", dict(scale_factor=2))):
        _check(getattr(paddle.nn, name)(**args), getattr(pnn, name)(**args),
               [x])
    _check(lambda t: JF.upsample(t, scale_factor=3, mode="bilinear"),
           lambda t: F.upsample(t, scale_factor=3, mode="bilinear"), [x])


@pytest.mark.parametrize("k,s,p,d", [(2, 1, 0, 1), (3, 2, 1, 1),
                                     ([2, 3], [1, 2], [1, 0], [2, 1])])
def test_unfold_and_fold_match_jax(k, s, p, d):
    x = _x(2, 3, 7, 8)
    _check(lambda t: JF.unfold(t, k, s, p, d),
           lambda t: F.unfold(t, k, s, p, d), [x])
    cols = F.unfold(torch.from_numpy(x), k, s, p, d).numpy()
    _check(lambda t: JF.fold(t, [7, 8], k, s, p, d),
           lambda t: F.fold(t, [7, 8], k, s, p, d), [cols])
    _check(paddle.nn.Unfold(k, s, p, d), pnn.Unfold(k, s, p, d), [x])
    _check(paddle.nn.Fold([7, 8], k, s, p, d), pnn.Fold([7, 8], k, s, p, d),
           [cols])


@pytest.mark.parametrize("axis", [1, -1])
def test_cosine_similarity_matches_jax(axis):
    a, b = _x(3, 4, 5), _x(3, 4, 5, seed=2)
    a[0, :, 0] = 0.0                               # a zero vector: the floor
    _check(lambda x, y: JF.cosine_similarity(x, y, axis=axis),
           lambda x, y: F.cosine_similarity(x, y, axis=axis), [a, b],
           (0, 1))
    _check(paddle.nn.CosineSimilarity(axis), pnn.CosineSimilarity(axis),
           [a, b], (0, 1))


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_shuffles_match_jax(fmt):
    x = _x(2, 8, 4, 6) if fmt == "NCHW" else _x(2, 4, 6, 8)
    for fn, layer, r in (("pixel_shuffle", "PixelShuffle", 2),
                         ("pixel_unshuffle", "PixelUnshuffle", 2),
                         ("channel_shuffle", "ChannelShuffle", 4)):
        _check(lambda t: getattr(JF, fn)(t, r, fmt),
               lambda t: getattr(F, fn)(t, r, fmt), [x])
        _check(getattr(paddle.nn, layer)(r, fmt),
               getattr(pnn, layer)(r, fmt), [x])


def test_label_smooth_matches_jax():
    lab = np.eye(5, dtype=np.float32)[[0, 3, 1]]
    prior = np.full(5, 0.2, np.float32)
    _check(lambda t: JF.label_smooth(t, epsilon=0.2),
           lambda t: F.label_smooth(t, epsilon=0.2), [lab])
    _check(lambda t: JF.label_smooth(t, Tensor(jnp.asarray(prior)), 0.3),
           lambda t: F.label_smooth(t, torch.from_numpy(prior), 0.3), [lab])


@pytest.mark.parametrize("bias", [False, True])
def test_bilinear_functional_matches_jax(bias):
    x1, x2, w, b = _x(4, 3), _x(4, 5, seed=2), _x(2, 3, 5, seed=3), \
        _x(1, 2, seed=4)
    arrays = [x1, x2, w] + ([b] if bias else [])
    _check(JF.bilinear, F.bilinear, arrays, tuple(range(len(arrays))))


def _state(jl):
    return {n: np.asarray(t._data) for n, t in jl.named_state().items()}


def test_bilinear_layer_carries_the_jax_parameters():
    jl = paddle.nn.Bilinear(3, 5, 2)
    pl = pnn.Bilinear(3, 5, 2, device="cpu")
    assert list(pl.state_dict()) == list(jl.named_state())
    load_numpy_state(pl, _state(jl))
    _check(jl, pl, [_x(4, 3), _x(4, 5, seed=2)], (0, 1))
    nb = pnn.Bilinear(3, 5, 2, bias_attr=False, device="cpu")
    assert nb.bias is None and list(nb.state_dict()) == ["weight"]


def test_spectral_norm_carries_the_jax_vectors():
    """With the JAX layer's ``weight_u`` / ``weight_v`` carried across: the
    normalised weight, its gradient (through the power iteration, as
    JAX's) and the vectors each call leaves (two calls)."""
    jl = paddle.nn.SpectralNorm([4, 3, 2], dim=1, power_iters=2)
    pl = pnn.SpectralNorm([4, 3, 2], dim=1, power_iters=2, device="cpu")
    assert list(pl.state_dict()) == list(jl.named_state()) \
        == ["weight_u", "weight_v"]
    load_numpy_state(pl, _state(jl))
    w = _x(4, 3, 2)
    for _ in range(2):
        _check(jl, pl, [w])
        _close(pl.weight_u, jl.weight_u)
        _close(pl.weight_v, jl.weight_v)


def test_spectral_norm_draws_unit_vectors_from_the_seed():
    ptt.seed(3)
    a = pnn.SpectralNorm([6, 5], device="cpu")
    ptt.seed(3)
    b = pnn.SpectralNorm([6, 5], device="cpu")
    c = pnn.SpectralNorm([6, 5], device="cpu")
    assert torch.equal(a.weight_u, b.weight_u)
    assert not torch.equal(a.weight_u, c.weight_u)
    for t in (a.weight_u, a.weight_v):
        assert abs(float(torch.linalg.vector_norm(t)) - 1) < 1e-5
    assert a.weight_u.shape == (6,) and a.weight_v.shape == (5,)


def test_stateless_layers_match_jax():
    x = _x(2, 3, 4, 5)
    for jl, pl in (
            (paddle.nn.Unflatten(1, [3, 1]), pnn.Unflatten(1, [3, 1])),
            (paddle.nn.Softmax2D(), pnn.Softmax2D()),
            (paddle.nn.Pad2D([1, 0, 2, 1], "reflect"),
             pnn.Pad2D([1, 0, 2, 1], "reflect")),
            (paddle.nn.Pad2D(1, "circular", data_format="NHWC"),
             pnn.Pad2D(1, "circular", data_format="NHWC")),
            (paddle.nn.ZeroPad2D([1, 1, 0, 2]), pnn.ZeroPad2D([1, 1, 0, 2])),
    ):
        _check(jl, pl, [x])
    x3, x5 = _x(2, 3, 5), _x(1, 2, 3, 4, 5)
    _check(paddle.nn.Pad1D([2, 1], "replicate"),
           pnn.Pad1D([2, 1], "replicate"), [x3])
    _check(paddle.nn.ZeroPad1D(2), pnn.ZeroPad1D(2), [x3])
    _check(paddle.nn.Pad3D(1, "replicate"), pnn.Pad3D(1, "replicate"), [x5])
    _check(paddle.nn.ZeroPad3D([1, 0, 0, 1, 2, 0]),
           pnn.ZeroPad3D([1, 0, 0, 1, 2, 0]), [x5])
    e1, e2 = _x(4, 6), _x(4, 6, seed=2)
    _check(paddle.nn.PairwiseDistance(1.0, keepdim=True),
           pnn.PairwiseDistance(1.0, keepdim=True), [e1, e2], (0, 1))
    with pytest.raises(ValueError):
        pnn.Softmax2D()(torch.zeros(2, 3))


# -- the random ones ------------------------------------------------------

@pytest.mark.parametrize("fn,shape,fmt,axes", [
    ("dropout2d", (40, 50, 3, 3), "NCHW", (0, 1)),
    ("dropout2d", (40, 3, 3, 50), "NHWC", (0, 3)),
    ("dropout3d", (40, 50, 2, 2, 2), "NCDHW", (0, 1)),
    ("dropout3d", (40, 2, 2, 2, 50), "NDHWC", (0, 4))])
def test_channel_dropout_drops_whole_maps(fn, shape, fmt, axes):
    """A (sample, channel) map is kept whole (times 1 / (1 - p)) or
    dropped whole; the kept share is 1 - p within 5 standard errors; the
    same seed gives the same mask; eval is the identity."""
    p = 0.3
    x = torch.ones(shape)
    ptt.seed(7)
    y = getattr(F, fn)(x, p, data_format=fmt)
    ptt.seed(7)
    assert torch.equal(y, getattr(F, fn)(x, p, data_format=fmt))
    other = [a for a in range(len(shape)) if a not in axes]
    maps = y.amax(dim=other)
    assert torch.equal(maps, y.amin(dim=other))
    assert set(torch.unique(maps).tolist()) <= {0.0, np.float32(1 / (1 - p))}
    n = maps.numel()
    kept = float((maps > 0).float().mean())
    assert abs(kept - (1 - p)) <= 5 * np.sqrt(p * (1 - p) / n)
    assert torch.equal(getattr(F, fn)(x, p, training=False), x)
    layer = (pnn.Dropout2D if fn == "dropout2d" else pnn.Dropout3D)(
        p, data_format=fmt)
    layer.eval()
    assert torch.equal(layer(x), x)


@pytest.mark.parametrize("feature", [False, True])
def test_alpha_dropout_keeps_selu_statistics(feature):
    """On standard normals (SELU's fixed point) the output's mean and
    variance stay 0 and 1 (within 5 standard errors); dropped values are
    ``a alpha' + b``; the feature form drops whole channel maps; the same
    seed gives the same result; eval is the identity."""
    p = 0.2
    x = torch.from_numpy(_x(64, 32, 8, 8, seed=5))
    fn = F.feature_alpha_dropout if feature else F.alpha_dropout
    ptt.seed(8)
    y = fn(x, p)
    ptt.seed(8)
    assert torch.equal(y, fn(x, p))
    n = y.numel()
    assert abs(float(y.mean())) <= 5 * np.sqrt(1.0 / n) * (8 if feature
                                                           else 1)
    assert abs(float(y.var()) - 1.0) <= 5 * np.sqrt(2.0 / n) * (8 if feature
                                                                else 1)
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = (1 - p + alpha_p ** 2 * (1 - p) * p) ** -0.5
    dropped_value = a * alpha_p - a * alpha_p * p
    dropped = torch.isclose(y, torch.tensor(dropped_value), atol=1e-6)
    if feature:
        per_map = dropped.float().mean(dim=(2, 3))
        assert set(torch.unique(per_map).tolist()) <= {0.0, 1.0}
    assert abs(float(dropped.float().mean()) - p) < 0.05
    for layer in (pnn.AlphaDropout(p), pnn.FeatureAlphaDropout(p)):
        layer.eval()
        assert torch.equal(layer(x), x)


def test_alpha_dropout_matches_jax_given_the_same_mask():
    """The JAX formula, fed the port's keep mask: with every element kept
    it is the affine map alone, as JAX's at p small enough to keep all."""
    x = torch.from_numpy(_x(4, 6))
    p = 1e-9
    want = JF.alpha_dropout(paddle.to_tensor(x.numpy()), p)
    _close(F.alpha_dropout(x, p), want)


def test_class_center_sample_keeps_positives_and_samples_negatives():
    """Every positive class is kept, the set is sorted and ``num_samples``
    long, the remapped labels index it; each negative is drawn with the
    same probability (frequencies over seeds within 5 standard errors);
    the same seed, the same sample; positives past ``num_samples`` are
    all kept."""
    lab = torch.tensor([3, 7, 3, 12, 0])
    counts = torch.zeros(20)
    runs = 400
    for s in range(runs):
        ptt.seed(s)
        remapped, sampled = F.class_center_sample(lab, 20, 8)
        assert sampled.dtype == torch.int64 and len(sampled) == 8
        assert torch.equal(sampled, torch.sort(sampled).values)
        assert torch.equal(sampled[remapped], lab)
        counts[sampled] += 1
    pos = torch.tensor([0, 3, 7, 12])
    assert torch.equal(counts[pos], torch.full((4,), float(runs)))
    neg = torch.ones(20, dtype=torch.bool)
    neg[pos] = False
    q = 4 / 16
    assert float((counts[neg] / runs - q).abs().max()) <= \
        5 * np.sqrt(q * (1 - q) / runs)
    ptt.seed(1)
    a = F.class_center_sample(lab, 20, 8)
    ptt.seed(1)
    assert all(torch.equal(u, v) for u, v in
               zip(a, F.class_center_sample(lab, 20, 8)))
    _, all_pos = F.class_center_sample(lab, 20, 2)
    assert torch.equal(all_pos, pos)
    with pytest.raises(NotImplementedError):
        F.class_center_sample(lab, 20, 8, group=object())
