"""The dense attention's middle (``kernels/dense_attention.py``) and
``nn.functional._sdpa_reference`` against the JAX package's
``_sdpa_reference`` on the CPU, where the wrapper runs the plain version.

The JAX function's probabilities are read through its output: with v the
identity over the keys (``v[b, t, h, t] = 1``) its output is the
probabilities. Covered: every mask form the kernels read (bool and
additive, at [sq, sk], [b, 1, 1, sk], [b, 1, sq, sk] and [b, h, sq, sk]),
causal with sq < sk and sq > sk (bottom-right), a row that sees no key,
a scale other than 1/sqrt(d), and gradients of q, k, v (and of an
additive mask) by ``jax.vjp`` at p 0. At p > 0 the JAX bits cannot be had
(its generator is not the port's): the keep mask equals
``kernels/dropout.py``'s for the same key, the kept values are the
probabilities times 1/(1 - p), the keep fraction is 1 - p within 5 sigma.

Tolerances: fp32, outputs within 1e-5 of the largest |value| (sums over
the keys in another order), gradients within 1e-4 of the largest.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional.attention import _sdpa_reference as jax_sdpa

from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.framework.random import RandomKey
from paddle_tpu_torch.kernels import dense_attention as DA
from paddle_tpu_torch.kernels import dropout as D
from paddle_tpu_torch.nn import functional as F

B, H = 2, 3


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def _mask(kind, sq, sk, rng):
    """A mask of ``kind`` ("bool" or "add") at one of the broadcast
    shapes, with a row of every head hidden for the bool one."""
    form, dtype = kind
    shape = {"2d": (sq, sk), "pad": (B, 1, 1, sk), "rows": (B, 1, sq, sk),
             "full": (B, H, sq, sk)}[form]
    if dtype == "bool":
        m = rng.random(shape) < 0.7
        if form in ("rows", "full"):
            m[..., 0, :] = False
        return m
    return (rng.standard_normal(shape) * 2).astype(np.float32)


def _identity_v(sk):
    v = np.zeros((B, sk, H, sk), np.float32)
    v[:, np.arange(sk), :, np.arange(sk)] = 1.0
    return v


MASKS = [None] + [(f, t) for f in ("2d", "pad", "rows", "full")
                  for t in ("bool", "add")]


@pytest.mark.parametrize("mask", MASKS,
                         ids=lambda m: "none" if m is None else "-".join(m))
@pytest.mark.parametrize("causal,sq,sk", [(False, 7, 7), (True, 5, 9),
                                          (True, 9, 5)])
def test_probs_match_jax(mask, causal, sq, sk):
    """``dense_softmax_plain``'s probabilities (the raw scores, the scale)
    equal the JAX function's, read through an identity v."""
    rng = np.random.default_rng(sq * sk)
    q = rng.standard_normal((B, sq, H, 8)).astype(np.float32)
    k = rng.standard_normal((B, sk, H, 8)).astype(np.float32)
    m = None if mask is None else _mask(mask, sq, sk, rng)
    want = jax_sdpa(jnp.asarray(q), jnp.asarray(k),
                    jnp.asarray(_identity_v(sk)),
                    mask=None if m is None else jnp.asarray(m),
                    causal=causal, scale=0.3)
    scores = torch.einsum("bshd,bthd->bhst", torch.from_numpy(q),
                          torch.from_numpy(k))
    probs, dropped = DA.dense_softmax_plain(
        scores, None if m is None else torch.from_numpy(m), causal, 0.3)
    assert dropped is probs
    _close(probs.permute(0, 2, 1, 3), want)


def test_a_row_without_a_key_averages_every_value():
    """A bool mask that hides a whole row gives it uniform probabilities
    (every score -1e30), as the JAX function."""
    scores = torch.randn(1, 1, 3, 5)
    m = torch.ones(3, 5, dtype=torch.bool)
    m[1] = False
    probs, _ = DA.dense_softmax_plain(scores, m, False, 1.0)
    torch.testing.assert_close(probs[0, 0, 1], torch.full((5,), 0.2))


@pytest.mark.parametrize("mask", [None, ("pad", "bool"), ("rows", "add")],
                         ids=lambda m: "none" if m is None else "-".join(m))
@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_reference_and_gradients_match_jax(mask, causal):
    """``_sdpa_reference`` (q, k, v [b, s, h, d]) and its gradients of q,
    k, v (and of an additive mask) equal ``jax.vjp`` of the JAX
    function's, at p 0."""
    rng = np.random.default_rng(11)
    sq, sk = 6, 9
    q = rng.standard_normal((B, sq, H, 16)).astype(np.float32)
    k = rng.standard_normal((B, sk, H, 16)).astype(np.float32)
    v = rng.standard_normal((B, sk, H, 16)).astype(np.float32)
    m = None if mask is None else _mask(mask, sq, sk, rng)
    g = rng.standard_normal((B, sq, H, 16)).astype(np.float32)
    add = m is not None and m.dtype != np.bool_
    jargs = [jnp.asarray(a) for a in (q, k, v)] + (
        [jnp.asarray(m)] if add else [])

    def jf(*a):
        mm = a[3] if add else (None if m is None else jnp.asarray(m))
        return jax_sdpa(a[0], a[1], a[2], mask=mm, causal=causal)
    want, vjp = jax.vjp(jf, *jargs)
    wgrads = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    mt = None if m is None else torch.from_numpy(m)
    if add:
        mt.requires_grad_()
    before = K.kernel_launches()
    out = F._sdpa_reference(*ts, mask=mt, causal=causal)
    grads = torch.autograd.grad(out, ts + ([mt] if add else []),
                                torch.from_numpy(g))
    assert K.kernel_launches() == before      # the plain version on the CPU
    _close(out, want)
    for got, w in zip(grads, wgrads):
        _close(got, w, 1e-4)


def test_scale_is_passed_on():
    """``_sdpa_reference(scale=)`` multiplies the scores by it (the JAX
    function's ``scale``), 1/sqrt(d) by default."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, 4, 2, 8)).astype(np.float32)
               for _ in range(3))
    for scale in (None, 0.7):
        want = jax_sdpa(*(jnp.asarray(a) for a in (q, k, v)), scale=scale)
        got = F._sdpa_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                                scale=scale)
        _close(got, want)


@pytest.mark.parametrize("sk", [64, 10])
def test_dropout_keeps_the_dropout_kernels_bits(sk):
    """At p > 0 the dropped probabilities are the probabilities times the
    fp32 1/(1 - p) where ``kernels/dropout.py``'s keep mask (the same key
    and site, the element's index in [b, h, sq, sk]) keeps them, 0
    elsewhere; the keep fraction is 1 - p within 5 sigma."""
    p = 0.2
    scores = torch.randn(4, 2, 32, sk, generator=torch.Generator()
                         .manual_seed(sk))
    key = RandomKey((123, 456), 7)
    probs, dropped = DA.dense_softmax_plain(scores, None, False, 0.5, p, key)
    keep = D.keep_mask_plain(tuple(scores.shape), p, key)
    want = torch.where(keep, probs * D.scale_of(p, "upscale_in_train"),
                       torch.zeros(()))
    assert torch.equal(dropped, want)
    n = keep.numel()
    frac = float(keep.float().mean())
    assert abs(frac - (1 - p)) <= 5 * (p * (1 - p) / n) ** 0.5


def test_dense_softmax_routes_cpu_to_the_plain_version():
    """On CPU tensors ``dense_softmax`` is the plain version's dropped
    probabilities and launches nothing; the kernels' wrappers refuse CPU
    tensors (no fallback)."""
    scores = torch.randn(2, 2, 5, 7)
    key = RandomKey((1, 2), 3)
    before = K.kernel_launches()
    got = DA.dense_softmax(scores, None, True, 0.25, 0.1, key)
    assert K.kernel_launches() == before
    assert torch.equal(got, DA.dense_softmax_plain(scores, None, True, 0.25,
                                                   0.1, key)[1])
    with pytest.raises(ValueError, match="CUDA"):
        DA.dense_softmax_forward(scores)
    with pytest.raises(ValueError, match="CUDA"):
        DA.dense_softmax_backward(scores, scores)


def test_without_a_key_nothing_is_dropped():
    scores = torch.randn(1, 1, 3, 4)
    assert torch.equal(DA.dense_softmax(scores, p=0.5),
                       torch.softmax(scores, -1))


@pytest.mark.parametrize("sk,want", [(1, (64, 1, True)), (64, (32, 16, True)),
                                     (77, (16, 32, True)),
                                     (512, (4, 128, True)),
                                     (4096, (1, 1024, True)),
                                     (8192, (1, 2048, True)),
                                     (10001, (1, 1024, False))])
def test_plan(sk, want):
    """Rows of up to MAX_ONE keys are one tile of ~2048 elements (R rows of
    the next power of two), longer ones chunks of CHUNK."""
    assert DA.plan(sk) == want


def test_mask_strides_broadcast_without_copies():
    """The kernels read a broadcast mask through strides 0 on its broadcast
    dimensions (no copy at [b, h, sq, sk]); a bool mask as bytes, an
    integer one as fp32."""
    shape = (2, 3, 4, 5)
    kind, m, st = DA._mask_args(torch.ones(2, 1, 1, 5, dtype=torch.bool),
                                shape, torch.device("cpu"))
    assert (kind, m.dtype, st) == (1, torch.uint8, (5, 0, 0, 1))
    kind, m, st = DA._mask_args(torch.zeros(4, 5), shape,
                                torch.device("cpu"))
    assert (kind, m.dtype, st) == (2, torch.float32, (0, 0, 5, 1))
    kind, m, _ = DA._mask_args(torch.zeros(4, 5, dtype=torch.int32), shape,
                               torch.device("cpu"))
    assert (kind, m.dtype) == (2, torch.float32)
    assert DA._mask_args(None, shape, torch.device("cpu"))[0] == 0
