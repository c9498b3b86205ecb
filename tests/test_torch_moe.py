"""paddle_tpu_torch's grouped matmuls, routing, dropless MoE FFN and
MoELayer against paddle_tpu's, on the CPU.

The JAX grouped matmul runs its Pallas kernels in interpret mode (as
tests/test_gmm_pallas.py runs them); the port's wrappers take their plain
versions on CPU tensors, through the same autograd function the CUDA
kernels sit in. Inputs are made with numpy and handed to both.

Tolerances (float32): gmm forward and dx 1e-5, dw 1e-4 (as
tests/test_gmm_pallas.py holds the Pallas kernel to its oracle: sums of
16–32 products in another order); the MoE FFN, the layer's output and
l_aux 1e-5 (values O(1)); the layer's gradients 1e-5 plus 1e-4 relative
(sums over the tokens of such products). bfloat16 FFN: within 2^-6 of the
largest output value (two bf16 ulps: both round h, the activation and y
at the same places, in another summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.distributed.models.moe import MoELayer as JaxMoE
from paddle_tpu.kernels import fused_pallas as fp
from paddle_tpu.kernels import gmm_pallas as G

from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.incubate.distributed.models.moe import (MoELayer,
                                                              NaiveGate)
from paddle_tpu_torch.kernels import gmm as PG
from paddle_tpu_torch.models import load_numpy_state

SIZES = [
    [8, 8, 8, 8],        # tile-aligned
    [3, 13, 0, 16],      # ragged + empty group
    [32, 0, 0, 0],       # everything in one group
    [1, 1, 1, 29],       # many tiny groups in one tile
]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(fp, "_INTERPRET", True)
    yield


def _case(seed, sizes, t=32, k=16, n=16):
    rng = np.random.default_rng(seed)
    e = len(sizes)
    return (rng.standard_normal((t, k)).astype(np.float32),
            rng.standard_normal((e, k, n)).astype(np.float32),
            np.asarray(sizes, np.int32),
            rng.standard_normal((t, n)).astype(np.float32))


@pytest.mark.parametrize("sizes", SIZES)
def test_gmm_forward_matches_jax(sizes):
    x, w, gs, _ = _case(0, sizes)
    want = np.asarray(G.gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs),
                            bt=8, block=8))
    got = PG.gmm(torch.from_numpy(x), torch.from_numpy(w),
                 torch.from_numpy(gs)).numpy()
    rows = int(np.sum(sizes))
    np.testing.assert_allclose(got[:rows], want[:rows], rtol=1e-5, atol=1e-5)
    assert not got[rows:].any()          # rows past the groups are zeros
    # the transposed read of w: x . w[g]^T == gmm against the swapped bank
    wt = np.ascontiguousarray(np.swapaxes(w, 1, 2))
    got_t = PG.gmm(torch.from_numpy(x), torch.from_numpy(wt),
                   torch.from_numpy(gs), trans_w=True).numpy()
    np.testing.assert_allclose(got_t, got, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sizes", SIZES)
def test_gmm_grads_match_jax(sizes):
    """GMMFunction's backward (dx = gmm(dy, w^T), dw = tgmm(x, dy))
    against jax.grad of the Pallas gmm."""
    x, w, gs, ct = _case(1, sizes)

    def loss(x_, w_):
        return jnp.sum(G.gmm(x_, w_, jnp.asarray(gs), bt=8, block=8) * ct)

    jx, jw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    (PG.GMMFunction.apply(xt, wt, torch.from_numpy(gs))
     * torch.from_numpy(ct)).sum().backward()
    rows = int(np.sum(sizes))
    np.testing.assert_allclose(xt.grad.numpy()[:rows], np.asarray(jx)[:rows],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jw), rtol=1e-4,
                               atol=1e-4)


def test_tgmm_plain_is_zero_for_empty_groups():
    x, _, gs, dy = _case(2, [3, 0, 29, 0])
    dw = PG.tgmm(torch.from_numpy(x), torch.from_numpy(dy),
                 torch.from_numpy(gs))
    assert dw.dtype == torch.float32 and dw.shape == (4, 16, 16)
    assert not dw[1].any() and not dw[3].any()
    np.testing.assert_allclose(dw[0].numpy(), x[:3].T @ dy[:3], rtol=1e-5,
                               atol=1e-5)


def test_wrappers_check_shapes_and_devices():
    x, w, gs, dy = (torch.from_numpy(a) for a in _case(3, [8, 8, 8, 8]))
    with pytest.raises(ValueError):
        PG.gmm(x, w[:, :8], gs)                   # k does not fit
    with pytest.raises(ValueError):
        PG.gmm(x, w, gs[:3])                      # one size per group
    with pytest.raises(ValueError):
        PG.tgmm(x, dy[:5], gs)
    with pytest.raises(ValueError):
        PG.gmm(x, w.to("meta"), gs)
    before = K.kernel_launches()
    PG.gmm(x, w, gs)
    PG.tgmm(x, dy, gs)
    assert K.kernel_launches() == before      # CPU: no launch


def test_topk_route_breaks_ties_as_jax():
    """Planted ties (equal logits in one row, equal top-2 in another, a
    row of all equal): the port picks JAX's experts, lower index first."""
    logits = np.asarray([[1.0, 3.0, 3.0, 0.0, 3.0],
                         [2.0, 2.0, 1.0, 1.0, 1.0],
                         [0.5, 0.5, 0.5, 0.5, 0.5],
                         [0.1, -1.0, 4.0, 4.0, 0.0]], np.float32)
    for k in (1, 2, 3):
        jp, jv, ji = G.topk_route(jnp.asarray(logits), k)
        pp, pv, pi = PG.topk_route(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-6)
        np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=1e-6)
    bf = jnp.asarray(logits * 0.37).astype(jnp.bfloat16)
    _, _, ji = G.topk_route(bf, 2)
    _, _, pi = PG.topk_route(torch.from_numpy(logits * 0.37).bfloat16(), 2)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))


def test_route_sorted_is_the_stable_argsort():
    rng = np.random.default_rng(4)
    topi = torch.from_numpy(rng.integers(0, 6, (37, 2)))
    topi[:, 1] = (topi[:, 0] + 1 + torch.from_numpy(
        rng.integers(0, 5, 37))) % 6
    order, pos, gs = PG.route_sorted(topi, 6)
    flat = topi.reshape(-1)
    want = np.argsort(flat.numpy(), kind="stable")
    np.testing.assert_array_equal(order.numpy(), want)
    np.testing.assert_array_equal(pos.numpy(), np.argsort(want))
    np.testing.assert_array_equal(gs.numpy(),
                                  np.bincount(flat.numpy(), minlength=6))
    assert gs.dtype == torch.int32


def _ffn_inputs(seed, t=24, d=16, h=32, e=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, d)).astype(np.float32),
            rng.standard_normal((t, e)).astype(np.float32),
            (rng.standard_normal((e, d, h)) * 0.3).astype(np.float32),
            (rng.standard_normal((e, h)) * 0.1).astype(np.float32),
            (rng.standard_normal((e, h, d)) * 0.3).astype(np.float32),
            (rng.standard_normal((e, d)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("act", ["gelu", "tanh"])
def test_moe_dropless_ffn_matches_jax(act):
    """Output and aux at the default row tile of 128 (48 slot rows padded
    to 128, the padded rows with expert 0's biases)."""
    arrs = _ffn_inputs(5)
    jact = {"gelu": jax.nn.gelu, "tanh": jnp.tanh}[act]
    pact = {"gelu": PG.gelu_tanh, "tanh": torch.tanh}[act]
    want, jaux = G.moe_dropless_ffn(*[jnp.asarray(a) for a in arrs[:2]], 2,
                                    *[jnp.asarray(a) for a in arrs[2:]],
                                    act=jact)
    got, aux = PG.moe_dropless_ffn(*[torch.from_numpy(a) for a in arrs[:2]],
                                   2, *[torch.from_numpy(a)
                                        for a in arrs[2:]], act=pact)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_moe_dropless_ffn_bf16_matches_jax():
    arrs = _ffn_inputs(6)
    want, jaux = G.moe_dropless_ffn(
        *[jnp.asarray(a).astype(jnp.bfloat16) for a in arrs[:2]], 2,
        *[jnp.asarray(a).astype(jnp.bfloat16) for a in arrs[2:]])
    got, aux = PG.moe_dropless_ffn(
        *[torch.from_numpy(a).bfloat16() for a in arrs[:2]], 2,
        *[torch.from_numpy(a).bfloat16() for a in arrs[2:]])
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2.0 ** -6 * float(np.abs(want).max()))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def _layers(gate="gshard", seed=8):
    paddle.seed(seed)
    jl = JaxMoE(d_model=16, d_hidden=32, num_expert=4, top_k=2, gate=gate,
                dropless=True)
    pl = MoELayer(d_model=16, d_hidden=32, num_expert=4, top_k=2, gate=gate,
                  dropless=True, device="cpu")
    load_numpy_state(pl, {n: np.asarray(t._data)
                          for n, t in jl.named_state().items()})
    return jl, pl


@pytest.mark.parametrize("gate", ["gshard", "naive"])
def test_moe_layer_matches_jax(gate):
    """MoELayer(dropless=True): output, l_aux and every gradient (the
    banks, the gate and the input) of sum(out * ct) + 0.01 * l_aux against
    the JAX eager backward."""
    jl, pl = _layers(gate)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 7, 16)).astype(np.float32)
    ct = rng.standard_normal((3, 7, 16)).astype(np.float32)
    jx = paddle.to_tensor(x)
    jx.stop_gradient = False
    jout = jl(jx)
    jloss = (jout * paddle.to_tensor(ct)).sum()
    if jl.l_aux is not None:
        jloss = jloss + 0.01 * jl.l_aux
    jloss.backward()
    px = torch.from_numpy(x).requires_grad_()
    pout = pl(px)
    ploss = (pout * torch.from_numpy(ct)).sum()
    if gate == "naive":
        assert pl.l_aux is None and jl.l_aux is None
    else:
        np.testing.assert_allclose(float(pl.l_aux.detach()),
                                   float(jl.l_aux.numpy()),
                                   rtol=1e-5)
        assert pl.gate.get_loss() is pl.l_aux and pl.gate.loss is None
        ploss = ploss + 0.01 * pl.l_aux
    ploss.backward()
    np.testing.assert_allclose(pout.detach().numpy(), jout.numpy(),
                               rtol=1e-5, atol=1e-5)
    want = {n: p.grad.numpy() for n, p in jl.named_parameters()}
    got = dict(pl.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), w, atol=1e-5,
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(px.grad.numpy(), jx.grad.numpy(), atol=1e-5,
                               rtol=1e-4)


def test_moe_layer_refuses_unported_paths():
    _, pl = _layers()
    pl.dropless = False
    with pytest.raises(NotImplementedError, match="capacity"):
        pl(torch.zeros(2, 16))
    with pytest.raises(NotImplementedError, match="experts"):
        MoELayer(d_model=16, experts=[torch.nn.Identity()] * 4,
                 device="cpu")
    with pytest.raises(ValueError):
        MoELayer(d_model=16, gate="bogus", device="cpu")


def test_moe_layer_takes_a_gate_object():
    gate = NaiveGate(16, 3, top_k=2, device="cpu")
    layer = MoELayer(d_model=16, d_hidden=32, gate=gate, dropless=True,
                     device="cpu")
    assert layer.num_expert == 3 and layer.w1.shape == (3, 16, 32)
    out = layer(torch.randn(5, 16))
    assert out.shape == (5, 16) and layer.l_aux is None
