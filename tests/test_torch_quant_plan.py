"""The weight-only GEMM's route and plan, on the CPU.

``kernels/quant_matmul.py`` decides in Python which of the two CUDA
kernels takes a call (``weight_only_gemm_takes``) and, for the wgmma
kernel, its plan: token tile, channel tile and split count, passed to the
kernel as they are. These tests hold that plan to covering every output
and K position exactly once, the route to taking every matrix of the
served models, and the split arithmetic (``weight_only_gemm_split_plain``,
the kernel's order of sums) to the JAX package's ``quant_matmul_arrays``
and to the port's plain version.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.quantization import _kernels as JK
from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.kernels import quant_matmul as QM
from paddle_tpu_torch.quantization import _kernels as PK

ALGOS = ["weight_only_int8", "weight_only_int4", "weight_only_fp8"]
DTYPE = {"weight_only_int8": torch.int8, "weight_only_int4": torch.int8,
         "weight_only_fp8": torch.float8_e4m3fn}

# (K, N) of every quantized matrix the port serves: Llama-2-7B's q/k/v/o,
# gate/up, down and head; GPT-2's qkv, attention out, fc in and fc out
SERVED = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000),
          (768, 2304), (768, 768), (768, 3072), (3072, 768)]
# tails: a partial stage, a partial channel tile, a single stage
TAILS = [(80, 136), (1000, 264), (64, 8)]
ROWS = [1, 8, 9, 200, 256, 257, 4096]


def _no_cluster_limit(token_tile, channel_tile, splits):
    """A card of 132 SMs whose clusters of any size use every SM."""
    per_sm = 2 if token_tile <= 8 else 1
    return 132 * per_sm // splits * splits


def _partition(ranges, end):
    """Whether the (lo, hi) ranges, each once, tile [0, end) in order."""
    pos = 0
    for lo, hi in sorted(ranges):
        if lo != pos or hi <= lo:
            return False
        pos = hi
    return pos == end


@pytest.mark.parametrize("capacity", [None, _no_cluster_limit],
                         ids=["h100", "no_cluster_limit"])
@pytest.mark.parametrize("k, n", SERVED + TAILS)
@pytest.mark.parametrize("m", ROWS)
def test_plan_covers_every_output_and_k_position_once(m, k, n, capacity):
    plan = QM.weight_only_gemm_plan(m, n, k, capacity)
    tn, tc, splits = plan
    assert (tn, tc) in QM.LARGE_TILES or (
        tn in QM.TOKEN_TILES and tc == QM.CHANNEL_TILE)
    assert 1 <= splits <= QM.MAX_SPLITS
    stages = -(-k // QM.STAGE_K)
    assert splits == 1 or splits * QM.MIN_SPLIT_STAGES <= stages
    if m <= 128:                      # the smallest tile that holds m
        assert tn == min(t for t in QM.TOKEN_TILES if t >= m)
    blocks = list(QM.weight_only_gemm_blocks(m, n, k, plan))
    tiles = {}
    for m0, m1, n0, n1, k0, k1 in blocks:
        tiles.setdefault((m0, m1, n0, n1), []).append((k0, k1))
    assert len(blocks) == splits * len(tiles)
    if splits > 1:                    # the blocks of a cluster fit at once
        cap = capacity or QM._h100_capacity
        assert len(blocks) <= cap(tn, tc, splits)
    assert _partition({(m0, m1) for m0, m1, _, _ in tiles}, m)
    assert _partition({(n0, n1) for _, _, n0, n1 in tiles}, n)
    for ranges in tiles.values():     # every K position once, in split order
        assert len(ranges) == splits and ranges == sorted(ranges)
        assert _partition(ranges, k)


@pytest.mark.parametrize("k, splits", [
    (k, s) for k in (64, 80, 1000, 4096, 11008) for s in (1, 2, 3, 5, 8)
    if s <= -(-k // 64)])            # the kernel refuses more splits
def test_k_ranges_are_whole_stages_in_order(k, splits):
    ranges = QM.weight_only_gemm_k_ranges(k, splits)
    assert _partition(ranges, k) and ranges == sorted(ranges)
    lengths = [-(-(hi - lo) // QM.STAGE_K) for lo, hi in ranges]
    assert all(lo % QM.STAGE_K == 0 for lo, _ in ranges)
    assert max(lengths) - min(lengths) <= 1


@pytest.mark.parametrize("m, k, n, tile, splits", [
    (8, 4096, 4096, (8, 128), None), (40, 4096, 4096, (64, 128), None),
    (100, 4096, 4096, (128, 128), None),
    (256, 4096, 4096, (256, 64), 2), (256, 11008, 4096, (256, 64), 2),
    (256, 4096, 11008, (256, 128), 1), (4096, 4096, 4096, (256, 128), 1),
    (4096, 11008, 4096, (256, 128), 1)])
def test_plan_choices_on_an_h100(m, k, n, tile, splits):
    """The plan's tile choices at the served shapes on an H100: the
    decode widths take the 8-token tile; the serving step's 4096-wide
    products 64-channel tiles split two ways, where 128-channel ones
    would need three splits and leave a quarter of the card idle; the
    11008-wide ones and the prefill 256 x 128 tiles."""
    plan = QM.weight_only_gemm_plan(m, n, k)
    assert (plan.token_tile, plan.channel_tile) == tile
    if splits is not None:
        assert plan.splits == splits


def _gemm_operands(m, k, n, algo, x_dtype=torch.bfloat16):
    ldw = (k + 1) // 2 if algo == "weight_only_int4" else k
    x2 = torch.empty(m, k, dtype=x_dtype)
    q = torch.empty(n, ldw, dtype=DTYPE[algo])
    s = torch.empty(n, dtype=torch.float32)
    return x2, q, s


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("k, n", SERVED)
@pytest.mark.parametrize("m", [1, 8, 256])
def test_served_matrices_take_the_wgmma_kernel(m, k, n, algo):
    assert QM.weight_only_gemm_takes(*_gemm_operands(m, k, n, algo))


@pytest.mark.parametrize("algo, k, n", [
    ("weight_only_int8", 33, 64), ("weight_only_int8", 200, 64),
    ("weight_only_int8", 4104, 64), ("weight_only_fp8", 200, 64),
    ("weight_only_int4", 200, 64),      # ceil(K/2) = 100: no 16-byte rows
    ("weight_only_int4", 33, 64), ("weight_only_int8", 64, 12)])
def test_unaligned_shapes_take_the_mma_sync_kernel(algo, k, n):
    assert not QM.weight_only_gemm_takes(*_gemm_operands(4, k, n, algo))


def test_the_route_sees_the_pointer():
    """A slice of a packed batch that starts off 16 bytes goes to the
    mma.sync kernel even though its shape is aligned; so does a weight or
    scale vector that starts off 16 bytes."""
    x2, q, s = _gemm_operands(4, 64, 64, "weight_only_int8")
    assert QM.weight_only_gemm_takes(x2, q, s)
    flat = torch.empty(4 * 64 + 1, dtype=torch.bfloat16)
    assert not QM.weight_only_gemm_takes(flat[1:].view(4, 64), q, s)
    qflat = torch.empty(64 * 64 + 8, dtype=torch.int8)
    assert not QM.weight_only_gemm_takes(x2, qflat[8:].view(64, 64), s)
    sflat = torch.empty(64 + 1, dtype=torch.float32)
    assert not QM.weight_only_gemm_takes(x2, q, sflat[1:])
    assert not QM.weight_only_gemm_takes(x2.T, q, s)   # not contiguous


def _weight(k, n, seed):
    return np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32) * 0.3


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("k, splits", [(320, 1), (320, 2), (320, 3),
                                       (320, 5), (33, 1), (1000, 4)])
def test_split_plain_matches_jax_in_float32(algo, k, splits):
    """In float32 the kernel's arithmetic (fp32 partials over whole
    stages, summed in split order, then the scale) is the JAX function's
    up to summation order: test_torch_quant.py's tolerance."""
    bits = JK.ALGO_BITS[algo]
    w = _weight(k, 40, seed=k + splits)
    x = np.random.default_rng(7).standard_normal((2, 5, k)).astype(
        np.float32)
    jq, js = JK.quantize_weight_arrays(jnp.asarray(w), bits=bits)
    pq, ps = PK.quantize_weight_arrays(torch.from_numpy(w), bits=bits)
    want = np.asarray(JK.quant_matmul_arrays(jnp.asarray(x), jq, js))
    got = QM.weight_only_gemm_split_plain(torch.from_numpy(x), pq, ps,
                                          QM.Plan(8, 128, splits))
    assert got.shape == (2, 5, 40) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("splits", [1, 2, 3, 6])
def test_split_plain_within_two_bf16_ulps_of_plain(algo, splits):
    """In bf16 every row of the split arithmetic is within 2 bf16 ulps of
    that row's largest value of the port's plain version (the rounding to
    bf16 before the scale moves by at most one step with the order)."""
    g = torch.Generator().manual_seed(splits)
    w = torch.randn(768, 96, generator=g) * 0.05
    q, s = PK.quantize_weight_arrays(w, bits=JK.ALGO_BITS[algo])
    x = torch.randn(24, 768, generator=g).to(torch.bfloat16)
    want = PK.quant_matmul_arrays(x, q, s).float()
    got = QM.weight_only_gemm_split_plain(x, q, s, QM.Plan(64, 128, splits))
    assert got.dtype == torch.bfloat16
    err = (got.float() - want).abs().amax(-1)
    tol = 2 * 2.0 ** -7 * want.abs().amax(-1)
    assert bool((err <= tol).all()), float((err / tol).max())


def test_the_cpu_wrapper_runs_the_plain_version_and_counts_nothing():
    q, s = PK.quantize_weight_arrays(torch.from_numpy(_weight(64, 16, 3)))
    x = torch.randn(3, 64, generator=torch.Generator().manual_seed(2)) \
        .to(torch.bfloat16)
    before = dict(K.LAUNCHES)
    y = QM.weight_only_gemm(x, q, s)
    assert torch.equal(y, PK.quant_matmul_arrays(x, q, s))
    assert K.LAUNCHES == before
    assert K.LAUNCHES["weight_only_gemm_sm80"] == before[
        "weight_only_gemm_sm80"]
