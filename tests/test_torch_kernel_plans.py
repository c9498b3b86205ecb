"""The launch plans of the recurrence's forward and backward
(``kernels/rnn.py`` ``rnn_forward_plan``, ``rnn_backward_plan``), of
BatchNorm's forward and backward (``kernels/batch_norm.py``
``batch_norm_forward_plan``, ``batch_norm_backward_plan``), of the
LayerNorm backward (``kernels/fused.py`` ``layer_norm_backward_plan``), of
GroupNorm's forward and backward (``kernels/group_norm.py``
``group_norm_forward_plan``, ``group_norm_backward_plan``) and of the
dense attention's forward (``kernels/dense_attention.py``
``dense_softmax_forward_plan``), on the CPU: pure Python, no ``triton``,
no ``nvcc``, no card; and the CPU emulations of the CUDA normalisations'
fixed-order sums against float64 (GroupNorm's forward also against the
JAX ``group_norm``).

What they must hold for the kernels they pick: the persistent kernel's
grid at most one block an SM (its blocks wait on each other at every
step: all must be resident), shared memory within the 232,448 bytes a
block may use, the persistent kernel only where T > 1 and H % 4 == 0; the
cluster kernel only for a channels-first bf16 or fp16 x in training whose
channel fits on chip over at most 8 blocks. The shapes are the main
paths': the IWSLT'15 attention LSTM's (phase 18 of ``chip_smoke.py``:
its encoder, decoder cells and beam step) and ResNet-50's 53 BatchNorms
at batch 128.
"""
import math

import pytest
import torch

from paddle_tpu_torch.kernels import batch_norm as BN
from paddle_tpu_torch.kernels import fused as FU
from paddle_tpu_torch.kernels import group_norm as GN
from paddle_tpu_torch.kernels import rnn as R

SMS = 132               # the H100's SMs
SMEM = 232448           # shared memory a block may use


# -- the recurrence's forward ------------------------------------------------

# (mode, T, B, H, route): phase 18's encoder layers, its decoder cells and
# beam step, and phase 3's timed cases
_RNN_MAIN = [("lstm", 50, 128, 512, "persistent"),
             ("gru", 50, 128, 512, "persistent"),
             ("rnn_tanh", 50, 128, 512, "persistent"),
             ("lstm", 1, 128, 512, "step"),
             ("lstm", 1, 1280, 512, "step")]


@pytest.mark.parametrize("mode,T,B,H,route", _RNN_MAIN,
                         ids=lambda v: str(v))
def test_rnn_plan_routes_the_main_paths(mode, T, B, H, route):
    plan = R.rnn_forward_plan(mode, T, B, H, SMS)
    assert plan.route == route
    assert plan.launches == (1 if route == "persistent" else T)
    assert plan.smem <= SMEM


@pytest.mark.parametrize("mode", sorted(R.MODES))
@pytest.mark.parametrize("T", [1, 2, 9, 50])
def test_rnn_plan_keeps_within_the_card(mode, T):
    """Every plan fits a block's shared memory; a persistent grid fits on
    the SMs at one block each; the step kernel's grid covers every row
    and unit (B and H on and off the tiles)."""
    for B in (1, 5, 37, 128, 130, 256, 1280):
        for H in (8, 40, 42, 96, 512, 1024):
            plan = R.rnn_forward_plan(mode, T, B, H, SMS)
            assert plan.smem <= SMEM
            units, rows = plan.grid
            assert units * 16 >= H and rows * plan.rows >= B
            assert units * 16 - H < 16 and rows * plan.rows - B < plan.rows
            if plan.route == "persistent":
                assert T > 1 and H % 4 == 0
                assert units * rows <= SMS and plan.launches == 1
                assert plan.rows == 32
            else:
                assert plan.route == "step" and plan.launches == T
                assert plan.rows in (32, 64)


def test_rnn_plan_sends_what_the_persistent_kernel_cannot_hold_to_steps():
    # the LSTM's slice of W_hh at H 1024 is 16 x 4 x 1028 x 4 bytes: too big
    assert R.rnn_forward_plan("lstm", 50, 128, 1024, SMS).route == "step"
    # more row blocks than SMs: not co-resident
    assert R.rnn_forward_plan("lstm", 50, 256, 512, SMS).route == "step"
    # the same shape on a card with more SMs fits
    assert R.rnn_forward_plan("lstm", 50, 256, 512, 264).route == \
        "persistent"
    # H % 4 != 0: no 16-byte copies of h
    assert R.rnn_forward_plan("gru", 9, 37, 42, SMS).route == "step"
    # a cell call is a step whatever its size
    assert R.rnn_forward_plan("rnn_tanh", 1, 37, 40, SMS).route == "step"


def test_rnn_plan_shared_memory_is_the_kernels():
    """The bytes the plan states are those the CUDA source computes for the
    launch (``persistent_floats`` and ``step_floats`` of
    ``csrc/rnn_recurrence.cu``), at the main paths' shapes."""
    assert R.rnn_forward_plan("lstm", 50, 128, 512, SMS).smem == \
        4 * (16 * 4 * 516 + max(32 * 516, 16384))
    assert R.rnn_forward_plan("gru", 50, 128, 512, SMS).smem == \
        4 * (16 * 3 * 516 + max(32 * 516, 16384))
    # step kernel: three stages of (32 WM rows + 16 G rows of W_hh) x 132
    assert R.rnn_forward_plan("lstm", 1, 128, 512, SMS).smem == \
        4 * 3 * (32 + 64) * 132
    assert R.rnn_forward_plan("lstm", 1, 1280, 512, SMS).smem == \
        4 * 3 * (64 + 64) * 132


def test_rnn_plan_refuses_unknown_modes():
    with pytest.raises(ValueError):
        R.rnn_forward_plan("lstmp", 2, 4, 8, SMS)


# -- BatchNorm's backward ----------------------------------------------------

def _resnet50_bn_calls(batch=128):
    """The 53 BatchNorm inputs of a ResNet-50 forward at [batch, 3, 224,
    224], in order, as (n, c, h): the stem's; each block's three (the
    stride on its 3 x 3, so the first BatchNorm of a stage's first block
    sees the stage's input size) and the first block's downsample."""
    calls = [(batch, 64, 112)]
    hw = 56
    for planes, blocks, stride in ((64, 3, 1), (128, 4, 2), (256, 6, 2),
                                   (512, 3, 2)):
        out = hw // stride
        for i in range(blocks):
            calls += [(batch, planes, hw if i == 0 else out),
                      (batch, planes, out), (batch, 4 * planes, out)]
            if i == 0:
                calls.append((batch, 4 * planes, out))
        hw = out
    return calls


def test_resnet50_has_53_batch_norms():
    assert len(_resnet50_bn_calls()) == 53


@pytest.mark.parametrize("stage", [112, 56, 28, 14, 7])
def test_batch_norm_plan_routes_resnet50(stage):
    """bf16 x under amp O1, training: 28 x 28 and below on the cluster
    kernel (41 of the 53), a cluster a channel, 56 x 56 and 112 x 112 on
    the two Triton kernels."""
    calls = [k for k in _resnet50_bn_calls() if k[2] == stage]
    assert calls
    for n, c, h in calls:
        plan = BN.batch_norm_backward_plan(n, c, h * h, False,
                                           torch.bfloat16, True, SMS)
        if h <= 28:
            route, cs, smem = plan
            assert route == "cluster" and cs in (1, 2, 4, 8)
            assert smem <= BN._CLUSTER_BLOCK_BYTES <= SMEM
            assert math.ceil(n / cs) * h * h * 6 <= smem
        else:
            assert plan[0] == "two_pass"


def test_batch_norm_plan_counts_41_cluster_calls_in_resnet50():
    routes = [BN.batch_norm_backward_plan(n, c, h * h, False, torch.bfloat16,
                                          True, SMS)[0]
              for n, c, h in _resnet50_bn_calls()]
    assert routes.count("cluster") == 41 and routes.count("two_pass") == 12


@pytest.mark.parametrize("shape,plan", [
    ((128, 2048, 49), ("cluster", 1)),
    ((128, 1024, 196), ("cluster", 2)),
    ((128, 512, 784), ("cluster", 8)),
    ((128, 256, 3136), ("two_pass",)),
    ((5, 7, 25), ("cluster", 1)),
    ((128, 8, 400), ("cluster", 4)),
    ((1, 2048, 2), ("cluster", 1)),        # many channels, two values each
])
def test_batch_norm_plan_layouts(shape, plan):
    got = BN.batch_norm_backward_plan(*shape, False, torch.bfloat16, True,
                                      SMS)
    assert got[:len(plan)] == plan


@pytest.mark.parametrize("channels_last,dtype,batch_stats", [
    (True, torch.bfloat16, True),      # NHWC
    (False, torch.float32, True),      # fp32 x
    (False, torch.bfloat16, False),    # the eval backward
])
@pytest.mark.parametrize("shape", [(128, 2048, 49), (128, 512, 784),
                                   (32, 256, 3136)])
def test_batch_norm_plan_two_pass_where_the_cluster_kernel_does_not_take(
        channels_last, dtype, batch_stats, shape):
    plan = BN.batch_norm_backward_plan(*shape, channels_last, dtype,
                                       batch_stats, SMS)
    assert plan[0] == "two_pass"
    # the Triton kernels' tiles and chunks, as the two-pass route takes them
    assert plan[1] * plan[2] <= 8192 and plan[3] >= 1


@pytest.mark.parametrize("n,c,s", [(1, 1, 2), (3, 5, 7), (16, 12, 1),
                                   (128, 64, 12544), (2, 3, 4),
                                   (37, 11, 25), (128, 4096, 49),
                                   (1, 2048, 2), (1, 4096, 4),
                                   (4, 512, 3), (2, 65536, 2)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_batch_norm_plan_keeps_within_the_card(n, c, s, dtype):
    """A cluster-kernel block holds its channel's share and its sums
    within the plan's budget (two blocks an SM), whatever the channels,
    down to a channel of two values."""
    plan = BN.batch_norm_backward_plan(n, c, s, False, dtype, True, SMS)
    if s == 1:
        assert plan[0] == "two_pass"
    if plan[0] == "cluster":
        _, cs, smem = plan
        assert smem == BN._cluster_smem(n, s, cs)
        assert 6 * math.ceil(n / cs) * s + 176 <= smem \
            <= BN._CLUSTER_BLOCK_BYTES <= SMEM


# -- the recurrence's backward -----------------------------------------------

def test_rnn_backward_plan_routes_the_main_paths():
    """Phase 18's encoder layers and decoder cells and phase 3's timed
    layers on the persistent kernel (one launch, the forward's grid), the
    beam step's 1280 rows (40 row groups: more blocks than SMs) on the
    step route (two launches a step), every shape within the card."""
    for mode, T, B, H, _ in _RNN_MAIN:
        plan = R.rnn_backward_plan(mode, T, B, H, SMS)
        route = "step" if B == 1280 else "persistent"
        assert plan.route == route, (mode, T, B, H)
        assert plan.launches == (1 if route == "persistent" else 2 * T)
        assert plan.smem <= SMEM
        if route == "persistent":
            assert plan.grid == (32, 4)
    # the beam step: 8 x 40 tiles of 32 rows by 64 columns
    assert R.rnn_backward_plan("lstm", 1, 1280, 512, SMS).grid == (8, 40)


def test_rnn_backward_plan_keeps_within_the_card():
    """Every plan fits a block's shared memory; a persistent grid fits on
    the SMs at one block each; the step route's grid covers every row and
    column (B and H on and off the tiles: 32 rows by 16 units persistent,
    by 64 columns on the step route)."""
    for mode in sorted(R.MODES):
        for T in (1, 2, 9, 50):
            for B in (1, 5, 37, 128, 130, 256, 1280):
                for H in (8, 40, 42, 96, 512, 516, 1024):
                    plan = R.rnn_backward_plan(mode, T, B, H, SMS)
                    assert plan.smem <= SMEM
                    cols, rows = plan.grid
                    assert rows * plan.rows >= B
                    assert rows * plan.rows - B < plan.rows
                    if plan.route == "persistent":
                        assert H % 4 == 0
                        assert plan.rows == 32
                        assert cols * rows <= SMS and plan.launches == 1
                        assert cols * 16 >= H and cols * 16 - H < 16
                    else:
                        assert plan.route == "step" and plan.rows == 32
                        assert plan.launches == 2 * T
                        assert cols == math.ceil(H / 64)


def test_rnn_backward_plan_sends_what_the_persistent_kernel_cannot_hold():
    # the LSTM's slice of W_hh at H 1024 is 16 x 4 x 1028 x 4 bytes: too big
    assert R.rnn_backward_plan("lstm", 50, 128, 1024, SMS).route == "step"
    # the GRU's fits (16 x 3 x 1028 x 4 bytes, its gradients and sums) where
    # its 64 x 2 blocks do
    assert R.rnn_backward_plan("gru", 50, 64, 1024, SMS).route == \
        "persistent"
    # more row blocks than SMs: not co-resident
    assert R.rnn_backward_plan("lstm", 50, 256, 512, SMS).route == "step"
    assert R.rnn_backward_plan("lstm", 50, 256, 512, 264).route == \
        "persistent"
    # H % 4 != 0: no 16-byte copies
    assert R.rnn_backward_plan("gru", 9, 37, 42, SMS).route == "step"
    assert R.rnn_backward_plan("gru", 1, 37, 42, SMS).route == "step"
    # a cell call takes the persistent kernel where it fits, as a layer does
    assert R.rnn_backward_plan("rnn_tanh", 1, 37, 40, SMS).route == \
        "persistent"
    with pytest.raises(ValueError):
        R.rnn_backward_plan("lstmp", 2, 4, 8, SMS)


def test_rnn_backward_plan_shared_memory_is_the_kernels():
    """The bytes the plan states are those the CUDA source computes
    (``bwd_persistent_floats`` and ``bwd_step_floats`` of
    ``csrc/rnn_recurrence.cu``), at the main paths' shapes."""
    # persistent: W_hh's 16 G rows of 516, the gradients 16 G x 32, the
    # two halves' sums 2 x 32 x 16
    for mode, g in (("lstm", 4), ("gru", 3), ("rnn_tanh", 1)):
        assert R.rnn_backward_plan(mode, 50, 128, 512, SMS).smem == \
            4 * (16 * g * 516 + 16 * g * 32 + 2 * 32 * 16)
    # step: three stages of 32 rows x 132 and 128 rows of W_hh x 64
    assert R.rnn_backward_plan("lstm", 1, 1280, 512, SMS).smem == \
        4 * 3 * (32 * 132 + 128 * 64)


# -- BatchNorm's forward -----------------------------------------------------

# the forward's route at each ResNet-50 size, batch 128, bf16 training:
# (route, blocks a cluster)
_FWD_RESNET = {7: ("cluster", 1), 14: ("cluster", 1), 28: ("cluster", 2),
               56: ("cluster", 8), 112: ("triton",)}


def test_batch_norm_forward_plan_routes_resnet50():
    """bf16 x under amp O1, training: every call of ResNet-50's 53 at 7 x
    7, 14 x 14, 28 x 28 and 56 x 56 on the cluster kernel (one block a
    channel, one, a cluster of 2, of 8), the stem on the Triton kernels; a
    block's bytes hold its share of the channel."""
    for n, c, h in _resnet50_bn_calls():
        plan = BN.batch_norm_forward_plan(n, c, h * h, False, torch.bfloat16,
                                          True, SMS)
        want = _FWD_RESNET[h]
        assert plan[:len(want)] == want, (n, c, h)
        if plan[0] == "cluster":
            assert 2 * math.ceil(n / plan[1]) * h * h <= plan[2] \
                <= BN._CLUSTER_BLOCK_BYTES <= SMEM


def test_batch_norm_forward_plan_keeps_within_the_card():
    """A cluster-kernel block holds its channel's share and its sums
    within the plan's budget (two blocks an SM), whatever the channels,
    down to a channel of two values; one of a single value (s == 1) takes
    the Triton kernels."""
    for n, c, s in ((1, 1, 2), (3, 5, 7), (16, 12, 1), (128, 64, 12544),
                    (2, 3, 4), (37, 11, 25), (128, 4096, 49), (1, 2048, 2),
                    (1, 4096, 4), (4, 512, 3), (2, 65536, 2),
                    (75, 3, 784), (77, 2, 3136)):
        for dtype in (torch.bfloat16, torch.float16):
            plan = BN.batch_norm_forward_plan(n, c, s, False, dtype, True,
                                              SMS)
            if s == 1:
                assert plan[0] == "triton"
            if plan[0] == "cluster":
                _, cs, smem = plan
                assert cs in (1, 2, 4, 8)
                assert smem == BN._fwd_cluster_smem(n, s, cs)
                assert 2 * math.ceil(n / cs) * s + 4 * (12 + 16) <= smem \
                    <= BN._CLUSTER_BLOCK_BYTES <= SMEM


def test_batch_norm_forward_plan_triton_where_the_cluster_does_not_take():
    """Channels last, fp32 x, eval (already one kernel) and the stem's
    112 x 112 take the Triton kernels, with their tiles and chunks."""
    for shape in ((128, 2048, 49), (128, 512, 784), (32, 256, 3136)):
        for channels_last, dtype, batch_stats in (
                (True, torch.bfloat16, True), (False, torch.float32, True),
                (False, torch.bfloat16, False)):
            plan = BN.batch_norm_forward_plan(*shape, channels_last, dtype,
                                              batch_stats, SMS)
            assert plan[0] == "triton"
            assert plan[1] * plan[2] <= 8192 and plan[3] >= 1
    assert BN.batch_norm_forward_plan(128, 64, 112 * 112, False,
                                      torch.bfloat16, True, SMS)[0] == \
        "triton"


# -- the LayerNorm backward ---------------------------------------------------

# (rows, n, dtype, calls a step): ERNIE's 32 x 512 tokens (bf16), GPT-MoE's
# 8 x 1024 (bf16), the UNet's transformer blocks at batch 4 (fp32 under O2:
# the black list) at 64 x 64, 32 x 32, 16 x 16 and 8 x 8, Transformer-base's
# 64 x 64 tokens (fp32 under O1)
_LN_MAIN = [(16384, 768, torch.bfloat16, 26), (8192, 768, torch.bfloat16, 25),
            (16384, 320, torch.float32, 15), (4096, 640, torch.float32, 15),
            (1024, 1280, torch.float32, 15), (256, 1280, torch.float32, 3),
            (4096, 512, torch.float32, 30)]


def _ln_plan_holds(plan, rows, n, esize):
    """What the CUDA kernel needs of a "warp" plan."""
    assert plan.blocks * 8 * plan.rows >= rows > plan.blocks * 8 * (
        plan.rows - 1) or plan.rows == 1
    assert plan.chunks * 256 >= n
    assert plan.smem == FU._ln_smem(n, esize) <= SMEM
    per_sm = 2 if esize == 2 and plan.chunks <= 3 else 1
    assert plan.smem <= FU._LN_BLOCK_BYTES[per_sm]
    assert plan.blocks <= SMS * per_sm
    # the warps' three column sums fit where their rings were
    assert 8 * 3 * n * 4 <= plan.smem - 4 * n


def test_layer_norm_backward_plan_routes_the_models():
    """Every LayerNorm of ERNIE, GPT-MoE, the UNet and Transformer-base
    (26, 25, 48 and 30 a step) takes the CUDA kernel."""
    assert sum(k for *_, k in _LN_MAIN) == 26 + 25 + 48 + 30
    for rows, n, dtype, _ in _LN_MAIN:
        plan = FU.layer_norm_backward_plan(rows, n, dtype, SMS)
        assert plan.route == "warp", (rows, n, dtype)
        _ln_plan_holds(plan, rows, n, 4 if dtype == torch.float32 else 2)
    # ERNIE's: two blocks an SM, 8 rows a warp; the UNet's fp32 rows one
    # block an SM
    assert FU.layer_norm_backward_plan(16384, 768, torch.bfloat16, SMS) \
        == FU.LnBwdPlan("warp", 264, 8, 76800, 3)
    assert FU.layer_norm_backward_plan(16384, 320, torch.float32, SMS)[:3] \
        == ("warp", 132, 16)


def test_layer_norm_backward_plan_keeps_within_the_card():
    """Widths of a multiple of 8 up to 1280 in the three dtypes take the
    CUDA kernel within a block's shared memory and the grid's rows;
    others take the Triton kernel's programs, which cover every row."""
    for dtype, esize in ((torch.float32, 4), (torch.bfloat16, 2),
                         (torch.float16, 2)):
        for n in (1, 4, 8, 16, 64, 130, 256, 320, 512, 520, 640, 768, 1000,
                  1024, 1280, 1288, 2048, 4096):
            for rows in (1, 7, 8, 9, 255, 2112, 4096, 16384, 100003):
                plan = FU.layer_norm_backward_plan(rows, n, dtype, SMS)
                if n % 8 == 0 and n <= 1280:
                    assert plan.route == "warp"
                    _ln_plan_holds(plan, rows, n, esize)
                else:
                    assert plan.route == "triton"
                    assert plan.blocks * plan.rows >= rows
                    assert plan.blocks <= 4 * SMS and plan.chunks * 4 >= n


def test_layer_norm_backward_plan_triton_for_what_the_kernel_does_not_take():
    """Odd widths (the tests' 130), widths past 1280, and dtypes the
    kernel lacks keep the Triton kernel."""
    for rows, n, dtype in ((15, 130, torch.bfloat16), (16384, 1288,
                                                        torch.bfloat16),
                           (64, 4096, torch.float32),
                           (64, 768, torch.float64), (64, 4, torch.float32)):
        plan = FU.layer_norm_backward_plan(rows, n, dtype, SMS)
        assert plan.route == "triton" and plan.smem == 0


def _ln_float64_sums(h, w, dy, eps, p=0.0, key=None):
    """dweight, dnorm_bias, dbias in float64 from the rounded dh the
    kernel writes (rounding dh is part of the function)."""
    from paddle_tpu_torch.kernels import dropout as D
    hd = h.double()
    m = hd.mean(-1, keepdim=True)
    rstd = 1.0 / torch.sqrt(((hd - m) ** 2).mean(-1, keepdim=True) + eps)
    xh = (hd - m) * rstd
    g = dy.double() * w.double()
    dh = rstd * (g - g.mean(-1, keepdim=True)
                 - xh * (g * xh).mean(-1, keepdim=True))
    dh = dh.to(h.dtype).double()
    if p:
        keep = D.keep_mask_plain(tuple(h.shape), p, key)
        dh = torch.where(keep, (dh * D.scale_of(p, "upscale_in_train"))
                         .to(h.dtype).double(), torch.zeros((),
                                                            dtype=dh.dtype))
    return (dy.double() * xh).sum(0), dy.double().sum(0), dh.sum(0)


@pytest.mark.parametrize("rows,n,dtype,p,sms", [
    (300, 64, torch.float32, 0.0, 4), (300, 136, torch.float32, 0.1, 2),
    (77, 520, torch.float32, 0.0, 3), (40, 1280, torch.float32, 0.0, 1),
    (257, 96, torch.bfloat16, 0.1, 2)])
def test_layer_norm_split_sums_match_float64(rows, n, dtype, p, sms):
    """The kernel's order of sums (rows over warps and blocks, lanes'
    chunks, xor trees, warps in order, the column sum's thread rows) on
    the CPU in fp32 against float64: each sum within 1e-5 of the sum of
    its terms' magnitudes."""
    from paddle_tpu_torch.framework.random import RandomKey
    g = torch.Generator().manual_seed(rows + n)
    h = (1 + torch.randn(rows, n, generator=g)).to(dtype)
    dy = torch.randn(rows, n, generator=g).to(dtype)
    w = 1 + 0.1 * torch.randn(n, generator=g)
    key = RandomKey((7, 9), 3) if p else None
    plan = FU.layer_norm_backward_plan(rows, n, dtype, sms)
    assert plan.route == "warp" and plan.blocks * 8 * plan.rows >= rows
    got = FU.layer_norm_backward_split_plain(h, w, dy, 1e-5, plan, p, key)
    want = _ln_float64_sums(h, w, dy, 1e-5, p, key)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        scale = float(b.abs().max()) + rows
        assert float((a.double() - b).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("rows,n,sms", [(300, 64, 4), (16384, 768, 132),
                                        (5000, 1280, 132), (9, 8, 2)])
def test_layer_norm_column_sums_split_order_is_only_additions(rows, n, sms):
    """The kernel's order of column sums adds its addends and nothing
    else: small integers (exact in fp32 in any order) sum to torch's sum,
    and every row is counted once."""
    plan = FU.layer_norm_backward_plan(rows, n, torch.bfloat16, sms)
    g = torch.Generator().manual_seed(rows)
    terms = torch.randint(-8, 9, (2, rows, n), generator=g).float()
    got = FU.layer_norm_column_sums_split_plain(terms, plan)
    assert got.shape == (2, n) and torch.equal(got, terms.sum(1))


def test_xor_tree_sums_every_lane():
    t = torch.arange(64, dtype=torch.float32).reshape(2, 32)
    s = FU.xor_tree_plain(t)
    assert torch.equal(s, t.sum(-1, keepdim=True).expand(2, 32))


# -- GroupNorm's backward -----------------------------------------------------

def _unet_group_norm_calls(batch=4):
    """The 61 GroupNorm inputs of the SD 1.5 UNet at 64 x 64 latents, as
    (n, c, h): each resnet's two norms, each transformer's, conv_norm_out
    (channels (320, 640, 1280, 1280), two resnets a down block and three an
    up block, the skips concatenated)."""
    ch = (320, 640, 1280, 1280)
    calls, skips, hw, c = [], [320], 64, 320
    for i, out in enumerate(ch):
        for _ in range(2):
            calls += [(batch, c, hw), (batch, out, hw)]
            c = out
            if i < 3:
                calls.append((batch, c, hw))
            skips.append(c)
        if i < 3:
            hw //= 2
            skips.append(c)
    calls += [(batch, c, hw)] * 2 + [(batch, c, hw)] + [(batch, c, hw)] * 2
    for i, out in enumerate(reversed(ch)):
        for _ in range(3):
            calls += [(batch, c + skips.pop(), hw), (batch, out, hw)]
            c = out
            if i > 0:
                calls.append((batch, c, hw))
        if i < 3:
            hw *= 2
    calls.append((batch, c, hw))
    return calls


def test_unet_has_61_group_norms_of_14_shapes():
    calls = _unet_group_norm_calls()
    assert len(calls) == 61 and len(set(calls)) == 14
    assert (4, 960, 64) in calls and (4, 2560, 8) in calls


def test_group_norm_backward_plan_routes_the_unet():
    """Every GroupNorm of the UNet (bf16 x under O2, G 32) takes the
    cluster kernel, and instance_norm's G = C at its shapes."""
    for n, c, h in _unet_group_norm_calls():
        plan = GN.group_norm_backward_plan(c // 32, h * h, False,
                                           torch.bfloat16)
        assert plan.route == "cluster", (n, c, h)
        assert plan.cs in (1, 2, 4, 8)
        assert plan.smem <= GN._CLUSTER_BLOCK_BYTES <= SMEM
        assert 6 * math.ceil(c // 32 / plan.cs) * h * h <= plan.smem
    assert GN.group_norm_backward_plan(30, 4096, False,
                                       torch.bfloat16)[:2] == ("cluster", 8)
    assert GN.group_norm_backward_plan(10, 4096, False,
                                       torch.bfloat16)[:2] == ("cluster", 4)
    assert GN.group_norm_backward_plan(80, 64, False,
                                       torch.bfloat16)[:2] == ("cluster", 1)
    assert GN.group_norm_backward_plan(1, 64 * 64, False,
                                       torch.float16)[:2] == ("cluster", 1)


def test_group_norm_backward_plan_keeps_within_the_card():
    """The fewest blocks of a power of two up to 8 whose share of a group
    fits; what fits nowhere, NHWC, fp32 and spatial sizes off a multiple
    of 8 take the Triton kernels, whose tiles cover the group."""
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for last in (False, True):
            for cg in (1, 2, 3, 10, 30, 40, 80, 200, 600):
                for s in (1, 7, 8, 64, 63, 256, 1024, 4096, 16384, 65536):
                    plan = GN.group_norm_backward_plan(cg, s, last, dtype)
                    fits = [cs for cs in (1, 2, 4, 8)
                            if GN._cluster_smem(cg, s, cs)
                            <= GN._CLUSTER_BLOCK_BYTES
                            and -(-cg // cs) <= 512]
                    if not last and dtype != torch.float32 and s % 8 == 0 \
                            and fits:
                        assert plan == GN.GnBwdPlan(
                            "cluster", fits[0], GN._cluster_smem(cg, s,
                                                                 fits[0]))
                        assert plan.smem <= SMEM
                    else:
                        assert plan == GN.GnBwdPlan("triton", 0, 0)
                        bc, bs, chunk, chunks = GN._plan(4, 32, cg, s, SMS)
                        assert chunk * chunks >= s and bc * bs <= 8192


@pytest.mark.parametrize("shape,groups,cs", [
    ((2, 64, 16, 16), 8, 1), ((3, 30, 8, 8), 3, 4), ((9, 40, 4, 8), 4, 8),
    ((2, 160, 4, 8), 2, 1), ((17, 6, 64, 64), 6, 1)])
def test_group_norm_column_sums_split_order_is_only_additions(shape, groups,
                                                              cs):
    """The cluster kernel's order of sums adds its addends and nothing
    else: small integers (exact in fp32 in any order) sum to torch's sum
    over samples and space, every element counted once."""
    n, c = shape[:2]
    g = torch.Generator().manual_seed(sum(shape))
    t = torch.randint(-8, 9, (n, c, shape[2] * shape[3]), generator=g).float()
    got = GN.group_norm_column_sums_split_plain(t, groups, cs)
    assert torch.equal(got, t.sum((0, 2)))


@pytest.mark.parametrize("shape,groups,cs,silu", [
    ((2, 64, 16, 16), 8, 1, False), ((2, 64, 16, 16), 8, 2, True),
    ((3, 30, 8, 8), 3, 4, True), ((2, 40, 4, 8), 4, 8, False),
    ((1, 6, 16, 16), 6, 1, True), ((2, 160, 4, 8), 2, 1, True)])
def test_group_norm_split_sums_match_float64(shape, groups, cs, silu):
    """The cluster kernel's order of sums (a group's channels over cluster
    ranks, a warp a channel with its lanes' vectors and the xor tree, the
    ranks in order, the samples' column sum) on the CPU in fp32 against
    float64: dweight, dbias and the groups' sums within 1e-5 of the sum of
    their terms' magnitudes."""
    g = torch.Generator().manual_seed(sum(shape) + cs)
    x = (3 + 2 * torch.randn(*shape, generator=g)).to(torch.bfloat16)
    dy = torch.randn(*shape, generator=g)
    c = shape[1]
    w = 1 + 0.2 * torch.randn(c, generator=g)
    b = 0.2 * torch.randn(c, generator=g)
    dw, db, sa, sb = GN.group_norm_backward_split_plain(x, groups, w, b, dy,
                                                        cs, silu)
    n, cg = shape[0], c // groups
    xd = x.double().reshape(n, groups, cg, -1)
    m = xd.mean(dim=(2, 3), keepdim=True)
    rstd = 1.0 / torch.sqrt(((xd - m) ** 2).mean(dim=(2, 3), keepdim=True)
                            + 1e-5)
    xh = (xd - m) * rstd
    dz = dy.double().reshape(n, groups, cg, -1)
    if silu:
        z = xh * w.double().reshape(1, groups, cg, 1) \
            + b.double().reshape(1, groups, cg, 1)
        sg = torch.sigmoid(z)
        dz = dz * sg * (1 + z * (1 - sg))
    a_c = (dz * xh).sum(-1)                       # [n, G, cg]
    b_c = dz.sum(-1)
    wd = w.double().reshape(1, groups, cg)
    want = (a_c.sum(0).reshape(c), b_c.sum(0).reshape(c),
            (wd * a_c).sum(-1), (wd * b_c).sum(-1))
    mag = float(dz.abs().sum()) * float(xh.abs().max()) * float(
        w.abs().max())
    for got, ref in zip((dw, db, sa, sb), want):
        assert got.dtype == torch.float32
        assert float((got.double() - ref).abs().max()) <= 1e-5 * mag


# -- GroupNorm's forward ------------------------------------------------------

def test_group_norm_forward_plan_routes_the_unet():
    """Every GroupNorm of the UNet (bf16 x under O2, G 32) takes the cluster
    forward, within the two-blocks-an-SM budget, and instance_norm's G = C
    at its shapes; the plan reads only the group's shape, the layout and
    x's dtype, so the SiLU and the output's dtype cannot change it (the
    fused SiLU and the separate O2 ops take the same statistics)."""
    import inspect
    assert list(inspect.signature(GN.group_norm_forward_plan).parameters) \
        == ["cg", "s", "channels_last", "dtype"]
    for n, c, h in _unet_group_norm_calls():
        plan = GN.group_norm_forward_plan(c // 32, h * h, False,
                                          torch.bfloat16)
        assert plan.route == "cluster", (n, c, h)
        assert plan.cs in (1, 2, 4, 8)
        assert plan.smem <= GN._CLUSTER_BLOCK_BYTES <= SMEM
        vectors = math.ceil(c // 32 * h * h / 8 / plan.cs)
        assert plan.smem == GN._FWD_HEAD_BYTES + 16 * vectors
        assert plan == GN.group_norm_forward_plan(c // 32, h * h, False,
                                                  torch.float16)
    for cg, s in ((1, 56 * 56), (1, 64 * 64), (1, 8)):
        assert GN.group_norm_forward_plan(cg, s, False,
                                          torch.bfloat16)[:2] == ("cluster", 1)
    assert GN.group_norm_forward_plan(30, 4096, False,
                                      torch.bfloat16)[:2] == ("cluster", 4)
    assert GN.group_norm_forward_plan(10, 4096, False,
                                      torch.bfloat16)[:2] == ("cluster", 1)


def test_group_norm_forward_plan_keeps_within_the_card():
    """The fewest blocks of a power of two up to 8 whose share of a group
    fits; NHWC, fp32, spatial sizes off a multiple of 8 and groups that fit
    nowhere take the Triton kernels."""
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for last in (False, True):
            for cg in (1, 2, 3, 10, 30, 40, 80, 200, 600):
                for s in (1, 7, 8, 64, 63, 256, 1024, 4096, 16384, 65536):
                    plan = GN.group_norm_forward_plan(cg, s, last, dtype)
                    fits = [cs for cs in (1, 2, 4, 8)
                            if GN._fwd_smem(cg, s, cs)
                            <= GN._CLUSTER_BLOCK_BYTES]
                    if not last and dtype != torch.float32 and s % 8 == 0 \
                            and fits:
                        assert plan == GN.GnFwdPlan(
                            "cluster", fits[0], GN._fwd_smem(cg, s, fits[0]))
                        assert 16 * math.ceil(cg * s / 8 / fits[0]) \
                            < plan.smem
                    else:
                        assert plan == GN.GnFwdPlan("triton", 0, 0)
    assert GN.group_norm_forward_plan(600, 65536, False,
                                      torch.bfloat16).route == "triton"


@pytest.mark.parametrize("shape,groups,cs", [
    ((2, 64, 16, 16), 8, 1), ((2, 64, 16, 16), 8, 2), ((3, 30, 8, 8), 3, 4),
    ((2, 40, 4, 8), 4, 8), ((1, 6, 16, 16), 6, 1), ((2, 4, 64, 136), 2, 8)])
def test_group_stats_cluster_matches_float64_and_jax(shape, groups, cs):
    """The cluster forward's order of sums on the CPU in fp32 (ranks of
    vectors, a thread's vectors in order, the xor tree, the warps and the
    ranks in order; the centred squares each rounded): the mean within
    1e-6 of max(1, |x|) and the variance within 1e-6 of the mean square
    of float64; x normalised by these statistics within 1e-5 of the JAX
    ``paddle_tpu.nn.functional.group_norm`` (fp32 sums in XLA's order)."""
    import numpy as np

    import paddle_tpu as paddle
    g = torch.Generator().manual_seed(sum(shape) + cs)
    x = (3 + 2 * torch.randn(*shape, generator=g)).to(torch.bfloat16)
    mean, var = GN.group_stats_cluster_plain(x, groups, cs)
    assert mean.dtype == var.dtype == torch.float32
    xd = x.double().reshape(shape[0], groups, -1)
    scale = max(1.0, float(xd.abs().max()))
    assert float((mean.double() - xd.mean(-1)).abs().max()) <= 1e-6 * scale
    want_var = xd.var(-1, unbiased=False)
    assert float((var.double() - want_var).abs().max()) \
        <= 1e-6 * float((xd * xd).mean())
    rstd = 1.0 / torch.sqrt(var + 1e-5)
    r = x.float().reshape(shape[0], groups, -1)
    ours = ((r - mean[..., None]) * rstd[..., None]).reshape(shape)
    theirs = paddle.nn.functional.group_norm(
        paddle.to_tensor(x.float().numpy()), groups, 1e-5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs.numpy()),
                               rtol=0, atol=1e-5)


# -- the dense attention's forward middle --------------------------------------

def test_dense_softmax_forward_plan_takes_short_aligned_rows():
    """fp32 rows of a multiple of 4 keys up to ``CUDA_MAX_KEYS`` (which
    holds Transformer-base's 64, and at most the kernel's 256) take the
    CUDA forward; other lengths and longer rows the Triton kernel."""
    from paddle_tpu_torch.kernels import dense_attention as DA
    assert 64 <= DA.CUDA_MAX_KEYS <= 256
    assert DA.dense_softmax_forward_plan(64) == "cuda"
    for sk in range(1, 4200):
        route = DA.dense_softmax_forward_plan(sk)
        assert route == ("cuda" if sk % 4 == 0 and sk <= DA.CUDA_MAX_KEYS
                         else "triton"), sk
    assert DA.dense_softmax_forward_plan(4096) == "triton"
