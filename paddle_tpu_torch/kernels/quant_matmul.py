"""The weight-only GEMM: ``x @ W`` for an int8, int4 or float8 ``W`` with
per-output-channel scales, reading the narrow bytes.

Replaces no Pallas kernel: it is the port of the convert that XLA fuses
into the dot of ``paddle_tpu/quantization/_kernels.py:99
quant_matmul_arrays`` (``csrc/weight_only_gemm.cu`` says how). The
weight is in the port's layout (``quantization/_kernels.py``): ``[N, K]``
int8 or float8_e4m3fn, or ``[N, ceil(K/2)]`` nibble-packed int8, with
fp32 scales ``[N]``.

``weight_only_gemm`` launches a kernel on CUDA tensors and raises on
what it does not take (activations in any dtype but bf16 among them: a
float32 model is not served quantized on the card); on CPU tensors, in
any dtype, it runs the plain version,
``quantization._kernels.quant_matmul_arrays``. Two hand-written kernels,
routed by shape and never on failure: the wgmma kernel where
``weight_only_gemm_takes`` (TMA's 16-byte rules; every matrix of the
served models), on the plan of ``weight_only_gemm_plan``; the mma.sync
kernel (``weight_only_gemm_sm80``) otherwise. Each launch counts in
``LAUNCHES["weight_only_gemm"]``; the mma.sync kernel's also in
``LAUNCHES["weight_only_gemm_sm80"]``.

The plan is computed here and passed to the kernel, so the plan the CPU
tests check is the one that launches: a token tile (wgmma's N) of 8, 64,
128 or 256 rows, output tiles of 128 channels (or 64 at 256 rows), and a
split of K into
``splits`` ranges of whole 64-deep stages, taken by the blocks of one
cluster and summed in split order (``weight_only_gemm_split_plain`` is
that arithmetic in PyTorch).
"""
from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import torch

from . import LAUNCHES
from ._build import library
from ..quantization._kernels import quant_matmul_arrays, unpack_int4_rows

_FMT = {torch.int8: 0, torch.float8_e4m3fn: 2}     # int4 (1): packed int8

TOKEN_TILES = (8, 64, 128, 256)   # the kernel's instantiations (wgmma's N)
CHANNEL_TILE = 128                # output channels of a block: two m64
# the tiles past 128 rows: (tokens, channels); 64 channels is one consumer
# warpgroup, twice the tiles at the 256-token tile's convert cost
LARGE_TILES = ((128, 128), (256, 128), (256, 64))
STAGE_K = 64                      # K positions of a stage
MAX_SPLITS = 8                    # blocks of a cluster
MIN_SPLIT_STAGES = 4              # stages a split keeps at least
H100_SMS = 132
# clusters of s blocks of the kernel that an H100 80GB HBM3 holds at once
# (cudaOccupancyMaxActiveClusters, as tools/quant_gemm_variants.py prints
# it): one block an SM, and two at the 8-token tile; its processor
# clusters leave some SMs out of clusters of 3 to 7
H100_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
H100_CLUSTERS_TWO_AN_SM = {1: 264, 2: 132, 3: 79, 4: 62, 5: 47, 6: 39,
                           7: 32, 8: 30}


class Plan(NamedTuple):
    token_tile: int
    channel_tile: int
    splits: int


def _ceil(a, b):
    return -(-a // b)


def _h100_capacity(token_tile, channel_tile, splits):
    """Blocks in clusters of ``splits`` an H100 holds at once (the
    8-token tile runs two blocks an SM, every other tile one)."""
    if token_tile <= 8:
        return H100_CLUSTERS_TWO_AN_SM[splits] * splits
    return H100_CLUSTERS[splits] * splits


# What the plan's choice between the large tiles weighs, from
# tools/quant_gemm_variants.py on an H100 80GB HBM3 at 700 W, int8 4096 x
# 4096 at M = 256: each tile's k loop rate an SM (the call's time less the
# wave's cost and the reduction), the rate at which a block reads its
# partners' fp32 partials through distributed shared memory (against
# local_reduce) and a wave's cost beside its k loop (no_mainloop: launch,
# set-up, epilogue).
_TILE_FLOPS = {(128, 128): 4.2e12, (256, 128): 5.5e12, (256, 64): 4.8e12}
_DSMEM_BYTES_PER_S = 18e9
_WAVE_SECONDS = 4e-6


def _plan_seconds(tn, tc, splits, tiles, k, cap):
    """A rough time of ``tiles`` output tiles of ``tn`` tokens and ``tc``
    channels split ``splits`` ways: waves of the card's ``cap`` blocks,
    each the k loop of one block, plus the reduction of the partials."""
    waves = _ceil(tiles * splits, cap)
    loop = 2 * tn * tc * _ceil(_ceil(k, STAGE_K), splits) * STAGE_K \
        / _TILE_FLOPS[tn, tc]
    reduce = (splits - 1) / splits * tn * tc * 4 / _DSMEM_BYTES_PER_S
    return waves * (loop + _WAVE_SECONDS) + reduce


def weight_only_gemm_plan(m, n, k, capacity: Optional[Callable] = None):
    """The wgmma kernel's plan for ``x [m, k] @ W [n, k]^T``. Up to 128
    rows the token tile is the smallest that holds them, at 128 channels;
    past that, the tile of ``LARGE_TILES`` that ``_plan_seconds`` finds
    fastest (256 tokens convert each weight byte once per 256 and run the
    k loop fastest; 128 tokens or 64 channels make twice the tiles where
    the card would otherwise idle or split K many ways). The split count
    is the largest (at most ``MAX_SPLITS``, each split at least
    ``MIN_SPLIT_STAGES`` stages) whose blocks the card holds at once.
    ``capacity(token_tile, channel_tile, splits)``: blocks in clusters of
    ``splits`` that fit on the card together (the card's own count on the
    GPU; an H100's by default)."""
    cap = capacity or _h100_capacity
    stages = _ceil(k, STAGE_K)
    if m <= TOKEN_TILES[-2]:
        tried = [(next(t for t in TOKEN_TILES if t >= m), CHANNEL_TILE)]
    else:
        tried = LARGE_TILES
    plans = []
    for tn, tc in tried:
        tiles = _ceil(m, tn) * _ceil(n, tc)
        splits = 1
        for s in range(2, MAX_SPLITS + 1):
            if s * MIN_SPLIT_STAGES <= stages and tiles * s <= cap(tn, tc, s):
                splits = s
        plans.append(Plan(tn, tc, splits))
    if len(plans) > 1:
        plans.sort(key=lambda p: _plan_seconds(
            *p, _ceil(m, p.token_tile) * _ceil(n, p.channel_tile), k,
            cap(*p)))
    return plans[0]


def weight_only_gemm_k_ranges(k, splits):
    """The K positions ``[(k0, k1), ...]`` of each split, in split order:
    split ``s`` takes stages ``[T s // S, T (s + 1) // S)`` of the ``T =
    ceil(k / 64)``, as the kernel computes them."""
    t = _ceil(k, STAGE_K)
    return [(STAGE_K * (t * s // splits),
             min(k, STAGE_K * (t * (s + 1) // splits)))
            for s in range(splits)]


def weight_only_gemm_blocks(m, n, k, plan):
    """Each block of the kernel's grid, in launch order, as ``(m0, m1,
    n0, n1, k0, k1)``: block ``b`` takes split ``b % S`` of token tile
    ``(b // S) % tiles_m`` of channel tile ``b // (S tiles_m)``."""
    tn, tc, splits = plan
    tiles_m, tiles_n = _ceil(m, tn), _ceil(n, tc)
    ranges = weight_only_gemm_k_ranges(k, splits)
    for b in range(splits * tiles_m * tiles_n):
        tile = b // splits
        m0 = tile % tiles_m * tn
        n0 = tile // tiles_m * tc
        yield (m0, min(m, m0 + tn), n0, min(n, n0 + tc)) + ranges[b % splits]


def weight_only_gemm_split_plain(x, q, s, plan):
    """The wgmma kernel's arithmetic in PyTorch: each split's fp32 partial
    over its K range, the partials summed in split order, then the plain
    version's rounding (to x's dtype, times the scale in fp32, to x's
    dtype again)."""
    k = x.shape[-1]
    w = q if q.shape[-1] == k else unpack_int4_rows(q, k)
    x2 = x.reshape(-1, k).float()
    wf = w.float()
    total = None
    for k0, k1 in weight_only_gemm_k_ranges(k, plan.splits):
        part = x2[:, k0:k1] @ wf[:, k0:k1].T
        total = part if total is None else total + part
    y = (total.to(x.dtype).float() * s).to(x.dtype)
    return y.reshape(*x.shape[:-1], q.shape[0])


def weight_only_gemm_takes(x2, q, s):
    """Whether the wgmma kernel takes ``x2 [M, K] @ q^T``: TMA reads rows
    of a multiple of 16 bytes from 16-byte aligned bases, so K % 8 == 0
    (x), the weight's rows a multiple of 16 bytes (int8 and fp8: K % 16;
    int4: ceil(K/2) % 16), N % 8 == 0 (y's 16-byte stores), and x2, q and
    s each start on 16 bytes. The pointer counts, not only the shape: a
    slice of a packed batch may start anywhere. Every matrix of the served
    models passes; what does not goes to the mma.sync kernel."""
    if x2.dim() != 2 or not x2.is_contiguous():
        return False
    return (x2.shape[1] % 8 == 0 and q.shape[1] % 16 == 0
            and q.shape[0] % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (x2, q, s)))


def _lib():
    lib = library("weight_only_gemm")
    if lib.ptt_weight_only_gemm_wgmma.argtypes is None:
        lib.ptt_weight_only_gemm_sm80.argtypes = \
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.ptt_weight_only_gemm_sm80.restype = ctypes.c_int
        lib.ptt_weight_only_gemm_wgmma.argtypes = \
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.ptt_weight_only_gemm_wgmma.restype = ctypes.c_int
        lib.ptt_weight_only_gemm_clusters.argtypes = \
            [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        lib.ptt_weight_only_gemm_clusters.restype = ctypes.c_int
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
    return lib


def _check_err(lib, err):
    if err != 0:
        raise RuntimeError("weight_only_gemm kernel launch failed: "
                           + lib.ptt_error_string(err).decode())


_CAPACITY = {}


def card_capacity(device, fmt):
    """``capacity(token_tile, channel_tile, splits)`` of the card:
    clusters of the wgmma kernel's blocks it holds at once
    (cudaOccupancyMaxActiveClusters) times their size, asked once per
    kernel and split count."""
    dev = torch.device(device).index
    if dev is None:
        dev = torch.cuda.current_device()

    def cap(tn, tc, splits):
        key = (dev, fmt, tn, tc, splits)
        if key not in _CAPACITY:
            lib = _lib()
            out = ctypes.c_int(0)
            with torch.cuda.device(dev):
                _check_err(lib, lib.ptt_weight_only_gemm_clusters(
                    fmt, tn, tc, splits, ctypes.byref(out)))
            _CAPACITY[key] = out.value * splits
        return _CAPACITY[key]
    return cap


def _format(x, q, s):
    """The kernels' format code of ``q`` (0 int8, 1 packed int4, 2 fp8),
    after the checks every CUDA call passes."""
    if x.device.type != "cuda":
        raise ValueError(f"weight_only_gemm runs on cuda or cpu, not "
                         f"{x.device}")
    k = x.shape[-1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"weight_only_gemm takes bf16 activations, got "
                        f"{x.dtype}")
    if q.device != x.device or s.device != x.device:
        raise ValueError("weight_only_gemm: the weight and its scales must "
                         "be on the activations' device")
    if q.dtype not in _FMT or q.dim() != 2 or not q.is_contiguous():
        raise TypeError(f"weight_only_gemm takes a contiguous 2-D int8 or "
                        f"float8_e4m3fn weight, got {q.dtype} "
                        f"{tuple(q.shape)}")
    if q.shape[1] == k:
        fmt = _FMT[q.dtype]
    elif q.dtype == torch.int8 and q.shape[1] == (k + 1) // 2:
        fmt = 1                                           # packed int4
    else:
        raise ValueError(f"weight_only_gemm: weight width {q.shape[1]} "
                         f"matches neither K={k} nor its packed half")
    n = q.shape[0]
    if s.dtype != torch.float32 or s.shape != (n,) or not s.is_contiguous():
        raise TypeError(f"weight_only_gemm: scales must be contiguous fp32 "
                        f"[{n}], got {s.dtype} {tuple(s.shape)}")
    return fmt


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def weight_only_gemm_sm80(x, q, s):
    """The mma.sync kernel on CUDA tensors, for any shape (the checks of
    ``weight_only_gemm``): ``weight_only_gemm``'s route for what the
    wgmma kernel does not take, callable alone to time it."""
    fmt = _format(x, q, s)
    k, n = x.shape[-1], q.shape[0]
    x2 = x.reshape(-1, k).contiguous()
    y = torch.empty(x2.shape[0], n, dtype=x.dtype, device=x.device)
    lib = _lib()
    _check_err(lib, lib.ptt_weight_only_gemm_sm80(
        x2.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
        x2.shape[0], n, k, fmt, q.shape[1], _stream(x)))
    LAUNCHES["weight_only_gemm"] += 1
    LAUNCHES["weight_only_gemm_sm80"] += 1
    return y.reshape(*x.shape[:-1], n)


def weight_only_gemm_wgmma(x, q, s, plan=None):
    """The wgmma kernel on CUDA tensors that ``weight_only_gemm_takes``
    (else it raises), on ``plan`` (``weight_only_gemm_plan`` on the card's
    capacity by default)."""
    fmt = _format(x, q, s)
    k, n = x.shape[-1], q.shape[0]
    x2 = x.reshape(-1, k).contiguous()
    if not weight_only_gemm_takes(x2, q, s):
        raise ValueError(f"weight_only_gemm_wgmma: TMA cannot read x "
                         f"{tuple(x2.shape)} / weight {tuple(q.shape)} "
                         f"(16-byte rows and bases)")
    m = x2.shape[0]
    if plan is None:
        plan = weight_only_gemm_plan(m, n, k, card_capacity(x.device, fmt))
    y = torch.empty(m, n, dtype=x.dtype, device=x.device)
    lib = _lib()
    _check_err(lib, lib.ptt_weight_only_gemm_wgmma(
        x2.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(), m, n, k,
        fmt, q.shape[1], plan.token_tile, plan.channel_tile, plan.splits,
        _stream(x)))
    LAUNCHES["weight_only_gemm"] += 1
    return y.reshape(*x.shape[:-1], n)


def weight_only_gemm(x, q, s):
    """``(x @ W) * s`` in x's dtype, x ``[..., K]``. On CUDA tensors this
    launches a kernel (bf16 x, a contiguous int8 / float8_e4m3fn /
    packed-int4 ``q`` and fp32 ``s`` on x's device, or it raises): the
    wgmma kernel where ``weight_only_gemm_takes``, the mma.sync kernel
    otherwise. On CPU tensors it runs the plain version."""
    if x.device.type == "cpu":
        return quant_matmul_arrays(x, q, s)
    _format(x, q, s)
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if weight_only_gemm_takes(x2, q, s):
        y = weight_only_gemm_wgmma(x2, q, s)
    else:
        y = weight_only_gemm_sm80(x2, q, s)
    return y.reshape(*x.shape[:-1], q.shape[0])


__all__ = ["weight_only_gemm", "weight_only_gemm_takes",
           "weight_only_gemm_plan", "weight_only_gemm_k_ranges",
           "weight_only_gemm_blocks", "weight_only_gemm_split_plain",
           "weight_only_gemm_sm80", "weight_only_gemm_wgmma", "Plan",
           "card_capacity"]
