"""BatchNorm, with the residual add and the ReLU that follow it in
ResNet's blocks, forward and backward: Triton kernels, CUDA kernels for
the training forward's and backward's short runs
(``csrc/batch_norm_fwd.cu``, ``csrc/batch_norm_bwd.cu``), and their plain
PyTorch version.

No TPU kernel: the JAX package's ``F.batch_norm``
(``paddle_tpu/nn/functional/norm.py:95-155``) is jnp, which XLA fuses with
the add and the ReLU after it. ResNet-50 makes 53 BatchNorm calls a
forward: 33 followed by a ReLU, 16 by the block's residual add and a
ReLU, the 4 downsamples' by nothing; under amp O1 (bf16 convolutions,
fp32 BatchNorm) they were the largest cost of its step as PyTorch ops.

What it computes, per channel: in training (``batch_stats``) the mean and
biased variance of the channel's N x spatial values in fp32, and the
running statistics updated in place, ``momentum * running + (1 -
momentum) * batch`` (the JAX convention: momentum weighs the old value);
in eval the running statistics. Then ``(x - mean) * rsqrt(var + eps) *
w + b`` in fp32, rounded where the separate ops round: to x's dtype where
the norm's output is x's dtype (``round_x``; under amp the black-listed
norm writes fp32), then, with a ``residual``, the sum in fp32 of the two
rounded to the output dtype, then the ReLU, written in ``out_dtype``. The
bits are those of the norm's output followed by PyTorch's add and ReLU;
the backward's too: the ReLU's mask is ``y > 0`` on the output it wrote,
the residual's gradient is the masked dy, and the norm's gradient is that
rounded as the add's and the casts' backwards round it.

Bound on the H100: bytes (about 10 flops an element forward, 20
backward; the card needs ~295 a byte before compute is the limit). The
design:

* A channel is N runs of its spatial size (NCL, NCHW, NCDHW) or one run
  of N x spatial rows of stride C (NC, and the channel-last formats, where
  the channels are contiguous). A program takes a [BLOCK_C, BLOCK_S] tile
  of channels by positions: in the first form BLOCK_S along a spatial run
  (the tile's channels are neighbouring runs), in the second BLOCK_C
  along the contiguous channels. ``_plan`` picks BLOCK_S so that a
  channel's runs waste few lanes: the longest power of two up to 1024
  whose tiles hold at most 35% more lanes than the run (7 x 7 in one tile
  of 64, 14 x 14 of 256, 28 x 28 of 1024: the tile's channels are then
  one contiguous stretch of memory; 56 x 56 in four of 1024), and about
  four programs an SM: a channel block's tiles, (n, tile-of-the-run)
  pairs, are cut into chunks. The stem's 64 channels over 128 x 12544
  values make 528 programs, not 64.
* The forward is two kernels: ``_bn_stats_kernel`` writes each chunk's
  fp32 (count, mean, M2) per channel, its tiles merged by Chan's formula
  (no E[x^2] - E[x]^2, which cancels); ``_bn_fwd_kernel`` loads its
  channels' chunk partials 32 at a time and merges them (the
  count-weighted mean, then M2 about it: every program the same bits, in
  two vector loads where a loop over the chunks made one round trip a
  chunk), normalises its chunk, and its chunk-0 program saves (mean,
  rstd) and updates the running statistics. No atomics anywhere: the same
  inputs give the same bits every run, so a captured step equals an eager
  one.
* The backward is two kernels: ``_bn_bwd_part_kernel`` writes per chunk
  and channel the fp32 sums of g and g * x-hat (g: dy under the ReLU's
  mask, rounded as the composition rounds it); ``_bn_bwd_dx_kernel``
  adds its channels' chunk partials 32 at a time (the chunk-0 program
  writes them as dbias and dweight), forms ``dx = rstd * w * (g -
  mean(g) - x-hat * mean(g * x-hat))`` (in eval ``rstd * w * g``) and
  writes dx and the residual's gradient.

A forward reads x twice (the statistics, then the normalisation) and the
two-pass backward reads x, dy (and the output, for the ReLU's mask) twice:
the second reads of a chunk come soon after the first, partly from L2.

``batch_norm_backward_plan`` routes the training backward of a
channels-first bf16 or fp16 x whose channel fits on chip to the cluster
kernel of ``csrc/batch_norm_bwd.cu``: a block, or a cluster of up to 8
blocks splitting the batch, owns a channel, reads x, dy and y once into
shared memory, sums per channel in a fixed order (the cluster's
blocks through distributed shared memory, in rank order) and writes dx
and the residual's gradient once. Long channels (56 x 56 and up at batch
128), channels last, fp32 x and the eval backward take the two Triton
kernels. One launch a call either way (``LAUNCHES["batch_norm_bwd"]``;
``["batch_norm_bwd_cluster"]`` counts the cluster kernel's too).

``batch_norm_forward_plan`` routes the training forward of such an x
whose channel fits a cluster of up to 8 blocks (56 x 56 and below at
batch 128) to the cluster kernel of ``csrc/batch_norm_fwd.cu``: x read
once into shared memory (2 bytes an element), the mean and then M2 about
it summed in a fixed order over the cluster, y written once. The stem,
channels last, fp32 x and eval take the Triton kernels
(``_triton_forward``).
``LAUNCHES["batch_norm"]`` counts every forward call,
``["batch_norm_cluster"]`` the cluster kernel's too.

Triton is imported, and the kernels compiled, at the first launch; the
CUDA sources are built by ``_build`` at their first launch.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import LAUNCHES, sm_count
from ._build import library

tl = None    # triton.language, bound by _jit() at the first launch

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_TILE = 4096            # elements of a [BLOCK_C, BLOCK_S] tile
_PROGRAMS_PER_SM = 4
_RUN_BLOCKS = (1024, 512, 256, 128, 64, 32, 16)
_RUN_WASTE = 1.35       # the most lanes a spatial run's tiles may hold, x S
_CH_BLOCK = 32          # chunk partials a program merges at once


# -- the kernels ------------------------------------------------------------------

def _bn_stats_kernel(x_ptr, part_ptr, C, S, sN, sC, sS, ns, per, tiles,
                     BLOCK_C: tl.constexpr, BLOCK_S: tl.constexpr):
    """Program (channel block cb, chunk k): the chunk's fp32 (count, mean,
    M2) of each channel into part[k, 0:3, c], its tiles merged by Chan's
    formula."""
    cb = tl.program_id(0)
    k = tl.program_id(1)
    c = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    cm = c < C
    rows = x_ptr + c[:, None].to(tl.int64) * sC
    cnt = 0.0
    mean = tl.zeros([BLOCK_C], dtype=tl.float32)
    m2 = tl.zeros([BLOCK_C], dtype=tl.float32)
    t_lo = k * per
    t_hi = tl.minimum(t_lo + per, tiles)
    for t in range(t_lo, t_hi):
        n = t // ns
        s0 = (t - n * ns) * BLOCK_S
        s = s0 + tl.arange(0, BLOCK_S)
        m = cm[:, None] & (s < S)[None, :]
        v = tl.load(rows + n.to(tl.int64) * sN
                    + s[None, :].to(tl.int64) * sS, mask=m,
                    other=0.0).to(tl.float32)
        nt = tl.minimum(S - s0, BLOCK_S).to(tl.float32)
        mt = tl.sum(v, axis=1) / nt
        dv = tl.where(m, v - mt[:, None], 0.0)
        m2t = tl.sum(dv * dv, axis=1)
        tot = cnt + nt
        d = mt - mean
        w = nt / tot
        mean = mean + d * w
        m2 = m2 + m2t + d * d * cnt * w
        cnt = tot
    p = part_ptr + k * 3 * C + c
    tl.store(p, tl.zeros([BLOCK_C], dtype=tl.float32) + cnt, mask=cm)
    tl.store(p + C, mean, mask=cm)
    tl.store(p + 2 * C, m2, mask=cm)


def _bn_fwd_kernel(x_ptr, w_ptr, b_ptr, rm_ptr, rv_ptr, r_ptr, y_ptr,
                   part_ptr, stat_ptr, C, S, sN, sC, sS, ns, per, tiles,
                   n_chunks, eps, momentum, keep_new,
                   TRAIN: tl.constexpr, HAS_RES: tl.constexpr,
                   RELU: tl.constexpr, ROUND_X: tl.constexpr,
                   BLOCK_C: tl.constexpr, BLOCK_S: tl.constexpr,
                   CH_BLOCK: tl.constexpr):
    """Program (cb, k): y over the chunk. In training the channels' chunk
    partials merged (every program the same arithmetic); program k = 0
    saves (mean, rstd) into stat[0:2, c] and updates the running
    statistics."""
    cb = tl.program_id(0)
    k = tl.program_id(1)
    c = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    cm = c < C
    if TRAIN:
        # the chunks' partials a block of CH_BLOCK at a time: the count-
        # weighted mean, then M2 about it (each chunk's own M2 plus its
        # count times its mean's squared distance)
        cnt = tl.zeros([BLOCK_C], dtype=tl.float32)
        tot = tl.zeros([BLOCK_C], dtype=tl.float32)
        for j0 in range(0, n_chunks, CH_BLOCK):
            j = j0 + tl.arange(0, CH_BLOCK)
            jm = (j < n_chunks)[:, None] & cm[None, :]
            p = part_ptr + j[:, None] * (3 * C) + c[None, :]
            cj = tl.load(p, mask=jm, other=0.0)
            cnt += tl.sum(cj, axis=0)
            tot += tl.sum(cj * tl.load(p + C, mask=jm, other=0.0), axis=0)
        cnt = tl.where(cm, cnt, 1.0)
        mean = tot / cnt
        m2 = tl.zeros([BLOCK_C], dtype=tl.float32)
        for j0 in range(0, n_chunks, CH_BLOCK):
            j = j0 + tl.arange(0, CH_BLOCK)
            jm = (j < n_chunks)[:, None] & cm[None, :]
            p = part_ptr + j[:, None] * (3 * C) + c[None, :]
            d = tl.load(p + C, mask=jm, other=0.0) - mean[None, :]
            m2 += tl.sum(tl.load(p + 2 * C, mask=jm, other=0.0)
                         + tl.load(p, mask=jm, other=0.0) * d * d, axis=0)
        var = m2 / cnt
    else:
        mean = tl.load(rm_ptr + c, mask=cm, other=0.0).to(tl.float32)
        var = tl.load(rv_ptr + c, mask=cm, other=1.0).to(tl.float32)
    rstd = 1.0 / tl.sqrt(var + eps)
    if k == 0:
        tl.store(stat_ptr + c, mean, mask=cm)
        tl.store(stat_ptr + C + c, rstd, mask=cm)
        if TRAIN:
            rm = tl.load(rm_ptr + c, mask=cm, other=0.0).to(tl.float32)
            rv = tl.load(rv_ptr + c, mask=cm, other=0.0).to(tl.float32)
            tl.store(rm_ptr + c, (momentum * rm + keep_new * mean)
                     .to(rm_ptr.dtype.element_ty), mask=cm)
            tl.store(rv_ptr + c, (momentum * rv + keep_new * var)
                     .to(rv_ptr.dtype.element_ty), mask=cm)
    scale = rstd * tl.load(w_ptr + c, mask=cm, other=0.0).to(tl.float32)
    b = tl.load(b_ptr + c, mask=cm, other=0.0).to(tl.float32)
    rows = c[:, None].to(tl.int64) * sC
    xdt = x_ptr.dtype.element_ty
    dt = y_ptr.dtype.element_ty
    t_lo = k * per
    t_hi = tl.minimum(t_lo + per, tiles)
    for t in range(t_lo, t_hi):
        n = t // ns
        s = (t - n * ns) * BLOCK_S + tl.arange(0, BLOCK_S)
        m = cm[:, None] & (s < S)[None, :]
        off = rows + n.to(tl.int64) * sN + s[None, :].to(tl.int64) * sS
        v = tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
        z = (v - mean[:, None]) * scale[:, None] + b[:, None]
        if ROUND_X:
            z = z.to(xdt).to(tl.float32)
        if HAS_RES:
            r = tl.load(r_ptr + off, mask=m, other=0.0)
            z = z.to(dt).to(tl.float32) + r.to(dt).to(tl.float32)
        if RELU:
            z = z.to(dt).to(tl.float32)
            z = tl.where(z < 0.0, 0.0, z)
        tl.store(y_ptr + off, z.to(dt), mask=m)


def _masked_grad(dy_ptr, y_ptr, off, m, RELU: tl.constexpr):
    """dy (in fp32) under the ReLU's mask: 0 where the output is <= 0, as
    PyTorch's ReLU backward."""
    g = tl.load(dy_ptr + off, mask=m, other=0.0).to(tl.float32)
    if RELU:
        yv = tl.load(y_ptr + off, mask=m, other=0.0).to(tl.float32)
        g = tl.where(yv <= 0.0, 0.0, g)
    return g


def _bn_bwd_part_kernel(x_ptr, dy_ptr, y_ptr, stat_ptr, part_ptr, C, S, sN,
                        sC, sS, ns, per, tiles, RELU: tl.constexpr,
                        ROUND_X: tl.constexpr, BLOCK_C: tl.constexpr,
                        BLOCK_S: tl.constexpr):
    """Program (cb, k): per channel, fp32 sums over the chunk of g * x-hat
    and of g into part[k, 0:2, c]."""
    cb = tl.program_id(0)
    k = tl.program_id(1)
    c = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    cm = c < C
    mean = tl.load(stat_ptr + c, mask=cm, other=0.0)
    rstd = tl.load(stat_ptr + C + c, mask=cm, other=0.0)
    rows = c[:, None].to(tl.int64) * sC
    xdt = x_ptr.dtype.element_ty
    acc_a = tl.zeros([BLOCK_C, BLOCK_S], dtype=tl.float32)
    acc_b = tl.zeros([BLOCK_C, BLOCK_S], dtype=tl.float32)
    t_lo = k * per
    t_hi = tl.minimum(t_lo + per, tiles)
    for t in range(t_lo, t_hi):
        n = t // ns
        s = (t - n * ns) * BLOCK_S + tl.arange(0, BLOCK_S)
        m = cm[:, None] & (s < S)[None, :]
        off = rows + n.to(tl.int64) * sN + s[None, :].to(tl.int64) * sS
        v = tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
        g = _masked_grad(dy_ptr, y_ptr, off, m, RELU)
        if ROUND_X:
            g = g.to(xdt).to(tl.float32)
        xh = (v - mean[:, None]) * rstd[:, None]
        acc_a += tl.where(m, g * xh, 0.0)
        acc_b += g
    p = part_ptr + k * 2 * C + c
    tl.store(p, tl.sum(acc_a, axis=1), mask=cm)
    tl.store(p + C, tl.sum(acc_b, axis=1), mask=cm)


def _bn_bwd_dx_kernel(x_ptr, w_ptr, dy_ptr, y_ptr, dx_ptr, dr_ptr, stat_ptr,
                      part_ptr, sums_ptr, C, S, sN, sC, sS, ns, per, tiles,
                      n_chunks, m_count, TRAIN: tl.constexpr,
                      HAS_RES: tl.constexpr, RELU: tl.constexpr,
                      ROUND_X: tl.constexpr, BLOCK_C: tl.constexpr,
                      BLOCK_S: tl.constexpr, CH_BLOCK: tl.constexpr):
    """Program (cb, k): dx (and the residual's gradient) over the chunk,
    from its channels' sums (the chunks' partials added CH_BLOCK at a
    time; program k = 0 writes them into sums[0:2, c]: dweight, dbias)."""
    cb = tl.program_id(0)
    k = tl.program_id(1)
    c = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    cm = c < C
    sa = tl.zeros([BLOCK_C], dtype=tl.float32)
    sb = tl.zeros([BLOCK_C], dtype=tl.float32)
    for j0 in range(0, n_chunks, CH_BLOCK):
        j = j0 + tl.arange(0, CH_BLOCK)
        jm = (j < n_chunks)[:, None] & cm[None, :]
        p = part_ptr + j[:, None] * (2 * C) + c[None, :]
        sa += tl.sum(tl.load(p, mask=jm, other=0.0), axis=0)
        sb += tl.sum(tl.load(p + C, mask=jm, other=0.0), axis=0)
    if k == 0:
        tl.store(sums_ptr + c, sa, mask=cm)
        tl.store(sums_ptr + C + c, sb, mask=cm)
    mean = tl.load(stat_ptr + c, mask=cm, other=0.0)
    rstd = tl.load(stat_ptr + C + c, mask=cm, other=0.0)
    ws = rstd * tl.load(w_ptr + c, mask=cm, other=0.0).to(tl.float32)
    mgx = sa / m_count
    mg = sb / m_count
    rows = c[:, None].to(tl.int64) * sC
    xdt = x_ptr.dtype.element_ty
    t_lo = k * per
    t_hi = tl.minimum(t_lo + per, tiles)
    for t in range(t_lo, t_hi):
        n = t // ns
        s = (t - n * ns) * BLOCK_S + tl.arange(0, BLOCK_S)
        m = cm[:, None] & (s < S)[None, :]
        off = rows + n.to(tl.int64) * sN + s[None, :].to(tl.int64) * sS
        g = _masked_grad(dy_ptr, y_ptr, off, m, RELU)
        if HAS_RES:
            tl.store(dr_ptr + off, g.to(dr_ptr.dtype.element_ty), mask=m)
        if ROUND_X:
            g = g.to(xdt).to(tl.float32)
        if TRAIN:
            v = tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
            xh = (v - mean[:, None]) * rstd[:, None]
            dx = ws[:, None] * (g - mg[:, None] - xh * mgx[:, None])
        else:
            dx = ws[:, None] * g
        tl.store(dx_ptr + off, dx.to(xdt), mask=m)


@functools.lru_cache(maxsize=None)
def _jit():
    """Import Triton and wrap the kernels and their helper (once)."""
    global tl, _masked_grad
    import triton
    import triton.language
    tl = triton.language
    _masked_grad = triton.jit(_masked_grad)
    # the counts that only bound loops and index the partials are not
    # specialised (each value would compile anew); the spatial size and the
    # strides are (their divisibility lets loads along a run vectorise)
    loose = ["C", "ns", "per", "tiles", "n_chunks"]
    return triton, {"stats": triton.jit(_bn_stats_kernel,
                                        do_not_specialize=loose),
                    "fwd": triton.jit(_bn_fwd_kernel,
                                      do_not_specialize=loose),
                    "bwd_part": triton.jit(_bn_bwd_part_kernel,
                                           do_not_specialize=loose),
                    "bwd_dx": triton.jit(_bn_bwd_dx_kernel,
                                         do_not_specialize=loose)}


# -- the launch plan ----------------------------------------------------------------

def _layout(shape, channels_last):
    """(N, C, S, sN, sC, sS) of a contiguous tensor: a channel's values
    are x[n * sN + c * sC + s * sS] for n < N, s < S, strides in elements.
    Channels first with spatial size S > 1: N runs of S; otherwise ([N,
    C], [N, C, 1, 1], channels last) one run of N x spatial rows of stride
    C, with N = 1."""
    if len(shape) < 2:
        raise ValueError(f"batch_norm takes [N, C, ...] tensors, got "
                         f"{list(shape)}")
    n = shape[0]
    c = shape[-1] if channels_last else shape[1]
    s = math.prod(shape[1:-1] if channels_last else shape[2:])
    if channels_last or s == 1:
        return 1, c, n * s, 0, 1, c
    return n, c, s, c * s, s, 1


def _next_pow2(v):
    return 1 << max(int(v) - 1, 0).bit_length()


def _tiles(c, s, rows):
    """(BLOCK_C, BLOCK_S): channels-contiguous rows (``rows``) take up to
    64 channels by rows of a tile of about ``_TILE`` elements; spatial
    runs take the longest power of two (up to 1024) whose tiles hold at
    most ``_RUN_WASTE`` times the run's lanes (else the run's power of
    two), and as many neighbouring channels as fill the tile (at most
    128)."""
    if rows:
        bc = min(_next_pow2(c), 64)
        return bc, max(16, min(_next_pow2(s), _TILE // bc))
    bs = next((b for b in _RUN_BLOCKS if -(-s // b) * b <= _RUN_WASTE * s),
              min(_next_pow2(s), _RUN_BLOCKS[0]))
    return max(1, min(_TILE // bs, _next_pow2(c), 128)), bs


def _plan(n, c, s, rows, sms):
    """(BLOCK_C, BLOCK_S, ns, per, n_chunks): a channel block's n x ns
    tiles (ns a run's) cut into ``n_chunks`` chunks of ``per`` tiles, so
    that there are about ``_PROGRAMS_PER_SM`` programs an SM."""
    bc, bs = _tiles(c, s, rows)
    ns = -(-s // bs)
    tiles = n * ns
    want = -(-(_PROGRAMS_PER_SM * sms) // -(-c // bc))
    per = -(-tiles // max(1, min(want, tiles)))
    return bc, bs, ns, per, -(-tiles // per)


# The cluster kernel: a block holds at most this many bytes of shared
# memory, two blocks an SM ((233,472 / 2) less the 1 KB each block keeps).
_CLUSTER_BLOCK_BYTES = 115712
_CLUSTER_SIZES = (1, 2, 4, 8)
_WARPS = 16                 # the cluster kernel's 512 threads
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _cluster_smem(n, s, cs):
    """Shared memory bytes of a cluster-kernel block (as
    ``ptt_batch_norm_bwd_smem``): 6 bytes an element held (g fp32, x 16
    bits) and 4 (8 + 2 x 16 + 4) of sums and parameters."""
    e = -(-n // cs) * s
    return -(-(6 * e + 4 * (8 + 2 * _WARPS + 4)) // 16) * 16


def batch_norm_backward_plan(n, c, s, channels_last, x_dtype, batch_stats,
                             sms):
    """The backward's route for x [n, c, spatial size s]: ``("cluster",
    blocks a cluster, shared memory bytes a block)``, a cluster a channel,
    where x is channels first with s > 1, bf16 or fp16, in training, and a
    channel fits in ``_CLUSTER_BLOCK_BYTES`` a block over at most 8 blocks
    (the fewest blocks of a power of two); else ``("two_pass", BLOCK_C,
    BLOCK_S, chunks)``, the Triton kernels' tiles on ``sms`` SMs."""
    if not channels_last and s > 1 and batch_stats \
            and x_dtype in (torch.bfloat16, torch.float16):
        for cs in _CLUSTER_SIZES:
            smem = _cluster_smem(n, s, cs)
            if smem <= _CLUSTER_BLOCK_BYTES:
                return "cluster", cs, smem
    rn, rc, rs, _, sc, _ = _layout((n, c, s) if not channels_last
                                   else (n, s, c), channels_last)
    bc, bs, _, _, chunks = _plan(rn, rc, rs, sc == 1, sms)
    return "two_pass", bc, bs, chunks


def _fwd_cluster_smem(n, s, cs):
    """Shared memory bytes of a forward cluster-kernel block (as
    ``ptt_batch_norm_fwd_smem``): 2 bytes an element held (x, 16 bits) and
    4 (12 + 16) of sums."""
    e = -(-n // cs) * s
    return -(-(2 * e + 4 * (12 + _WARPS)) // 16) * 16


def batch_norm_forward_plan(n, c, s, channels_last, x_dtype, batch_stats,
                            sms):
    """The forward's route for x [n, c, spatial size s]: ``("cluster",
    blocks a cluster, shared memory bytes a block)``, a cluster a channel
    (``csrc/batch_norm_fwd.cu``), where x is channels first with s > 1,
    bf16 or fp16, in training, and a channel fits in
    ``_CLUSTER_BLOCK_BYTES`` a block over at most 8 blocks (the fewest
    blocks of a power of two: 56 x 56 at batch 128 takes 8, measured
    faster than the Triton kernels in paired timings); else ``("triton",
    BLOCK_C, BLOCK_S, chunks)``, the Triton kernels' tiles on ``sms``
    SMs."""
    if not channels_last and s > 1 and batch_stats \
            and x_dtype in (torch.bfloat16, torch.float16):
        for cs in _CLUSTER_SIZES:
            smem = _fwd_cluster_smem(n, s, cs)
            if smem <= _CLUSTER_BLOCK_BYTES:
                return "cluster", cs, smem
    rn, rc, rs, _, sc, _ = _layout((n, c, s) if not channels_last
                                   else (n, s, c), channels_last)
    bc, bs, _, _, chunks = _plan(rn, rc, rs, sc == 1, sms)
    return "triton", bc, bs, chunks


def _cluster_lib(name):
    """The library of ``csrc/batch_norm_fwd.cu`` or ``batch_norm_bwd.cu``,
    its entry point's arguments set."""
    lib = library(name)
    if lib.ptt_error_string.restype is not ctypes.c_char_p:
        if name == "batch_norm_fwd":
            lib.ptt_batch_norm_fwd.argtypes = [ctypes.c_void_p] * 8 \
                + [ctypes.c_int] * 4 + [ctypes.c_float] * 3 \
                + [ctypes.c_int] * 10 + [ctypes.c_void_p]
            lib.ptt_batch_norm_fwd.restype = ctypes.c_int
        else:
            lib.ptt_batch_norm_bwd.argtypes = [ctypes.c_void_p] * 8 \
                + [ctypes.c_int] * 11 + [ctypes.c_void_p]
            lib.ptt_batch_norm_bwd.restype = ctypes.c_int
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
    return lib


def _cluster_forward(x, weight, bias, running_mean, running_var, residual,
                     relu, round_x, eps, momentum, y, stats, cs):
    """The forward cluster kernel on a contiguous channels-first x (N, C,
    S > 1, bf16 or fp16), training: y, stats and the running statistics
    in place."""
    n, c = x.shape[0], x.shape[1]
    s = x.numel() // (n * c)
    lib = _cluster_lib("batch_norm_fwd")
    res = None if residual is None else residual.contiguous()
    err = lib.ptt_batch_norm_fwd(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        running_mean.data_ptr(), running_var.data_ptr(),
        None if res is None else res.data_ptr(), y.data_ptr(),
        stats.data_ptr(), n, c, s, cs, float(eps), float(momentum),
        float(1 - momentum), _CODES[x.dtype], _CODES[weight.dtype],
        _CODES[bias.dtype], _CODES[running_mean.dtype],
        _CODES[running_var.dtype], _CODES[(x if res is None else res).dtype],
        _CODES[y.dtype], int(res is not None), int(bool(relu)),
        int(bool(round_x)), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("batch_norm forward cluster kernel launch failed: "
                           + lib.ptt_error_string(err).decode())


def _cluster_backward(x, weight, stats, dy, y, relu, round_x, dx, dres,
                      sums, cs):
    """The cluster kernel on a contiguous channels-first x (N, C, S > 1)."""
    n, c = x.shape[0], x.shape[1]
    s = x.numel() // (n * c)
    lib = _cluster_lib("batch_norm_bwd")
    yy = y if relu else dy
    err = lib.ptt_batch_norm_bwd(
        x.data_ptr(), dy.data_ptr(), yy.data_ptr(), stats.data_ptr(),
        weight.data_ptr(), dx.data_ptr(), None if dres is None
        else dres.data_ptr(), sums.data_ptr(), n, c, s, cs,
        _CODES[x.dtype], _CODES[dy.dtype], _CODES[yy.dtype],
        _CODES[weight.dtype], _CODES[dx.dtype if dres is None
                                     else dres.dtype], int(bool(relu)),
        int(bool(round_x)), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("batch_norm_bwd cluster kernel launch failed: "
                           + lib.ptt_error_string(err).decode())


# -- plain versions -----------------------------------------------------------------

def batch_norm_plain(x, running_mean, running_var, weight=None, bias=None,
                     batch_stats=False, momentum=0.9, eps=1e-5,
                     channels_last=False, residual=None, relu=False,
                     round_x=False, out_dtype=None):
    """The JAX formula (``paddle_tpu/nn/functional/norm.py:95``) and what
    follows it: with ``batch_stats`` the mean and biased variance of each
    channel in fp32, the running statistics updated in place (no grad);
    else the running statistics. ``(x - mean) / sqrt(var + eps)``, times
    the weight and plus the bias in fp32; rounded to x's dtype where
    ``round_x``; plus ``residual`` in ``out_dtype`` (both cast to it);
    ``torch.relu`` in ``out_dtype`` where ``relu``; written in
    ``out_dtype`` (x's dtype, or with a residual the promotion of the
    two). Differentiable by autograd."""
    if out_dtype is None:
        out_dtype = x.dtype if residual is None else torch.promote_types(
            x.dtype, residual.dtype)
    ch = x.dim() - 1 if channels_last and x.dim() > 2 else 1
    axes = tuple(i for i in range(x.dim()) if i != ch)
    shape = [1] * x.dim()
    shape[ch] = -1
    x32 = x.float()
    if batch_stats:
        mean = x32.mean(dim=axes)
        var = ((x32 - mean.reshape(shape)) ** 2).mean(dim=axes)
        with torch.no_grad():
            running_mean.copy_(momentum * running_mean.float()
                               + (1 - momentum) * mean)
            running_var.copy_(momentum * running_var.float()
                              + (1 - momentum) * var)
    else:
        mean, var = running_mean.float(), running_var.float()
    out = (x32 - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + eps)
    if weight is not None:
        out = out * weight.float().reshape(shape)
    if bias is not None:
        out = out + bias.float().reshape(shape)
    if round_x:
        out = out.to(x.dtype)
    if residual is not None:
        out = out.to(out_dtype) + residual.to(out_dtype)
    if relu:
        out = torch.relu(out.to(out_dtype))
    return out.to(out_dtype)


def batch_stats_split_plain(x, n_chunks, channels_last=False):
    """(mean, var) [C] of x's channels by the kernel's arithmetic, in fp32:
    each channel block's tiles (``_tiles``) cut into ``n_chunks`` chunks of
    whole tiles, each tile's mean and centred sum of squares merged into its
    chunk's by Chan's formula, then the chunks merged as the normalising
    program merges them: the count-weighted mean, then M2 about it."""
    n, c, s, _, sc, _ = _layout(tuple(x.shape), channels_last)
    bs = _tiles(c, s, sc == 1)[1]
    ns = -(-s // bs)
    tiles = n * ns
    per = -(-tiles // max(1, min(n_chunks, tiles)))
    if sc == 1:
        a = x.reshape(-1, c).t().reshape(c, 1, s).float()
    else:
        a = x.reshape(n, c, s).permute(1, 0, 2).float()

    def merge(acc, part):
        cnt, mean, m2 = acc
        cb, mb, m2b = part
        tot = cnt + cb
        d = mb - mean
        w = cb / tot
        return tot, mean + d * w, m2 + m2b + d * d * cnt * w

    zero = torch.zeros(c)
    chunks = []
    for t_lo in range(0, tiles, per):
        acc = (zero, zero, zero)
        for t in range(t_lo, min(t_lo + per, tiles)):
            s0 = (t % ns) * bs
            v = a[:, t // ns, s0:min(s0 + bs, s)]
            nt = torch.full_like(zero, float(v.shape[1]))
            mt = v.sum(dim=1) / nt
            dv = v - mt[:, None]
            acc = merge(acc, (nt, mt, (dv * dv).sum(dim=1)))
        chunks.append(torch.stack(acc))
    cnt_j, mean_j, m2_j = torch.stack(chunks, dim=1)     # [chunks, C]
    cnt = cnt_j.sum(dim=0)
    mean = (cnt_j * mean_j).sum(dim=0) / cnt
    d = mean_j - mean
    return mean, (m2_j + cnt_j * d * d).sum(dim=0) / cnt


# -- wrappers -----------------------------------------------------------------------

def _check(x, weight, bias, running_mean, running_var, residual,
           channels_last):
    if x.dtype not in _DTYPES:
        raise ValueError(f"batch_norm takes {_DTYPES}, got {x.dtype}")
    c = x.shape[-1] if channels_last and x.dim() > 2 else x.shape[1]
    for name, t in (("weight", weight), ("bias", bias),
                    ("running_mean", running_mean),
                    ("running_var", running_var)):
        if t is not None and (tuple(t.shape) != (c,) or t.device != x.device
                              or not t.is_contiguous()):
            raise ValueError(f"batch_norm: {name} must be a contiguous [{c}] "
                             f"on {x.device}, got {tuple(t.shape)} on "
                             f"{t.device}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.device != x.device):
        raise ValueError(f"batch_norm: residual {tuple(residual.shape)} "
                         f"against x {tuple(x.shape)}")
    return c


def _args(x, channels_last):
    """(triton, kernels, grid, the layout's and plan's launch arguments,
    BLOCK_C, BLOCK_S, n_chunks, count a channel) of a CUDA tensor."""
    n, c, s, sn, sc, ss = _layout(tuple(x.shape), channels_last)
    bc, bs, ns, per, n_chunks = _plan(n, c, s, sc == 1, sm_count(x.device))
    triton, k = _jit()
    grid = (triton.cdiv(c, bc), n_chunks)
    return (triton, k, grid, (c, s, sn, sc, ss, ns, per, n * ns), bc, bs,
            n_chunks, float(n * s))


def _warps(bc, bs):
    """Eight warps a full tile, four a smaller one or one whose runs are
    64 lanes or fewer (7 x 7: four came out 0.4 ms faster over ResNet-50's
    53 calls, ``tools/batch_norm_variants.py``)."""
    return 8 if bc * bs >= _TILE and bs > 64 else 4


def batch_norm_forward(x, weight, bias, running_mean, running_var,
                       batch_stats, momentum=0.9, eps=1e-5,
                       channels_last=False, residual=None, relu=False,
                       round_x=False, out_dtype=None):
    """(y, stats) of the forward kernels on a contiguous CUDA x: y in
    ``out_dtype`` (see ``batch_norm_plain``), stats the fp32 (mean, rstd)
    of each channel, ``[2, C]``; with ``batch_stats`` the running
    statistics updated in place. ``weight`` and ``bias`` are tensors of
    [C] in any dtype."""
    c = _check(x, weight, bias, running_mean, running_var, residual,
               channels_last)
    if out_dtype is None:
        out_dtype = x.dtype if residual is None else torch.promote_types(
            x.dtype, residual.dtype)
    if out_dtype not in _DTYPES:
        raise ValueError(f"batch_norm writes {_DTYPES}, not {out_dtype}")
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    stats = torch.empty(2, c, dtype=torch.float32, device=x.device)
    if x.numel():
        plan = batch_norm_forward_plan(
            x.shape[0], c, x.numel() // (x.shape[0] * c), channels_last,
            x.dtype, batch_stats, sm_count(x.device))
        if plan[0] == "cluster":
            _cluster_forward(x, weight, bias, running_mean, running_var,
                             residual, relu, round_x, eps, momentum, y, stats,
                             plan[1])
            LAUNCHES["batch_norm_cluster"] += 1
        else:
            _triton_forward(x, weight, bias, running_mean, running_var,
                            batch_stats, momentum, eps, channels_last,
                            residual, relu, round_x, y, stats)
        LAUNCHES["batch_norm"] += 1
    elif batch_stats:
        # The statistics of an empty batch are NaN, as the plain version's.
        for t in (stats, running_mean, running_var):
            t.fill_(float("nan"))
    return y, stats


def _triton_forward(x, weight, bias, running_mean, running_var, batch_stats,
                    momentum, eps, channels_last, residual, relu, round_x, y,
                    stats):
    """The Triton kernels (in training the chunks' statistics, then the
    normalisation) into y and stats."""
    c = stats.shape[1]
    triton, k, grid, geo, bc, bs, n_chunks, _ = _args(x, channels_last)
    nw = _warps(bc, bs)
    part = stats
    if batch_stats:
        part = torch.empty(n_chunks, 3, c, dtype=torch.float32,
                           device=x.device)
        k["stats"][grid](x, part, *geo, BLOCK_C=bc, BLOCK_S=bs, num_warps=nw)
    k["fwd"][grid](x, weight, bias, running_mean, running_var,
                   x if residual is None else residual, y, part, stats,
                   *geo, n_chunks, float(eps), float(momentum),
                   float(1 - momentum), TRAIN=bool(batch_stats),
                   HAS_RES=residual is not None, RELU=bool(relu),
                   ROUND_X=bool(round_x), BLOCK_C=bc, BLOCK_S=bs,
                   CH_BLOCK=_CH_BLOCK, num_warps=nw)


def _two_pass_backward(x, weight, stats, dy, y, batch_stats, channels_last,
                       relu, round_x, dx, dres, sums):
    """The two Triton kernels (the chunks' partial sums, then dx and the
    residual's gradient) into dx, dres and sums."""
    c = sums.shape[1]
    triton, k, grid, geo, bc, bs, n_chunks, m_count = _args(x, channels_last)
    nw = _warps(bc, bs)
    part = torch.empty(n_chunks, 2, c, dtype=torch.float32, device=x.device)
    yy = dy if y is None else y
    k["bwd_part"][grid](x, dy, yy, stats, part, *geo, RELU=bool(relu),
                        ROUND_X=bool(round_x), BLOCK_C=bc, BLOCK_S=bs,
                        num_warps=nw)
    k["bwd_dx"][grid](x, weight, dy, yy, dx, dx if dres is None else dres,
                      stats, part, sums, *geo, n_chunks, m_count,
                      TRAIN=bool(batch_stats), HAS_RES=dres is not None,
                      RELU=bool(relu), ROUND_X=bool(round_x),
                      BLOCK_C=bc, BLOCK_S=bs, CH_BLOCK=_CH_BLOCK,
                      num_warps=nw)


def batch_norm_backward(x, weight, stats, dy, y=None, batch_stats=True,
                        channels_last=False, relu=False, round_x=False,
                        residual_dtype=None):
    """(dx, dresidual, dweight, dbias) on CUDA tensors from the forward's
    x, stats and (with ``relu``) output y: dx in x's dtype, dresidual in
    ``residual_dtype`` (None without a residual), the two [C] vector
    gradients in fp32, sums in a fixed order. The route is
    ``batch_norm_backward_plan``'s."""
    dy = dy.contiguous()
    c = _check(x, weight, None, None, None, None, channels_last)
    if dy.shape != x.shape or dy.device != x.device \
            or (relu and (y is None or y.shape != x.shape)):
        raise ValueError(f"batch_norm_backward: dy {tuple(dy.shape)} "
                         f"against x {tuple(x.shape)}")
    dx = torch.empty_like(x)
    dres = None if residual_dtype is None else torch.empty(
        x.shape, dtype=residual_dtype, device=x.device)
    sums = torch.zeros(2, c, dtype=torch.float32, device=x.device)
    if x.numel():
        plan = batch_norm_backward_plan(
            x.shape[0], c, x.numel() // (x.shape[0] * c), channels_last,
            x.dtype, batch_stats, sm_count(x.device))
        if plan[0] == "cluster":
            _cluster_backward(x, weight, stats, dy, y, relu, round_x, dx,
                              dres, sums, plan[1])
            LAUNCHES["batch_norm_bwd_cluster"] += 1
        else:
            _two_pass_backward(x, weight, stats, dy, y, batch_stats,
                               channels_last, relu, round_x, dx, dres, sums)
        LAUNCHES["batch_norm_bwd"] += 1
    return dx, dres, sums[0], sums[1]


class BatchNormFunction(torch.autograd.Function):
    """BatchNorm (with the residual add and the ReLU) through the kernels:
    it keeps x, the weight (ones where there is none), the channels'
    (mean, rstd) and, with the ReLU, its output."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, running_mean, running_var,
                batch_stats, momentum, eps, channels_last, relu, round_x,
                out_dtype):
        c = x.shape[-1] if channels_last and x.dim() > 2 else x.shape[1]
        w = weight if weight is not None else torch.ones(
            c, dtype=torch.float32, device=x.device)
        b = bias if bias is not None else torch.zeros(
            c, dtype=torch.float32, device=x.device)
        y, stats = batch_norm_forward(x, w, b, running_mean, running_var,
                                      batch_stats, momentum, eps,
                                      channels_last, residual, relu, round_x,
                                      out_dtype)
        ctx.save_for_backward(x, w, stats, y if relu else None)
        ctx.args = (batch_stats, channels_last, relu, round_x)
        ctx.dtypes = tuple(None if t is None else t.dtype
                           for t in (weight, bias, residual))
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, stats, y = ctx.saved_tensors
        batch_stats, channels_last, relu, round_x = ctx.args
        tw, tb, tr = ctx.dtypes
        dx, dres, dw, db = batch_norm_backward(x, w, stats, dy, y,
                                               batch_stats, channels_last,
                                               relu, round_x, tr)
        return (dx, None if tw is None else dw.to(tw),
                None if tb is None else db.to(tb), dres) + (None,) * 9


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               batch_stats=False, momentum=0.9, eps=1e-5,
               channels_last=False, residual=None, relu=False,
               round_x=False, out_dtype=None):
    """BatchNorm of x ([N, C, ...], or [N, ..., C] with ``channels_last``;
    [N, C] either way) with what follows it (see ``batch_norm_plain``);
    differentiable: on a CUDA tensor the Triton kernels (forward and
    backward), on a CPU tensor ``batch_norm_plain``."""
    if x.device.type == "cpu":
        return batch_norm_plain(x, running_mean, running_var, weight, bias,
                                batch_stats, momentum, eps, channels_last,
                                residual, relu, round_x, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"batch_norm runs on cuda or cpu, not {x.device}")
    return BatchNormFunction.apply(
        x.contiguous(), weight, bias,
        None if residual is None else residual.contiguous(), running_mean,
        running_var, bool(batch_stats), float(momentum), float(eps),
        bool(channels_last), bool(relu), bool(round_x), out_dtype)


__all__ = ["batch_norm", "batch_norm_plain", "batch_stats_split_plain",
           "batch_norm_forward", "batch_norm_backward", "BatchNormFunction",
           "batch_norm_forward_plan", "batch_norm_backward_plan"]
