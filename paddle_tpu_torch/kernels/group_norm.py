"""GroupNorm, with a SiLU after it where the model applies one, forward and
backward: CUDA and Triton kernels and their plain PyTorch version.

No TPU kernel: the JAX package's ``F.group_norm``
(``paddle_tpu/nn/functional/norm.py:186-223``) is jnp, which XLA fuses
with the SiLU that follows it into the convolutions' neighbourhood. The
Stable Diffusion UNet makes 61 GroupNorm calls a forward, 45 of them
followed by SiLU: its largest elementwise work outside attention.

What it computes: per (sample, group) the mean and biased variance in
fp32, ``(x - mean) / sqrt(var + eps)``, times the fp32 weight plus the
fp32 bias, written in ``out_dtype`` (x's dtype by default). With
``silu=True`` the result is first rounded to ``out_dtype`` (where the
separate ops round: the norm's output, or ``amp``'s cast of it to the
SiLU's dtype) and then ``z / (1 + exp(-z))`` in fp32 (IEEE division and
libdevice's exp, as PyTorch's own SiLU computes it) is rounded again.
``amp.auto_cast`` at level O2 runs the UNet's GroupNorms in fp32 (the
black list) and casts their outputs back to bf16 for the SiLU or the
convolution that follows; reading x in bf16 and writing the bf16 rounding
gives the same bits with two bytes read and two written an element, where
the casts and an fp32 norm move twenty.

Bound on the H100: bytes (about 10 flops an element forward, 20 backward;
the card needs ~295 a byte before compute is the limit). The design:

* A group of an NCHW tensor is (C / G) rows of H * W contiguous elements;
  at the UNet's batch 2 there are 64 groups against 132 SMs, of up to
  122,880 elements each. One program a group would leave half the card
  idle, so a group's spatial range is cut into chunks (``_plan``: about
  four programs an SM, a chunk a whole number of tiles; a small group,
  as [B, 1280, 8, 8]'s 2,560 elements, is one chunk). The Triton forward is
  two kernels: ``_gn_stats_kernel`` writes each chunk's fp32 (count, mean,
  M2), merging its [BLOCK_C, BLOCK_S] tiles by Chan's formula (each
  tile's own mean and centred sum of squares: no E[x^2] - E[x]^2, which
  cancels); ``_gn_fwd_kernel`` merges its group's chunks in a fixed order
  (every program of the group the same bits) and normalises its chunk.
  The chunk's program 0 saves the group's mean and rstd.
* ``group_norm_forward_plan`` sends the forward of a channels-first x in
  bf16 or fp16 whose spatial size is a multiple of 8 and whose group fits
  on chip over at most 8 blocks (every GroupNorm of the UNet) to
  ``csrc/group_norm_fwd.cu`` instead: one launch, a thread-block cluster a
  group that reads x once into shared memory; each block sums its share
  and then the squares about its own mean, the blocks' (count, mean, M2)
  merge in rank order through distributed shared memory, and y (with the
  SiLU) is written from shared memory. The rest keeps the two Triton
  kernels (``_triton_forward``).
* The backward saves x, the mean and rstd (not an fp32 x-hat) and is
  three kernels: ``_gn_bwd_part_kernel`` recomputes x-hat (and, under
  SiLU, z and dy * silu'(z), rounded where the separate ops round) and
  writes per (sample, chunk, channel) fp32 sums of dz * x-hat and dz;
  ``_gn_bwd_dx_kernel`` adds its group's chunks in a fixed order, forms
  ``dx = rstd * (g - mean(g) - x-hat * mean(g * x-hat))`` with g = dz *
  gamma, and writes dx in x's dtype; ``kernels/fused.py``'s column sum
  adds the partials over samples and chunks, in order, into d(gamma) and
  d(beta). No atomics: a captured step equals an eager one bit for bit.
* NHWC (``channels_last``): the same kernels with the channel stride 1
  and the spatial stride C.
* ``group_norm_backward_plan`` sends the backward of a channels-first x in
  bf16 or fp16 whose spatial size is a multiple of 8 and whose group fits
  on chip over at most 8 blocks (every GroupNorm of the UNet) to
  ``csrc/group_norm_bwd.cu`` instead: a thread-block cluster a group reads
  x and dy once into shared memory, adds the sums in a fixed order across
  the cluster through distributed shared memory, and writes dx from shared
  memory; the per-(sample, channel) sums go to a table that its column sum
  adds over the samples (two launches). The rest keeps the three Triton
  kernels (``_triton_backward``).

The Triton forward reads x twice (the stats, then the normalisation) and
the Triton backward reads x and dy twice: the second reads of a chunk come
soon after the first, mostly from L2.

Triton is imported, and the kernels compiled, at the first launch.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import LAUNCHES
from ._build import library

tl = None    # triton.language, bound by _jit() at the first launch
ld = None    # Triton's libdevice (exp, IEEE division), bound by _jit()

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_TILE = 4096            # elements of a [BLOCK_C, BLOCK_S] tile
_PROGRAMS_PER_SM = 4


# -- the kernels ------------------------------------------------------------------

def _silu_tl(z):
    """PyTorch's SiLU in fp32: ``z / (1 + exp(-z))``."""
    return ld.div_rn(z, 1.0 + ld.exp(-z))


def _dsilu_tl(z, dy):
    """PyTorch's SiLU backward in fp32: ``dy * s * (1 + z * (1 - s))``,
    s = 1 / (1 + exp(-z))."""
    s = ld.div_rn(1.0, 1.0 + ld.exp(-z))
    return dy * s * (1.0 + z * (1.0 - s))


def _gn_stats_kernel(x_ptr, part_ptr, S, G, Cg, sN, sC, sS, chunk, n_chunks,
                     BLOCK_C: tl.constexpr, BLOCK_S: tl.constexpr):
    """Program (group ng, chunk k): the chunk's fp32 (count, mean, M2) into
    part[ng, k], its tiles merged by Chan's formula."""
    ng = tl.program_id(0)
    k = tl.program_id(1)
    n = ng // G
    g = ng % G
    base = x_ptr + n.to(tl.int64) * sN + (g * Cg).to(tl.int64) * sC
    s_lo = k * chunk
    s_hi = tl.minimum(s_lo + chunk, S)
    cnt = 0.0
    mean = 0.0
    m2 = 0.0
    for c0 in range(0, Cg, BLOCK_C):
        c = c0 + tl.arange(0, BLOCK_C)
        cm = c < Cg
        rows = base + c[:, None].to(tl.int64) * sC
        nc = tl.minimum(Cg - c0, BLOCK_C)
        for s0 in range(s_lo, s_hi, BLOCK_S):
            s = s0 + tl.arange(0, BLOCK_S)
            m = cm[:, None] & (s < s_hi)[None, :]
            v = tl.load(rows + s[None, :].to(tl.int64) * sS, mask=m,
                        other=0.0).to(tl.float32)
            nt = (nc * tl.minimum(s_hi - s0, BLOCK_S)).to(tl.float32)
            mt = tl.sum(tl.sum(v, axis=1), axis=0) / nt
            dv = tl.where(m, v - mt, 0.0)
            m2t = tl.sum(tl.sum(dv * dv, axis=1), axis=0)
            tot = cnt + nt
            d = mt - mean
            w = nt / tot
            mean = mean + d * w
            m2 = m2 + m2t + d * d * cnt * w
            cnt = tot
    p = part_ptr + (ng * n_chunks + k) * 3
    tl.store(p, cnt)
    tl.store(p + 1, mean)
    tl.store(p + 2, m2)


def _group_stats(part_ptr, ng, n_chunks, eps):
    """(mean, rstd) of group ng: its chunks' partials merged in order."""
    cnt = 0.0
    mean = 0.0
    m2 = 0.0
    for j in range(0, n_chunks):
        p = part_ptr + (ng * n_chunks + j) * 3
        cb = tl.load(p)
        mb = tl.load(p + 1)
        tot = cnt + cb
        d = mb - mean
        w = cb / tot
        mean = mean + d * w
        m2 = m2 + tl.load(p + 2) + d * d * cnt * w
        cnt = tot
    return mean, 1.0 / tl.sqrt(m2 / cnt + eps)


def _gn_fwd_kernel(x_ptr, w_ptr, b_ptr, y_ptr, part_ptr, stat_ptr, S, G, Cg,
                   sN, sC, sS, chunk, n_chunks, eps, SILU: tl.constexpr,
                   BLOCK_C: tl.constexpr, BLOCK_S: tl.constexpr):
    """Program (group ng, chunk k): y over the chunk; program k = 0 also
    saves the group's (mean, rstd) into stat[ng]."""
    ng = tl.program_id(0)
    k = tl.program_id(1)
    n = ng // G
    g = ng % G
    mean, rstd = _group_stats(part_ptr, ng, n_chunks, eps)
    if k == 0:
        tl.store(stat_ptr + 2 * ng, mean)
        tl.store(stat_ptr + 2 * ng + 1, rstd)
    off0 = n.to(tl.int64) * sN + (g * Cg).to(tl.int64) * sC
    s_lo = k * chunk
    s_hi = tl.minimum(s_lo + chunk, S)
    dt = y_ptr.dtype.element_ty
    for c0 in range(0, Cg, BLOCK_C):
        c = c0 + tl.arange(0, BLOCK_C)
        cm = c < Cg
        w = tl.load(w_ptr + g * Cg + c, mask=cm, other=0.0).to(tl.float32)
        b = tl.load(b_ptr + g * Cg + c, mask=cm, other=0.0).to(tl.float32)
        rows = off0 + c[:, None].to(tl.int64) * sC
        for s0 in range(s_lo, s_hi, BLOCK_S):
            s = s0 + tl.arange(0, BLOCK_S)
            m = cm[:, None] & (s < s_hi)[None, :]
            off = rows + s[None, :].to(tl.int64) * sS
            v = tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
            z = (v - mean) * rstd * w[:, None] + b[:, None]
            if SILU:
                z = _silu(z.to(dt).to(tl.float32))
            tl.store(y_ptr + off, z.to(dt), mask=m)


def _gn_bwd_part_kernel(x_ptr, w_ptr, b_ptr, dy_ptr, stat_ptr, part_ptr, C,
                        S, G, Cg, sN, sC, sS, chunk, n_chunks,
                        SILU: tl.constexpr, BLOCK_C: tl.constexpr,
                        BLOCK_S: tl.constexpr):
    """Program (group ng, chunk k): per channel of the group, fp32 sums over
    the chunk of dz * x-hat and of dz (dz = dy, or under SiLU dy * silu'(z)
    rounded to dy's dtype) into row n * n_chunks + k of part ([., 2 C]:
    the first C columns the former, the next C the latter)."""
    ng = tl.program_id(0)
    k = tl.program_id(1)
    n = ng // G
    g = ng % G
    mean = tl.load(stat_ptr + 2 * ng)
    rstd = tl.load(stat_ptr + 2 * ng + 1)
    off0 = n.to(tl.int64) * sN + (g * Cg).to(tl.int64) * sC
    row = part_ptr + (n * n_chunks + k).to(tl.int64) * (2 * C) + g * Cg
    s_lo = k * chunk
    s_hi = tl.minimum(s_lo + chunk, S)
    dt = dy_ptr.dtype.element_ty
    for c0 in range(0, Cg, BLOCK_C):
        c = c0 + tl.arange(0, BLOCK_C)
        cm = c < Cg
        w = tl.load(w_ptr + g * Cg + c, mask=cm, other=0.0).to(tl.float32)
        b = tl.load(b_ptr + g * Cg + c, mask=cm, other=0.0).to(tl.float32)
        rows = off0 + c[:, None].to(tl.int64) * sC
        acc_a = tl.zeros([BLOCK_C, BLOCK_S], dtype=tl.float32)
        acc_b = tl.zeros([BLOCK_C, BLOCK_S], dtype=tl.float32)
        for s0 in range(s_lo, s_hi, BLOCK_S):
            s = s0 + tl.arange(0, BLOCK_S)
            m = cm[:, None] & (s < s_hi)[None, :]
            off = rows + s[None, :].to(tl.int64) * sS
            v = tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
            dz = tl.load(dy_ptr + off, mask=m, other=0.0).to(tl.float32)
            xh = (v - mean) * rstd
            if SILU:
                z = (xh * w[:, None] + b[:, None]).to(dt).to(tl.float32)
                dz = _dsilu(z, dz).to(dt).to(tl.float32)
            acc_a += tl.where(m, dz * xh, 0.0)
            acc_b += dz
        tl.store(row + c, tl.sum(acc_a, axis=1), mask=cm)
        tl.store(row + C + c, tl.sum(acc_b, axis=1), mask=cm)


def _gn_bwd_dx_kernel(x_ptr, w_ptr, b_ptr, dy_ptr, dx_ptr, stat_ptr, part_ptr,
                      C, S, G, Cg, sN, sC, sS, chunk, n_chunks,
                      SILU: tl.constexpr, BLOCK_C: tl.constexpr,
                      BLOCK_S: tl.constexpr):
    """Program (group ng, chunk k): dx over the chunk, from the group's
    sums (its chunks' partials added in order)."""
    ng = tl.program_id(0)
    k = tl.program_id(1)
    n = ng // G
    g = ng % G
    mean = tl.load(stat_ptr + 2 * ng)
    rstd = tl.load(stat_ptr + 2 * ng + 1)
    sa = 0.0
    sb = 0.0
    for c0 in range(0, Cg, BLOCK_C):
        c = c0 + tl.arange(0, BLOCK_C)
        cm = c < Cg
        w = tl.load(w_ptr + g * Cg + c, mask=cm, other=0.0).to(tl.float32)
        acc_a = tl.zeros([BLOCK_C], dtype=tl.float32)
        acc_b = tl.zeros([BLOCK_C], dtype=tl.float32)
        for j in range(0, n_chunks):
            row = part_ptr + (n * n_chunks + j).to(tl.int64) * (2 * C) \
                + g * Cg
            acc_a += tl.load(row + c, mask=cm, other=0.0)
            acc_b += tl.load(row + C + c, mask=cm, other=0.0)
        sa += tl.sum(w * acc_a, axis=0)
        sb += tl.sum(w * acc_b, axis=0)
    m_count = (Cg * S) * 1.0     # Cg, S may be constexpr 1
    mgx = sa / m_count
    mg = sb / m_count
    off0 = n.to(tl.int64) * sN + (g * Cg).to(tl.int64) * sC
    s_lo = k * chunk
    s_hi = tl.minimum(s_lo + chunk, S)
    dt = dy_ptr.dtype.element_ty
    for c0 in range(0, Cg, BLOCK_C):
        c = c0 + tl.arange(0, BLOCK_C)
        cm = c < Cg
        w = tl.load(w_ptr + g * Cg + c, mask=cm, other=0.0).to(tl.float32)
        b = tl.load(b_ptr + g * Cg + c, mask=cm, other=0.0).to(tl.float32)
        rows = off0 + c[:, None].to(tl.int64) * sC
        for s0 in range(s_lo, s_hi, BLOCK_S):
            s = s0 + tl.arange(0, BLOCK_S)
            m = cm[:, None] & (s < s_hi)[None, :]
            off = rows + s[None, :].to(tl.int64) * sS
            v = tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
            dz = tl.load(dy_ptr + off, mask=m, other=0.0).to(tl.float32)
            xh = (v - mean) * rstd
            if SILU:
                z = (xh * w[:, None] + b[:, None]).to(dt).to(tl.float32)
                dz = _dsilu(z, dz).to(dt).to(tl.float32)
            dx = rstd * (dz * w[:, None] - mg - xh * mgx)
            tl.store(dx_ptr + off, dx.to(dx_ptr.dtype.element_ty), mask=m)


_silu = None     # the wrapped ``_silu_tl``, bound by _jit()
_dsilu = None    # the wrapped ``_dsilu_tl``, bound by _jit()


def _libdevice():
    try:
        from triton.language.extra import libdevice
        libdevice.exp       # noqa: B018  (a stub module in some versions)
    except (ImportError, AttributeError):
        from triton.language.extra.cuda import libdevice
    return libdevice


@functools.lru_cache(maxsize=None)
def _jit():
    """Import Triton and wrap the kernels and their helpers (once)."""
    global tl, ld, _silu, _dsilu, _group_stats
    import triton
    import triton.language
    tl = triton.language
    ld = _libdevice()
    _silu = triton.jit(_silu_tl)
    _dsilu = triton.jit(_dsilu_tl)
    _group_stats = triton.jit(_group_stats)
    from . import fused
    _, fk = fused._jit()
    # the counts that set loop bounds and masks across the channels only
    # are not specialised (each value would compile anew); the spatial size,
    # the chunk and the strides are (their divisibility lets loads along
    # the contiguous axis vectorise)
    loose = ["G", "Cg", "n_chunks"]
    return triton, {"stats": triton.jit(_gn_stats_kernel,
                                        do_not_specialize=loose),
                    "fwd": triton.jit(_gn_fwd_kernel,
                                      do_not_specialize=loose),
                    "bwd_part": triton.jit(_gn_bwd_part_kernel,
                                           do_not_specialize=loose + ["C"]),
                    "bwd_dx": triton.jit(_gn_bwd_dx_kernel,
                                         do_not_specialize=loose + ["C"]),
                    "col_sum": fk["col_sum"]}


# -- the launch plan ----------------------------------------------------------------

def _layout(shape, channels_last):
    """(N, C, S, sN, sC, sS) of a contiguous tensor: S the spatial size
    (1 for [N, C]), strides in elements."""
    if len(shape) < 2:
        raise ValueError(f"group_norm takes [N, C, ...] tensors, got "
                         f"{list(shape)}")
    n = shape[0]
    c = shape[-1] if channels_last else shape[1]
    s = math.prod(shape[1:-1] if channels_last else shape[2:])
    if channels_last:
        return n, c, s, s * c, 1, c
    return n, c, s, c * s, s, 1


def _next_pow2(v):
    return 1 << max(int(v) - 1, 0).bit_length()


def _tiles(cg, s, n_chunks):
    """(BLOCK_C, BLOCK_S, chunk): tiles of about ``_TILE`` elements (at
    most 64 channels), and the spatial range of size ``s`` cut into
    ``n_chunks`` chunks of whole tiles (the last may be shorter)."""
    bc = min(_next_pow2(cg), 64)
    bs = max(16, min(_next_pow2(s), _TILE // bc))
    return bc, bs, -(-(-(-s // n_chunks)) // bs) * bs


def _plan(n, groups, cg, s, sms):
    """(BLOCK_C, BLOCK_S, chunk, n_chunks): each group's spatial range cut
    into chunks of whole tiles so that there are about
    ``_PROGRAMS_PER_SM`` programs an SM (one chunk where the group is a
    tile or less)."""
    bs = _tiles(cg, s, 1)[1]
    want = -(-(_PROGRAMS_PER_SM * sms) // max(n * groups, 1))
    bc, bs, chunk = _tiles(cg, s, max(1, min(want, -(-s // bs))))
    return bc, bs, chunk, -(-s // chunk)


# The cluster backward (csrc/group_norm_bwd.cu): a block holds at most this
# many bytes of shared memory, two blocks an SM ((233,472 / 2) less the 1 KB
# each block keeps), as BatchNorm's cluster kernels
_CLUSTER_BLOCK_BYTES = 115712
_CLUSTER_SIZES = (1, 2, 4, 8)
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


class GnBwdPlan(NamedTuple):
    """The GroupNorm backward's launch: ``route`` "cluster" (the CUDA
    kernel: ``cs`` blocks a cluster, a cluster a group, ``smem`` bytes a
    block) or "triton" (the three Triton kernels, on ``_plan``'s tiles:
    ``cs`` 0, ``smem`` 0)."""
    route: str
    cs: int
    smem: int


_CLUSTER_THREADS = 512        # a block's threads: at most a channel each
_CLUSTER_COL_ROWS = 8         # thread rows of its column sum


def _cluster_smem(cg, s, cs):
    """Shared memory bytes of a cluster-kernel block, which the wrapper
    hands the kernel: 6 bytes an element of its channels (x 16 bits, dz
    fp32) and 4 (8 + 32 + 4 x its channels) of sums and parameters."""
    cpb = -(-cg // cs)
    return -(-(4 * (40 + 4 * cpb) + 6 * cpb * s) // 16) * 16


def group_norm_backward_plan(cg, s, channels_last, dtype):
    """The backward's route for groups of ``cg`` channels of spatial size
    ``s`` in ``dtype`` (the batch and the number of groups give only the
    grid): ``"cluster"`` where x is channels first, bf16 or fp16, s a
    multiple of 8 (16-byte vectors) and a group's channels split over the fewest blocks of a power of two up to 8 fit
    ``_CLUSTER_BLOCK_BYTES`` a block (the UNet at batch 4: [4, 320, 64,
    64] clusters of 4, [4, 960, 64, 64] of 8, 32 x 32 and smaller one
    block a group; ``tools/norm_bwd_plans.py`` times every cluster size
    beside this one); else ``"triton"`` (NHWC, fp32, odd spatial sizes,
    groups too large)."""
    if not channels_last and dtype in (torch.bfloat16, torch.float16) \
            and s % 8 == 0 and s > 0 and cg > 0:
        for cs in _CLUSTER_SIZES:
            smem = _cluster_smem(cg, s, cs)
            if smem <= _CLUSTER_BLOCK_BYTES \
                    and -(-cg // cs) <= _CLUSTER_THREADS:
                return GnBwdPlan("cluster", cs, smem)
    return GnBwdPlan("triton", 0, 0)


# The cluster forward (csrc/group_norm_fwd.cu): 4 (12 + 16) bytes of sums a
# block, then x at 2 bytes an element
_FWD_HEAD_BYTES = 112


class GnFwdPlan(NamedTuple):
    """The GroupNorm forward's launch: ``route`` "cluster" (the CUDA kernel:
    ``cs`` blocks a cluster, a cluster a group, ``smem`` bytes a block) or
    "triton" (the two Triton kernels, on ``_plan``'s tiles: ``cs`` 0,
    ``smem`` 0)."""
    route: str
    cs: int
    smem: int


def _fwd_smem(cg, s, cs):
    """Shared memory bytes of a cluster-forward block, which the wrapper
    hands the kernel: its sums, then its ceil(cg s / 8 / cs) 16-byte
    vectors of x."""
    return _FWD_HEAD_BYTES + 16 * -(-(cg * s // 8) // cs)


def group_norm_forward_plan(cg, s, channels_last, dtype):
    """The forward's route for groups of ``cg`` channels of spatial size
    ``s`` in x's ``dtype`` (the batch and the number of groups give only
    the grid; the SiLU, the output's dtype and the parameters' do not
    enter, so the fused SiLU and the separate ops take the same statistics
    bit for bit): ``"cluster"`` where x is channels first, bf16 or fp16, s
    a multiple of 8 and a group's share fits ``_CLUSTER_BLOCK_BYTES`` a
    block over a power of two of blocks up to 8, the fewest that fit (the
    UNet at batch 4: [4, 960, 64, 64] clusters of 4, [4, 640, 64, 64] and
    [4, 1920, 32, 32] of 2, the rest one block a group;
    ``tools/norm_fwd_plans.py`` times every cluster size beside this one:
    more blocks than the fewest that fit measured no faster at any UNet
    shape); else ``"triton"`` (NHWC, fp32, odd spatial sizes, groups too
    large)."""
    if not channels_last and dtype in (torch.bfloat16, torch.float16) \
            and s % 8 == 0 and s > 0 and cg > 0:
        for cs in _CLUSTER_SIZES:
            smem = _fwd_smem(cg, s, cs)
            if smem <= _CLUSTER_BLOCK_BYTES:
                return GnFwdPlan("cluster", cs, smem)
    return GnFwdPlan("triton", 0, 0)


def _check_err(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.ptt_error_string(err).decode())


def _fwd_lib():
    """The library of ``csrc/group_norm_fwd.cu``, its entry point's
    arguments set."""
    lib = library("group_norm_fwd")
    if lib.ptt_error_string.restype is not ctypes.c_char_p:
        lib.ptt_group_norm_fwd.argtypes = [ctypes.c_void_p] * 5 \
            + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        lib.ptt_group_norm_fwd.restype = ctypes.c_int
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
    return lib


def _cluster_forward(x, weight, bias, y, stats, num_groups, eps, silu,
                     plan):
    """The cluster kernel on contiguous channels-first CUDA tensors, on a
    "cluster" ``GnFwdPlan`` (also called alone: the smoke and the card's
    tests time and hold it beside the Triton route)."""
    n, c = x.shape[0], x.shape[1]
    s = x.numel() // (n * c)
    lib = _fwd_lib()
    _check_err(lib, lib.ptt_group_norm_fwd(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        stats.data_ptr(), n, c, num_groups, s, plan.cs, plan.smem,
        float(eps), _CODES[x.dtype], _CODES[weight.dtype],
        _CODES[bias.dtype], _CODES[y.dtype], int(bool(silu)),
        torch.cuda.current_stream(x.device).cuda_stream),
        "group_norm_fwd cluster kernel")


def _cluster_lib():
    """The library of ``csrc/group_norm_bwd.cu``, its entry point's
    arguments set."""
    lib = library("group_norm_bwd")
    if lib.ptt_error_string.restype is not ctypes.c_char_p:
        lib.ptt_group_norm_bwd.argtypes = [ctypes.c_void_p] * 8 \
            + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        lib.ptt_group_norm_bwd.restype = ctypes.c_int
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
    return lib


def _cluster_backward(x, weight, bias, stats, dy, num_groups, silu, dx, sums,
                      plan):
    """The cluster kernel and its column sum on contiguous channels-first
    CUDA tensors, on a "cluster" ``GnBwdPlan``."""
    n, c = x.shape[0], x.shape[1]
    s = x.numel() // (n * c)
    table = torch.empty(n, 2 * c, dtype=torch.float32, device=x.device)
    lib = _cluster_lib()
    err = lib.ptt_group_norm_bwd(
        x.data_ptr(), dy.data_ptr(), stats.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), dx.data_ptr(), table.data_ptr(), sums.data_ptr(),
        n, c, num_groups, s, plan.cs, plan.smem, _CODES[x.dtype],
        _CODES[dy.dtype],
        _CODES[weight.dtype], _CODES[bias.dtype], int(bool(silu)),
        torch.cuda.current_stream(x.device).cuda_stream)
    _check_err(lib, err, "group_norm_bwd cluster kernel")


# -- plain versions -----------------------------------------------------------------

def group_norm_plain(x, num_groups, weight=None, bias=None, eps=1e-5,
                     channels_last=False, silu=False, out_dtype=None):
    """The JAX formula (``paddle_tpu/nn/functional/norm.py:186``): mean and
    biased variance of each (sample, group) in fp32, ``(x - mean) /
    sqrt(var + eps)``, times the weight and plus the bias in fp32, cast to
    ``out_dtype`` (x's dtype); with ``silu``, ``F.silu`` of that in
    ``out_dtype``. Differentiable by autograd."""
    out_dtype = out_dtype or x.dtype
    a = x.movedim(-1, 1) if channels_last else x
    n, c = a.shape[0], a.shape[1]
    r = a.reshape(n, num_groups, c // num_groups, -1).float()
    mean = r.mean(dim=(2, 3), keepdim=True)
    centered = r - mean
    var = (centered * centered).mean(dim=(2, 3), keepdim=True)
    out = (centered / torch.sqrt(var + eps)).reshape(a.shape)
    shape = [1] * a.dim()
    shape[1] = -1
    if weight is not None:
        out = out * weight.float().reshape(shape)
    if bias is not None:
        out = out + bias.float().reshape(shape)
    out = out.to(out_dtype)
    if silu:
        out = torch.nn.functional.silu(out)
    return out.movedim(1, -1) if channels_last else out


def group_stats_split_plain(x, num_groups, n_chunks, channels_last=False):
    """(mean, var) [N, G] of x's groups by the kernel's arithmetic, in fp32:
    each group's spatial range cut into ``n_chunks`` chunks of the kernel's
    tiles (``_tiles``), each tile's mean and centred
    sum of squares merged into its chunk's by Chan's formula, then the
    chunks merged in order."""
    n, c, s, *_ = _layout(tuple(x.shape), channels_last)
    cg = c // num_groups
    a = x.movedim(-1, 1) if channels_last else x
    r = a.reshape(n, num_groups, cg, s).float()
    bc, bs, chunk = _tiles(cg, s, n_chunks)

    def merge(acc, part):
        cnt, mean, m2 = acc
        cb, mb, m2b = part
        tot = cnt + cb
        d = mb - mean
        w = cb / tot
        return tot, mean + d * w, m2 + m2b + d * d * cnt * w

    zero = torch.zeros(n, num_groups)
    total = (zero, zero, zero)
    for s_lo in range(0, s, chunk):
        acc = (zero, zero, zero)
        s_hi = min(s_lo + chunk, s)
        for c0 in range(0, cg, bc):
            for s0 in range(s_lo, s_hi, bs):
                t = r[:, :, c0:c0 + bc, s0:min(s0 + bs, s_hi)]
                nt = torch.full_like(zero, float(t.shape[2] * t.shape[3]))
                mt = t.sum(dim=(2, 3)) / nt
                dv = t - mt[..., None, None]
                acc = merge(acc, (nt, mt, (dv * dv).sum(dim=(2, 3))))
        total = merge(total, acc)
    cnt, mean, m2 = total
    return mean, m2 / cnt


def group_stats_cluster_plain(x, num_groups, cs):
    """(mean, var) [N, G] of x's groups (x [N, C, ...] channels first, its
    spatial size a multiple of 8) in the cluster forward's order, fp32 on
    x's device: a group's 16-byte vectors cut into ``cs`` ranks of
    ceil(Cg S / 8 / cs); in each rank thread t adds its vectors t, t + 512,
    ... (each vector's 8 values in order), then the xor tree over a warp's
    lanes and the 16 warps in order give the rank's sum, its mean, then in
    the same order the sum of the squares about that mean (each square
    rounded before it is added); the ranks' (count, mean, M2) merged in
    rank order by Chan's formula, every operation rounded apart; var = M2
    / (Cg S). The kernel's statistics are these bit for bit (a card test
    holds them), its rstd ``1 / sqrt(var + eps)`` of them in fp32."""
    from .fused import xor_tree_plain
    n, c = x.shape[0], x.shape[1]
    cg = c // num_groups
    m = cg * (x.numel() // (n * c))
    vpb = -(-(m // 8) // cs)
    steps = -(-vpb // _CLUSTER_THREADS)
    pad = torch.nn.functional.pad

    def lanes(t):
        """[n, G, m] to [n, G, cs, steps, threads, 8]: rank, step, thread,
        the vector's values (zeros past the group)."""
        t = pad(t, (0, cs * vpb * 8 - m)).reshape(n, num_groups, cs, vpb, 8)
        return pad(t, (0, 0, 0, steps * _CLUSTER_THREADS - vpb)).reshape(
            n, num_groups, cs, steps, _CLUSTER_THREADS, 8)

    def block_total(t):
        """[n, G, cs]: each rank's sum in the kernel's order."""
        acc = torch.zeros(n, num_groups, cs, _CLUSTER_THREADS,
                          device=x.device)
        for k in range(steps):
            for e in range(8):
                acc = acc + t[:, :, :, k, :, e]
        warps = xor_tree_plain(acc.reshape(n, num_groups, cs, -1,
                                           32))[..., 0]
        out = torch.zeros(n, num_groups, cs, device=x.device)
        for w in range(warps.shape[-1]):
            out = out + warps[..., w]
        return out
    vals = lanes(x.reshape(n, num_groups, m).float())
    valid = lanes(torch.ones(n, num_groups, m, device=x.device)) != 0
    # the ranks' counts; divisions tensor by tensor (a CUDA division by a
    # Python number is a product with its reciprocal, not the kernel's
    # quotient)
    counts = [float(max(0, min(vpb, m // 8 - r * vpb)) * 8)
              for r in range(cs)]
    nb = torch.tensor(counts, device=x.device).expand(n, num_groups, cs)
    bmean = torch.where(nb > 0, block_total(vals) / nb.clamp(min=1.0), 0.0)
    d = vals - bmean[..., None, None, None]
    bm2 = block_total(torch.where(valid, d * d, 0.0))
    cnt = torch.zeros(n, num_groups, device=x.device)
    mean, m2 = torch.zeros_like(cnt), torch.zeros_like(cnt)
    for r in range(cs):
        if counts[r] == 0:
            continue
        cb = nb[..., r]
        tot = cnt + cb
        dr = bmean[..., r] - mean
        wt = cb / tot
        mean = mean + dr * wt
        m2 = (m2 + bm2[..., r]) + dr * dr * cnt * wt
        cnt = tot
    return mean, m2 / torch.full_like(m2, float(m))


def _cluster_channel_sums(t, num_groups, cs):
    """The per-(sample, channel) sums of ``t`` [N, C, S] fp32 (channels
    first, S a multiple of 8) in the cluster kernel's order, [N, C]: a
    group's channels cut into ``cs`` ranks of ceil(Cg / cs); a rank's nc
    channels each over tpc = 512 / 2^ceil(log2 nc) threads, thread t
    adding the channel's 8-value vectors t, t + tpc, ... in order, then
    the xor tree over the channel's lanes and its warps in order."""
    from .fused import xor_tree_plain
    n, c, s = t.shape
    cg = c // num_groups
    vs = s // 8
    tg = t.reshape(n, num_groups, cg, s)
    cpb = -(-cg // cs)
    out = torch.zeros(n, num_groups, cg, device=t.device)
    for r in range(cs):
        lo, hi = min(r * cpb, cg), min((r + 1) * cpb, cg)
        if lo == hi:
            continue
        nc = hi - lo
        tpc = _CLUSTER_THREADS >> (nc - 1).bit_length()
        steps = -(-vs // tpc)
        lanes = torch.nn.functional.pad(
            tg[:, :, lo:hi].reshape(n, num_groups, nc, vs, 8),
            (0, 0, 0, steps * tpc - vs)).reshape(n, num_groups, nc, steps,
                                                 tpc, 8)
        acc = torch.zeros(n, num_groups, nc, tpc, device=t.device)
        for k in range(steps):
            for e in range(8):
                acc = acc + lanes[:, :, :, k, :, e]
        if tpc <= 32:
            out[:, :, lo:hi] = xor_tree_plain(acc)[..., 0]
            continue
        warps = xor_tree_plain(acc.reshape(n, num_groups, nc, tpc // 32,
                                           32))[..., 0]
        total = torch.zeros(n, num_groups, nc, device=t.device)
        for k in range(tpc // 32):
            total = total + warps[..., k]
        out[:, :, lo:hi] = total
    return out.reshape(n, c)


def group_norm_column_sums_split_plain(t, num_groups, cs):
    """The sums of ``t`` [N, C, S] fp32 over samples and space, [C], in
    the cluster kernel's order: the per-(sample, channel) sums of
    ``_cluster_channel_sums`` into rows of the [N, 2 C] table, which the
    column sum adds over the samples (8 thread rows, samples p, p + 8, ...
    in order, then the rows in order). Only additions: given the kernel's
    own addends (dy for dbias without the SiLU) it gives the kernel's bits,
    which the card's tests hold."""
    table = _cluster_channel_sums(t, num_groups, cs)
    rows = torch.zeros(_CLUSTER_COL_ROWS, table.shape[1], device=t.device)
    for q in range(table.shape[0]):
        rows[q % _CLUSTER_COL_ROWS] = rows[q % _CLUSTER_COL_ROWS] + table[q]
    total = rows[0]
    for r in range(1, _CLUSTER_COL_ROWS):
        total = total + rows[r]
    return total


def group_norm_backward_split_plain(x, num_groups, weight, bias, dy, cs,
                                   silu=False, eps=1e-5):
    """(dweight, dbias [C], sa, sb [N, G]) in the cluster kernel's order of
    sums, in fp32 on x's device (x channels first, its spatial size a
    multiple of 8): A_c = sum dz x-hat and B_c = sum dz by
    ``_cluster_channel_sums``; a rank's w_c A_c and w_c B_c in channel
    order, the ranks in rank order (the group's sa, sb); dweight and dbias
    by ``group_norm_column_sums_split_plain``. The (mean, rstd) are the
    plain formula's; under ``silu`` dz rounds as the kernel rounds it (z
    and dz to dy's dtype). The addends here are plain fp32 arithmetic; the
    kernel contracts products into fused multiply-adds, so dweight's
    addends may differ from the kernel's in the last bits, and only sums
    of the kernel's own addends are bit-equal."""
    n, c, s, *_ = _layout(tuple(x.shape), False)
    cg = c // num_groups
    xf = x.reshape(n, num_groups, cg, s).float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    rstd = 1.0 / torch.sqrt(var + eps)
    xh = (xf - mean) * rstd
    wf = weight.float().reshape(1, num_groups, cg, 1)
    dz = dy.reshape(n, num_groups, cg, s).float()
    if silu:
        z = (xh * wf + bias.float().reshape(1, num_groups, cg, 1)).to(
            dy.dtype).float()
        sg = 1.0 / (1.0 + torch.exp(-z))
        dz = (dz * sg * (1.0 + z * (1.0 - sg))).to(dy.dtype).float()
    ca = _cluster_channel_sums((dz * xh).reshape(n, c, s), num_groups, cs)
    cb = _cluster_channel_sums(dz.reshape(n, c, s), num_groups, cs)
    ca = ca.reshape(n, num_groups, cg)
    cb = cb.reshape(n, num_groups, cg)
    cpb = -(-cg // cs)
    sa = torch.zeros(n, num_groups, device=x.device)
    sb = torch.zeros(n, num_groups, device=x.device)
    w2 = weight.float().reshape(num_groups, cg)
    for r in range(cs):
        lo, hi = min(r * cpb, cg), min((r + 1) * cpb, cg)
        if lo == hi:
            continue
        ra = torch.zeros(n, num_groups, device=x.device)
        rb = torch.zeros(n, num_groups, device=x.device)
        for ch in range(lo, hi):
            ra = ra + w2[:, ch] * ca[:, :, ch]
            rb = rb + w2[:, ch] * cb[:, :, ch]
        sa, sb = sa + ra, sb + rb
    dw = group_norm_column_sums_split_plain((dz * xh).reshape(n, c, s),
                                            num_groups, cs)
    db = group_norm_column_sums_split_plain(dz.reshape(n, c, s), num_groups,
                                            cs)
    return dw, db, sa, sb


# -- wrappers -----------------------------------------------------------------------

def _check(x, num_groups, weight, bias, channels_last):
    if x.dtype not in _DTYPES:
        raise ValueError(f"group_norm takes {_DTYPES}, got {x.dtype}")
    n, c, s, *_ = _layout(tuple(x.shape), channels_last)
    if num_groups < 1 or c % num_groups:
        raise ValueError(f"group_norm: {c} channels do not split into "
                         f"{num_groups} groups")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and (tuple(t.shape) != (c,)
                              or t.device != x.device):
            raise ValueError(f"group_norm: {name} must be [{c}] on "
                             f"{x.device}, got {tuple(t.shape)} on "
                             f"{t.device}")
    return n, c, s


def _args(x, num_groups, channels_last):
    """(triton, kernels, grid, the layout's and plan's launch arguments,
    BLOCK_C, BLOCK_S, n_chunks) of a CUDA tensor."""
    n, c, s, sn, sc, ss = _layout(tuple(x.shape), channels_last)
    cg = c // num_groups
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    bc, bs, chunk, n_chunks = _plan(n, num_groups, cg, s, sms)
    triton, k = _jit()
    grid = (n * num_groups, n_chunks)
    return (triton, k, grid, (s, num_groups, cg, sn, sc, ss, chunk, n_chunks),
            bc, bs, n_chunks)


def _warps(bc, bs):
    return 8 if bc * bs >= _TILE else 4


def _triton_forward(x, weight, bias, y, stats, num_groups, eps,
                    channels_last, silu):
    """The two Triton kernels: the chunks' statistics, then y (also called
    alone: the smoke and the card's tests hold the cluster kernel against
    them)."""
    triton, k, grid, geo, bc, bs, n_chunks = _args(x, num_groups,
                                                   channels_last)
    part = torch.empty(grid[0] * n_chunks, 3, dtype=torch.float32,
                       device=x.device)
    nw = _warps(bc, bs)
    k["stats"][grid](x, part, *geo, BLOCK_C=bc, BLOCK_S=bs, num_warps=nw)
    k["fwd"][grid](x, weight, bias, y, part, stats, *geo, float(eps),
                   SILU=bool(silu), BLOCK_C=bc, BLOCK_S=bs, num_warps=nw)


def group_norm_forward(x, weight, bias, num_groups, eps=1e-5,
                       channels_last=False, silu=False, out_dtype=None):
    """(y, stats) of the forward kernel on a contiguous CUDA x: y in
    ``out_dtype`` (x's dtype), stats the fp32 (mean, rstd) of each
    (sample, group), ``[N * G, 2]``. ``weight`` and ``bias`` are tensors
    of [C], in any dtype. The route is ``group_norm_forward_plan``'s; an x
    not 16-byte aligned takes the Triton kernels.
    ``LAUNCHES["group_norm"]`` counts every call,
    ``["group_norm_cluster"]`` those of the cluster kernel."""
    n, c, s = _check(x, num_groups, weight, bias, channels_last)
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _DTYPES:
        raise ValueError(f"group_norm writes {_DTYPES}, not {out_dtype}")
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    stats = torch.empty(n * num_groups, 2, dtype=torch.float32,
                        device=x.device)
    if x.numel():
        plan = group_norm_forward_plan(c // num_groups, s, channels_last,
                                       x.dtype)
        if plan.route == "cluster" and x.data_ptr() % 16 == 0:
            _cluster_forward(x, weight, bias, y, stats, num_groups, eps,
                             silu, plan)
            LAUNCHES["group_norm_cluster"] += 1
        else:
            _triton_forward(x, weight, bias, y, stats, num_groups, eps,
                            channels_last, silu)
    LAUNCHES["group_norm"] += 1
    return y, stats


def _triton_backward(x, weight, bias, stats, dy, num_groups, channels_last,
                     silu, dx, sums):
    """The three Triton kernels: the chunks' partial sums, dx, the
    column sums (also called alone: the smoke and the card's tests hold
    the cluster kernel against them)."""
    c = x.shape[-1] if channels_last else x.shape[1]
    triton, k, grid, geo, bc, bs, n_chunks = _args(x, num_groups,
                                                   channels_last)
    rows = x.shape[0] * n_chunks
    part = torch.empty(rows, 2 * c, dtype=torch.float32, device=x.device)
    nw = _warps(bc, bs)
    k["bwd_part"][grid](x, weight, bias, dy, stats, part, c, *geo,
                        SILU=bool(silu), BLOCK_C=bc, BLOCK_S=bs,
                        num_warps=nw)
    k["bwd_dx"][grid](x, weight, bias, dy, dx, stats, part, c, *geo,
                      SILU=bool(silu), BLOCK_C=bc, BLOCK_S=bs,
                      num_warps=nw)
    k["col_sum"][(triton.cdiv(2 * c, 64),)](part, sums, rows, 2 * c,
                                            BLOCK_P=64, BLOCK_C=64,
                                            num_warps=4)


def group_norm_backward(x, weight, bias, stats, dy, num_groups,
                        channels_last=False, silu=False):
    """(dx, dweight, dbias) on CUDA tensors from the forward's x and stats:
    dx in x's dtype, the two [C] vector gradients in fp32, each a sum of
    partials added in a fixed order. The route is
    ``group_norm_backward_plan``'s; tensors not 16-byte aligned take the
    Triton kernels. ``LAUNCHES["group_norm_bwd"]``
    counts every call, ``["group_norm_bwd_cluster"]`` those of the cluster
    kernel."""
    dy = dy.contiguous()
    n, c, s = _check(x, num_groups, weight, bias, channels_last)
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"group_norm_backward: dy {tuple(dy.shape)} "
                         f"against x {tuple(x.shape)}")
    dx = torch.empty_like(x)
    # either route's column sum writes every entry; an empty x runs none
    sums = (torch.empty if x.numel() else torch.zeros)(
        2 * c, dtype=torch.float32, device=x.device)
    if x.numel():
        plan = group_norm_backward_plan(c // num_groups, s, channels_last,
                                        x.dtype)
        if plan.route == "cluster" and x.data_ptr() % 16 == 0 \
                and dy.data_ptr() % 16 == 0:
            _cluster_backward(x, weight, bias, stats, dy, num_groups, silu,
                              dx, sums, plan)
            LAUNCHES["group_norm_bwd_cluster"] += 1
        else:
            _triton_backward(x, weight, bias, stats, dy, num_groups,
                             channels_last, silu, dx, sums)
    LAUNCHES["group_norm_bwd"] += 1
    return dx, sums[:c], sums[c:]


class GroupNormFunction(torch.autograd.Function):
    """GroupNorm (with the SiLU after it) through the kernels: it keeps x,
    the weight and bias (ones and zeros where there are none) and the
    groups' (mean, rstd)."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, channels_last, silu,
                out_dtype):
        c = x.shape[-1] if channels_last else x.shape[1]
        w = weight if weight is not None else torch.ones(
            c, dtype=torch.float32, device=x.device)
        b = bias if bias is not None else torch.zeros(
            c, dtype=torch.float32, device=x.device)
        y, stats = group_norm_forward(x, w, b, num_groups, eps,
                                      channels_last, silu, out_dtype)
        ctx.save_for_backward(x, w, b, stats)
        ctx.args = (num_groups, channels_last, silu)
        ctx.dtypes = tuple(None if t is None else t.dtype
                           for t in (weight, bias))
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, b, stats = ctx.saved_tensors
        dx, dw, db = group_norm_backward(x, w, b, stats, dy, *ctx.args)
        tw, tb = ctx.dtypes
        return (dx, None if tw is None else dw.to(tw),
                None if tb is None else db.to(tb), None, None, None, None,
                None)


def group_norm(x, num_groups, weight=None, bias=None, eps=1e-5,
               channels_last=False, silu=False, out_dtype=None):
    """GroupNorm of x ([N, C, ...], or [N, ..., C] with ``channels_last``)
    over ``num_groups`` groups, written in ``out_dtype`` (x's dtype), with
    ``silu`` a SiLU after it; differentiable: on a CUDA tensor the kernels
    (forward and backward, each by its plan), on a CPU tensor
    ``group_norm_plain``."""
    if x.device.type == "cpu":
        return group_norm_plain(x, num_groups, weight, bias, eps,
                                channels_last, silu, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm runs on cuda or cpu, not {x.device}")
    return GroupNormFunction.apply(x.contiguous(), weight, bias,
                                   int(num_groups), float(eps),
                                   bool(channels_last), bool(silu),
                                   out_dtype)


__all__ = ["group_norm", "group_norm_plain", "group_stats_split_plain",
           "group_stats_cluster_plain",
           "group_norm_forward", "group_norm_backward", "GroupNormFunction",
           "group_norm_forward_plan", "GnFwdPlan",
           "group_norm_backward_plan", "GnBwdPlan",
           "group_norm_backward_split_plain",
           "group_norm_column_sums_split_plain"]
