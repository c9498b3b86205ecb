"""Dropout's random mask: Philox4x32-10 in a Triton kernel, and its plain
PyTorch version.

No TPU kernel: the JAX package's ``F.dropout``
(``paddle_tpu/nn/functional/common.py:40-59``) draws
``jax.random.bernoulli`` and selects, which XLA fuses into one pass of its
compiled step; its attention draws the same over the probabilities
(``paddle_tpu/nn/functional/attention.py:39-41``). Here the mask is made
in registers from a counter-based generator, so nothing of it is stored:
the backward runs the same kernel on the gradient and draws the mask
again.

The bits (``framework/random.py``): element e of a mask drawn under
``RandomKey(base, site)`` is word ``e % 4`` of Philox4x32-10 with counter
``(e // 4 low, e // 4 high, site, 0)`` and key ``base``; it is dropped
where its top 24 bits are below ``round(p * 2**24)`` (p to 2**-24). The
kernel reads ``base`` from a device tensor (int64 ``[2]``), so a captured
step replays with each step's key; ``site`` is a launch argument (a step's
sites come in the same order every step). ``philox_plain`` makes the same
words with int64 torch ops, the 32 x 32-bit products split into 16-bit
limbs (torch has no unsigned multiply-high), on any device.

The kept values are ``x * scale`` in fp32, rounded to x's dtype, with
``scale`` the fp32 value of ``1 / (1 - p)`` ("upscale_in_train") or 1
("downscale_in_infer"); the JAX function divides by ``1 - p`` (within an
fp32 ulp of this; the kernel and the plain version multiply, so they are
bit-equal).

Bound on the H100: bytes. A Philox block of four words costs 10 rounds
of 2 multiply-highs, 2 multiplies, 4 xors and 2 key adds, about 25
integer operations an element, which the SMs' integer units finish in
less time than the memory takes to read and write the element. One
program covers 1024 blocks (4096 elements) as a [1024, 4] tile: each row
of the tile is one Philox block, its four elements read and written
once.

Triton is imported, and the kernel compiled, at the first launch.
"""
from __future__ import annotations

import functools
import math
import struct

import torch

from . import LAUNCHES
from ..framework.random import M32, PHILOX_M, PHILOX_ROUNDS, PHILOX_W

tl = None    # triton.language, bound by _jit() at the first launch
_philox = None   # the wrapped ``_philox_tl``, bound by _jit()

MODES = ("upscale_in_train", "downscale_in_infer")
_BLOCK_G = 1024          # Philox blocks (4 elements each) a program
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _philox_tl(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on uint32 tensors (one block an element)."""
    for _ in tl.static_range(10):
        h0 = tl.umulhi(c0, 0xD2511F53)
        h1 = tl.umulhi(c2, 0xCD9E8D57)
        l0 = c0 * 0xD2511F53
        l1 = c2 * 0xCD9E8D57
        c0 = h1 ^ c1 ^ k0
        c2 = h0 ^ c3 ^ k1
        c1 = l1
        c3 = l0
        k0 = k0 + 0x9E3779B9
        k1 = k1 + 0xBB67AE85
    return c0, c1, c2, c3


def _mask_bits(grp, word, key_ptr, site):
    """The mask words of the elements whose Philox block is ``grp`` (int64)
    and word in it ``word`` (broadcast together)."""
    k0 = tl.load(key_ptr).to(tl.uint32)
    k1 = tl.load(key_ptr + 1).to(tl.uint32)
    c0 = grp.to(tl.uint32)
    c1 = (grp >> 32).to(tl.uint32)
    c2 = tl.zeros_like(c0) + site.to(tl.uint32)
    c3 = tl.zeros_like(c0)
    r0, r1, r2, r3 = _philox(c0, c1, c2, c3, k0, k1)
    return tl.where(word == 0, r0, tl.where(word == 1, r1,
                                            tl.where(word == 2, r2, r3)))


def _dropout_kernel(x_ptr, y_ptr, key_ptr, n, site, thresh, scale,
                    BLOCK_G: tl.constexpr):
    g = tl.program_id(0).to(tl.int64) * BLOCK_G + tl.arange(0, BLOCK_G)
    j = tl.arange(0, 4)
    offs = g[:, None] * 4 + j[None, :]
    m = offs < n
    x = tl.load(x_ptr + offs, mask=m, other=0.0).to(tl.float32)
    bits = _mask_bits(g[:, None], j[None, :], key_ptr, site)
    keep = (bits >> 8).to(tl.int32) >= thresh
    y = tl.where(keep, x * scale, 0.0)
    tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=m)


@functools.lru_cache(maxsize=None)
def _jit():
    """Import Triton and wrap the kernel and its helpers (once). The
    kernels call the helpers by their module names, so those names are
    bound to the wrapped helpers here (``kernels/fused.py`` reads
    ``_mask_bits`` from this module after this call)."""
    global tl, _philox, _mask_bits
    import triton
    import triton.language
    tl = triton.language
    _philox = triton.jit(_philox_tl)
    _mask_bits = triton.jit(_mask_bits)
    return triton, {"dropout": triton.jit(_dropout_kernel,
                                          do_not_specialize=["site",
                                                             "thresh"])}


# -- the mask's parameters ------------------------------------------------------

def threshold(p: float) -> int:
    """The 24-bit threshold below which a word drops its element."""
    return int(round(float(p) * (1 << 24)))


def scale_of(p: float, mode: str) -> float:
    """The fp32 factor of a kept element: ``1 / (1 - p)`` rounded to fp32
    ("upscale_in_train"), or 1 ("downscale_in_infer")."""
    if mode not in MODES:
        raise ValueError(f"dropout mode must be one of {MODES}, got {mode!r}")
    if mode == "downscale_in_infer":
        return 1.0
    return struct.unpack("f", struct.pack("f", 1.0 / (1.0 - float(p))))[0]


# -- plain versions -------------------------------------------------------------

def _mulhilo(a, m):
    """(high, low) 32-bit words of ``a * m``: a an int64 tensor of values
    in [0, 2**32), m a 32-bit constant, in 16-bit limbs of m so that no
    int64 product overflows."""
    lo16 = a * (m & 0xFFFF)
    hi16 = a * (m >> 16)
    hi = (hi16 + (lo16 >> 16)) >> 16
    lo = (((hi16 & 0xFFFF) << 16) + lo16) & M32
    return hi, lo


def philox_plain(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding 32-bit words (k0, k1 may be
    ints or 0-d tensors): the kernel's rounds."""
    for _ in range(PHILOX_ROUNDS):
        h0, l0 = _mulhilo(c0, PHILOX_M[0])
        h1, l1 = _mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = h1 ^ c1 ^ k0, l1, h0 ^ c3 ^ k1, l0
        k0 = (k0 + PHILOX_W[0]) & M32
        k1 = (k1 + PHILOX_W[1]) & M32
    return c0, c1, c2, c3


def _key_words(base, device):
    """The two key words for the plain version: ints, or 0-d int64
    tensors on ``device`` (read from a key tensor without a host copy)."""
    if torch.is_tensor(base):
        base = base.to(device)
        return base[0], base[1]
    return int(base[0]) & M32, int(base[1]) & M32


def mask_bits_plain(n: int, key, device=None):
    """The first ``n`` words of the mask under ``key`` (a ``RandomKey``),
    int64 in [0, 2**32)."""
    base, site = key
    if device is None:
        device = base.device if torch.is_tensor(base) else torch.device("cpu")
    k0, k1 = _key_words(base, device)
    g = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    r = philox_plain(g & M32, g >> 32, torch.full_like(g, int(site) & M32),
                     torch.zeros_like(g), k0, k1)
    return torch.stack(r, dim=-1).reshape(-1)[:n]


def keep_mask_plain(shape, p, key, device=None):
    """The keep mask (bool, ``shape``) of dropout at rate p under ``key``."""
    n = math.prod(shape)
    bits = mask_bits_plain(n, key, device)
    return ((bits >> 8) >= threshold(p)).reshape(shape)


def uniform_plain(shape, key, device=None):
    """Uniform fp32 values in (0, 1) of ``shape`` under ``key`` (a
    ``RandomKey``): the top 24 bits of the mask's words, plus a half, over
    2^24. The port's random layers and initializers draw from these."""
    bits = mask_bits_plain(math.prod(shape), key, device)
    return (((bits >> 8).float() + 0.5) * 2.0 ** -24).reshape(tuple(shape))


def dropout_plain(x, p, key, mode="upscale_in_train", mask_shape=None):
    """``where(keep, x * scale, 0)`` in fp32, rounded to x's dtype, with
    the keep mask of ``mask_shape`` (x's shape when None; else it
    broadcasts over x: the ``axis`` form) under ``key``."""
    shape = tuple(x.shape) if mask_shape is None else tuple(mask_shape)
    keep = keep_mask_plain(shape, p, key, x.device)
    y = torch.where(keep, x.float() * scale_of(p, mode),
                    torch.zeros((), dtype=torch.float32, device=x.device))
    return y.to(x.dtype)


# -- the kernel -------------------------------------------------------------------

def key_tensor(base, device):
    """The key as the int64 ``[2]`` tensor the kernels read: a device
    tensor as it is, two ints copied to ``device``."""
    if torch.is_tensor(base):
        if base.device != device or base.dtype != torch.int64 \
                or base.shape != (2,) or not base.is_contiguous():
            raise ValueError(f"a key tensor must be int64 [2] on {device}, "
                             f"got {base.dtype} {tuple(base.shape)} on "
                             f"{base.device}")
        return base
    return torch.tensor([int(base[0]) & M32, int(base[1]) & M32],
                        dtype=torch.int64, device=device)


def _launch(x, key, p, scale):
    """The Triton pass over a contiguous CUDA tensor: a new tensor of x's
    dtype, ``where(keep, x * scale, 0)``."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"dropout takes {_DTYPES}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("dropout: x must be contiguous")
    base, site = key
    kt = key_tensor(base, x.device)
    triton, k = _jit()
    y = torch.empty_like(x)
    n = x.numel()
    if n:
        k["dropout"][(triton.cdiv(n, 4 * _BLOCK_G),)](
            x, y, kt, n, int(site) & M32, threshold(p), scale,
            BLOCK_G=_BLOCK_G, num_warps=8)
    LAUNCHES["dropout"] += 1
    return y


def _apply(x, key, p, mode, mask_shape):
    """Dropout of x on its device: the kernel on a CUDA tensor (for a
    broadcast mask, the kernel draws the mask's scale factors and one
    product spreads them over x), the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return dropout_plain(x, p, key, mode, mask_shape)
    if x.device.type != "cuda":
        raise ValueError(f"dropout runs on cuda or cpu, not {x.device}")
    scale = scale_of(p, mode)
    if mask_shape is None or tuple(mask_shape) == tuple(x.shape):
        return _launch(x.contiguous(), key, p, scale)
    m = _launch(torch.ones(mask_shape, dtype=torch.float32,
                           device=x.device), key, p, scale)
    y = torch.where(m != 0, x.float() * m,
                    torch.zeros((), dtype=torch.float32, device=x.device))
    return y.to(x.dtype)


class DropoutFunction(torch.autograd.Function):
    """Dropout whose backward is the same pass on the gradient: the mask
    is drawn again from the key, never stored."""

    @staticmethod
    def forward(ctx, x, key, p, mode, mask_shape):
        ctx.key, ctx.p, ctx.mode, ctx.mask_shape = key, p, mode, mask_shape
        return _apply(x, key, p, mode, mask_shape)

    @staticmethod
    def backward(ctx, dy):
        return (_apply(dy, ctx.key, ctx.p, ctx.mode, ctx.mask_shape),
                None, None, None, None)


def dropout(x, key, p, mode="upscale_in_train", mask_shape=None):
    """Dropout of x at rate ``p`` (0 < p < 1) under ``key`` (a
    ``RandomKey``), differentiable: the Triton kernel on a CUDA tensor, the
    plain version on a CPU tensor; ``mask_shape`` broadcasts one mask over
    x (the ``axis`` form)."""
    scale_of(p, mode)       # checks the mode
    return DropoutFunction.apply(x, key, float(p), mode,
                                 None if mask_shape is None
                                 else tuple(mask_shape))


__all__ = ["dropout", "dropout_plain", "uniform_plain", "DropoutFunction",
           "philox_plain", "mask_bits_plain", "keep_mask_plain", "key_tensor",
           "threshold", "scale_of", "MODES"]
