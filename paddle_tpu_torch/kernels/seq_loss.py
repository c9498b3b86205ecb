"""CTC and RNN-T losses: CUDA kernels (``csrc/ctc_loss.cu``,
``csrc/rnnt_loss.cu``) and their plain PyTorch versions.

No TPU kernel: the JAX package's ``ctc_loss`` and ``rnnt_loss``
(``paddle_tpu/nn/functional/loss.py:282, :363``) are recursions in the
log semiring written as ``jax.lax.scan``s (RNN-T a scan over time with a
scan over the labels inside it, ``:405``), which XLA compiles into a
while loop on the device. In PyTorch a scan is a Python loop of small
ops, T of them for CTC and T x U for RNN-T, thousands of launches a
forward: the kernels run each sample's whole recursion in one block.

The arithmetic is the JAX functions', in fp32 whatever the input's
dtype: the input log-softmaxed, the floor ``NEG = -1e30`` (not -inf),
``logaddexp(a, b) = max(a, b) + log1p(exp(-|a - b|))``, each sample read
at ``t_last = clip(input_len - 1, 0, T - 1)``. Neither kernel nor plain
version computes past ``t_last`` or past a sample's labels: nothing there
reaches the loss. The gradient is the JAX autodiff of that recursion, not
the textbook alpha-beta product: the adjoint ``G`` of each state runs
backwards from the loss, and a ``logaddexp`` hands its output's adjoint
to each input x times ``exp(x - out)``, as JAX's rule does. Where every
path is infeasible (all at the floor, absorbed in fp32) that gives JAX's
finite values, not zeros. The log-softmax's gradient is then ``dx = gLP -
softmax * sum(gLP)``, gLP the gradient of the gathered log-probabilities.

The wrappers return each sample's negative log-likelihood (fp32 ``[B]``);
the caller reduces. CTC's ``norm_by_times`` scales only its gradient, by
``1 / max(input_len, 1)``; RNN-T's ``fastemit_lambda`` only the emission
log-probabilities' gradient, by ``1 + lambda``; neither changes the value.

Kernels (each wrapper call launches two CUDA kernels and counts once in
``LAUNCHES``: ``ctc_fwd``, ``ctc_bwd``, ``rnnt_fwd``, ``rnnt_bwd``): a pass
over the rows (one warp a row: the row's log-sum-exp and the gathered
log-probabilities forward; the row's gradient backward) and a recursion
(one block a sample: the states of a time step, or of a lattice
anti-diagonal, across its threads, in shared memory, a barrier between
steps). The source notes say what bounds each on the card. No float
atomics: the sums run in a fixed order, so two runs give the same bits
and a captured step its eager step's. Lengths and labels stay on the
device (no ``.item()``), so a training step around them can be captured.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES
from ._build import library

NEG = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _lae(a, b):
    """JAX's ``logaddexp`` of finite fp32 values."""
    return torch.maximum(a, b) + torch.log1p(torch.exp(-(a - b).abs()))


def _neg(like, *shape):
    return torch.full(shape, NEG, dtype=torch.float32, device=like.device)


def _lengths(ilen, llen, T, L, device):
    """(t_last, label length clipped to [0, L]) as int64 on ``device``."""
    t_last = (ilen.to(device).long() - 1).clamp(0, T - 1)
    return t_last, llen.to(device).long().clamp(0, L)


# -- CTC, plain ---------------------------------------------------------------

def _ctc_ext(labels, blank, B, L, device):
    """The extended labels ``[B, 2L + 1]`` (blank, l1, blank, ..., blank)
    and where the skip s-2 -> s is allowed."""
    S = 2 * L + 1
    ext = torch.full((B, S), blank, dtype=torch.int64, device=device)
    ext[:, 1::2] = labels.to(device).long()
    s = torch.arange(S, device=device)
    skip = (s % 2 == 1) & (s >= 2) & (ext != torch.roll(ext, 2, dims=1))
    return ext, skip


def _ctc_merge(prev, skip):
    """(stay, prev1, prev2, u, m) of a step from the previous alphas:
    ``u = lae(stay, prev1)``, ``m = lae(u, prev2)`` (prev2 at the floor
    where the skip is not allowed)."""
    B = prev.shape[0]
    p1 = torch.cat([_neg(prev, B, 1), prev[:, :-1]], 1)[:, :prev.shape[1]]
    p2 = torch.cat([_neg(prev, B, 2), prev[:, :-2]], 1)[:, :prev.shape[1]]
    p2 = torch.where(skip, p2, _neg(prev, 1, 1))
    u = _lae(prev, p1)
    return prev, p1, p2, u, _lae(u, p2)


def ctc_forward_plain(x, labels, ilen, llen, blank=0):
    """Each sample's CTC negative log-likelihood (fp32 ``[B]``) of
    ``x [T, B, C]`` (logits, log-softmaxed here) and ``labels [B, L]``,
    step by step as the JAX scan, and what the backward reads: (nll,
    alpha ``[T, B, 2L + 1]``)."""
    T, B, _ = x.shape
    L = labels.shape[1]
    dev = x.device
    lp = torch.log_softmax(x.float(), dim=-1)
    ext, skip = _ctc_ext(labels, blank, B, L, dev)
    t_last, ll = _lengths(ilen, llen, T, L, dev)
    emit = lp.gather(2, ext.unsqueeze(0).expand(T, B, 2 * L + 1))
    alpha = _neg(x, B, 2 * L + 1)
    alpha[:, 0] = lp[0, :, blank]
    if L > 0:
        alpha[:, 1] = torch.where(ll > 0, emit[0, :, 1], _neg(x, B))
    hist = [alpha]
    for t in range(1, T):
        alpha = _ctc_merge(alpha, skip)[4] + emit[t]
        hist.append(alpha)
    hist = torch.stack(hist)
    return _ctc_nll(hist, t_last, ll)[0], hist


def _ctc_nll(hist, t_last, ll):
    """(nll, end1, end2, loglik) from the alpha history."""
    B = hist.shape[1]
    a_last = hist[t_last, torch.arange(B, device=hist.device)]
    sl = 2 * ll
    end1 = a_last.gather(1, sl[:, None])[:, 0]
    end2 = a_last.gather(1, (sl - 1).clamp(0, hist.shape[2] - 1)[:, None])
    end2 = torch.where(ll > 0, end2[:, 0], torch.full_like(end1, NEG))
    loglik = _lae(end1, end2)
    return -loglik, end1, end2, loglik


def ctc_backward_plain(x, labels, ilen, llen, alpha, g, blank=0,
                       norm_by_times=False):
    """dx (x's dtype) of ``sum(g * nll)``: the adjoint of the forward's
    recursion run backwards from each sample's ``t_last``, then the
    log-softmax's gradient. ``g [B]`` is the upstream gradient."""
    return softmax_grad_plain(x, ctc_log_prob_grad_plain(
        x, labels, ilen, llen, alpha, g, blank, norm_by_times))


def softmax_grad_plain(x, glp):
    """dx (x's dtype) of the log-softmax over x's last axis, given the
    gradient ``glp`` (fp32) on its output: ``glp - softmax(x) *
    sum(glp)``."""
    sm = torch.softmax(x.float(), dim=-1)
    return (glp - sm * glp.sum(-1, keepdim=True)).to(x.dtype)


def ctc_log_prob_grad_plain(x, labels, ilen, llen, alpha, g, blank=0,
                            norm_by_times=False):
    """The gradient (fp32, x's shape) of ``sum(g * nll)`` on the
    log-softmaxed logits: each class sums the adjoints of its states."""
    T, B, C = x.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = x.device
    ext, skip = _ctc_ext(labels, blank, B, L, dev)
    t_last, ll = _lengths(ilen, llen, T, L, dev)
    g = g.to(dev).float()
    if norm_by_times:
        g = g * (1.0 / ilen.to(dev).float().clamp(min=1.0))
    _, end1, end2, loglik = _ctc_nll(alpha, t_last, ll)
    rows = torch.arange(B, device=dev)
    seed = torch.zeros(B, S, dtype=torch.float32, device=dev)
    seed[rows, 2 * ll] = -g * torch.exp(end1 - loglik)
    second = torch.where(ll > 0, -g * torch.exp(end2 - loglik),
                         torch.zeros_like(g))
    seed[rows, (2 * ll - 1).clamp(min=0)] += second
    G = torch.zeros(B, S, dtype=torch.float32, device=dev)
    gE = torch.zeros(T, B, S, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for t in range(T - 1, 0, -1):
        G = G + torch.where((t_last == t)[:, None], seed, zero)
        gE[t] = G
        st, p1, p2, u, m = _ctc_merge(alpha[t - 1], skip)
        a = G * torch.exp(u - m)
        c_p1 = a * torch.exp(p1 - u)
        c_p2 = torch.where(skip, G * torch.exp(p2 - m), zero)
        G = a * torch.exp(st - u)
        G[:, :-1] += c_p1[:, 1:]
        G[:, :-2] += c_p2[:, 2:]
    G = G + torch.where((t_last == 0)[:, None], seed, zero)
    s = torch.arange(S, device=dev)
    first = (s == 0) | ((s == 1) & (ll > 0)[:, None])
    gE[0] = torch.where(first, G, zero)
    glp = torch.zeros(T, B, C, dtype=torch.float32, device=dev)
    glp.scatter_add_(2, ext.unsqueeze(0).expand(T, B, S), gE)
    return glp


# -- RNN-T, plain -------------------------------------------------------------

def _rnnt_lp(x, labels, blank):
    """(blank log-probs [B, T, U+1], label log-probs [B, T, U]) of the
    log-softmaxed joint ``x [B, T, U+1, V]``."""
    B, T, U1, _ = x.shape
    lp = torch.log_softmax(x.float(), dim=-1)
    idx = labels.to(x.device).long()[:, None, :, None].expand(B, T, U1 - 1, 1)
    return lp[..., blank], lp[:, :, :U1 - 1, :].gather(3, idx)[..., 0]


def _diagonal(d, T, U1, device):
    """The lattice cells (t, u) with t + u = d."""
    u = torch.arange(max(0, d - T + 1), min(d, U1 - 1) + 1, device=device)
    return d - u, u


def rnnt_forward_plain(x, labels, ilen, llen, blank=0):
    """Each sample's RNN-T negative log-likelihood (fp32 ``[B]``) of the
    joint ``x [B, T, U+1, V]`` (logits) and ``labels [B, U]``, and the
    alphas ``[B, T, U+1]`` the backward reads: ``alpha(t, u) =
    lae(alpha(t-1, u) + blank(t-1, u), alpha(t, u-1) + emit(t, u-1))``
    (at t = 0 the first term is the floor; at u = 0 the second is absent),
    the JAX scans' cells computed one lattice anti-diagonal at a time
    (each cell is the same formula of the same two cells)."""
    B, T, U1, _ = x.shape
    U = U1 - 1
    dev = x.device
    blp, elp = _rnnt_lp(x, labels, blank)
    t_last, ll = _lengths(ilen, llen, T, U, dev)
    em = torch.where(torch.arange(U, device=dev)[None, None, :]
                     < ll[:, None, None], elp, torch.full_like(elp, NEG))
    alpha = _neg(x, B, T, U1)
    for d in range(T + U):
        t, u = _diagonal(d, T, U1, dev)
        tp = (t - 1).clamp(min=0)
        from_t = torch.where(t > 0, alpha[:, tp, u] + blp[:, tp, u],
                             torch.full((B, t.numel()), NEG, device=dev))
        val = torch.where(t > 0, from_t, torch.zeros_like(from_t))
        if U > 0:
            up = (u - 1).clamp(min=0)
            val = torch.where(u > 0, _lae(from_t, alpha[:, t, up]
                                          + em[:, t, up]), val)
        alpha[:, t, u] = val
    rows = torch.arange(B, device=dev)
    nll = -(alpha[rows, t_last, ll] + blp[rows, t_last, ll])
    return nll, alpha


def rnnt_backward_plain(x, labels, ilen, llen, alpha, g, blank=0,
                        fastemit_lambda=0.0):
    """dx (x's dtype) of ``sum(g * nll)``: the adjoint of each lattice
    cell, pulled from its two successors one anti-diagonal at a time from
    ``(t_last, label_len)``; the emissions' share times ``1 +
    fastemit_lambda``; then the log-softmax's gradient."""
    return softmax_grad_plain(x, rnnt_log_prob_grad_plain(
        x, labels, ilen, llen, alpha, g, blank, fastemit_lambda))


def rnnt_log_prob_grad_plain(x, labels, ilen, llen, alpha, g, blank=0,
                             fastemit_lambda=0.0):
    """The gradient (fp32, x's shape) of ``sum(g * nll)`` on the
    log-softmaxed joint: non-zero only at blank and at each position's
    label."""
    B, T, U1, V = x.shape
    U = U1 - 1
    dev = x.device
    blp, elp = _rnnt_lp(x, labels, blank)
    t_last, ll = _lengths(ilen, llen, T, U, dev)
    rows = torch.arange(B, device=dev)
    g = g.to(dev).float()
    G = torch.zeros(B, T + 1, U1 + 1, dtype=torch.float32, device=dev)
    gB = torch.zeros(B, T, U1, dtype=torch.float32, device=dev)
    gE = torch.zeros(B, T, max(U, 1), dtype=torch.float32, device=dev)
    G[rows, t_last, ll] = -g
    gB[rows, t_last, ll] = -g
    a_pad = torch.full((B, T + 1, U1 + 1), NEG, dtype=torch.float32,
                       device=dev)
    a_pad[:, :T, :U1] = alpha
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    scale = 1.0 + float(fastemit_lambda)
    for d in range(T + U - 1, -1, -1):
        t, u = _diagonal(d, T, U1, dev)
        a = alpha[:, t, u]
        w_a = torch.where(
            u > 0, torch.exp(a + blp[:, t, u] - a_pad[:, t + 1, u]),
            torch.ones_like(a))
        from_t = torch.where((t + 1)[None, :] <= t_last[:, None],
                             G[:, t + 1, u] * w_a, zero)
        uc = u.clamp(max=max(U - 1, 0))
        if U > 0:
            w_b = torch.exp(a + elp[:, t, uc] - a_pad[:, t, u + 1])
            from_u = torch.where((u + 1)[None, :] <= ll[:, None],
                                 G[:, t, u + 1] * w_b, zero)
        else:
            from_u = torch.zeros_like(from_t)
        G[:, t, u] += from_t + from_u
        gB[:, t, u] += from_t
        if U > 0:
            gE[:, t, uc] += torch.where(u[None, :] < U, from_u * scale, zero)
    glp = torch.zeros(B, T, U1, V, dtype=torch.float32, device=dev)
    glp[..., blank] += gB
    if U > 0:
        idx = labels.to(dev).long()[:, None, :, None].expand(B, T, U, 1)
        glp[:, :, :U, :].scatter_add_(3, idx, gE[..., None])
    return glp


# -- the kernels --------------------------------------------------------------

_SIGS = {
    "ptt_ctc_forward": [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5,
    "ptt_ctc_backward": [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 7,
    "ptt_rnnt_forward": [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 6,
    "ptt_rnnt_backward": [ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_float]
    + [ctypes.c_void_p] * 9,
}


def _lib(name):
    lib = library(name)
    if lib.ptt_error_string.restype is not ctypes.c_char_p:
        for fn, args in _SIGS.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = ctypes.c_int
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
    return lib


def _check_launch(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.ptt_error_string(err).decode())


def _inputs(x, labels, ilen, llen):
    """x contiguous, labels and lengths as contiguous int32 on x's device;
    raises on what the kernels do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"the sequence-loss kernels run on cuda, not "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the sequence-loss kernels take float32 or "
                        f"bfloat16 logits, got {x.dtype}")
    def i32(t):
        return t.to(device=x.device, dtype=torch.int32).contiguous()
    return x.contiguous(), i32(labels), i32(ilen), i32(llen)


def _ptr(t):
    return t.data_ptr() if t.numel() else None


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def ctc_forward(x, labels, ilen, llen, blank=0):
    """The kernel: (nll fp32 ``[B]``, lse ``[T, B]``, alpha ``[B, T, 2L +
    1]``) of ``x [T, B, C]`` on the card."""
    x, lab, il, ll = _inputs(x, labels, ilen, llen)
    T, B, C = x.shape
    L = lab.shape[1]
    f32 = dict(dtype=torch.float32, device=x.device)
    lse = torch.empty(T, B, **f32)
    lpl = torch.empty(B, T, L + 1, **f32)
    alpha = torch.empty(B, T, 2 * L + 1, **f32)
    nll = torch.empty(B, **f32)
    lib = _lib("ctc_loss")
    err = lib.ptt_ctc_forward(x.data_ptr(), _DTYPE_CODE[x.dtype], _ptr(lab),
                              il.data_ptr(), ll.data_ptr(), T, B, C, L,
                              int(blank), lse.data_ptr(), lpl.data_ptr(),
                              alpha.data_ptr(), nll.data_ptr(), _stream(x))
    _check_launch(lib, err, "ctc forward")
    LAUNCHES["ctc_fwd"] += 1
    return nll, lse, alpha


def ctc_backward(x, labels, ilen, llen, lse, alpha, g, blank=0,
                 norm_by_times=False):
    """The kernel: dx (x's dtype) of ``sum(g * nll)`` on the card."""
    x, lab, il, ll = _inputs(x, labels, ilen, llen)
    T, B, C = x.shape
    L = lab.shape[1]
    g = g.to(device=x.device, dtype=torch.float32).contiguous()
    G = torch.empty(B, T, 2 * L + 1, dtype=torch.float32, device=x.device)
    order = torch.empty(B, max(L, 1), dtype=torch.int32, device=x.device)
    dx = torch.empty_like(x)
    lib = _lib("ctc_loss")
    err = lib.ptt_ctc_backward(x.data_ptr(), _DTYPE_CODE[x.dtype], _ptr(lab),
                               il.data_ptr(), ll.data_ptr(), T, B, C, L,
                               int(blank), int(bool(norm_by_times)),
                               lse.data_ptr(), alpha.data_ptr(),
                               g.data_ptr(), G.data_ptr(), order.data_ptr(),
                               dx.data_ptr(), _stream(x))
    _check_launch(lib, err, "ctc backward")
    LAUNCHES["ctc_bwd"] += 1
    return dx


def rnnt_forward(x, labels, ilen, llen, blank=0):
    """The kernel: (nll fp32 ``[B]``, lse ``[B, T, U+1]``, blank and label
    log-probs, alpha ``[B, T, U+1]``) of ``x [B, T, U+1, V]`` on the
    card."""
    x, lab, il, ll = _inputs(x, labels, ilen, llen)
    B, T, U1, V = x.shape
    U = U1 - 1
    f32 = dict(dtype=torch.float32, device=x.device)
    lse = torch.empty(B, T, U1, **f32)
    blp = torch.empty(B, T, U1, **f32)
    elp = torch.empty(B, T, max(U, 1), **f32)
    alpha = torch.empty(B, T, U1, **f32)
    nll = torch.empty(B, **f32)
    lib = _lib("rnnt_loss")
    err = lib.ptt_rnnt_forward(x.data_ptr(), _DTYPE_CODE[x.dtype], _ptr(lab),
                               il.data_ptr(), ll.data_ptr(), B, T, U, V,
                               int(blank), lse.data_ptr(), blp.data_ptr(),
                               elp.data_ptr(), alpha.data_ptr(),
                               nll.data_ptr(), _stream(x))
    _check_launch(lib, err, "rnnt forward")
    LAUNCHES["rnnt_fwd"] += 1
    return nll, lse, blp, elp, alpha


def rnnt_backward(x, labels, ilen, llen, lse, blp, elp, alpha, g, blank=0,
                  fastemit_lambda=0.0):
    """The kernel: dx (x's dtype) of ``sum(g * nll)`` on the card."""
    x, lab, il, ll = _inputs(x, labels, ilen, llen)
    B, T, U1, V = x.shape
    U = U1 - 1
    g = g.to(device=x.device, dtype=torch.float32).contiguous()
    gblank = torch.empty(B, T, U1, dtype=torch.float32, device=x.device)
    gemit = torch.empty(B, T, max(U, 1), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    lib = _lib("rnnt_loss")
    err = lib.ptt_rnnt_backward(
        x.data_ptr(), _DTYPE_CODE[x.dtype], _ptr(lab), il.data_ptr(),
        ll.data_ptr(), B, T, U, V, int(blank), 1.0 + float(fastemit_lambda),
        lse.data_ptr(), blp.data_ptr(), elp.data_ptr(), alpha.data_ptr(),
        g.data_ptr(), gblank.data_ptr(), gemit.data_ptr(), dx.data_ptr(),
        _stream(x))
    _check_launch(lib, err, "rnnt backward")
    LAUNCHES["rnnt_bwd"] += 1
    return dx


# -- autograd -----------------------------------------------------------------

class CTCFunction(torch.autograd.Function):
    """Each sample's CTC nll; the kernels on a CUDA tensor, the plain
    versions on a CPU tensor."""

    @staticmethod
    def forward(ctx, x, labels, ilen, llen, blank, norm_by_times):
        ctx.blank, ctx.norm_by_times = blank, norm_by_times
        if x.device.type == "cpu":
            nll, alpha = ctc_forward_plain(x, labels, ilen, llen, blank)
            ctx.save_for_backward(x, labels, ilen, llen, alpha)
        else:
            nll, lse, alpha = ctc_forward(x, labels, ilen, llen, blank)
            ctx.save_for_backward(x, labels, ilen, llen, lse, alpha)
        return nll

    @staticmethod
    def backward(ctx, g):
        x, labels, ilen, llen, *saved = ctx.saved_tensors
        if x.device.type == "cpu":
            dx = ctc_backward_plain(x, labels, ilen, llen, saved[0], g,
                                    ctx.blank, ctx.norm_by_times)
        else:
            dx = ctc_backward(x, labels, ilen, llen, saved[0], saved[1], g,
                              ctx.blank, ctx.norm_by_times)
        return dx, None, None, None, None, None


class RNNTFunction(torch.autograd.Function):
    """Each sample's RNN-T nll; the kernels on a CUDA tensor, the plain
    versions on a CPU tensor."""

    @staticmethod
    def forward(ctx, x, labels, ilen, llen, blank, fastemit_lambda):
        ctx.blank, ctx.lam = blank, fastemit_lambda
        if x.device.type == "cpu":
            nll, alpha = rnnt_forward_plain(x, labels, ilen, llen, blank)
            ctx.save_for_backward(x, labels, ilen, llen, alpha)
        else:
            nll, *saved = rnnt_forward(x, labels, ilen, llen, blank)
            ctx.save_for_backward(x, labels, ilen, llen, *saved)
        return nll

    @staticmethod
    def backward(ctx, g):
        x, labels, ilen, llen, *saved = ctx.saved_tensors
        if x.device.type == "cpu":
            dx = rnnt_backward_plain(x, labels, ilen, llen, saved[0], g,
                                     ctx.blank, ctx.lam)
        else:
            dx = rnnt_backward(x, labels, ilen, llen, *saved, g, ctx.blank,
                               ctx.lam)
        return dx, None, None, None, None, None


def ctc_nll(x, labels, ilen, llen, blank=0, norm_by_times=False):
    """Each sample's CTC negative log-likelihood, fp32 ``[B]``,
    differentiable in x (``[T, B, C]`` logits)."""
    return CTCFunction.apply(x, labels, ilen, llen, int(blank),
                             bool(norm_by_times))


def rnnt_nll(x, labels, ilen, llen, blank=0, fastemit_lambda=0.0):
    """Each sample's RNN-T negative log-likelihood, fp32 ``[B]``,
    differentiable in x (``[B, T, U+1, V]`` logits)."""
    return RNNTFunction.apply(x, labels, ilen, llen, int(blank),
                              float(fastemit_lambda or 0.0))


__all__ = ["ctc_nll", "rnnt_nll", "ctc_forward_plain", "ctc_backward_plain",
           "rnnt_forward_plain", "rnnt_backward_plain", "ctc_forward",
           "ctc_backward", "rnnt_forward", "rnnt_backward", "CTCFunction",
           "RNNTFunction", "NEG", "ctc_log_prob_grad_plain",
           "rnnt_log_prob_grad_plain", "softmax_grad_plain"]
