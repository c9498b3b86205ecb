"""Grouped matrix products for the dropless MoE layer: the CUDA kernels,
their plain PyTorch versions, the autograd function and the MoE FFN.

Replaces ``paddle_tpu/kernels/gmm_pallas.py``: ``_gmm_call``
(``_gmm_kernel``) -> ``gmm``, ``_tgmm_call`` (``_tgmm_kernel``) -> ``tgmm``,
the ``custom_vjp`` of ``_gmm_with_blocks`` -> ``GMMFunction``, and
``topk_route``, ``load_balance_aux`` and ``moe_dropless_ffn`` one for one.
The kernels (``csrc/gmm.cu``: TMA and wgmma in bf16, FMA in float32) are
bound by operations on the H100 at the MoE slice's shapes; the source
note says how they are built. The JAX
function's work-item tables (``make_group_metadata``) have no counterpart:
each CUDA block reads the group offsets itself.

The functions: rows of ``x [t, k]`` are sorted by group, group g owning
``group_sizes[g]`` consecutive rows from the top. ``gmm`` multiplies each
row by its group's ``w[g]`` (``[k, n]``, or ``[n, k]`` read transposed with
``trans_w``), sums in fp32 and rounds once to x's dtype; rows past
``sum(group_sizes)`` come out as zeros. ``tgmm`` gives ``dw[g] = x_g^T .
dy_g`` in fp32, zeros for a group with no rows. Group sizes stay on the
device: nothing here reads them on the host, so a training step through
the MoE layer needs no sync.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as TF

from . import LAUNCHES
from ._build import library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUPS = 1024            # the kernels keep the offsets in shared memory


# -- plain versions -------------------------------------------------------------

def _group_masks(group_sizes, t):
    """[e, t] bool: which rows each group owns."""
    ends = torch.cumsum(group_sizes.long(), 0)
    starts = ends - group_sizes.long()
    rows = torch.arange(t, device=group_sizes.device)
    return (rows[None, :] >= starts[:, None]) & (rows[None, :] < ends[:, None])


def gmm_plain(x, w, group_sizes, trans_w=False):
    """The per-group masked fp32 product of ``_gmm_reference``, rounded
    once to x's dtype."""
    t = x.shape[0]
    n = w.shape[1] if trans_w else w.shape[2]
    masks = _group_masks(group_sizes.to(x.device), t)
    xf = x.float()
    out = torch.zeros(t, n, dtype=torch.float32, device=x.device)
    for g in range(w.shape[0]):
        wg = w[g].float()
        prod = xf @ (wg.T if trans_w else wg)
        out = out + torch.where(masks[g][:, None], prod, 0.0)
    return out.to(x.dtype)


def tgmm_plain(x, dy, group_sizes):
    """``dw[g] = x_g^T . dy_g`` in fp32 over the rows of group g (the
    masked product of the Pallas kernel); zeros for an empty group."""
    masks = _group_masks(group_sizes.to(x.device), x.shape[0])
    xf, df = x.float(), dy.float()
    return torch.stack([torch.where(masks[g][:, None], xf, 0.0).T @ df
                        for g in range(group_sizes.shape[0])])


# -- kernels --------------------------------------------------------------------

def _lib():
    lib = library("gmm")
    if lib.ptt_gmm.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.ptt_gmm.argtypes = [ptr] * 4 + [i] * 6 + [ptr]
        lib.ptt_tgmm.argtypes = [ptr] * 4 + [i] * 5 + [ptr]
        lib.ptt_gmm.restype = lib.ptt_tgmm.restype = ctypes.c_int
        lib.ptt_error_string.argtypes = [i]
        lib.ptt_error_string.restype = ctypes.c_char_p
    return lib


def _on_cuda(name, a, b, group_sizes):
    """False for CPU tensors (plain version); True for CUDA tensors the
    kernels take; raises on anything else."""
    for what, x in (("the second operand", b), ("group_sizes", group_sizes)):
        if x.device != a.device:
            raise ValueError(f"{name}: {what} is on {x.device}, the first "
                             f"operand on {a.device}")
    if a.device.type == "cpu":
        return False
    if a.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {a.device}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16 operands of one "
                        f"dtype, got {a.dtype} and {b.dtype}")
    if group_sizes.dtype != torch.int32 or group_sizes.dim() != 1:
        raise TypeError(f"{name}: group_sizes must be a 1-D int32 tensor")
    if not 0 < group_sizes.shape[0] <= MAX_GROUPS:
        raise ValueError(f"{name} takes 1 to {MAX_GROUPS} groups, got "
                         f"{group_sizes.shape[0]}")
    return True


def _check_widths(name, k, n):
    if k % 16 or n % 16:
        raise ValueError(f"the {name} kernel takes widths that are multiples "
                         f"of 16, got k={k}, n={n}")


def _offsets(group_sizes):
    """[e + 1] int32 prefix sums on the device (no sync)."""
    off = torch.zeros(group_sizes.shape[0] + 1, dtype=torch.int32,
                      device=group_sizes.device)
    torch.cumsum(group_sizes, 0, dtype=torch.int32, out=off[1:])
    return off


def _aligned(x):
    """x contiguous with a 16-byte-aligned start (the bf16 kernels read
    through TMA, the float32 ones with 16-byte cp.async copies)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.ptt_error_string(err).decode())


def gmm(x, w, group_sizes, trans_w=False):
    """Grouped matmul ``[t, k] x [e, k, n] -> [t, n]`` (``w`` is ``[e, n,
    k]`` with ``trans_w``) in x's dtype. On CUDA tensors this launches the
    kernel (and raises on what it does not take); on CPU tensors it runs
    the plain version."""
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f"gmm takes x [t, k] and w [e, k, n], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    k = x.shape[1]
    e, wk, n = (w.shape[0], w.shape[2], w.shape[1]) if trans_w else w.shape
    if wk != k or group_sizes.shape != (e,):
        raise ValueError(f"gmm: x {tuple(x.shape)}, w {tuple(w.shape)} "
                         f"(trans_w={trans_w}) and group_sizes "
                         f"{tuple(group_sizes.shape)} do not fit")
    if not _on_cuda("gmm", x, w, group_sizes):
        return gmm_plain(x, w, group_sizes, trans_w)
    _check_widths("gmm", k, n)
    x, w = _aligned(x), _aligned(w)
    out = torch.empty(x.shape[0], n, dtype=x.dtype, device=x.device)
    off = _offsets(group_sizes)
    lib = _lib()
    err = lib.ptt_gmm(x.data_ptr(), w.data_ptr(), off.data_ptr(),
                      out.data_ptr(), x.shape[0], k, n, e,
                      _DTYPE_CODE[x.dtype], int(bool(trans_w)),
                      torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "gmm")
    LAUNCHES["gmm"] += 1
    return out


def tgmm(x, dy, group_sizes):
    """Transposed grouped matmul ``[t, k]^T x [t, n] -> [e, k, n]`` in
    fp32, per group. On CUDA tensors this launches the kernel; on CPU
    tensors it runs the plain version."""
    if x.dim() != 2 or dy.dim() != 2 or x.shape[0] != dy.shape[0] \
            or group_sizes.dim() != 1:
        raise ValueError(f"tgmm takes x [t, k], dy [t, n] and group_sizes "
                         f"[e], got {tuple(x.shape)}, {tuple(dy.shape)} and "
                         f"{tuple(group_sizes.shape)}")
    if not _on_cuda("tgmm", x, dy, group_sizes):
        return tgmm_plain(x, dy, group_sizes)
    t, k = x.shape
    n = dy.shape[1]
    e = group_sizes.shape[0]
    _check_widths("tgmm", k, n)
    x, dy = _aligned(x), _aligned(dy)
    dw = torch.empty(e, k, n, dtype=torch.float32, device=x.device)
    off = _offsets(group_sizes)
    lib = _lib()
    err = lib.ptt_tgmm(x.data_ptr(), dy.data_ptr(), off.data_ptr(),
                       dw.data_ptr(), t, k, n, e, _DTYPE_CODE[x.dtype],
                       torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "tgmm")
    LAUNCHES["tgmm"] += 1
    return dw


class GMMFunction(torch.autograd.Function):
    """out = gmm(x, w, group_sizes); the backward is dx = gmm(dy, w^T)
    cast to x's dtype and dw = tgmm(x, dy) cast to w's dtype, as the
    ``custom_vjp`` of ``gmm_pallas.py`` computes them (each a kernel on
    CUDA tensors)."""

    @staticmethod
    def forward(ctx, x, w, group_sizes):
        ctx.save_for_backward(x, w, group_sizes)
        return gmm(x, w, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        x, w, group_sizes = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gmm(dy, w, group_sizes, trans_w=True).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = tgmm(x, dy, group_sizes).to(w.dtype)
        return dx, dw, None


class ExpertBias(torch.autograd.Function):
    """Each expert-sorted row's bias, ``b[es]`` (``b`` [e, n] fp32) cast
    to ``dtype``, whose gradient sums each group's rows with ``tgmm``
    against columns of ones (the kernel on CUDA tensors, the bf16 one for
    a bf16 gradient, whose values it reads exactly and sums in fp32): a
    sum in a fixed order, the same every run, where the backward of an
    indexed gather adds the rows with atomics, in whatever order they
    arrive, or sorts them first (slower than the step's grouped products
    together). Rows past the groups (the padding) are left out: their
    gradient is zero, since the products' rows past the groups are."""

    @staticmethod
    def forward(ctx, b, es, group_sizes, dtype):
        ctx.save_for_backward(group_sizes)
        ctx.rows = es.shape[0]
        return torch.index_select(b, 0, es).to(dtype)

    @staticmethod
    def backward(ctx, dy):
        (group_sizes,) = ctx.saved_tensors
        # 128 columns fill one of the bf16 kernel's tiles; the float32
        # kernel takes 16
        ones = dy.new_ones(ctx.rows, 128 if dy.dtype == torch.bfloat16
                           else 16)
        db = tgmm(ones, dy.contiguous(), group_sizes)[:, 0, :]
        return db, None, None, None


# -- routing and the dropless FFN ---------------------------------------------

def topk_route(logits, top_k: int, normalize: bool = True):
    """(probs, topv, topi): softmax in fp32, the top_k experts of each row
    in descending order, renormalised when ``normalize`` and top_k > 1.
    Ties go to the lower expert index, as ``lax.top_k`` orders them: each
    pick is an argmax (the first maximum), and a picked expert is masked
    out before the next."""
    probs = torch.softmax(logits.float(), dim=-1)
    masked = probs
    vals, idxs = [], []
    for _ in range(top_k):
        i = torch.argmax(masked, dim=-1, keepdim=True)
        vals.append(probs.gather(-1, i))
        idxs.append(i)
        masked = masked.scatter(-1, i, float("-inf"))
    topv, topi = torch.cat(vals, -1), torch.cat(idxs, -1)
    if normalize and top_k > 1:
        topv = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, topv, topi


def load_balance_aux(probs, topi):
    """Switch/GShard load-balance loss: e * sum_e mean(P_e) * mean(f_e),
    f_e the share of rows whose first choice is e."""
    e = probs.shape[-1]
    first = torch.zeros_like(probs).scatter_(-1, topi[:, :1], 1.0)
    return (probs.mean(0) * first.mean(0)).sum() * float(e)


def route_sorted(topi, num_experts: int):
    """The stable sort of the (token, choice) slots by expert, on the
    device and without a sort: (order, pos, group_sizes). ``order[i]`` is
    the slot at sorted position i (``argsort(topi.reshape(-1),
    stable=True)``), ``pos`` its inverse, ``group_sizes`` int32 [e]. A
    slot's position is its expert's offset plus the number of earlier
    slots routed to the same expert: a running count along each expert's
    row of an [e, t*k] one-hot (a scan along the contiguous axis; along
    the other axis PyTorch's CUDA scan takes ~2.5 ms at 16384 x 8)."""
    flat = topi.reshape(-1)
    tk = flat.shape[0]
    onehot = torch.zeros(num_experts, tk, dtype=torch.int32,
                         device=flat.device).scatter_(0, flat[None, :], 1)
    counts = torch.cumsum(onehot, 1, dtype=torch.int32)
    group_sizes = counts[:, -1].contiguous()
    starts = torch.cumsum(group_sizes, 0, dtype=torch.int32) - group_sizes
    rank = counts.gather(0, flat[None, :])[0] - 1
    pos = (starts.gather(0, flat) + rank).long()
    order = torch.empty_like(pos).scatter_(
        0, pos, torch.arange(tk, device=flat.device))
    return order, pos, group_sizes


def gelu_tanh(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return TF.gelu(x, approximate="tanh")


def moe_dropless_ffn(x2, logits, top_k: int, w1, b1, w2, b2, *,
                     act=gelu_tanh, normalize: bool = True, bt: int = 128):
    """Dropless MoE FFN: top-k route, sort the (token, choice) slots by
    expert, both FFN products as grouped matmuls, unsort, combine.

    x2 [t, d]; logits [t, e]; w1 [e, d, h]; w2 [e, h, d]. Returns ([t, d]
    in x2's dtype, the aux load-balance loss). As ``gmm_pallas.
    moe_dropless_ffn``: the t*k rows are padded with zeros to a multiple of
    ``bt``, the padded rows take expert 0's biases and are sliced off
    before the combine, and the activation runs in fp32. Biases are
    gathered from fp32 copies, so their gradients sum in fp32 before the
    cast to the bias dtype (the values gathered are the same), in the same
    order every run (``ExpertBias``)."""
    t, d = x2.shape
    e = logits.shape[-1]
    probs, topv, topi = topk_route(logits, top_k, normalize)
    order, pos, group_sizes = route_sorted(topi, e)
    tk = t * top_k
    pad = (-tk) % bt
    src_tok = torch.div(order, top_k, rounding_mode="floor")
    xs = torch.index_select(x2, 0, src_tok)
    es = torch.index_select(topi.reshape(-1), 0, order)
    if pad:
        xs = torch.cat([xs, xs.new_zeros(pad, d)])
        es = torch.cat([es, es.new_zeros(pad)])
    h = GMMFunction.apply(xs, w1, group_sizes)
    h = h + ExpertBias.apply(b1.float(), es, group_sizes, h.dtype)
    h = act(h.float()).to(h.dtype)
    y = GMMFunction.apply(h, w2, group_sizes)
    y = y + ExpertBias.apply(b2.float(), es, group_sizes, y.dtype)
    y = torch.index_select(y[:tk], 0, pos).reshape(t, top_k, d)
    out = torch.einsum("tk,tkd->td", topv.to(y.dtype), y)
    return out.to(x2.dtype), load_balance_aux(probs, topi)


__all__ = ["gmm", "tgmm", "gmm_plain", "tgmm_plain", "GMMFunction",
           "ExpertBias",
           "topk_route", "load_balance_aux",
           "route_sorted", "moe_dropless_ffn", "gelu_tanh"]
