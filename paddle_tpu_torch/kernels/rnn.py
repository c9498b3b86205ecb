"""The recurrence of the RNN layers: CUDA kernels (``csrc/rnn_recurrence.cu``)
and their plain PyTorch versions.

No TPU kernel: the JAX package runs each layer and direction of its
stacked RNNs as one ``jax.lax.scan`` (``paddle_tpu/nn/layer/rnn.py:281-302``)
over the step of ``:30-58``, which XLA compiles into a loop on the device.
In eager PyTorch a scan is a Python loop of about a dozen launches a step;
here the input term of every step is one product before the loop (the
caller's: ``xw = x . W_ih^T`` plus the biases that fold into it), and each
step of the recurrence one kernel launch.

Modes and the arithmetic of a step (fp32, the JAX step's; ``xw`` the
step's input term, ``h'`` and ``c'`` the carry, ``sig(x) = 1 / (1 +
exp(-x))``):

- ``lstm``, gates (i, f, g, o): ``a = xw + h' . W_hh^T``; ``c = sig(f) c'
  + sig(i) tanh(g)``; ``h = sig(o) tanh(c)``. Both biases fold into xw.
- ``gru``, gates (r, z, c): ``hr, hz, hc = h' . W_hh^T`` with ``b_hc``
  added to ``hc``; ``r = sig(xw_r + hr)``, ``z = sig(xw_z + hz)``, ``n =
  tanh(xw_c + r hc)``, ``h = (1 - z) n + z h'``. The candidate keeps its
  hidden bias ``b_hc`` inside the reset product, so only ``b_ih`` and the
  hidden biases of r and z fold into xw.
- ``rnn_tanh`` / ``rnn_relu``: ``h = act(xw + h' . W_hh^T)``, both biases
  folded.

What the backward reads, saved by the forward kernel: lstm the activated
gates (i, f, g, o) and every c_t; gru r, z, n and hc; the simple RNN its
outputs. The backward of a step is the gates' gradients ``dgates_t`` from
``dh_t`` (the output's gradient plus the recurrent one) and ``dc_t``,
then ``dh_{t-1} = dgates_t . W_hh`` (plus ``dh_t z`` for the gru) and
``dc_{t-1} = dc f``; the weight and bias gradients are sums over every
step, one ``torch.matmul`` / ``sum`` each after the loop.

``rnn_scan`` on CUDA tensors launches the kernels through
``RNNScanFunction``; on CPU tensors it is ``rnn_scan_plain``, the loop of
the plain step under torch's autograd. The forward takes one of two
kernels by ``rnn_forward_plan``: the persistent kernel for T > 1 where a
block's rows of W_hh fit in shared memory and the grid fits on the SMs
(one launch for the sequence), else the step kernel (one launch a step).
The backward takes one of two routes by ``rnn_backward_plan``: its
persistent kernel on the same terms but at any T (one launch), else two
kernels a step (the gate gradients, then the product). ``LAUNCHES["rnn_fwd"]``
counts each forward launch, ``["rnn_fwd_step"]`` the forward's on the
step kernel; ``["rnn_bwd"]`` the persistent backward's launches,
``["rnn_bwd_gates"]`` and ``["rnn_bwd_step"]`` the step route's two
kernels', each only its own.
The kernels compute in fp32: a bf16 or fp16 call on the card (a cell
under ``auto_cast(level="O2")``) goes up to fp32 exactly, runs them, and
its outputs are rounded back to its dtype, so it computes what a kernel
that loads half precision and writes it would; on the CPU the same call
rounds every op, as JAX's cell does. float64 on the card raises. No float
atomics: the sums run in a fixed order, so two runs give the same bits
and a captured step its eager step's.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from . import LAUNCHES, sm_count
from ._build import library

MODES = {"lstm": 0, "gru": 1, "rnn_tanh": 2, "rnn_relu": 3}
GATES = {"lstm": 4, "gru": 3, "rnn_tanh": 1, "rnn_relu": 1}


def _sig(x):
    return 1.0 / (1.0 + torch.exp(-x))


def _check_mode(mode):
    if mode not in MODES:
        raise ValueError(f"rnn mode must be one of {sorted(MODES)}, got "
                         f"{mode!r}")


# -- plain --------------------------------------------------------------------

def rnn_step_plain(mode, xw, h, c, w_hh, b_hc=None):
    """One step: ``(h_t, c_t)`` from the step's input term ``xw [B, G H]``,
    the carry ``h`` (and ``c`` for the lstm) ``[B, H]`` and ``w_hh [G H,
    H]``; ``b_hc`` the gru candidate's hidden bias; ``c_t`` None but for
    the lstm. Differentiable."""
    _check_mode(mode)
    H = h.shape[-1]
    gh = h @ w_hh.t()
    if mode == "lstm":
        a = xw + gh
        i, f = _sig(a[:, :H]), _sig(a[:, H:2 * H])
        g, o = torch.tanh(a[:, 2 * H:3 * H]), _sig(a[:, 3 * H:])
        c2 = f * c + i * g
        return o * torch.tanh(c2), c2
    if mode == "gru":
        hc = gh[:, 2 * H:] if b_hc is None else gh[:, 2 * H:] + b_hc
        r = _sig(xw[:, :H] + gh[:, :H])
        z = _sig(xw[:, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(xw[:, 2 * H:] + r * hc)
        return (1.0 - z) * n + z * h, None
    a = xw + gh
    return (torch.tanh(a) if mode == "rnn_tanh" else torch.relu(a)), None


def rnn_scan_plain(mode, xw, h0, c0, w_hh, b_hc=None, reverse=False):
    """The recurrence over ``xw [T, B, G H]`` (time order) from ``h0`` (and
    ``c0``), a Python loop of ``rnn_step_plain``: ``(y [T, B, H], h_T,
    c_T)``, each output at its input's time index (``reverse`` runs from T
    - 1 down, as ``lax.scan(reverse=True)`` does); c_T None but for the
    lstm. Differentiable by torch's autograd."""
    T = xw.shape[0]
    h, c = h0, c0
    ys = [None] * T
    order = range(T - 1, -1, -1) if reverse else range(T)
    for t in order:
        h, c = rnn_step_plain(mode, xw[t], h, c, w_hh, b_hc)
        ys[t] = h
    return torch.stack(ys), h, c


# -- the forward's plan -------------------------------------------------------

SMEM_BYTES = 232448     # shared memory a block may use on the H100 (227 KB)
_UNITS, _ROWS = 16, 32  # a block's units, and a warp's rows
_RED = 8 * _ROWS * _UNITS * 4   # floats of the warps' sums
_KC = 128               # the step kernel's depth a stage


class RnnPlan(NamedTuple):
    """How ``rnn_forward`` or ``rnn_backward`` runs a sequence: ``route``
    "persistent" (one cooperative launch; blocks of 32 rows by 16 units,
    W_hh resident) or "step" (a launch a step forward, two backward;
    blocks of ``rows`` rows by 16 units); ``grid`` (unit blocks, row
    blocks); ``smem`` bytes a block; ``launches`` of the call."""
    route: str
    grid: Tuple[int, int]
    smem: int
    rows: int
    launches: int


def _cdiv(a, b):
    return -(-a // b)


def rnn_forward_plan(mode, T, B, H, sms):
    """The forward's kernel for ``T`` steps of ``B`` rows at width ``H`` on
    a card of ``sms`` SMs: the persistent kernel where T > 1, H % 4 == 0,
    a block's rows of W_hh (G gates by H, rounded up to 128, plus 4 of
    padding a row) and its h or sums fit in ``SMEM_BYTES`` and the grid
    is at most one block an SM; else the step kernel, 64 rows a block
    where that still gives every SM a block, else 32. The same bytes as
    ``csrc/rnn_recurrence.cu`` computes."""
    _check_mode(mode)
    G = GATES[mode]
    units = _cdiv(H, _UNITS)
    if T > 1 and H % 4 == 0:
        ld = _cdiv(H, 128) * 128 + 4
        smem = 4 * (_UNITS * G * ld + max(_ROWS * ld, _RED))
        grid = (units, _cdiv(B, _ROWS))
        if smem <= SMEM_BYTES and grid[0] * grid[1] <= sms:
            return RnnPlan("persistent", grid, smem, _ROWS, 1)
    wm = 2 if _cdiv(B, 2 * _ROWS) * units >= sms else 1
    stages = 3 * (_ROWS * wm + _UNITS * G) * (_KC + 4)
    return RnnPlan("step", (units, _cdiv(B, _ROWS * wm)),
                   4 * max(stages, _RED), _ROWS * wm, T)


# -- the backward's plan ------------------------------------------------------

_P_RED = 2 * _ROWS * _UNITS   # floats of the persistent backward's two halves
_S_ROWS, _S_COLS = 32, 64   # a backward step-kernel block's tile


def rnn_backward_plan(mode, T, B, H, sms):
    """The backward's kernels for ``T`` steps of ``B`` rows at width ``H``
    on a card of ``sms`` SMs: the persistent kernel on the forward's grid
    where H % 4 == 0, a block's rows of W_hh (G gates by H, rounded up to
    128, plus 4 a row), its rows' gate gradients and its sums fit in
    ``SMEM_BYTES`` and the grid is at most one block an SM (one launch,
    also at T = 1: the decoder cell's 128 rows took 18.9 us against the
    step route's 26.5); else the step route, two launches a step (the
    gate gradients, then the product, 32 rows by 64 columns a block over
    the whole depth). ``smem`` is the product kernel's bytes there; the
    same bytes as ``csrc/rnn_recurrence.cu`` computes."""
    _check_mode(mode)
    G = GATES[mode]
    units = _cdiv(H, _UNITS)
    if H % 4 == 0:
        ld = _cdiv(H, 128) * 128 + 4
        smem = 4 * (_UNITS * G * ld + _UNITS * G * _ROWS + _P_RED)
        grid = (units, _cdiv(B, _ROWS))
        if smem <= SMEM_BYTES and grid[0] * grid[1] <= sms:
            return RnnPlan("persistent", grid, smem, _ROWS, 1)
    smem = 4 * max(3 * (_S_ROWS * (_KC + 4) + _KC * _S_COLS),
                   8 * _S_ROWS * _S_COLS)
    return RnnPlan("step", (_cdiv(H, _S_COLS), _cdiv(B, _S_ROWS)), smem,
                   _S_ROWS, 2 * T)


# -- the kernels --------------------------------------------------------------

_SIGS = {
    "ptt_rnn_forward": [ctypes.c_int] + [ctypes.c_void_p] * 11
    + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "ptt_rnn_backward": [ctypes.c_int] + [ctypes.c_void_p] * 15
    + [ctypes.c_int] * 5 + [ctypes.c_void_p],
}


def _lib():
    lib = library("rnn_recurrence")
    if lib.ptt_error_string.restype is not ctypes.c_char_p:
        for fn, args in _SIGS.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
    return lib


def _on_card(*ts):
    """Each tensor (or None) contiguous; raises unless every one is a
    float32 CUDA tensor on one device."""
    dev = None
    out = []
    for t in ts:
        if t is not None:
            if t.device.type != "cuda":
                raise ValueError(f"the recurrence kernels run on cuda, not "
                                 f"{t.device}")
            if t.dtype != torch.float32:
                raise TypeError(f"the recurrence kernels take float32, got "
                                f"{t.dtype}")
            if dev is not None and t.device != dev:
                raise ValueError("the recurrence's tensors lie on different "
                                 "devices")
            dev = t.device
            t = t.contiguous()
        out.append(t)
    return out


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_launch(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.ptt_error_string(err).decode())


def _shapes(mode, xw, h0, c0, w_hh, b_hc):
    _check_mode(mode)
    T, B, GH = xw.shape
    H = h0.shape[-1]
    G = GATES[mode]
    if GH != G * H or tuple(h0.shape) != (B, H) \
            or tuple(w_hh.shape) != (G * H, H):
        raise ValueError(f"{mode}: xw {tuple(xw.shape)}, h0 "
                         f"{tuple(h0.shape)} and w_hh {tuple(w_hh.shape)} "
                         f"do not agree")
    if (mode == "lstm") != (c0 is not None):
        raise ValueError("c0 is given for the lstm and only for it")
    if b_hc is not None and (mode != "gru" or tuple(b_hc.shape) != (H,)):
        raise ValueError("b_hc is the gru candidate's hidden bias [H]")
    return T, B, H, G


def rnn_forward(mode, xw, h0, c0, w_hh, b_hc=None, reverse=False):
    """The forward kernel on ``rnn_forward_plan``'s route: ``(y [T, B, H],
    h_T, c_T, saved, cs)``, ``saved`` the gates the backward reads ([T, B,
    4 H]: lstm i, f, g, o; gru r, z, n, hc; None for the simple RNN),
    ``cs`` the lstm's c_t ([T, B, H], else None). A refused launch
    raises."""
    xw, h0, c0, w_hh, b_hc = _on_card(xw, h0, c0, w_hh, b_hc)
    T, B, H, G = _shapes(mode, xw, h0, c0, w_hh, b_hc)
    plan = rnn_forward_plan(mode, T, B, H, sm_count(xw.device))
    f32 = dict(dtype=torch.float32, device=xw.device)
    y = torch.empty(T, B, H, **f32)
    h_fin = torch.empty(B, H, **f32)
    lstm = mode == "lstm"
    c_fin = torch.empty(B, H, **f32) if lstm else None
    cs = torch.empty(T, B, H, **f32) if lstm else None
    saved = torch.empty(T, B, 4 * H, **f32) if G > 1 else None
    persistent = plan.route == "persistent"
    # the barriers' step counters, one a row group, zeroed on the stream
    # (in a graph, on every replay)
    counter = torch.zeros(plan.grid[1], dtype=torch.int32,
                          device=xw.device) if persistent else None
    lib = _lib()
    err = lib.ptt_rnn_forward(
        MODES[mode], xw.data_ptr(), h0.data_ptr(), _ptr(c0), w_hh.data_ptr(),
        _ptr(b_hc), y.data_ptr(), _ptr(cs), _ptr(saved), h_fin.data_ptr(),
        _ptr(c_fin), _ptr(counter), T, B, H, int(bool(reverse)),
        int(persistent), plan.rows // _ROWS, _stream(xw))
    _check_launch(lib, err, f"rnn forward ({mode}, {plan.route})")
    LAUNCHES["rnn_fwd"] += plan.launches
    if not persistent:
        LAUNCHES["rnn_fwd_step"] += plan.launches
    return y, h_fin, c_fin, saved, cs


def rnn_backward(mode, dy, dhT, dcT, saved, cs, h0, c0, y, w_hh,
                 reverse=False):
    """The backward kernels on ``rnn_backward_plan``'s route: ``(dxw [T, B,
    G H], dhc [T, B, H] or None, dh0, dc0 or None)``: the gate gradients of
    the input side, the gru candidate's hidden-side gradient (``da_n r``)
    and the initial states' gradients. ``dy``, ``dhT``, ``dcT`` may be None
    (no gradient). A refused launch raises."""
    dy, dhT, dcT, saved, cs, h0, c0, y, w_hh = _on_card(
        dy, dhT, dcT, saved, cs, h0, c0, y, w_hh)
    T, B, H = y.shape
    G = GATES[mode]
    plan = rnn_backward_plan(mode, T, B, H, sm_count(y.device))
    f32 = dict(dtype=torch.float32, device=y.device)
    dxw = torch.empty(T, B, G * H, **f32)
    dhc = torch.empty(T, B, H, **f32) if mode == "gru" else None
    persistent = plan.route == "persistent"
    if persistent:
        # the partials, two (by the step's parity) a block of 32 x HP
        hp = _cdiv(H, 128) * 128
        scratch = torch.empty(2 * plan.grid[0] * plan.grid[1] * _ROWS * hp,
                              **f32)
        # the barriers' step counters, zeroed on the stream (in a graph, on
        # every replay)
        counter = torch.zeros(plan.grid[1], dtype=torch.int32,
                              device=y.device)
    else:
        scratch, counter = torch.empty(4, B, H, **f32), None
    dh0 = torch.empty(B, H, **f32)
    dc0 = torch.empty(B, H, **f32) if mode == "lstm" else None
    lib = _lib()
    err = lib.ptt_rnn_backward(
        MODES[mode], _ptr(dy), _ptr(dhT), _ptr(dcT), _ptr(saved), _ptr(cs),
        h0.data_ptr(), _ptr(c0), y.data_ptr(), w_hh.data_ptr(),
        dxw.data_ptr(), _ptr(dhc), scratch.data_ptr(), dh0.data_ptr(),
        _ptr(dc0), _ptr(counter), T, B, H, int(bool(reverse)),
        int(persistent), _stream(y))
    _check_launch(lib, err, f"rnn backward ({mode}, {plan.route})")
    if persistent:
        LAUNCHES["rnn_bwd"] += 1
    else:
        LAUNCHES["rnn_bwd_gates"] += T
        LAUNCHES["rnn_bwd_step"] += T
    return dxw, dhc, dh0, dc0


# -- autograd -----------------------------------------------------------------

def weight_grads(dxw, dhc, h0, y, reverse, has_b_hc):
    """(dW_hh, db_hc) from every step's gate gradients: ``dW_hh = sum_t
    dgates_t^T h_{t-1}`` as one product over T.B rows (the gru's candidate
    third from ``dhc``), ``db_hc`` the sum of ``dhc``."""
    T, B, H = y.shape
    if reverse:
        hprev = torch.cat([y[1:], h0[None]])
    else:
        hprev = torch.cat([h0[None], y[:-1]])
    dgh = dxw if dhc is None else torch.cat([dxw[..., :2 * H], dhc], -1)
    dw = dgh.reshape(T * B, -1).t() @ hprev.reshape(T * B, H)
    db = dhc.sum((0, 1)) if has_b_hc else None
    return dw, db


class RNNScanFunction(torch.autograd.Function):
    """The kernels' recurrence of one layer and direction (or, at T = 1,
    one cell step), on CUDA tensors: ``(y, h_T, c_T)`` (c_T only for the
    lstm) of ``xw [T, B, G H]``, ``h0``, ``c0``, ``w_hh`` and ``b_hc``. Its
    gradients: xw's (dgates of the input side), h0's, c0's, W_hh's and
    b_hc's."""

    @staticmethod
    def forward(ctx, xw, h0, c0, w_hh, b_hc, mode, reverse):
        ctx.set_materialize_grads(False)
        ctx.mode, ctx.reverse = mode, reverse
        ctx.has_b_hc = b_hc is not None
        y, hT, cT, saved, cs = rnn_forward(mode, xw, h0, c0, w_hh, b_hc,
                                           reverse)
        ctx.save_for_backward(h0, c0, w_hh, y, saved, cs)
        return (y, hT, cT) if mode == "lstm" else (y, hT)

    @staticmethod
    def backward(ctx, dy, dhT, dcT=None):
        h0, c0, w_hh, y, saved, cs = ctx.saved_tensors
        dxw, dhc, dh0, dc0 = rnn_backward(ctx.mode, dy, dhT, dcT, saved, cs,
                                          h0, c0, y, w_hh, ctx.reverse)
        dw, db = weight_grads(dxw, dhc, h0, y, ctx.reverse, ctx.has_b_hc)
        return dxw, dh0, dc0, dw, db, None, None


_HALF = (torch.bfloat16, torch.float16)


def rnn_scan(mode, xw, h0, c0, w_hh, b_hc=None, reverse=False):
    """The recurrence, differentiable: ``(y [T, B, H], h_T, c_T)`` (c_T
    None but for the lstm). On CUDA tensors the kernels, in fp32 (bf16 and
    fp16 go up to fp32 and their outputs come back rounded; float64
    raises); on CPU tensors ``rnn_scan_plain`` in the tensors' dtype."""
    _shapes(mode, xw, h0, c0, w_hh, b_hc)
    if xw.device.type == "cpu":
        return rnn_scan_plain(mode, xw, h0, c0, w_hh, b_hc, reverse)
    if xw.dtype in _HALF:
        dt = xw.dtype
        y, hT, cT = rnn_scan(mode, *[None if t is None else t.float()
                                     for t in (xw, h0, c0, w_hh, b_hc)],
                             reverse=reverse)
        return y.to(dt), hT.to(dt), None if cT is None else cT.to(dt)
    out = RNNScanFunction.apply(xw, h0, c0, w_hh, b_hc, mode, bool(reverse))
    return out if mode == "lstm" else (out[0], out[1], None)


__all__ = ["rnn_scan", "rnn_step_plain", "rnn_scan_plain", "rnn_forward",
           "rnn_backward", "RNNScanFunction", "weight_grads", "MODES",
           "GATES", "RnnPlan", "rnn_forward_plan", "rnn_backward_plan"]
