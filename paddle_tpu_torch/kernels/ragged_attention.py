"""Ragged paged attention: the CUDA kernels and their plain PyTorch versions.

Replaces ``paddle_tpu/kernels/ragged_pallas.py:ragged_decode_attention``.
bfloat16 (the serving dtype) runs ``csrc/ragged_attention_bf16.cu``: a
work plan built on the card, a persistent attention kernel that walks the
plan's items (TMA page loads, wgmma), and a combine kernel that merges
split key ranges; its source note says how. float32 keeps the kernel of
``csrc/ragged_attention.cu`` (one block per token and kv head).

Layouts are the JAX package's: packed queries ``q [T, H, D]``, pools
``[P, kvh, bs, D]``, ``page_tables [S, MP]`` int32 (-1 = unassigned),
``slot_ids``/``positions [T]`` int32, ``valid [T]`` bool. Token t sees its
slot's cache positions ``<= positions[t]``; invalid rows are zeros.

The work plan (``ragged_plan_plain`` computes it in Python, the plan
kernel on the card):
  * a row is live if it is valid and its position is >= 0;
  * a query tile is a run of consecutive live rows of one slot at
    consecutive positions, cut every ``bq`` rows from the run's start
    (``bq = 64 // rep``: a tile's rows times the group's heads are the 64
    rows of one wgmma); a decode token is a tile of one row;
  * a split is a piece of at most ``ks`` keys of the tile's visible range
    ``[0, min(last position + 1, MP * bs))``, ``ks`` a multiple of
    ``bs``: ``ks_decode`` for a tile of one row, ``ks_prefill`` for
    longer ones;
  * a work item is (tile, split, kv head), tile by tile in row order, then
    split, then kv head. An item is eight int32: the tile's first row, its
    rows, the split, the tile's splits, the kv head, the first row's
    position and slot, and 0;
  * ``row_splits[t]`` is the number of splits of row t's tile, 0 for a
    row that is not live. A tile of one split writes its output directly;
    the items of a split tile write fp32 partials (unnormalised output,
    running max and sum), which the combine merges in split order.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import LAUNCHES, sm_count
from ._build import library

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
GROUP_SIZES = (1, 2, 4, 8)
STAGE_ROWS = 64             # key rows of one stage of the bf16 kernel's ring
# the bf16 kernels' settings, the fastest of tools/ragged_variants.py's runs
KS_DECODE = 128             # keys a split of a one-row tile holds, about
KS_PREFILL = 512            # and of a longer tile
BLOCKS_PER_SM = 2           # blocks of the attention kernel an SM
STAGES = {128: 2, 64: 3}    # stages of each block's ring, by head_dim
PLAN_ROWS = 12288           # rows (T) the plan kernel takes


def ragged_attention_plain(q, k_pool, v_pool, page_tables, slot_ids,
                           positions, valid, rep=1):
    """Plain PyTorch version: per sequence slot, gather its pages once and
    run a masked softmax for the slot's tokens in fp32. Agrees with the
    JAX reference ``serving.ragged.ragged_paged_attention``; a valid row
    that sees no slot at all (which the engine never sends) is zero, as in
    the kernel."""
    t, h, d = q.shape
    p_total, kvh, bs, _ = k_pool.shape
    mp = page_tables.shape[1]
    out = torch.zeros(t, h, d, dtype=torch.float32, device=q.device)
    valid = valid.to(torch.bool)
    for s in torch.unique(slot_ids[valid]).tolist():
        rows = torch.nonzero(valid & (slot_ids == s)).squeeze(1)
        n = rows.numel()
        pos = positions[rows].long()
        cols = min(mp, max(int(pos.max()) // bs + 1, 1))
        tab = page_tables[s, :cols].long()
        safe = tab.clamp(0, p_total - 1)
        kg = k_pool[safe].permute(1, 0, 2, 3).reshape(kvh, cols * bs, d)
        vg = v_pool[safe].permute(1, 0, 2, 3).reshape(kvh, cols * bs, d)
        slot_pos = torch.arange(cols * bs, device=q.device)
        page_ok = (tab >= 0).repeat_interleave(bs)
        live = (slot_pos[None, :] <= pos[:, None]) & page_ok[None, :]
        qg = q[rows].reshape(n, kvh, rep, d).float()
        scores = torch.einsum("ngrd,gld->ngrl", qg, kg.float()) / math.sqrt(d)
        scores = scores.masked_fill(~live[:, None, None, :], NEG_INF)
        p = torch.softmax(scores, dim=-1) \
            * live.any(dim=-1).to(scores.dtype)[:, None, None, None]
        o = torch.einsum("ngrl,gld->ngrd", p, vg.float())
        out[rows] = o.reshape(n, h, d)
    return out.to(q.dtype)


# -- the work plan ---------------------------------------------------------

def split_keys(bs, target):
    """Keys of a split near ``target``: a multiple of the keys one stage of
    the bf16 kernel's ring holds (whole pages of ``round_up(bs, 8)`` rows
    each for bs <= 64; a 64-row segment of one page otherwise), and so of
    ``bs``."""
    unit = (STAGE_ROWS // (-(-bs // 8) * 8)) * bs if bs <= STAGE_ROWS else bs
    return max(1, target // unit) * unit


def plan_geometry(bs, mp, rep, ks_decode=None, ks_prefill=None, bq=None):
    """(bq, ks_decode, ks_prefill, n_splits_max) of the plan; the bf16
    kernels take ``bq = 64 // rep`` (the default) only."""
    bq = STAGE_ROWS // rep if bq is None else bq
    ks_d = split_keys(bs, KS_DECODE) if ks_decode is None else ks_decode
    ks_p = split_keys(bs, KS_PREFILL) if ks_prefill is None else ks_prefill
    for ks in (ks_d, ks_p):
        if ks <= 0 or ks % bs:
            raise ValueError(f"split sizes must be positive multiples of "
                             f"bs={bs}, got {ks}")
    return bq, ks_d, ks_p, -(-(mp * bs) // min(ks_d, ks_p))


def ragged_plan_plain(slot_ids, positions, valid, kvh, bs, mp, bq, ks_decode,
                      ks_prefill):
    """The plan kernel's function in Python: (items [N, 8] int32 in the
    kernel's encoding and order, row_splits [T] int32), on the CPU."""
    slot = [int(x) for x in slot_ids.tolist()]
    pos = [int(x) for x in positions.tolist()]
    live = [bool(v) and p >= 0 for v, p in zip(valid.tolist(), pos)]
    t_rows = len(slot)

    def cont(t):
        return (t > 0 and live[t] and live[t - 1] and slot[t] == slot[t - 1]
                and pos[t] == pos[t - 1] + 1)

    items, row_splits = [], [0] * t_rows
    start = 0
    for t in range(t_rows):
        if not cont(t):
            start = t
        if not live[t] or (t - start) % bq:
            continue
        n = 1
        while n < bq and t + n < t_rows and cont(t + n):
            n += 1
        keys = min(pos[t + n - 1] + 1, mp * bs)
        ks = ks_decode if n == 1 else ks_prefill
        n_splits = -(-keys // ks)
        row_splits[t:t + n] = [n_splits] * n
        for s in range(n_splits):
            for g in range(kvh):
                items.append((t, n, s, n_splits, g, pos[t], slot[t], 0))
    return (torch.tensor(items, dtype=torch.int32).reshape(-1, 8),
            torch.tensor(row_splits, dtype=torch.int32))


def ragged_attention_split_plain(q, k_pool, v_pool, page_tables, slot_ids,
                                 positions, valid, rep=1, ks_decode=None,
                                 ks_prefill=None, bq=None):
    """The bf16 kernels' algorithm in plain PyTorch, in fp32: the plan,
    each item's partial (running max m, sum l and unnormalised output over
    its split's keys), then per row the log-sum-exp merge of its splits in
    split order. Invalid rows are 0."""
    t_rows, h, d = q.shape
    p_total, kvh, bs, _ = k_pool.shape
    mp = page_tables.shape[1]
    bq, ks_d, ks_p, _ = plan_geometry(bs, mp, rep, ks_decode, ks_prefill,
                                      bq)
    items, row_splits = ragged_plan_plain(slot_ids, positions, valid, kvh,
                                          bs, mp, bq, ks_d, ks_p)
    scale = d ** -0.5
    qf, kf, vf = q.float(), k_pool.float(), v_pool.float()
    parts = {}                                   # (row, split) -> (m, l, acc)
    for t0, n, s, n_splits, g in items[:, :5].tolist():
        keys = min(int(positions[t0 + n - 1]) + 1, mp * bs)
        ks = ks_d if n == 1 else ks_p
        k0, k1 = s * ks, min(s * ks + ks, keys)
        tab = page_tables[int(slot_ids[t0]), k0 // bs:-(-k1 // bs)].long()
        ok = (tab >= 0) & (tab < p_total)
        safe = tab.clamp(0, p_total - 1)
        kg = kf[safe, g].reshape(-1, d)           # [L, D]
        vg = vf[safe, g].reshape(-1, d)
        kpos = k0 + torch.arange(kg.shape[0])
        lim = positions[t0:t0 + n].long()
        vis = (kpos[None, :] <= lim[:, None]) & ok.repeat_interleave(bs)[None]
        qg = qf[t0:t0 + n, g * rep:(g + 1) * rep]            # [n, rep, D]
        sc = torch.einsum("nrd,ld->nrl", qg, kg) * scale
        sc = sc.masked_fill(~vis[:, None, :], -math.inf)
        m = sc.amax(-1)                                      # [n, rep]
        p = torch.exp(sc - torch.where(torch.isinf(m), 0.0, m)[..., None])
        parts_l, acc = p.sum(-1), torch.einsum("nrl,ld->nrd", p, vg)
        for i in range(n):
            parts.setdefault((t0 + i, s), {})[g] = (m[i], parts_l[i], acc[i])
    out = torch.zeros(t_rows, h, d, dtype=torch.float32)
    for t in range(t_rows):
        n_splits = int(row_splits[t])
        if n_splits == 0:
            continue
        per = [parts[(t, s)] for s in range(n_splits)]
        for g in range(kvh):
            ms = torch.stack([p[g][0] for p in per])           # [S, rep]
            big = ms.amax(0)
            w = torch.where(torch.isinf(ms), 0.0,
                            torch.exp(ms - torch.where(torch.isinf(big), 0.0,
                                                       big)))
            l_sum = sum(w[i] * per[i][g][1] for i in range(n_splits))
            acc = sum(w[i][:, None] * per[i][g][2] for i in range(n_splits))
            o = torch.where(l_sum[:, None] > 0,
                            acc / torch.where(l_sum > 0, l_sum, 1.0)[:, None],
                            0.0)
            out[t, g * rep:(g + 1) * rep] = o
    return out.to(q.dtype)


# -- the kernels -----------------------------------------------------------

def _fn_f32():
    lib = library("ragged_attention")
    fn = lib.ptt_ragged_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
    return lib, fn


def _lib_bf16():
    lib = library("ragged_attention_bf16")
    if lib.ptt_ragged_attention_bf16.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ptt_ragged_plan.argtypes = [p] * 6 + [i] * 8 + [p]
        lib.ptt_ragged_plan.restype = i
        lib.ptt_ragged_attention_bf16.argtypes = [p] * 13 + [i] * 15 \
            + [ctypes.c_float, p]
        lib.ptt_ragged_attention_bf16.restype = i
        lib.ptt_error_string.argtypes = [i]
        lib.ptt_error_string.restype = ctypes.c_char_p
    return lib


def kernel_takes(head_dim, rep):
    """Whether the kernel takes this head_dim and GQA group (query heads
    per kv head); ``serving.ragged.make_attend`` sends the others to
    ``ragged_attention_plain``, as the JAX package takes its jnp path
    wherever its kernel is off."""
    return head_dim in HEAD_DIMS and rep in GROUP_SIZES


_DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k_pool, v_pool, page_tables, slot_ids, positions, valid, rep):
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "page_tables": page_tables, "slot_ids": slot_ids,
               "positions": positions, "valid": valid}
    for name, x in tensors.items():
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("the pools must start on a 16-byte boundary")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("k_pool and v_pool must have q's dtype")
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError("want q [T, H, D] and pools [P, kvh, bs, D]")
    t, h, d = q.shape
    _, kvh, bs, dk = k_pool.shape
    if dk != d or h != kvh * rep:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_pool.shape)} with rep={rep}")
    if not kernel_takes(d, rep):
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS} and "
                         f"rep in {GROUP_SIZES}, got {d} and {rep}")
    for name, x in (("page_tables", page_tables), ("slot_ids", slot_ids),
                    ("positions", positions)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    if page_tables.dim() != 2:
        raise ValueError("page_tables must be [S, MP]")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if slot_ids.shape != (t,) or positions.shape != (t,) \
            or valid.shape != (t,):
        raise ValueError("slot_ids, positions and valid must be [T]")


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.ptt_error_string(err).decode())


def _plan_buffers(t, kvh, n_splits_max, dev):
    """The plan's device buffers, sized from the shapes alone: items (at
    most every row a tile, every tile all splits), their count, and the
    splits of each row's tile."""
    cap = max(1, t * n_splits_max * kvh)
    return (torch.empty(cap, 8, dtype=torch.int32, device=dev),
            torch.empty(1, dtype=torch.int32, device=dev),
            torch.empty(t, dtype=torch.int32, device=dev))


def ragged_plan(slot_ids, positions, valid, kvh, bs, mp, rep):
    """The plan kernel alone on CUDA tensors: (items [cap, 8], count [1],
    row_splits [T]), on the card; the first ``count`` items are the plan.
    For tests; ``ragged_attention`` launches the plan itself."""
    if slot_ids.device.type != "cuda":
        raise ValueError("ragged_plan launches the plan kernel: give it "
                         "CUDA tensors (ragged_plan_plain runs on the CPU)")
    t = slot_ids.shape[0]
    bq, ks_d, ks_p, nsm = plan_geometry(bs, mp, rep)
    items, count, row_splits = _plan_buffers(t, kvh, nsm, slot_ids.device)
    lib = _lib_bf16()
    err = lib.ptt_ragged_plan(
        slot_ids.data_ptr(), positions.data_ptr(), valid.data_ptr(),
        items.data_ptr(), count.data_ptr(), row_splits.data_ptr(), t, kvh,
        bs, mp, bq, ks_d, ks_p, items.shape[0],
        torch.cuda.current_stream(slot_ids.device).cuda_stream)
    _raise_on(lib, err, "ragged plan")
    return items, count, row_splits


def _ragged_bf16(q, k_pool, v_pool, page_tables, slot_ids, positions, valid,
                 rep, plan):
    t, h, d = q.shape
    p_total, kvh, bs, _ = k_pool.shape
    mp = page_tables.shape[1]
    bq, ks_d, ks_p, nsm = plan_geometry(bs, mp, rep)
    if t > PLAN_ROWS:
        raise ValueError(f"the bf16 kernels take at most {PLAN_ROWS} rows, "
                         f"got {t}")
    if q.data_ptr() % 16:               # TMA reads q from a 16-byte boundary
        q = q.clone()
    dev = q.device
    make_plan = plan is None or "items" not in plan
    if make_plan:
        items, count, row_splits = _plan_buffers(t, kvh, nsm, dev)
        if plan is not None:
            plan.update(items=items, count=count, row_splits=row_splits)
    else:
        items, count, row_splits = (plan["items"], plan["count"],
                                    plan["row_splits"])
    ws = torch.empty(t, h, nsm, d, dtype=torch.float32, device=dev)
    ml = torch.empty(t, h, nsm, 2, dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    grid = sm_count(dev) * BLOCKS_PER_SM
    lib = _lib_bf16()
    err = lib.ptt_ragged_attention_bf16(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_tables.data_ptr(), slot_ids.data_ptr(), positions.data_ptr(),
        valid.data_ptr(), out.data_ptr(), items.data_ptr(), count.data_ptr(),
        row_splits.data_ptr(), ws.data_ptr(), ml.data_ptr(),
        t, h, kvh, d, p_total, bs, mp, bq, ks_d, ks_p, items.shape[0], nsm,
        STAGES[d], grid, int(make_plan), d ** -0.5,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "ragged_attention (bf16)")
    return out


def ragged_attention(q, k_pool, v_pool, page_tables, slot_ids, positions,
                     valid, rep=1, plan=None):
    """Ragged paged attention. On a CUDA tensor this launches the kernels
    (and raises on anything they do not take); on a CPU tensor it runs
    the plain version.

    ``plan``: None, or a dict shared by calls over one batch (the same
    slot_ids, positions, valid, page-table width, pool geometry and rep,
    as the layers of one serving step are): the first bf16 call launches
    the plan kernel into buffers it keeps there, and the later calls reuse
    them instead of planning again."""
    if q.device.type == "cpu":
        return ragged_attention_plain(q, k_pool, v_pool, page_tables,
                                      slot_ids, positions, valid, rep)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_attention runs on cuda or cpu, not "
                         f"{q.device}")
    _check(q, k_pool, v_pool, page_tables, slot_ids, positions, valid, rep)
    if q.dtype == torch.bfloat16:
        out = _ragged_bf16(q, k_pool, v_pool, page_tables, slot_ids,
                           positions, valid, rep, plan)
        LAUNCHES["ragged_attention"] += 1
        return out
    t, h, d = q.shape
    p_total, kvh, bs, _ = k_pool.shape
    out = torch.empty_like(q)
    lib, fn = _fn_f32()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             page_tables.data_ptr(), slot_ids.data_ptr(),
             positions.data_ptr(), valid.data_ptr(), out.data_ptr(),
             t, h, kvh, d, p_total, bs, page_tables.shape[1], 0, d ** -0.5,
             stream)
    _raise_on(lib, err, "ragged_attention (float32)")
    LAUNCHES["ragged_attention"] += 1
    return out


__all__ = ["ragged_attention", "ragged_attention_plain", "kernel_takes",
           "ragged_plan", "ragged_plan_plain", "ragged_attention_split_plain",
           "plan_geometry", "split_keys"]
