"""The bf16 ragged attention kernels' work plan and split-and-merge, in
their plain versions, against a brute-force walk and the JAX package.

``ragged_plan_plain`` (the plan kernel's function) must cover every
(row, query head, visible key) by exactly one work item and no invisible
key by any. ``ragged_attention_split_plain`` (each item's fp32 partial,
then the log-sum-exp merge of a row's splits) must agree with the JAX
reference ``serving.ragged.ragged_paged_attention`` and with the Pallas
kernel ``ragged_pallas.ragged_decode_attention`` in interpret mode, in
float32 within 2e-5 (the JAX suite's own tolerance: the sums run in
another order), with invalid rows exactly 0. Splits are small here (2
pages of 4 keys) and tiles short (3 rows), so that tiles cross split
boundaries and chunks are cut.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import ragged_pallas as rp
from paddle_tpu.serving.ragged import ragged_paged_attention as jax_ragged

from paddle_tpu_torch.kernels import ragged_attention as RA

BS, MP, KVH, D = 4, 5, 2, 8
KS = 2 * BS                     # a split holds 2 pages
BQ = 3                          # rows of a tile

CASES = ["mixed", "random", "hole", "long_chunk", "diagonal", "scattered",
         "one_key", "all_invalid"]


def _case(case, rep, seed=2):
    """Pools, tables and a packed batch. "mixed", "random", "hole": the
    cases of test_torch_kernels.py; "long_chunk": a prefill chunk of 7
    rows (tiles of 3, 3 and 1, the last alone with the diagonal key in its
    own split); "diagonal": decode tokens whose last split ends at the
    diagonal or holds it alone; "scattered": rows of one slot that are not
    adjacent and not in order; "one_key": contexts of one key;
    "all_invalid": no valid row."""
    rng = np.random.default_rng(seed)
    p = 12
    kp = rng.standard_normal((p, KVH, BS, D)).astype(np.float32)
    vp = rng.standard_normal((p, KVH, BS, D)).astype(np.float32)
    tables = np.full((3, MP), -1, np.int32)
    tables[0, :3] = [2, 5, 7]
    tables[1, :2] = [1, 9]
    tables[2, :5] = [0, 3, 4, 6, 8]
    rows = {
        "mixed": ([0, 1, 2, 2, 2, 2, 2, 0, 0],
                  [9, 6, 12, 13, 14, 15, 16, 0, 0],
                  [1, 1, 1, 1, 1, 1, 1, 0, 0]),
        "long_chunk": ([0] + [2] * 7 + [1, 0],
                       [11] + list(range(10, 17)) + [7, 0],
                       [1] * 9 + [0]),
        "diagonal": ([2, 2, 0, 2, 0], [7, 8, 8, 15, 0], [1, 1, 1, 1, 0]),
        "scattered": ([2, 0, 2, 1, 2, 2], [12, 4, 5, 6, 13, 11],
                      [1, 1, 1, 1, 1, 1]),
        "one_key": ([0, 1, 2, 0], [0, 0, 0, 3], [1, 1, 1, 1]),
        "all_invalid": ([0, 1, 2, 0], [3, 5, 9, 0], [0, 0, 0, 0]),
    }
    if case in rows:
        slot, pos, valid = (np.asarray(x) for x in rows[case])
        slot, pos, valid = (slot.astype(np.int32), pos.astype(np.int32),
                            valid.astype(bool))
    else:
        t = 10
        slot = rng.integers(0, 3, (t,)).astype(np.int32)
        cap = np.asarray([3, 2, 5])[slot] * BS - 1
        pos = rng.integers(0, cap + 1).astype(np.int32)
        valid = rng.random(t) > 0.2
        if case == "hole":
            tables[2, 1] = -1
            slot[:4] = 2
            pos[:4] = [5, 9, 13, 19]
            valid[:4] = True
    q = rng.standard_normal((len(slot), KVH * rep, D)).astype(np.float32)
    return q, kp, vp, tables, slot, pos, valid


def _visible(tables, slot, pos, valid, rep, p_total):
    """Brute force: every (row, query head, key position) a row sees."""
    seen = set()
    for t, (s, p, v) in enumerate(zip(slot, pos, valid)):
        if not v or p < 0:
            continue
        for key in range(min(p + 1, MP * BS)):
            page = tables[s, key // BS]
            if 0 <= page < p_total:
                seen.update((t, h, key) for h in range(KVH * rep))
    return seen


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("rep", [1, 2])
def test_plan_covers_every_visible_key_once(case, rep):
    q, kp, vp, tables, slot, pos, valid = _case(case, rep)
    t = torch.from_numpy
    items, row_splits = RA.ragged_plan_plain(t(slot), t(pos), t(valid), KVH,
                                             BS, MP, BQ, KS, KS)
    covered = []
    for t0, n, s, n_splits, g in items[:, :5].tolist():
        assert 1 <= n <= BQ and 0 <= s < n_splits and 0 <= g < KVH
        assert all(slot[t0 + i] == slot[t0] and pos[t0 + i] == pos[t0] + i
                   for i in range(n))
        assert all(row_splits[t0 + i] == n_splits for i in range(n))
        for i in range(n):
            row = t0 + i
            for key in range(s * KS, min(s * KS + KS, MP * BS)):
                page = tables[slot[row], key // BS]
                if key <= pos[row] and 0 <= page < kp.shape[0]:
                    covered += [(row, g * rep + r, key) for r in range(rep)]
    want = _visible(tables, slot, pos, valid, rep, kp.shape[0])
    assert len(covered) == len(set(covered))          # no key twice
    assert set(covered) == want                       # every visible key
    live = valid & (pos >= 0)
    assert not row_splits.numpy()[~live].any()
    assert (row_splits.numpy()[live] > 0).all()
    if case == "all_invalid":
        assert items.shape[0] == 0


def test_plan_tiles_and_splits_where_expected():
    """The long chunk: tiles of 3, 3 and 1 rows; the 1-row tile at
    position 16 has its diagonal key alone in its third split. The
    scattered slot: every row is a tile of its own."""
    _, _, _, tables, slot, pos, valid = _case("long_chunk", 1)
    t = torch.from_numpy
    items, _ = RA.ragged_plan_plain(t(slot), t(pos), t(valid), KVH, BS, MP,
                                    BQ, KS, KS)
    tiles = sorted({(a, n, ns) for a, n, _, ns in items[:, :4].tolist()})
    assert tiles == [(0, 1, 2), (1, 3, 2), (4, 3, 2), (7, 1, 3), (8, 1, 1)]
    _, _, _, tables, slot, pos, valid = _case("scattered", 1)
    items, _ = RA.ragged_plan_plain(t(slot), t(pos), t(valid), KVH, BS, MP,
                                    BQ, KS, KS)
    assert set(items[:, 1].tolist()) == {1}


def test_plan_geometry_of_the_kernels():
    """The kernels' tile is 64 rows of the product (tokens x group heads);
    splits are whole stages of the ring and so whole pages."""
    for rep in (1, 2, 4, 8):
        assert RA.plan_geometry(16, 128, rep)[0] * rep == 64
    assert RA.plan_geometry(16, 128, 1)[1:] == (128, 512, 16)
    for bs in (1, 4, 5, 16, 24, 48, 64, 100, 128):
        for target in (RA.KS_DECODE, RA.KS_PREFILL):
            assert RA.split_keys(bs, target) % bs == 0
    assert RA.split_keys(4, 128) == 128 and RA.split_keys(24, 128) == 96
    with pytest.raises(ValueError):
        RA.plan_geometry(16, 128, 1, ks_decode=24)


def _split(q, kp, vp, tables, slot, pos, valid, rep):
    t = torch.from_numpy
    return RA.ragged_attention_split_plain(
        t(q), t(kp), t(vp), t(tables), t(slot), t(pos), t(valid), rep=rep,
        ks_decode=KS, ks_prefill=KS, bq=BQ).numpy()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("rep", [1, 2])
def test_split_plain_matches_jax_reference(case, rep):
    q, kp, vp, tables, slot, pos, valid = _case(case, rep)
    want = np.asarray(jax_ragged(*map(jnp.asarray, (q, kp, vp, tables, slot,
                                                     pos, valid)), rep=rep))
    got = _split(q, kp, vp, tables, slot, pos, valid, rep)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    assert not got[~valid].any()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("rep", [1, 2])
def test_split_plain_matches_pallas_interpret(monkeypatch, case, rep):
    monkeypatch.setattr(rp, "_INTERPRET", True)
    q, kp, vp, tables, slot, pos, valid = _case(case, rep)
    want = np.asarray(rp.ragged_decode_attention(
        *map(jnp.asarray, (q, kp, vp, tables, slot, pos, valid)), rep=rep))
    got = _split(q, kp, vp, tables, slot, pos, valid, rep)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("rep", [1, 4])
def test_split_plain_in_the_kernels_geometry(rep):
    """At the kernels' own tile and split sizes (bq = 64 // rep, 128 /
    512 keys) on a batch shaped like the engine's: decode tokens over long
    contexts, a chunk longer than a tile, padding rows."""
    rng = np.random.default_rng(5)
    bs, mp, kvh, d = 16, 40, 2, 16
    ctx = [1, 97, 300, 640]
    tables = np.full((len(ctx), mp), -1, np.int32)
    perm = rng.permutation(sum(-(-c // bs) for c in ctx)).astype(np.int32)
    nxt = 0
    for s, c in enumerate(ctx):
        n = -(-c // bs)
        tables[s, :n] = perm[nxt:nxt + n]
        nxt += n
    tables[2, 3] = -1
    chunk = 70
    slot = np.asarray([0, 1, 2] + [3] * chunk + [0] * 5, np.int32)
    pos = np.asarray([c - 1 for c in ctx[:3]]
                     + list(range(ctx[3] - chunk, ctx[3])) + [0] * 5, np.int32)
    valid = np.arange(len(slot)) < 3 + chunk
    q = rng.standard_normal((len(slot), kvh * rep, d)).astype(np.float32)
    kp = rng.standard_normal((nxt, kvh, bs, d)).astype(np.float32)
    vp = rng.standard_normal((nxt, kvh, bs, d)).astype(np.float32)
    t = torch.from_numpy
    got = RA.ragged_attention_split_plain(t(q), t(kp), t(vp), t(tables),
                                          t(slot), t(pos), t(valid),
                                          rep=rep).numpy()
    want = np.asarray(jax_ragged(*map(jnp.asarray, (q, kp, vp, tables, slot,
                                                     pos, valid)), rep=rep))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    assert not got[~valid].any()
