"""paddle_tpu_torch kernels' plain versions against the JAX package.

Each port kernel has a plain PyTorch version that CPU tensors take; here
it is held, on the same numpy inputs, against the JAX reference function
and against the Pallas kernel it replaces, run in interpret mode as the
JAX package's own tests run it. float32, atol/rtol 2e-5 for attention (the
JAX suite's own tolerance) and 1e-5 for the norms and rope.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import generation as G
from paddle_tpu.kernels import fused_pallas as fp
from paddle_tpu.kernels import ragged_pallas as rp
from paddle_tpu.serving.ragged import ragged_paged_attention as jax_ragged

from paddle_tpu_torch import kernels as K
from paddle_tpu_torch import generation as TG
from paddle_tpu_torch.kernels import fused, ragged_attention as RA


def _ragged_case(case, rep, seed=2):
    """Pools, tables and a packed batch. "mixed": decode tokens of three
    slots plus a prefill chunk of one; "random": random slots and
    positions with invalid rows; "hole": a -1 page inside the visible
    range of one slot."""
    rng = np.random.default_rng(seed)
    kvh, d, p, bs, mp = 2, 8, 12, 4, 5
    kp = rng.standard_normal((p, kvh, bs, d)).astype(np.float32)
    vp = rng.standard_normal((p, kvh, bs, d)).astype(np.float32)
    tables = np.full((3, mp), -1, np.int32)
    tables[0, :3] = [2, 5, 7]
    tables[1, :2] = [1, 9]
    tables[2, :5] = [0, 3, 4, 6, 8]
    if case == "mixed":
        slot = np.asarray([0, 1, 2, 2, 2, 2, 2, 0, 0], np.int32)
        pos = np.asarray([9, 6, 12, 13, 14, 15, 16, 0, 0], np.int32)
        valid = np.asarray([1, 1, 1, 1, 1, 1, 1, 0, 0], bool)
    else:
        t = 10
        slot = rng.integers(0, 3, (t,)).astype(np.int32)
        cap = np.asarray([3, 2, 5])[slot] * bs - 1
        pos = rng.integers(0, cap + 1).astype(np.int32)
        valid = rng.random(t) > 0.2
        if case == "hole":
            tables[2, 1] = -1
            slot[:4] = 2
            pos[:4] = [5, 9, 13, 19]
            valid[:4] = True
    q = rng.standard_normal((len(slot), kvh * rep, d)).astype(np.float32)
    return q, kp, vp, tables, slot, pos, valid


def _port_ragged(q, kp, vp, tables, slot, pos, valid, rep):
    t = torch.from_numpy
    return RA.ragged_attention(t(q), t(kp), t(vp), t(tables), t(slot),
                               t(pos), t(valid), rep=rep).numpy()


@pytest.mark.parametrize("case", ["random", "mixed", "hole"])
@pytest.mark.parametrize("rep", [1, 2])
def test_ragged_plain_matches_jax_reference(case, rep):
    q, kp, vp, tables, slot, pos, valid = _ragged_case(case, rep)
    want = np.asarray(jax_ragged(*map(jnp.asarray, (q, kp, vp, tables, slot,
                                                     pos, valid)), rep=rep))
    got = _port_ragged(q, kp, vp, tables, slot, pos, valid, rep)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    assert not got[~valid].any()


@pytest.mark.parametrize("case", ["random", "mixed", "hole"])
@pytest.mark.parametrize("rep", [1, 2])
def test_ragged_plain_matches_pallas_interpret(monkeypatch, case, rep):
    monkeypatch.setattr(rp, "_INTERPRET", True)
    q, kp, vp, tables, slot, pos, valid = _ragged_case(case, rep)
    want = np.asarray(rp.ragged_decode_attention(
        *map(jnp.asarray, (q, kp, vp, tables, slot, pos, valid)), rep=rep))
    got = _port_ragged(q, kp, vp, tables, slot, pos, valid, rep)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def _norm_inputs(seed=0, shape=(3, 5, 64)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    r = rng.standard_normal(shape).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, r, w


@pytest.mark.parametrize("residual", [False, True])
def test_rms_norm_plain_matches_pallas_interpret(monkeypatch, residual):
    monkeypatch.setattr(fp, "_INTERPRET", True)
    x, r, w = _norm_inputs()
    want = np.asarray(fp.fused_rms_norm_pallas(
        jnp.asarray(x), jnp.asarray(w), eps=1e-5,
        residual=jnp.asarray(r) if residual else None))
    tx, tr, tw = map(torch.from_numpy, (x, r, w))
    if residual:
        got = fused.add_rms_norm(tx, tr, tw, 1e-5)[1].numpy()
    else:
        got = fused.rms_norm(tx, tw, 1e-5).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_rms_plain_matches_decoder_rms():
    x, r, w = _norm_inputs(1)
    want = np.asarray(G._rms(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = TG._rms(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_add_rms_matches_decoder_add_then_rms():
    """The decoder's fused residual add + norm equals the JAX decoder's
    ``h = h + o; _rms(h)`` in float32."""
    x, r, w = _norm_inputs(2)
    h = jnp.asarray(x) + jnp.asarray(r)
    want_norm = np.asarray(G._rms(h, jnp.asarray(w), 1e-5))
    got_sum, got_norm = TG._add_rms(torch.from_numpy(x), torch.from_numpy(r),
                                    torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(got_sum.numpy(), np.asarray(h), atol=1e-6)
    np.testing.assert_allclose(got_norm.numpy(), want_norm, atol=1e-5,
                               rtol=1e-5)


def test_add_rms_matches_decoder_add_then_rms_bf16():
    """In bf16 the sum is rounded before the norm reads it, as in the JAX
    decoder's ``h = h + o; _rms(h)``: both outputs are bit-identical."""
    x, r, w = _norm_inputs(3, shape=(64, 256))
    jx, jr, jw = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (x, r, w))
    h = jx + jr
    want_norm = G._rms(h, jw, 1e-5)
    tx, tr, tw = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, r, w))
    got_sum, got_norm = TG._add_rms(tx, tr, tw, 1e-5)
    np.testing.assert_array_equal(got_sum.float().numpy(),
                                  np.asarray(h.astype(jnp.float32)))
    np.testing.assert_array_equal(got_norm.float().numpy(),
                                  np.asarray(want_norm.astype(jnp.float32)))


def _rope_inputs(seed=0, s=6, h=4, kvh=2, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, s, h, d)).astype(np.float32)
    k = rng.standard_normal((1, s, kvh, d)).astype(np.float32)
    ang = rng.uniform(0, 6.3, (s, d // 2)).astype(np.float32)
    return q, k, np.cos(ang), np.sin(ang)


def test_rope_plain_matches_pallas_interpret(monkeypatch):
    monkeypatch.setattr(fp, "_INTERPRET", True)
    q, k, cos, sin = _rope_inputs()
    wq, wk = fp.fused_rope_pallas(*map(jnp.asarray, (q, k, cos, sin)))
    gq, gk = fused.fused_rope(*map(torch.from_numpy, (q, k, cos, sin)))
    np.testing.assert_allclose(gq.numpy(), np.asarray(wq), atol=1e-5)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=1e-5)


def test_rope_rows_matches_decoder_rope_rows():
    """Per-row tables [T, 1, D/2] over a packed [T, 1, H, D] batch."""
    q, k, cos, sin = _rope_inputs(1)
    q, k = q[0][:, None], k[0][:, None]              # [T, 1, H, D]
    cos, sin = cos[:, None], sin[:, None]            # [T, 1, D/2]
    gq, gk = TG._rope_rows(*map(torch.from_numpy, (q, k, cos, sin)))
    for got, x in ((gq, q), (gk, k)):
        want = G._rope_rows(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_cpu_calls_never_count_launches():
    K.reset_launches()
    q, kp, vp, tables, slot, pos, valid = _ragged_case("mixed", 2)
    _port_ragged(q, kp, vp, tables, slot, pos, valid, 2)
    x, r, w = map(torch.from_numpy, _norm_inputs())
    fused.rms_norm(x, w)
    fused.add_rms_norm(x, r, w)
    fused.fused_rope(*map(torch.from_numpy, _rope_inputs()))
    assert set(K.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("tool, source", [
    ("flash_variants", "flash_attention_bf16"), ("gmm_variants", "gmm"),
    ("ragged_variants", "ragged_attention_bf16"),
    ("quant_gemm_variants", "weight_only_gemm"),
    ("rnn_variants", "rnn_recurrence"),
    ("batch_norm_bwd_variants", "batch_norm_bwd"),
    ("batch_norm_fwd_variants", "batch_norm_fwd")])
def test_variant_tools_still_apply_to_their_sources(tool, source, tmp_path,
                                                    monkeypatch):
    """Each variant of the timing scripts under ``tools/`` is its source
    with some text replaced: every replaced text must still be in the
    source, and the shared builder writes and compiles each variant (nvcc
    stood in by a script that only creates the library)."""
    import importlib.util
    from pathlib import Path
    from paddle_tpu_torch.kernels import _build
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = -o ] && '
                    'touch "$2"; shift; done\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    path = Path(_build.CSRC).parent / "tools" / f"{tool}.py"
    spec = importlib.util.spec_from_file_location(tool, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    variants = {n: v[0] if tool == "ragged_variants" else v
                for n, v in mod.VARIANTS.items()}
    built = _build.build_variants(source, variants)
    assert sorted(built) == sorted(variants)
    for name, reps in variants.items():
        text = (tmp_path / "variants" / f"{source}_{name}.cu").read_text()
        assert all(new in text for _, new in reps)
