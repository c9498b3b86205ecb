"""paddle_tpu_torch kernels against their plain versions on the GPU.

Marked ``cuda``: every test skips where no CUDA device is present. The
file imports neither JAX nor paddle_tpu, so it runs on a machine that has
only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

Tolerances: float32 2e-5 (the kernels and the plain versions both sum
in fp32, in another order); bfloat16 one ulp of the largest reference
value (2^-7 of it): both compute in fp32 from the same bf16 inputs and
round once at the end, so they differ by at most one rounding step.
Flash attention in bfloat16: each row within two ulps of the row's own
largest value (P is also rounded to bf16, at another running max). AdamW:
equal, since the kernel rounds every operation explicitly in the plain
version's order. Grouped matmuls: float32 1e-5 of the largest value (fp32
sums in another order); bfloat16 each row within two ulps of its largest
value (both round one fp32 sum); rows past the groups and an empty
group's dw exactly 0. FlashMask: as flash attention; a row that sees no
key must give output 0, lse -1e30 and dq 0 exactly. The weight-only
GEMM: each row within two ulps of its largest plain value (both round
one fp32 sum to bf16 before the scale), on either of its kernels and
every plan; two calls give the same bits (the split partials are summed
in a fixed order). FlashMask's tile-summary
pre-pass and the bf16 ragged kernels' work plan equal their plain versions
exactly, and two bf16 ragged calls (also a CUDA-graph replay on rewritten
metadata) give the same bits. Attention shapes the
kernels do not take: the plain path on the card against the same function
on the CPU, at the tolerances above. Dropout: the kernel equal to its plain
version bit for bit (the same Philox words), also after a graph replay
with a new key. LayerNorm with a dropout and a residual: the sum it
normalises bit-equal to the ops one by one, its output and gradients
within one ulp of the row's largest value in bf16 (2e-5 in fp32) of the
plain ops' autograd, which sums in another order. BatchNorm: as GroupNorm
(fp32 2e-5 of the largest value, dx's own scale where the variance makes
it large; bf16 one ulp of each row's largest value, two for the
gradients, and dx within 2e-5 of its own scale, where a channel of two
values makes it rounding noise), its weight and bias gradients, sums over
a channel's n values, within 2e-5 times max(1, sqrt(n) / 8) of the
largest (at least two bf16 ulps in bf16), the running statistics within
2e-5, a bf16 norm added to an fp32 residual within one bf16 ulp of the
norm's largest value; the fused residual add
and ReLU bit-equal to the unfused kernel followed by PyTorch's add and
ReLU, and a graph replay bit-equal to an eager call. The recurrence
(every mode, both directions, a cell step and a sequence): outputs within
1e-5 and gradients within 1e-4 of the largest plain value (fp32 sums in
another order, over the steps), two calls and a graph replay bit-equal;
a beam decode's tokens and lengths equal to the CPU's. GroupNorm's
cluster forward: as GroupNorm, and its statistics bit-equal to their
emulation (the same fp32 sums in the same order). X2's CUDA forward: each
probability within 2e-5 of its size (fp32 sums in another order), its
keep mask bit-equal to the plain version's.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.kernels import fused
from paddle_tpu_torch.kernels.ragged_attention import (ragged_attention,
                                                       ragged_attention_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(ref, dtype):
    if dtype == torch.float32:
        return 2e-5 * max(1.0, float(ref.abs().max()))
    return 2.0 ** -7 * float(ref.float().abs().max())


def _assert_rows_close(got, ref, ulps):
    """bf16: each row (the last axis) within ``ulps`` ulps (2^-7 each,
    relative) of its largest reference value; a row below 2^-8 of the
    tensor's largest holds only rounding noise and gets 2^-8 of it."""
    mag = ref.float().abs().amax(-1)
    tol = ulps * 2.0 ** -7 * mag.clamp(min=2.0 ** -8 * float(mag.max()))
    err = (got.float() - ref.float()).abs().amax(-1)
    assert bool((err <= tol).all()), float((err / tol).max())


def _ragged_inputs(dev, dtype, d, rep, bs, seed=0):
    g = np.random.default_rng(seed)
    kvh = 2
    ctx = [1, bs, 3 * bs + 5, 40, 7]                # per-slot context lengths
    mp = max(-(-c // bs) for c in ctx) + 1
    tables = np.full((len(ctx), mp), -1, np.int32)
    nxt = 0
    for s, c in enumerate(ctx):
        n = -(-c // bs)
        tables[s, :n] = np.arange(nxt, nxt + n)
        nxt += n
    tables[3, 1] = -1                               # a hole in slot 3
    p = nxt + 2
    slot, pos = [], []
    for s, c in enumerate(ctx):
        slot.append(s)
        pos.append(c - 1)
    slot += [2] * 6                                 # a prefill chunk of slot 2
    pos += list(range(3 * bs - 1, 3 * bs + 5))
    slot += [0, 0]                                  # padding rows
    pos += [0, 0]
    valid = np.asarray([True] * (len(slot) - 2) + [False, False])
    t = len(slot)
    to = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)
    q = to(g.standard_normal((t, kvh * rep, d)), dtype)
    kp = to(g.standard_normal((p, kvh, bs, d)), dtype)
    vp = to(g.standard_normal((p, kvh, bs, d)), dtype)
    return (q, kp, vp, to(tables, torch.int32), to(slot, torch.int32),
            to(pos, torch.int32), to(valid, torch.bool))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("bs", [4, 16])
def test_ragged_kernel_matches_plain(dev, dtype, d, rep, bs):
    args = _ragged_inputs(dev, dtype, d, rep, bs)
    before = K.LAUNCHES["ragged_attention"]
    got = ragged_attention(*args, rep=rep)
    torch.cuda.synchronize()
    assert K.LAUNCHES["ragged_attention"] == before + 1
    want = ragged_attention_plain(*args, rep=rep)
    err = float((got.float() - want.float()).abs().max())
    assert err <= _tol(want, dtype), err
    assert not got[~args[-1]].any()


def _ragged_batch(dev, dtype, d, rep, bs, contexts, rows, seed=0, kvh=2,
                  holes=()):
    """Pools and tables for per-slot ``contexts`` (pages of a slot spread
    over the pool), and a packed batch ``rows``: (slot, position, valid)
    triples in any order."""
    g = np.random.default_rng(seed)
    mp = max(-(-c // bs) for c in contexts) + 1
    tables = np.full((len(contexts), mp), -1, np.int32)
    n_pages = sum(-(-c // bs) for c in contexts)
    perm = g.permutation(n_pages)
    nxt = 0
    for s, c in enumerate(contexts):
        n = -(-c // bs)
        tables[s, :n] = perm[nxt:nxt + n]
        nxt += n
    for s, col in holes:
        tables[s, col] = -1
    slot, pos, valid = (np.asarray(x) for x in zip(*rows))
    to = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    t = len(rows)
    q = to(g.standard_normal((t, kvh * rep, d)), dtype)
    kp = to(g.standard_normal((n_pages, kvh, bs, d)), dtype)
    vp = to(g.standard_normal((n_pages, kvh, bs, d)), dtype)
    return (q, kp, vp, to(tables, torch.int32), to(slot, torch.int32),
            to(pos, torch.int32), to(valid.astype(bool), torch.bool))


def _ragged_case_rows(case):
    """(contexts, rows) of the edge cases: "long" two decode tokens over
    2048 and 2047 keys (16 splits of 128), a hole inside a split; "chunk"
    a 100-row prefill chunk (longer than a 64-row tile) whose tiles cross
    the 512-key split boundary, beside decode tokens; "scattered" rows of
    one slot neither adjacent nor in order; "all_invalid"; "one_key"
    contexts of one key."""
    if case == "long":
        return [2048, 2047, 5], [(0, 2047, 1), (1, 2046, 1), (2, 4, 1),
                                 (0, 0, 0)]
    if case == "chunk":
        return ([600, 33, 700], [(1, 32, 1)] + [(2, p, 1)
                                               for p in range(480, 580)]
                + [(0, 599, 1), (0, 0, 0)])
    if case == "scattered":
        return [300, 40], [(0, 200, 1), (1, 39, 1), (0, 17, 1), (0, 201, 1),
                           (1, 12, 1), (0, 199, 1), (0, 0, 0)]
    if case == "all_invalid":
        return [64, 30], [(0, 63, 0), (1, 29, 0), (0, 10, 0)]
    return [1, 1, 20], [(0, 0, 1), (1, 0, 1), (2, 0, 1), (0, 0, 0)]


RAGGED_EDGE_CASES = ["long", "chunk", "scattered", "all_invalid", "one_key"]


@pytest.mark.parametrize("case", RAGGED_EDGE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("bs", [4, 16])
def test_ragged_kernel_edge_cases(dev, case, dtype, d, rep, bs):
    contexts, rows = _ragged_case_rows(case)
    holes = [(0, 300 // bs)] if case == "long" else ()
    args = _ragged_batch(dev, dtype, d, rep, bs, contexts, rows, holes=holes)
    before = K.LAUNCHES["ragged_attention"]
    got = ragged_attention(*args, rep=rep)
    torch.cuda.synchronize()
    assert K.LAUNCHES["ragged_attention"] == before + 1
    want = ragged_attention_plain(*args, rep=rep)
    err = float((got.float() - want.float()).abs().max())
    assert err <= _tol(want, dtype), err
    assert not got[~args[-1]].any()


@pytest.mark.parametrize("case", ["long", "chunk", "scattered",
                                  "all_invalid", "one_key", "serving"])
@pytest.mark.parametrize("rep", [1, 2, 8])
def test_ragged_plan_kernel_matches_plain(dev, case, rep):
    from paddle_tpu_torch.kernels import ragged_attention as RA
    if case == "serving":       # the engine's shape: 256 rows, most padding
        contexts = [97, 300, 511, 803, 1024, 1500, 1801, 960]
        rows = [(s, c - 1, 1) for s, c in enumerate(contexts[:7])] \
            + [(7, p, 1) for p in range(711, 960)]
        rows += [(0, 0, 0)] * (256 - len(rows))
    else:
        contexts, rows = _ragged_case_rows(case)
    _, _, _, tables, slot, pos, valid = _ragged_batch(dev, torch.bfloat16,
                                                      64, rep, 16, contexts,
                                                      rows)
    kvh, bs, mp = 2, 16, tables.shape[1]
    items, count, row_splits = RA.ragged_plan(slot, pos, valid, kvh, bs, mp,
                                              rep)
    torch.cuda.synchronize()
    bq, ks_d, ks_p, _ = RA.plan_geometry(bs, mp, rep)
    want, want_rows = RA.ragged_plan_plain(slot.cpu(), pos.cpu(),
                                           valid.cpu(), kvh, bs, mp, bq,
                                           ks_d, ks_p)
    n = int(count.item())
    assert torch.equal(items[:n].cpu(), want)
    assert torch.equal(row_splits.cpu(), want_rows)


def test_ragged_bf16_calls_are_bit_equal(dev):
    contexts, rows = _ragged_case_rows("chunk")
    args = _ragged_batch(dev, torch.bfloat16, 128, 1, 16, contexts, rows)
    a = ragged_attention(*args)
    b = ragged_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("rep", [1, 4])
def test_ragged_graph_replay_with_rewritten_metadata(dev, rep):
    """One call captured in a CUDA graph; slot_ids, positions and valid
    rewritten in place to another batch (other chunk lengths, more valid
    rows); the replay must equal an eager call on the new batch."""
    contexts = [700, 300, 1200, 90]
    first = [(0, 699, 1), (1, 299, 1)] + [(2, p, 1) for p in range(1100, 1130)]
    first += [(0, 0, 0)] * (64 - len(first))
    second = [(3, 89, 1), (0, 699, 1)] + [(1, p, 1) for p in range(200, 260)] \
        + [(2, 1199, 1)]
    second += [(0, 0, 0)] * (64 - len(second))
    q, kp, vp, tables, slot, pos, valid = _ragged_batch(
        dev, torch.bfloat16, 128, rep, 16, contexts, first)
    _, _, _, _, slot2, pos2, valid2 = _ragged_batch(
        dev, torch.bfloat16, 128, rep, 16, contexts, second)
    call = lambda: ragged_attention(q, kp, vp, tables, slot, pos, valid,  # noqa: E731
                                    rep=rep)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, call())
    slot.copy_(slot2)
    pos.copy_(pos2)
    valid.copy_(valid2)
    graph.replay()
    torch.cuda.synchronize()
    want = call()
    assert torch.equal(out, want)
    ref = ragged_attention_plain(q, kp, vp, tables, slot, pos, valid, rep=rep)
    assert float((out.float() - ref.float()).abs().max()) \
        <= _tol(ref, torch.bfloat16)


@pytest.mark.parametrize("sk", [333, 2048, 2049])
def test_flashmask_summary_kernel_matches_plain(dev, sk):
    from paddle_tpu_torch.kernels import flash_attention as FA
    g = torch.Generator(device=dev).manual_seed(sk)
    bounds = torch.randint(-5, sk + 5, (2, 3, sk, 4), generator=g,
                           device=dev, dtype=torch.int32)
    got = FA.flashmask_summary(bounds)
    torch.cuda.synchronize()
    assert torch.equal(got, FA.flashmask_summary_plain(bounds))


def test_ragged_kernel_refuses_what_it_does_not_take(dev):
    q, kp, vp, tables, slot, pos, valid = _ragged_inputs(dev, torch.float32,
                                                         64, 1, 16)
    with pytest.raises(ValueError):
        ragged_attention(q[:, :, :32].contiguous(), kp[..., :32].contiguous(),
                         vp[..., :32].contiguous(), tables, slot, pos, valid)
    with pytest.raises(TypeError):
        ragged_attention(q, kp, vp, tables.long(), slot, pos, valid)
    with pytest.raises(ValueError):
        ragged_attention(q, kp.transpose(1, 2), vp, tables, slot, pos, valid)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [64, 4096])
def test_rms_norm_kernels_match_plain(dev, dtype, hidden):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(5, 3, hidden, device=dev, generator=g).to(dtype)
    r = torch.randn(5, 3, hidden, device=dev, generator=g).to(dtype)
    w = (1 + 0.1 * torch.randn(hidden, device=dev, generator=g)).to(dtype)
    before = dict(K.LAUNCHES)
    got = fused.rms_norm(x, w, 1e-5)
    want = fused.rms_norm_plain(x, w, 1e-5)
    assert float((got.float() - want.float()).abs().max()) \
        <= _tol(want, dtype)
    s, y = fused.add_rms_norm(x, r, w, 1e-5)
    assert K.LAUNCHES["rms_norm"] == before["rms_norm"] + 1
    assert K.LAUNCHES["rms_norm_residual"] == before["rms_norm_residual"] + 1
    ws, wy = fused.add_rms_norm_plain(x, r, w, 1e-5)
    assert torch.equal(s, ws)
    assert float((y.float() - wy.float()).abs().max()) <= _tol(wy, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,d", [(32, 32, 128), (32, 8, 128), (4, 2, 64)])
def test_rope_kernel_matches_plain(dev, dtype, h, kvh, d):
    g = torch.Generator(device=dev).manual_seed(1)
    s = 37
    q = torch.randn(1, s, h, d, device=dev, generator=g).to(dtype)
    k = torch.randn(1, s, kvh, d, device=dev, generator=g).to(dtype)
    ang = torch.rand(s, d // 2, device=dev, generator=g) * 6.3
    before = K.LAUNCHES["rope"]
    gq, gk = fused.fused_rope(q, k, torch.cos(ang), torch.sin(ang))
    assert K.LAUNCHES["rope"] == before + 1
    wq, wk = fused.fused_rope_plain(q, k, torch.cos(ang), torch.sin(ang))
    for got, want in ((gq, wq), (gk, wk)):
        assert float((got.float() - want.float()).abs().max()) \
            <= _tol(want, dtype)


def test_engine_on_gpu_matches_cpu(dev):
    """A tiny float32 Llama served on the GPU through the kernels returns
    the CPU engine's greedy tokens (plain versions)."""
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         load_numpy_state)
    from paddle_tpu_torch.serving import EngineConfig, ServingEngine
    cfg = LlamaConfig.tiny(vocab_size=97, hidden_size=128, layers=2,
                           heads=2, kv_heads=1, seq=128)
    cpu = LlamaForCausalLM(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(4))
    gpu = LlamaForCausalLM(cfg, device=dev)
    load_numpy_state(gpu, {n: p.detach().numpy()
                           for n, p in cpu.named_parameters()})
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 97, (n,)).tolist() for n in (5, 17, 33, 9)]
    ecfg = dict(max_seqs=3, token_budget=24, block_size=16)
    want = ServingEngine(cpu, EngineConfig(**ecfg), device="cpu") \
        .generate_batch(prompts, max_new_tokens=8)
    K.reset_launches()
    got = ServingEngine(gpu, EngineConfig(**ecfg), device=dev) \
        .generate_batch(prompts, max_new_tokens=8)
    assert got == want
    assert all(K.LAUNCHES[n] > 0
               for n in ("ragged_attention", "rms_norm", "rms_norm_residual",
                         "rope"))


# -- the training slice ----------------------------------------------------------

FLASH_CASES = [  # (b, h, sq, sk, d, causal)
    (2, 3, 256, 256, 64, True),
    (1, 2, 200, 200, 128, True),       # ragged last tile
    (1, 2, 100, 300, 64, True),        # sq < sk, bottom-right causal
    (2, 2, 130, 70, 128, False),
    # at the bf16 kernels' 128-row, 128-key tiles and one past them
    (1, 2, 128, 128, 64, True),
    (1, 2, 129, 129, 128, True),
    (1, 2, 255, 383, 128, True),
    (2, 2, 127, 257, 64, False),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernels_match_plain(dev, dtype, case):
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_backward, flash_backward_plain, flash_forward,
        flash_forward_plain)
    b, h, sq, sk, d, causal = case
    g = torch.Generator(device=dev).manual_seed(2)
    q, dout = (torch.randn(b, h, sq, d, device=dev, generator=g).to(dtype)
               for _ in range(2))
    k, v = (torch.randn(b, h, sk, d, device=dev, generator=g).to(dtype)
            for _ in range(2))
    before = dict(K.LAUNCHES)
    out, lse = flash_forward(q, k, v, causal)
    torch.cuda.synchronize()
    wout, wlse = flash_forward_plain(q, k, v, causal)
    if dtype == torch.float32:
        assert float((out - wout).abs().max()) <= _tol(wout, dtype)
    else:
        _assert_rows_close(out, wout, 2)
    assert float((lse - wlse).abs().max()) <= 1e-4
    grads = flash_backward(q, k, v, out, lse, dout, causal)
    torch.cuda.synchronize()
    want = flash_backward_plain(q, k, v, out, lse, dout, causal)
    for got, ref in zip(grads, want):
        if dtype == torch.float32:
            # a gradient sums up to sq products: 1e-4 of its scale
            tol = 1e-4 * max(1.0, float(ref.abs().max()))
            assert float((got - ref).abs().max()) <= tol
        else:
            _assert_rows_close(got, ref, 2)
    assert K.LAUNCHES["flash_fwd"] == before["flash_fwd"] + 1
    assert K.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert K.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1


def test_flash_kernel_refuses_what_it_does_not_take(dev):
    from paddle_tpu_torch.kernels.flash_attention import flash_forward
    q = torch.zeros(1, 1, 16, 96, device=dev)
    with pytest.raises(ValueError):
        flash_forward(q, q, q)
    q = torch.zeros(1, 1, 16, 64, device=dev)
    with pytest.raises(ValueError):
        flash_forward(q, q[:, :, :8], q[:, :, :8], causal=True)
    with pytest.raises(TypeError):
        flash_forward(q.half(), q.half(), q.half())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decoupled", [True, False])
def test_adamw_kernel_matches_plain(dev, dtype, decoupled):
    from paddle_tpu_torch.kernels.optimizer import (CHUNK, adamw_plain,
                                                    multi_tensor_adamw)
    g = torch.Generator(device=dev).manual_seed(3)
    sizes = [CHUNK * 2 + 13, 1000, 7, 3 * CHUNK]
    flat = torch.randn(sum(sizes) + 1, device=dev, generator=g).to(dtype)
    # the last tensor starts off the 16-byte grid: element accesses
    ps = [torch.randn(n, device=dev, generator=g).to(dtype)
          for n in sizes[:-1]] + [flat[1:1 + sizes[-1]]]
    gs = [torch.randn(n, device=dev, generator=g).to(dtype) for n in sizes]
    ms = [0.1 * torch.randn(n, device=dev, generator=g) for n in sizes]
    vs = [torch.rand(n, device=dev, generator=g) * 1e-3 for n in sizes]
    wds = [0.01, 0.0, 0.1, 0.01]
    hp = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8)
    want = [adamw_plain(p, gg, m, v, hp["lr"], hp["beta1"], hp["beta2"],
                        hp["eps"], wd, 4.0, decoupled)
            for p, gg, m, v, wd in zip(ps, gs, ms, vs, wds)]
    # the update changes p: a kernel that did not write it would fail
    assert all(bool((wp != p).any()) for (wp, _, _), p in zip(want, ps))
    before = K.LAUNCHES["adamw"]
    multi_tensor_adamw(ps, gs, ms, vs, wds=wds, step=4.0, decoupled=decoupled,
                       **hp)
    torch.cuda.synchronize()
    assert K.LAUNCHES["adamw"] == before + 1
    for (wp, wm, wv), p, m, v in zip(want, ps, ms, vs):
        # the same correctly rounded fp32 operations in the same order
        assert torch.equal(p, wp) and torch.equal(m, wm) \
            and torch.equal(v, wv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_kernel_per_tensor_rates(dev, dtype):
    """Mixed rate multipliers and weight decays in one launch equal
    ``adamw_plain`` with the same multipliers exactly; with every
    multiplier 1.0 the kernel equals the multiplier-free plain version
    (the rate the kernel had before it took multipliers)."""
    from paddle_tpu_torch.kernels.optimizer import (CHUNK, adamw_plain,
                                                    multi_tensor_adamw)
    g = torch.Generator(device=dev).manual_seed(5)
    sizes = [CHUNK + 77, 2048, 5, 2 * CHUNK]
    wds = [0.1, 0.0, 0.01, 0.0]
    hp = dict(lr=3e-4, beta1=0.9, beta2=0.95, eps=1e-8)

    def inputs():
        g.manual_seed(5)
        return ([torch.randn(n, device=dev, generator=g).to(dtype)
                 for n in sizes],
                [torch.randn(n, device=dev, generator=g).to(dtype)
                 for n in sizes],
                [0.1 * torch.randn(n, device=dev, generator=g)
                 for n in sizes],
                [torch.rand(n, device=dev, generator=g) * 1e-3
                 for n in sizes])

    for mults in ([0.5, 1.0, 0.1, 2.0], [1.0] * 4):
        ps, gs, ms, vs = inputs()
        if mults[0] == 1.0:
            want = [adamw_plain(p, gg, m, v, hp["lr"], hp["beta1"],
                                hp["beta2"], hp["eps"], wd, 2.0)
                    for p, gg, m, v, wd in zip(ps, gs, ms, vs, wds)]
        else:
            want = [adamw_plain(p, gg, m, v, hp["lr"], hp["beta1"],
                                hp["beta2"], hp["eps"], wd, 2.0, True, mu)
                    for p, gg, m, v, wd, mu in zip(ps, gs, ms, vs, wds,
                                                   mults)]
        before = K.LAUNCHES["adamw"]
        multi_tensor_adamw(ps, gs, ms, vs, wds=wds, step=2.0, lr_mults=mults,
                           **hp)
        torch.cuda.synchronize()
        assert K.LAUNCHES["adamw"] == before + 1
        for (wp, wm, wv), p, m, v in zip(want, ps, ms, vs):
            assert torch.equal(p, wp) and torch.equal(m, wm) \
                and torch.equal(v, wv)


def test_training_on_gpu_matches_cpu(dev):
    """A tiny float32 Llama (head_dim 64) trained 3 steps on the GPU
    through every training kernel matches the CPU trainer (plain
    versions): losses 1e-5 relative; weights within 1e-5 for 99.9% of the
    elements and within 3 lr for all (Adam turns the sign of a near-zero
    gradient element's fp32 rounding difference into up to lr a step)."""
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         load_numpy_state)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import SpmdTrainer
    cfg = LlamaConfig.tiny(vocab_size=97, hidden_size=128, layers=2,
                           heads=2, kv_heads=1, seq=96)
    cpu = LlamaForCausalLM(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(4))
    gpu = LlamaForCausalLM(cfg, device=dev)
    load_numpy_state(gpu, {n: p.detach().numpy()
                           for n, p in cpu.named_parameters()})
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 97, (2, 96)))

    def run(model, x):
        tr = SpmdTrainer(model, AdamW(learning_rate=1e-3,
                                      parameters=model.parameters()),
                         lambda m, i, l: m.forward_loss(i, l,
                                                        loss_chunk_size=32),
                         remat_layers=list(model.model.layers))
        return [float(tr.train_step(x, x)) for _ in range(3)]

    want = run(cpu, ids)
    K.reset_launches()
    got = run(gpu, ids.to(dev))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    close = total = 0
    for (n, p), q in zip(cpu.named_parameters(), gpu.parameters()):
        d = (q.detach().cpu() - p.detach()).abs()
        assert float(d.max()) <= 3e-3, n
        close += int((d <= 1e-5).sum())
        total += d.numel()
    assert close >= 0.999 * total, (close, total)
    assert K.LAUNCHES["adamw"] == 3
    assert all(K.LAUNCHES[n] > 0 for n in ("flash_fwd", "flash_bwd_dq",
                                            "flash_bwd_dkv", "rms_norm",
                                            "rope"))


# -- the MoE slice ---------------------------------------------------------------

GMM_SIZES = {  # group sizes over t = 384 rows (rows past the sum stay 0)
    "skewed": [1, 1, 1, 0, 192, 2, 1, 130],        # one-row groups, an empty one
    "one_group": [0, 0, 384, 0],
    "ragged_tail": [100, 0, 37, 200],             # 47 rows past the groups
}


def _gmm_case(dev, dtype, sizes, k=64, n=96, seed=5):
    g = torch.Generator(device=dev).manual_seed(seed)
    t, e = 384, len(sizes)
    x = torch.randn(t, k, device=dev, generator=g).to(dtype)
    w = torch.randn(e, k, n, device=dev, generator=g).to(dtype)
    dy = torch.randn(t, n, device=dev, generator=g).to(dtype)
    return x, w, dy, torch.tensor(sizes, dtype=torch.int32, device=dev)


def _assert_gmm_close(got, want, dtype):
    if dtype == torch.float32:
        # fp32 sums of up to 384 products in another order
        tol = 1e-5 * max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= tol
    else:
        _assert_rows_close(got, want, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(GMM_SIZES))
def test_gmm_kernels_match_plain(dev, dtype, case):
    from paddle_tpu_torch.kernels.gmm import gmm, gmm_plain, tgmm, tgmm_plain
    x, w, dy, gs = _gmm_case(dev, dtype, GMM_SIZES[case])
    before = dict(K.LAUNCHES)
    out = gmm(x, w, gs)
    dx = gmm(dy, w, gs, trans_w=True)
    dw = tgmm(x, dy, gs)
    torch.cuda.synchronize()
    assert K.LAUNCHES["gmm"] == before["gmm"] + 2
    assert K.LAUNCHES["tgmm"] == before["tgmm"] + 1
    total = sum(GMM_SIZES[case])
    assert not out[total:].any() and not dx[total:].any()
    _assert_gmm_close(out, gmm_plain(x, w, gs), dtype)
    _assert_gmm_close(dx, gmm_plain(dy, w, gs, trans_w=True), dtype)
    want = tgmm_plain(x, dy, gs)
    assert dw.dtype == torch.float32
    for g_, size in enumerate(GMM_SIZES[case]):
        if size == 0:
            assert not dw[g_].any()
    _assert_gmm_close(dw.to(dtype), want.to(dtype), dtype)


def test_gmm_function_backward_launches_the_kernels(dev):
    from paddle_tpu_torch.kernels.gmm import GMMFunction
    x, w, dy, gs = _gmm_case(dev, torch.bfloat16, GMM_SIZES["skewed"])
    x.requires_grad_()
    w.requires_grad_()
    K.reset_launches()
    GMMFunction.apply(x, w, gs).backward(dy)
    torch.cuda.synchronize()
    assert (K.LAUNCHES["gmm"], K.LAUNCHES["tgmm"]) == (2, 1)
    assert x.grad.dtype == w.grad.dtype == torch.bfloat16


def test_gmm_kernel_refuses_what_it_does_not_take(dev):
    from paddle_tpu_torch.kernels.gmm import gmm, tgmm
    x, w, dy, gs = _gmm_case(dev, torch.float32, GMM_SIZES["skewed"])
    with pytest.raises(ValueError):                  # k not a multiple of 16
        gmm(x[:, :40], w[:, :40], gs)
    with pytest.raises(TypeError):
        gmm(x, w.bfloat16(), gs)
    with pytest.raises(TypeError):
        tgmm(x, dy, gs.long())


# shapes the new kernels' tiles do not divide: t, k and n off the 128-row,
# 64-deep and 256- / 128-column tiles; group sizes off the 64-row slices;
# empty first and last groups; rows past the groups; more tiles than SMs
GMM_EDGES = {  # (t, k, n, group sizes)
    "tails": (300, 80, 208, [37, 100, 0, 130, 29]),       # 4 rows past
    "empty_ends": (384, 64, 96, [0, 200, 150, 0]),        # 34 rows past
    "deep": (700, 320, 272, [0, 130, 1, 64, 255, 0, 190, 0]),
    "many_tiles": (4100, 192, 1040, [700, 1, 1299, 0, 2048, 3]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(GMM_EDGES))
def test_gmm_kernels_at_tile_edges(dev, dtype, case):
    from paddle_tpu_torch.kernels.gmm import gmm, gmm_plain, tgmm, tgmm_plain
    t, k, n, sizes = GMM_EDGES[case]
    g = torch.Generator(device=dev).manual_seed(t)
    x = torch.randn(t, k, device=dev, generator=g).to(dtype)
    w = torch.randn(len(sizes), k, n, device=dev, generator=g).to(dtype)
    dy = torch.randn(t, n, device=dev, generator=g).to(dtype)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    out, dx, dw = gmm(x, w, gs), gmm(dy, w, gs, trans_w=True), tgmm(x, dy, gs)
    torch.cuda.synchronize()
    total = sum(sizes)
    assert not out[total:].any() and not dx[total:].any()     # exactly 0
    for g_, size in enumerate(sizes):
        if size == 0:
            assert not dw[g_].any()                            # exactly 0
    _assert_gmm_close(out, gmm_plain(x, w, gs), dtype)
    _assert_gmm_close(dx, gmm_plain(dy, w, gs, trans_w=True), dtype)
    _assert_gmm_close(dw.to(dtype), tgmm_plain(x, dy, gs).to(dtype), dtype)


# -- attention shapes the kernels do not take -----------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq, sk, d, causal", [(7, 5, 64, True),
                                               (12, 12, 32, True),
                                               (9, 13, 80, False),
                                               (8, 8, 256, True)])
def test_sdpa_routes_what_the_kernels_lack(dev, dtype, sq, sk, d, causal):
    """On the card too, a call the flash kernels do not take runs the plain
    path (the same function on the CPU), counted once; no flash kernel
    launches, only the dense middle's (X2) forward and backward, once
    each (the forward on the CUDA kernel where its plan takes the row);
    gradients flow."""
    from paddle_tpu_torch.nn import functional as F
    g = torch.Generator().manual_seed(d)
    q, k, v = (torch.randn(2, s, 3, d, generator=g).to(dtype)
               for s in (sq, sk, sk))
    want = F._sdpa_reference(q, k, v, causal=causal)
    qd, kd, vd = (a.to(dev).requires_grad_() for a in (q, k, v))
    before = dict(K.LAUNCHES)
    got = F.scaled_dot_product_attention(qd, kd, vd, is_causal=causal)
    got.float().sum().backward()
    torch.cuda.synchronize()
    assert K.LAUNCHES["sdpa_plain"] == before["sdpa_plain"] + 1
    from paddle_tpu_torch.kernels import dense_attention as DA
    x2 = ("dense_softmax", "dense_softmax_bwd") + (
        ("dense_softmax_cuda",)
        if DA.dense_softmax_forward_plan(sk) == "cuda" else ())
    assert K.kernel_launches() == {n: c + (n in x2)
                                   for n, c in before.items()
                                   if n not in K.ROUTED}
    assert qd.grad is not None and bool(torch.isfinite(qd.grad).all())
    err = float((got.detach().cpu().float() - want.float()).abs().max())
    assert err <= _tol(want, dtype), err


def test_sdpa_keeps_the_kernels_for_what_they_take(dev):
    from paddle_tpu_torch.nn import functional as F
    q = torch.randn(1, 40, 2, 64, device=dev, dtype=torch.bfloat16)
    before = dict(K.LAUNCHES)
    F.scaled_dot_product_attention(q, q, q, is_causal=True)
    torch.cuda.synchronize()
    assert K.LAUNCHES["flash_fwd"] == before["flash_fwd"] + 1
    assert K.LAUNCHES["sdpa_plain"] == before["sdpa_plain"]


@pytest.mark.parametrize("d, rep", [(32, 3), (256, 1), (64, 3)])
def test_make_attend_routes_what_the_kernel_lacks(dev, d, rep):
    from paddle_tpu_torch.serving.ragged import make_attend
    q, kp, vp, tables, slot, pos, valid = _ragged_inputs(dev, torch.float32,
                                                         d, rep, 16)
    before = dict(K.LAUNCHES)
    got = make_attend(tables, slot, pos, valid, rep)(q, kp, vp)
    torch.cuda.synchronize()
    assert K.LAUNCHES["ragged_plain"] == before["ragged_plain"] + 1
    assert K.LAUNCHES["ragged_attention"] == before["ragged_attention"]
    want = ragged_attention_plain(*(a.cpu() for a in (q, kp, vp, tables, slot,
                                                       pos, valid)), rep=rep)
    assert float((got.cpu() - want).abs().max()) <= _tol(want, torch.float32)


def test_moe_layer_on_gpu_matches_cpu(dev):
    """One dropless MoE layer (float32) forward and backward on the GPU
    against the same layer on the CPU: output and every gradient within
    1e-5 of their scale."""
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    cpu = MoELayer(d_model=64, d_hidden=128, num_expert=4, dropless=True,
                   device="cpu", generator=torch.Generator().manual_seed(1))
    gpu = MoELayer(d_model=64, d_hidden=128, num_expert=4, dropless=True,
                   device=dev)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn(3, 50, 64, generator=torch.Generator().manual_seed(2))
    outs = []
    for layer, xx in ((cpu, x), (gpu, x.to(dev))):
        out = layer(xx)
        (out.square().sum() + layer.l_aux).backward()
        outs.append(out.detach().cpu())
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-5 * max(
        1.0, float(outs[0].abs().max()))
    for (n, p), q in zip(cpu.named_parameters(), gpu.parameters()):
        tol = 1e-5 * max(1.0, float(p.grad.abs().max()))
        assert float((q.grad.cpu() - p.grad).abs().max()) <= tol, n


def test_gpt_moe_training_on_gpu_matches_cpu(dev):
    """A tiny float32 GPT-MoE (head_dim 64, dropless MoE in every block)
    trained 3 steps on the GPU through the flash, gmm, tgmm and AdamW
    kernels matches the CPU trainer: losses 1e-5 relative; weights within
    3 lr, and within 1e-5 for 99.9% of the elements."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import SpmdTrainer
    cfg = GPTConfig.tiny(vocab_size=97, hidden_size=128, layers=2, heads=2,
                         seq=96, num_experts=4, moe_every=1)
    cpu = GPTForCausalLM(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(4))
    gpu = GPTForCausalLM(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 97, (2, 96)))

    def run(model, x):
        for block in model.transformer.h:
            block.mlp.dropless = True
        tr = SpmdTrainer(model, AdamW(learning_rate=1e-3,
                                      parameters=model.parameters()),
                         lambda m, i, l: m.compute_loss(m(i), l))
        return [float(tr.train_step(x, x)) for _ in range(3)]

    want = run(cpu, ids)
    K.reset_launches()
    got = run(gpu, ids.to(dev))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    close = total = 0
    for (n, p), q in zip(cpu.named_parameters(), gpu.parameters()):
        d = (q.detach().cpu() - p.detach()).abs()
        assert float(d.max()) <= 3e-3, n
        close += int((d <= 1e-5).sum())
        total += d.numel()
    assert close >= 0.999 * total, (close, total)
    # tgmm: each MoE layer's two weight gradients and its two biases'
    assert K.LAUNCHES["gmm"] == 3 * 2 * 4 and K.LAUNCHES["tgmm"] == 3 * 2 * 4
    assert K.LAUNCHES["adamw"] == 3 and K.LAUNCHES["flash_fwd"] == 3 * 2


# -- the FlashMask slice -----------------------------------------------------------

def _doc_ends(rng, s, lo, hi):
    """End of each column's document, documents of lengths in [lo, hi]."""
    ends = np.empty(s, np.int32)
    start = 0
    while start < s:
        end = min(s, start + int(rng.integers(lo, hi + 1)))
        ends[start:end] = end
        start = end
    return ends


def _flashmask_bounds(form, b, hb, s, seed=6):
    """(canonical bounds [b, hb, s, 4] int32 on the CPU, causal)."""
    from paddle_tpu_torch.nn.functional import _canonical_startend
    rng = np.random.default_rng(seed)
    col = lambda lo, hi: rng.integers(lo, hi, (b, hb, s, 1))   # noqa: E731
    if form in ("docs", "long_docs"):
        lo, hi = (20, 90) if form == "docs" else (150, 400)
        se = np.stack([np.stack([_doc_ends(rng, s, lo, hi)
                                 for _ in range(hb)]) for _ in range(b)])
        se, causal = se[..., None], True
    elif form == "causal_2":
        lts = col(1, s)
        se, causal = np.concatenate([lts, np.minimum(lts + col(0, s), s)],
                                    -1), True
    elif form == "noncausal_2":
        se, causal = np.concatenate([col(1, s), col(0, s)], -1), False
    elif form == "noncausal_4":
        lts, uts = col(1, s), col(0, s)
        se = np.concatenate([lts, np.minimum(lts + col(0, 64), s), uts,
                             np.minimum(uts + col(0, 64), s)], -1)
        causal = False
    else:                                   # "empty": rows 90..149 see nothing
        se = np.broadcast_to(np.asarray([90, 150, 90, 150]),
                             (b, hb, s, 4)).copy()
        causal = False
    return _canonical_startend(torch.from_numpy(se.astype(np.int32)), s,
                               causal), causal


FLASHMASK_CASES = {  # (b, h, hb, s, d, form, window)
    "causal_docs": (2, 3, 1, 256, 64, "docs", None),
    "causal_docs_ragged": (1, 2, 1, 200, 128, "docs", None),
    "causal_long_docs": (1, 2, 1, 512, 64, "long_docs", None),
    "causal_2_per_head": (1, 2, 2, 192, 64, "causal_2", None),
    "causal_window": (1, 2, 1, 256, 128, "docs", (100, None)),
    "noncausal_2": (2, 2, 1, 256, 128, "noncausal_2", None),
    "noncausal_4_window": (1, 2, 2, 333, 64, "noncausal_4", (40, 70)),
    "empty_rows": (1, 2, 1, 256, 64, "empty", (-1, None)),
    # at the bf16 kernels' 128 x 128 tiles and one past or short of them
    "causal_docs_257": (1, 2, 1, 257, 128, "docs", None),
    "noncausal_2_384": (1, 2, 2, 384, 64, "noncausal_2", None),
    "causal_2_127": (1, 2, 1, 127, 128, "causal_2", None),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(FLASHMASK_CASES))
def test_flashmask_kernels_match_plain(dev, dtype, case):
    from paddle_tpu_torch.kernels import flash_attention as FA
    b, h, hb, s, d, form, window = FLASHMASK_CASES[case]
    bounds, causal = _flashmask_bounds(form, b, hb, s)
    bounds = bounds.to(dev)
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v, dout = (torch.randn(b, h, s, d, device=dev, generator=g)
                     .to(dtype) for _ in range(4))
    seen = FA.flashmask_visible(bounds, s, s, causal, window).any(-1) \
        .expand(b, h, s)
    before = dict(K.LAUNCHES)
    summary = FA.flashmask_summary(bounds)
    assert torch.equal(summary, FA.flashmask_summary_plain(bounds))
    tile = FA.KIND_TILE[dtype]
    nt = -(-s // tile)
    kinds = torch.full((b * h, nt, nt), -1, dtype=torch.int8, device=dev)
    out, lse = FA.flash_forward(q, k, v, causal, bounds=bounds, window=window,
                                summary=summary, tile_kinds=kinds)
    torch.cuda.synchronize()
    wout, wlse = FA.flash_forward_plain(q, k, v, causal, bounds=bounds,
                                        window=window)
    if dtype == torch.float32:
        assert float((out - wout).abs().max()) <= _tol(wout, dtype)
    else:
        _assert_rows_close(out, wout, 2)
    assert float((lse - wlse).abs().max()) <= 1e-4
    assert not out[~seen].any()
    assert bool((lse[~seen] == FA.NEG_INF).all())
    if case == "empty_rows":
        assert int((~seen).sum()) == b * h * 61
    # the kernel's own tile kinds: a skipped tile holds no visible entry, a
    # full one only visible entries
    vis = FA.flashmask_visible(bounds, s, s, causal, window)
    vis = torch.nn.functional.pad(vis, (0, nt * tile - s, 0, nt * tile - s))
    vis = vis.reshape(b, hb, nt, tile, nt, tile)
    kinds = kinds.view(b, hb, h // hb, nt, nt)
    assert bool((kinds == kinds[:, :, :1]).all())
    kinds = kinds[:, :, 0]
    assert not vis.any(5).any(3)[kinds == 0].any()
    assert bool(vis.all(5).all(3)[kinds == 2].all())
    assert bool((kinds >= 0).any())
    grads = FA.flash_backward(q, k, v, out, lse, dout, causal, bounds=bounds,
                              window=window, summary=summary)
    torch.cuda.synchronize()
    want = FA.flash_backward_plain(q, k, v, out, lse, dout, causal,
                                   bounds=bounds, window=window)
    for got, ref in zip(grads, want):
        if dtype == torch.float32:
            tol = 1e-4 * max(1.0, float(ref.abs().max()))
            assert float((got - ref).abs().max()) <= tol
        else:
            _assert_rows_close(got, ref, 2)
    assert not grads[0][~seen].any()
    used = {n: K.LAUNCHES[n] - before[n] for n in K.LAUNCHES}
    assert used == {**{n: 0 for n in K.LAUNCHES}, "flashmask_summary": 1,
                    "flashmask_fwd": 1, "flashmask_bwd_dq": 1,
                    "flashmask_bwd_dkv": 1}


def test_flashmask_kernel_refuses_what_it_does_not_take(dev):
    from paddle_tpu_torch.kernels.flash_attention import flash_forward
    bounds = torch.zeros(1, 1, 64, 4, dtype=torch.int32, device=dev)
    q = torch.zeros(1, 2, 64, 64, device=dev)
    with pytest.raises(NotImplementedError):             # sq != sk
        flash_forward(q[:, :, :32], q, q, True, bounds=bounds)
    q32 = torch.zeros(1, 2, 64, 32, device=dev)
    with pytest.raises(ValueError):                      # head_dim 32
        flash_forward(q32, q32, q32, True, bounds=bounds)
    with pytest.raises(TypeError):
        flash_forward(q, q, q, True, bounds=bounds.long())
    with pytest.raises(ValueError):                      # 3 bound heads of 2
        flash_forward(q, q, q, True, bounds=bounds.expand(1, 3, 64, 4))
    with pytest.raises(ValueError):
        flash_forward(q, q, q, True, bounds=bounds.cpu())
    with pytest.raises(ValueError):                      # a window alone
        flash_forward(q, q, q, True, window=(8, None))
    with pytest.raises(ValueError):                      # a summary of 2 tiles
        flash_forward(q, q, q, True, bounds=bounds,
                      summary=torch.zeros(1, 1, 2, 8, dtype=torch.int32,
                                          device=dev))


def test_packed_training_on_gpu_matches_cpu(dev):
    """A tiny float32 Llama trained 3 steps on packed documents on the GPU
    through the FlashMask kernels matches the CPU trainer, held as the
    dense tiny Llama is."""
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         load_numpy_state)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import SpmdTrainer
    cfg = LlamaConfig.tiny(vocab_size=97, hidden_size=128, layers=2,
                           heads=2, kv_heads=1, seq=160)
    cpu = LlamaForCausalLM(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(4))
    gpu = LlamaForCausalLM(cfg, device=dev)
    load_numpy_state(gpu, {n: p.detach().numpy()
                           for n, p in cpu.named_parameters()})
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, 97, (2, 160)))
    se = torch.from_numpy(np.stack([_doc_ends(rng, 160, 20, 70)
                                    for _ in range(2)])[:, None, :, None])

    def run(model, x, bounds):
        tr = SpmdTrainer(model, AdamW(learning_rate=1e-3,
                                      parameters=model.parameters()),
                         lambda m, i, l, e: m.forward_loss(
                             i, l, loss_chunk_size=32,
                             attn_startend_row_indices=e),
                         remat_layers=list(model.model.layers))
        return [float(tr.train_step(x, x, bounds)) for _ in range(3)]

    want = run(cpu, ids, se)
    K.reset_launches()
    got = run(gpu, ids.to(dev), se.to(dev))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    close = total = 0
    for (n, p), q in zip(cpu.named_parameters(), gpu.parameters()):
        d = (q.detach().cpu() - p.detach()).abs()
        assert float(d.max()) <= 3e-3, n
        close += int((d <= 1e-5).sum())
        total += d.numel()
    assert close >= 0.999 * total, (close, total)
    # remat: two forwards a layer a step, one backward
    # and the bounds summarised once a step, in the model's forward
    assert (K.LAUNCHES["flashmask_fwd"], K.LAUNCHES["flashmask_bwd_dq"],
            K.LAUNCHES["flashmask_bwd_dkv"],
            K.LAUNCHES["flashmask_summary"]) == (12, 6, 6, 3)
    assert K.LAUNCHES["flash_fwd"] == 0 and K.LAUNCHES["adamw"] == 3


# -- the captured serving step and generate() --------------------------------------

def _tiny_llama_pair(dev, dtype, kv_heads=1, seed=4):
    """A tiny Llama (head_dim 64, which the ragged kernel takes) on the CPU
    in float32 and the same weights on the card in ``dtype``."""
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         load_numpy_state)
    cfg = LlamaConfig.tiny(vocab_size=97, hidden_size=128, layers=2,
                           heads=2, kv_heads=kv_heads, seq=256)
    cpu = LlamaForCausalLM(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(seed))
    gpu = LlamaForCausalLM(cfg, device=dev)
    load_numpy_state(gpu, {n: p.detach().numpy()
                           for n, p in cpu.named_parameters()})
    return cpu, gpu.to(dtype)


SERVE_PROMPT_LENS = (5, 17, 33, 9, 60)


def _serve_prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 97, (n,)).tolist() for n in SERVE_PROMPT_LENS]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_captured_engine_matches_eager_step(dev, dtype):
    """Two engines over the same requests, one replaying its captured step
    and one running the step op by op, stepped together: every step's
    logits bit-equal, the pools' real pages equal after every step, and
    the same tokens; the captured engine captured at construction."""
    from paddle_tpu_torch.serving import EngineConfig, ServingEngine
    _, gpu = _tiny_llama_pair(dev, dtype)
    ecfg = EngineConfig(max_seqs=3, token_budget=24, block_size=16)
    graph, eager = (ServingEngine(gpu, ecfg) for _ in range(2))
    eager._step = eager._step_eager
    assert graph._graph is not None and graph.capture_seconds > 0
    reqs = [[e.submit(p, max_new_tokens=8) for p in _serve_prompts()]
            for e in (graph, eager)]
    p_real = graph.pool.num_blocks
    more, steps = True, 0
    while more:
        more = graph.step()
        assert eager.step() == more
        steps += 1
        assert torch.equal(graph._logits, eager._logits), steps
        assert torch.equal(graph._kp[:, :p_real], eager._kp[:, :p_real])
        assert torch.equal(graph._vp[:, :p_real], eager._vp[:, :p_real])
    assert [r.result(0) for r in reqs[0]] == [r.result(0) for r in reqs[1]]


def test_captured_engine_matches_cpu_engine(dev):
    """float32: the captured engine's greedy tokens equal the CPU
    engine's (plain versions)."""
    from paddle_tpu_torch.serving import EngineConfig, ServingEngine
    cpu, gpu = _tiny_llama_pair(dev, torch.float32, kv_heads=2)
    ecfg = dict(max_seqs=3, token_budget=24, block_size=16)
    want = ServingEngine(cpu, EngineConfig(**ecfg), device="cpu") \
        .generate_batch(_serve_prompts(1), max_new_tokens=8)
    got = ServingEngine(gpu, EngineConfig(**ecfg)) \
        .generate_batch(_serve_prompts(1), max_new_tokens=8)
    assert got == want


def test_captured_engine_launch_counts(dev):
    """Each replay adds the launches the capture recorded (one ragged
    attention, RoPE and residual norm a layer, one norm a layer and the
    final norm); the capture itself counts none."""
    from paddle_tpu_torch.serving import EngineConfig, ServingEngine
    _, gpu = _tiny_llama_pair(dev, torch.bfloat16)
    layers = gpu.config.num_hidden_layers
    K.reset_launches()
    eng = ServingEngine(gpu, EngineConfig(max_seqs=3, token_budget=24,
                                          block_size=16))
    tally = {"ragged_attention": layers, "rms_norm": layers + 1,
             "rms_norm_residual": layers, "rope": layers}
    assert eng._tally == tally
    K.reset_launches()
    eng.generate_batch(_serve_prompts(), max_new_tokens=4)
    assert eng.steps > 0
    want = {n: 0 for n in K.LAUNCHES}
    want.update({n: c * eng.steps for n, c in tally.items()})
    assert K.LAUNCHES == want


def test_ragged_layers_share_one_plan(dev):
    """A plan dict shared by the calls over one batch: the first call's
    plan equals the plain plan, and a later call reusing it (another
    layer's q and pools) equals a call that plans for itself, bit for
    bit."""
    from paddle_tpu_torch.kernels import ragged_attention as RA
    contexts, rows = _ragged_case_rows("chunk")
    rep, bs = 2, 16
    q, kp, vp, tables, slot, pos, valid = _ragged_batch(
        dev, torch.bfloat16, 128, rep, bs, contexts, rows)
    q2, kp2, vp2, *_ = _ragged_batch(dev, torch.bfloat16, 128, rep, bs,
                                     contexts, rows, seed=1)
    plan = {}
    first = ragged_attention(q, kp, vp, tables, slot, pos, valid, rep,
                             plan=plan)
    second = ragged_attention(q2, kp2, vp2, tables, slot, pos, valid, rep,
                              plan=plan)
    torch.cuda.synchronize()
    assert torch.equal(first, ragged_attention(q, kp, vp, tables, slot, pos,
                                               valid, rep))
    assert torch.equal(second, ragged_attention(q2, kp2, vp2, tables, slot,
                                                pos, valid, rep))
    mp = tables.shape[1]
    bq, ks_d, ks_p, _ = RA.plan_geometry(bs, mp, rep)
    want, want_rows = RA.ragged_plan_plain(slot.cpu(), pos.cpu(),
                                           valid.cpu(), kp.shape[1], bs, mp,
                                           bq, ks_d, ks_p)
    n = int(plan["count"].item())
    assert torch.equal(plan["items"][:n].cpu(), want)
    assert torch.equal(plan["row_splits"].cpu(), want_rows)


def _left_padded(b, width, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, width + 1, (b,))
    ids = np.zeros((b, width), np.int64)
    mask = np.zeros((b, width), np.int64)
    for i, n in enumerate(lens):
        ids[i, width - n:] = rng.integers(1, 97, (n,))
        mask[i, width - n:] = 1
    return ids, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_heads", [1, 2])
def test_captured_generate_matches_eager(dev, dtype, kv_heads):
    """generate()'s replayed decode graph against the same loop run op by
    op on the card: equal tokens and finished flags, and in float32 equal
    to the CPU's generate() too; the decode graph is kept for the next
    call of the same signature."""
    from paddle_tpu_torch import generation as G
    cpu, gpu = _tiny_llama_pair(dev, dtype, kv_heads=kv_heads)
    ids, mask = _left_padded(4, 24)
    got = G.generate(gpu, ids, attention_mask=mask, max_new_tokens=10,
                     repetition_penalty=1.2)
    dec = G._decoder_for(gpu)
    assert len(dec.loops) == 1
    want = G._decode(dec, dec.weights(gpu), torch.from_numpy(ids).to(dev),
                     torch.from_numpy(mask).to(dev), 10,
                     repetition_penalty=1.2, capture=False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    again = G.generate(gpu, ids, attention_mask=mask, max_new_tokens=10,
                       repetition_penalty=1.2)
    assert torch.equal(again[0], got[0]) and len(dec.loops) == 1
    if dtype == torch.float32:
        ref = G.generate(cpu, ids, attention_mask=mask, max_new_tokens=10,
                         repetition_penalty=1.2, device="cpu")
        assert torch.equal(got[0], ref[0])


def test_generate_graph_launch_counts(dev):
    """The prefill's launches, then each replay's: a norm a layer and the
    final one, a residual norm and a RoPE a layer."""
    from paddle_tpu_torch import generation as G
    _, gpu = _tiny_llama_pair(dev, torch.bfloat16)
    layers = gpu.config.num_hidden_layers
    ids, mask = _left_padded(3, 16, seed=2)
    G.generate(gpu, ids, attention_mask=mask, max_new_tokens=6)   # capture
    K.reset_launches()
    G.generate(gpu, ids, attention_mask=mask, max_new_tokens=6)
    calls = 1 + 6                           # the prefill, then 6 replays
    want = {n: 0 for n in K.LAUNCHES}
    want.update(rms_norm=(layers + 1) * calls, rms_norm_residual=layers
                * calls, rope=layers * calls)
    assert K.LAUNCHES == want


def test_sampled_graph_draws_new_noise_each_step(dev):
    """The sampled decode graph's generator is registered with the graph:
    each replay draws new noise (an unregistered one would replay the
    first draw), the same seed repeats a run, and every token is in the
    vocabulary."""
    from paddle_tpu_torch import generation as G
    _, gpu = _tiny_llama_pair(dev, torch.bfloat16)
    ids, mask = _left_padded(4, 20, seed=3)
    kw = dict(attention_mask=mask, max_new_tokens=8, do_sample=True,
              temperature=0.8, top_k=50, top_p=0.9)
    a, _ = G.generate(gpu, ids, seed=7, **kw)
    b, _ = G.generate(gpu, ids, seed=7, **kw)
    assert torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < 97
    dec = G._decoder_for(gpu)
    loop = G._loop_for(dec, dec.weights(gpu), 4, 20, 8, True, False, 50,
                       0.9, False, 1)
    assert loop.graph is not None
    loop.start(torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev),
               0.8, 0, 1.0, seed=7)
    draws = []
    for _ in range(4):
        loop.step()
        draws.append(loop.noise.clone())
    assert all(not torch.equal(draws[i], draws[i + 1]) for i in range(3))


# -- the weight-only GEMM ---------------------------------------------------------
#
# Tolerance: each row within two bf16 ulps of its largest plain value. The
# kernel and the plain version both round the fp32 sum to bf16, scale it in
# fp32 and round again; they differ in summation order only, which moves
# the first rounding by at most one step.

QUANT_ALGOS = ("weight_only_int8", "weight_only_int4", "weight_only_fp8")
# (M, K, N): decode, a tile edge in every dim, the serving step's rows, an
# odd K (no 16-byte rows: the element-load path) and a K tail
GEMM_SHAPES = [(8, 768, 2304), (37, 200, 136), (256, 1024, 512),
               (5, 33, 24), (130, 4104, 96)]


def _quant_case(dev, algo, m, k, n, seed=0):
    from paddle_tpu_torch.quantization import weight_quantize
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(k, n, generator=g) * 0.05
    q, s = weight_quantize(w, algo)
    x = torch.randn(m, k, generator=g).to(torch.bfloat16)
    return x.to(dev), q.to(dev), s.to(dev)


@pytest.mark.parametrize("algo", QUANT_ALGOS)
@pytest.mark.parametrize("m, k, n", GEMM_SHAPES)
def test_weight_only_gemm_matches_plain(dev, algo, m, k, n):
    from paddle_tpu_torch.kernels.quant_matmul import weight_only_gemm
    from paddle_tpu_torch.quantization._kernels import quant_matmul_arrays
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from paddle_tpu_torch.kernels.quant_matmul import weight_only_gemm_takes
    x, q, s = _quant_case(dev, algo, m, k, n)
    before = K.LAUNCHES["weight_only_gemm"]
    sm80 = K.LAUNCHES["weight_only_gemm_sm80"]
    got = weight_only_gemm(x, q, s)
    torch.cuda.synchronize()
    assert K.LAUNCHES["weight_only_gemm"] == before + 1
    # the odd shapes (K 200, 33, 4104; N 24, 136, 96) go to the mma.sync
    # kernel, the rest to the wgmma kernel
    assert K.LAUNCHES["weight_only_gemm_sm80"] == sm80 + (
        not weight_only_gemm_takes(x, q, s))
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    _assert_rows_close(got, quant_matmul_arrays(x, q, s), 2)


# (M, token tile, channel tile): each instantiation of the wgmma kernel,
# and 600 rows over three 256-row tiles
WGMMA_TILES = [(5, 8, 128), (40, 64, 128), (100, 128, 128), (256, 256, 128),
               (600, 256, 128), (256, 256, 64), (600, 256, 64)]


@pytest.mark.parametrize("algo", QUANT_ALGOS)
@pytest.mark.parametrize("m, tile, channels", WGMMA_TILES)
@pytest.mark.parametrize("splits", range(1, 9))
def test_weight_only_gemm_wgmma_every_tile_and_split(dev, algo, m, tile,
                                                     channels, splits):
    """The wgmma kernel on each tile and split count (K = 512: 8 stages;
    N = 392: a partial channel tile): within 2 ulps of the plain version
    and of its own arithmetic in PyTorch (the split partials summed in
    order); two calls give the same bits."""
    from paddle_tpu_torch.kernels import quant_matmul as QM
    from paddle_tpu_torch.quantization._kernels import quant_matmul_arrays
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    x, q, s = _quant_case(dev, algo, m, 512, 392, seed=splits)
    plan = QM.Plan(tile, channels, splits)
    got = QM.weight_only_gemm_wgmma(x, q, s, plan)
    again = QM.weight_only_gemm_wgmma(x, q, s, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _assert_rows_close(got, quant_matmul_arrays(x, q, s), 2)
    _assert_rows_close(got, QM.weight_only_gemm_split_plain(x, q, s, plan), 2)


def test_weight_only_gemm_split_plan_replays_in_a_graph(dev):
    """A call whose plan splits K across a cluster: two eager calls are
    bit-equal, and a captured call replayed on new activations written in
    place equals an eager call on them."""
    from paddle_tpu_torch.kernels import quant_matmul as QM
    from paddle_tpu_torch.kernels.quant_matmul import weight_only_gemm
    x, q, s = _quant_case(dev, "weight_only_int8", 256, 4096, 1024)
    assert QM.weight_only_gemm_plan(
        256, 1024, 4096, QM.card_capacity(dev, 0)).splits > 1
    first = weight_only_gemm(x, q, s)
    assert torch.equal(first, weight_only_gemm(x, q, s))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        weight_only_gemm(x, q, s)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = weight_only_gemm(x, q, s)
    x.copy_(torch.randn(x.shape, device=dev).to(x.dtype))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, weight_only_gemm(x, q, s))
    assert not torch.equal(out, first)


@pytest.mark.parametrize("k, n", [(4096, 4096), (4096, 11008),
                                  (11008, 4096), (768, 2304), (768, 768),
                                  (768, 3072), (3072, 768)])
def test_served_shapes_take_the_wgmma_kernel(dev, k, n):
    """Every served matrix (the Llama-2-7B head aside, by size) counts in
    ``weight_only_gemm`` and not in ``weight_only_gemm_sm80``."""
    from paddle_tpu_torch.kernels.quant_matmul import weight_only_gemm
    from paddle_tpu_torch.quantization._kernels import quant_matmul_arrays
    x, q, s = _quant_case(dev, "weight_only_int4", 8, k, n)
    before = dict(K.LAUNCHES)
    got = weight_only_gemm(x, q, s)
    torch.cuda.synchronize()
    assert K.LAUNCHES["weight_only_gemm"] == before["weight_only_gemm"] + 1
    assert K.LAUNCHES["weight_only_gemm_sm80"] == \
        before["weight_only_gemm_sm80"]
    _assert_rows_close(got, quant_matmul_arrays(x, q, s), 2)


def test_an_unaligned_slice_takes_the_mma_sync_kernel(dev):
    """Activations that start 2 bytes into their storage (a slice of a
    packed batch) go to the mma.sync kernel, with the same result."""
    from paddle_tpu_torch.kernels.quant_matmul import weight_only_gemm
    from paddle_tpu_torch.quantization._kernels import quant_matmul_arrays
    x, q, s = _quant_case(dev, "weight_only_int8", 6, 256, 128)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    xs = flat[1:].view(x.shape)
    xs.copy_(x)
    sm80 = K.LAUNCHES["weight_only_gemm_sm80"]
    got = weight_only_gemm(xs, q, s)
    torch.cuda.synchronize()
    assert K.LAUNCHES["weight_only_gemm_sm80"] == sm80 + 1
    _assert_rows_close(got, quant_matmul_arrays(x, q, s), 2)


def test_weight_only_gemm_replays_in_a_graph(dev):
    """A captured call replayed on new activations written in place equals
    an eager call on them, bit for bit; two eager calls are bit-equal."""
    from paddle_tpu_torch.kernels.quant_matmul import weight_only_gemm
    x, q, s = _quant_case(dev, "weight_only_int4", 8, 4096, 512)
    first = weight_only_gemm(x, q, s)
    assert torch.equal(first, weight_only_gemm(x, q, s))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        weight_only_gemm(x, q, s)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = weight_only_gemm(x, q, s)
    x.copy_(torch.randn(x.shape, device=dev).to(x.dtype))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, weight_only_gemm(x, q, s))
    assert not torch.equal(out, first)


def test_weight_only_gemm_refuses_what_it_does_not_take(dev):
    from paddle_tpu_torch.kernels.quant_matmul import weight_only_gemm
    from paddle_tpu_torch.serving import EngineConfig, ServingEngine
    x, q, s = _quant_case(dev, "weight_only_int8", 4, 64, 32)
    with pytest.raises(TypeError, match="bf16"):
        weight_only_gemm(x.float(), q, s)
    with pytest.raises(ValueError, match="width"):
        weight_only_gemm(x, q[:, :40].contiguous(), s)
    with pytest.raises(TypeError, match="contiguous"):
        weight_only_gemm(x, q.T.contiguous().T, s)
    with pytest.raises(TypeError, match="int8"):
        weight_only_gemm(x, q.to(torch.int16), s)
    with pytest.raises(TypeError, match="scales"):
        weight_only_gemm(x, q, s.double())
    # nothing is routed to the plain version on the card: a float32 model
    # is refused quantized weights before the engine quantizes or captures
    _, gpu = _tiny_llama_pair(dev, torch.float32)
    with pytest.raises(TypeError, match="bf16 model"):
        ServingEngine(gpu, EngineConfig(max_seqs=2, token_budget=16,
                                        block_size=16,
                                        quant="weight_only_int8"))


@pytest.mark.parametrize("algo", QUANT_ALGOS)
def test_quantized_engine_captured_matches_eager(dev, algo):
    """A bf16 engine serving quantized weights: the captured step equals
    the eager step bit for bit at every step, the tokens are equal, and
    each replay launches the GEMM once per quantized matrix."""
    from paddle_tpu_torch.generation import _decoder_for
    from paddle_tpu_torch.serving import EngineConfig, ServingEngine
    _, gpu = _tiny_llama_pair(dev, torch.bfloat16)
    ecfg = EngineConfig(max_seqs=3, token_budget=24, block_size=16,
                        quant=algo)
    graph, eager = (ServingEngine(gpu, ecfg) for _ in range(2))
    eager._step = eager._step_eager
    names, lm = _decoder_for(gpu).quant_plan()
    assert graph._tally["weight_only_gemm"] == len(names) + (lm is not None)
    reqs = [[e.submit(p, max_new_tokens=6) for p in _serve_prompts()]
            for e in (graph, eager)]
    more = True
    while more:
        more = graph.step()
        eager.step()
        assert torch.equal(graph._logits, eager._logits)
    assert [r.result(0) for r in reqs[0]] == [r.result(0) for r in reqs[1]]


def test_quantized_generate_graph_matches_eager(dev):
    from paddle_tpu_torch import generation as G
    _, gpu = _tiny_llama_pair(dev, torch.bfloat16, kv_heads=2)
    ids, mask = _left_padded(4, 24)
    got = G.generate(gpu, ids, attention_mask=mask, max_new_tokens=8,
                     quant="weight_only_int8")
    dec = G._decoder_for(gpu)
    w = G._quant_weights_cached(dec, gpu, "weight_only_int8")
    want = G._decode(dec, w, torch.from_numpy(ids).to(dev),
                     torch.from_numpy(mask).to(dev), 8, capture=False)
    assert torch.equal(got[0], want[0])


# -- GPT serving at head_dim 64 ------------------------------------------------------

def _tiny_gpt_pair(dev, dtype, experts=0, seed=5):
    """A tiny GPT (head_dim 64, which the ragged kernel takes; naive-gated
    MoE in every block with ``experts``) on the CPU in float32 and the
    same weights on the card in ``dtype``."""
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         load_numpy_state)
    cfg = GPTConfig.tiny(vocab_size=97, hidden_size=128, layers=2, heads=2,
                         seq=256, num_experts=experts, moe_every=1,
                         moe_gate="naive")
    cpu = GPTForCausalLM(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    gpu = GPTForCausalLM(cfg, device=dev)
    load_numpy_state(gpu, {n: p.detach().numpy()
                           for n, p in cpu.named_parameters()})
    return cpu, gpu.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("experts", [0, 4])
def test_gpt_engine_on_card(dev, dtype, experts):
    """GPT and GPT-MoE served at head_dim 64 through the ragged kernel:
    the captured step equals the eager one bit for bit; in float32 the
    tokens equal the CPU engine's; no attention call is routed."""
    from paddle_tpu_torch.serving import EngineConfig, ServingEngine
    cpu, gpu = _tiny_gpt_pair(dev, dtype, experts)
    ecfg = dict(max_seqs=3, token_budget=24, block_size=16)
    K.reset_launches()
    graph, eager = (ServingEngine(gpu, EngineConfig(**ecfg))
                    for _ in range(2))
    eager._step = eager._step_eager
    # a replay: one ragged attention a layer, and the LayerNorms (two a
    # layer and the final one) through the LayerNorm kernel
    assert graph._tally == {"ragged_attention": 2, "dropout_add_ln": 5}
    reqs = [[e.submit(p, max_new_tokens=6) for p in _serve_prompts(2)]
            for e in (graph, eager)]
    more = True
    while more:
        more = graph.step()
        eager.step()
        assert torch.equal(graph._logits, eager._logits)
    got = [r.result(0) for r in reqs[0]]
    assert got == [r.result(0) for r in reqs[1]]
    assert K.LAUNCHES["ragged_plain"] == 0
    if dtype == torch.float32:
        want = ServingEngine(cpu, EngineConfig(**ecfg), device="cpu") \
            .generate_batch(_serve_prompts(2), max_new_tokens=6)
        assert got == want


# -- speculative decoding: verify and roll back on the card --------------------------

@pytest.mark.parametrize("method", ["ngram", "draft_model"])
def test_spec_engine_on_card_matches_plain_decode(dev, method):
    """float32: the captured engine with speculation gives the tokens of
    the captured engine without it (and of the CPU engine); drafts were
    fed and rejected ones rolled back."""
    from paddle_tpu_torch.serving import EngineConfig, ServingEngine
    cpu, gpu = _tiny_llama_pair(dev, torch.float32, kv_heads=2)
    rng = np.random.default_rng(6)
    pattern = rng.integers(1, 97, (6,)).tolist()
    prompts = [(pattern * 5)[:n] for n in (20, 27, 13)] + _serve_prompts(3)
    ecfg = dict(max_seqs=3, token_budget=32, block_size=16)
    want = ServingEngine(gpu, EngineConfig(**ecfg)) \
        .generate_batch(prompts, max_new_tokens=12)
    spec = ServingEngine(gpu, EngineConfig(
        spec_method=method, num_draft_tokens=3, draft_model=gpu,
        spec_options={"context_width": 16} if method == "draft_model"
        else None, **ecfg))
    assert spec.generate_batch(prompts, max_new_tokens=12) == want
    assert spec.spec_proposed > 0 and spec.spec_rollback_pages >= 0
    assert spec.pool.used_blocks() == 0
    ref = ServingEngine(cpu, EngineConfig(**ecfg), device="cpu") \
        .generate_batch(prompts, max_new_tokens=12)
    assert want == ref


def test_spec_rollback_copies_a_shared_page_on_card(dev):
    """A rollback whose boundary page another holder shares: the engine's
    page copy gives the sequence a private copy of it (every layer, K and
    V) and leaves the shared page as it was."""
    from paddle_tpu_torch.serving import EngineConfig, ServingEngine
    _, gpu = _tiny_llama_pair(dev, torch.bfloat16)
    eng = ServingEngine(gpu, EngineConfig(max_seqs=2, token_budget=16,
                                          block_size=16))
    eng._kp.normal_()
    eng._vp.normal_()
    pages = eng.pool.allocate(2)
    eng.pool.incref([pages[1]])                   # a second holder
    k_before = eng._kp[:, pages[1]].clone()
    v_before = eng._vp[:, pages[1]].clone()
    kept, released, cow = eng.pool.truncate(list(pages), 20)
    assert released == 0 and cow == (pages[1], kept[1])
    eng._copy_page(*cow)
    torch.cuda.synchronize()
    assert torch.equal(eng._kp[:, cow[1]], k_before)
    assert torch.equal(eng._vp[:, cow[1]], v_before)
    assert torch.equal(eng._kp[:, pages[1]], k_before)
    assert torch.equal(eng._vp[:, pages[1]], v_before)


# -- the kernels as torch.library ops, the artifact, beams, routing ------------
#
# Tolerances as above: each op on CUDA tensors (the kernel) against the
# same op on CPU tensors (the plain version) from the same inputs.

def test_library_ops_launch_their_kernels(dev):
    """Each op on CUDA tensors launches its kernel (and counts it), on CPU
    tensors runs the plain version (and counts nothing); the two agree."""
    from paddle_tpu_torch.kernels import flash_attention as FA
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 256, generator=g).bfloat16()
    r = torch.randn(6, 256, generator=g).bfloat16()
    w = torch.rand(256, generator=g).bfloat16() + 0.5
    q = torch.randn(2, 9, 4, 64, generator=g).bfloat16()
    k = torch.randn(2, 9, 2, 64, generator=g).bfloat16()
    cos = torch.rand(9, 32, generator=g)
    sin = torch.rand(9, 32, generator=g)
    fq = torch.randn(1, 2, 100, 64, generator=g).bfloat16()
    fk = torch.randn(1, 2, 100, 64, generator=g).bfloat16()
    fv = torch.randn(1, 2, 100, 64, generator=g).bfloat16()
    cases = {
        "rms_norm": (fused.rms_norm_op, (x, w, 1e-6)),
        "rms_norm_residual": (fused.add_rms_norm_op, (x, r, w, 1e-6)),
        "rope": (fused.rope_op, (q, k, cos, sin)),
        "flash_fwd": (FA.flash_fwd_op,
                      (fq, fk, fv, True, None, None, None, False, None,
                       None)),
    }
    for name, (op, args) in cases.items():
        before = dict(K.LAUNCHES)
        want = op(*args)
        assert K.LAUNCHES == before
        got = op(*[a.to(dev) if isinstance(a, torch.Tensor) else a
                   for a in args])
        torch.cuda.synchronize()
        assert K.LAUNCHES[name] == before[name] + 1, name
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for gt, wt in zip(got, want):
            if name == "flash_fwd" and gt.dtype == torch.bfloat16:
                _assert_rows_close(gt.cpu(), wt, 2)
            else:
                assert float((gt.cpu().float() - wt.float()).abs().max()) \
                    <= _tol(wt, wt.dtype), name


def test_flash_op_refuses_what_the_kernel_does_not_take(dev):
    from paddle_tpu_torch.kernels import flash_attention as FA
    q = torch.zeros(1, 2, 8, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_fwd_op(q, q, q, False, None, None, None, False, None, None)


@pytest.mark.parametrize("case", ["causal_q_longer", "causal_q_shorter",
                                  "d32"])
def test_flashmask_routed_to_the_plain_path_on_card(dev, case):
    """FlashMask calls the kernels do not take run the plain versions on
    the card, counted in sdpa_plain, equal to the CPU's within the
    tolerances above; the rows that see a key only (a row without one is
    0 on both)."""
    from paddle_tpu_torch.nn import functional as F
    sq, sk, d = {"causal_q_longer": (24, 16, 64),
                 "causal_q_shorter": (16, 24, 64),
                 "d32": (20, 20, 32)}[case]
    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, sq, 4, d, generator=g)
    k = torch.randn(2, sk, 2, d, generator=g)
    v = torch.randn(2, sk, 2, d, generator=g)
    se = torch.randint(sq // 2, sq + 1, (2, 1, sk, 1), generator=g,
                       dtype=torch.int32)
    want = F.flashmask_attention(q, k, v, se, causal=True)
    before = dict(K.LAUNCHES)
    got = F.flashmask_attention(q.to(dev), k.to(dev), v.to(dev), se.to(dev),
                                causal=True)
    torch.cuda.synchronize()
    assert K.LAUNCHES["sdpa_plain"] == before["sdpa_plain"] + 1
    assert K.kernel_launches() == {n: c for n, c in before.items()
                                   if n not in K.ROUTED}
    assert float((got.cpu() - want).abs().max()) <= _tol(want,
                                                         torch.float32)


def test_dense_attention_reads_the_bf16_cache_in_place(dev):
    """generate()'s attention over a bf16 heads-major cache on the card
    (fp32-output bmms for the scores and for P.V, P as a bf16 head and
    tail) against the fp32 form on the CPU (K and V copied to fp32, P
    unrounded, the JAX function's arithmetic), within one bf16 ulp of the
    tensor's largest value."""
    from paddle_tpu_torch import generation as G
    g = torch.Generator().manual_seed(2)
    q = torch.randn(3, 1, 8, 64, generator=g).bfloat16()
    kc = torch.randn(3, 2, 40, 64, generator=g).bfloat16()
    vc = torch.randn(3, 2, 40, 64, generator=g).bfloat16()
    mask = torch.rand(3, 1, 1, 40, generator=g) > 0.3
    want = G._attend_gqa(q.float(), kc.float(), vc.float(), mask, 4) \
        .bfloat16()
    got = G._attend_gqa(q.to(dev), kc.to(dev), vc.to(dev), mask.to(dev), 4)
    err = float((got.cpu().float() - want.float()).abs().max())
    assert err <= _tol(want, torch.bfloat16), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_captured_beams_match_eager(dev, dtype):
    """generate(num_beams=3)'s captured beam loop against the same loop
    run op by op on the card: equal tokens and finished flags; float32
    also equal to the CPU's beams."""
    from paddle_tpu_torch import generation as G
    cpu, gpu = _tiny_llama_pair(dev, dtype, kv_heads=2)
    ids, mask = _left_padded(3, 20, seed=5)
    kw = dict(max_new_tokens=8, num_beams=3, eos_token_id=11,
              length_penalty=0.8)
    got = G.generate(gpu, ids, attention_mask=mask, **kw)
    dec = G._decoder_for(gpu)
    want = G._decode(dec, dec.weights(gpu), torch.from_numpy(ids).to(dev),
                     torch.from_numpy(mask).to(dev), 8, eos_token_id=11,
                     num_beams=3, length_penalty=0.8, capture=False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if dtype == torch.float32:
        ref = G.generate(cpu, ids, attention_mask=mask, device="cpu", **kw)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_artifact_runs_the_kernels_on_card(dev, tmp_path):
    """A bf16 tiny Llama saved on the card and loaded there: its logits
    equal the live forward's bit for bit, and the program launches the
    RMSNorm, RoPE and flash kernels (no call routed to a plain path). The
    float32 artifact saved on the CPU, loaded on the card, launches them
    too and agrees with the CPU's logits within 2e-5."""
    from paddle_tpu_torch import jit
    cpu, gpu = _tiny_llama_pair(dev, torch.bfloat16)
    ids = torch.from_numpy(_left_padded(2, 24, seed=6)[0])
    spec = [jit.InputSpec([None, None], "int64")]
    jit.save(gpu, str(tmp_path / "gpu"), input_spec=spec)
    jit.save(cpu, str(tmp_path / "cpu"), input_spec=spec)
    for tag in ("gpu", "cpu"):
        layer = jit.load(str(tmp_path / tag))
        K.reset_launches()
        got = layer(ids)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        assert launches["flash_fwd"] > 0 and launches["rms_norm"] > 0 \
            and launches["rope"] > 0 and launches["sdpa_plain"] == 0, launches
        with torch.no_grad():
            if tag == "gpu":
                assert torch.equal(got, gpu(ids.to(dev)))
            else:
                want = cpu(ids)
                assert float((got.cpu() - want).abs().max()) \
                    <= _tol(want, torch.float32)


def test_batching_server_delegates_to_the_engine_on_card(dev):
    """Requests submitted to a BatchingServer over an EnginePredictor from
    4 threads: the worker thread drives the engine's captured step, and
    every request gets generate_batch's tokens."""
    import threading
    from paddle_tpu_torch.inference import (BatchingServer,
                                            create_llm_predictor)
    from paddle_tpu_torch.serving import EngineConfig, ServingEngine
    _, gpu = _tiny_llama_pair(dev, torch.bfloat16)
    prompts = _serve_prompts(1) + _serve_prompts(2)
    want = ServingEngine(gpu, EngineConfig()) \
        .generate_batch(prompts, max_new_tokens=6)
    pred = create_llm_predictor(gpu, max_new_tokens=6)
    server = BatchingServer(pred)
    got = [None] * len(prompts)

    def client(i):
        for j in range(i, len(prompts), 4):
            got[j] = server.submit([np.asarray(prompts[j])])
    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    try:
        outs = [f.result(timeout=120)[0].tolist() for f in got]
    finally:
        server.close()
    assert outs == want


# -- the captured training step and the fused passes ---------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4096, 2048), (3, 5, 130), (7, 64)])
def test_rms_norm_backward_matches_plain(dev, dtype, shape):
    """The backward kernels against the autograd of the fp32 formula: dx
    each row within one ulp of its largest value in bf16 (2e-5 in fp32);
    dw, a sum over every row in fp32 before one rounding, within one ulp
    of its largest value in bf16 (2e-5 relative in fp32; the partials
    are summed in another order); two calls give the same bits (the
    partials are summed in a fixed order, without atomics)."""
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(*shape, device=dev, generator=g).to(dtype)
    w = (1 + 0.1 * torch.randn(shape[-1], device=dev, generator=g)).to(dtype)
    dy = torch.randn(*shape, device=dev, generator=g).to(dtype)
    want = fused.rms_norm_backward_plain(x, w, dy, 1e-6)
    before = K.LAUNCHES["rms_norm_bwd"]
    got = fused.rms_norm_backward(x, w, dy, 1e-6)
    again = fused.rms_norm_backward(x, w, dy, 1e-6)
    torch.cuda.synchronize()
    assert K.LAUNCHES["rms_norm_bwd"] == before + 2
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    if dtype == torch.float32:
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) <= _tol(b, dtype)
    else:
        _assert_rows_close(got[0], want[0], 1)
        assert float((got[1].float() - want[1].float()).abs().max()) \
            <= _tol(want[1], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2048, 5632), (3, 7, 33)])
def test_swiglu_matches_plain(dev, dtype, shape):
    """silu(gate) * up and its backward against PyTorch's ops: the kernel
    computes silu with Triton's exp, so its fp32 values differ from
    PyTorch's in the last bits and a bf16 result may round the other way:
    y and dup each row within one ulp of its largest value, dgate within
    two (silu's backward cancels near gate = -1.28); fp32 2e-5."""
    g = torch.Generator(device=dev).manual_seed(12)
    gate = (3 * torch.randn(*shape, device=dev, generator=g)).to(dtype)
    up = torch.randn(*shape, device=dev, generator=g).to(dtype)
    dy = torch.randn(*shape, device=dev, generator=g).to(dtype)
    before = (K.LAUNCHES["swiglu_fwd"], K.LAUNCHES["swiglu_bwd"])
    a, b = gate.clone().requires_grad_(), up.clone().requires_grad_()
    y = fused.swiglu(a, b)
    y.backward(dy)
    torch.cuda.synchronize()
    assert (K.LAUNCHES["swiglu_fwd"], K.LAUNCHES["swiglu_bwd"]) == \
        (before[0] + 1, before[1] + 1)
    want_y = fused.swiglu_plain(gate, up)
    want_dg, want_du = fused.swiglu_backward_plain(gate, up, dy)
    if dtype == torch.float32:
        for got, want in ((y, want_y), (a.grad, want_dg), (b.grad, want_du)):
            assert float((got - want).abs().max()) <= _tol(want, dtype)
    else:
        _assert_rows_close(y.detach(), want_y, 1)
        _assert_rows_close(b.grad, want_du, 1)
        _assert_rows_close(a.grad, want_dg, 2)


def test_adamw_reads_rate_and_step_from_the_device(dev):
    """One launch captured in a CUDA graph, replayed after the rate and
    step tensors were rewritten: each replay equals ``adamw_plain`` at
    the new values bit for bit."""
    from paddle_tpu_torch.kernels.optimizer import (adamw_plain,
                                                    multi_tensor_adamw)
    g = torch.Generator(device=dev).manual_seed(13)
    p = torch.randn(70000, device=dev, generator=g).to(torch.bfloat16)
    grad = torch.randn(70000, device=dev, generator=g).to(torch.bfloat16)
    m = torch.zeros(70000, device=dev)
    v = torch.zeros(70000, device=dev)
    lr = torch.zeros((), device=dev)
    step = torch.zeros((), device=dev)
    hp = dict(beta1=0.9, beta2=0.95, eps=1e-8, wds=[0.1], lr_mults=[0.5])
    lr.fill_(1e-3)
    step.fill_(1.0)
    kept = multi_tensor_adamw([p], [grad], [m], [v], lr=lr, step=step, **hp)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kept = multi_tensor_adamw([p], [grad], [m], [v], lr=lr, step=step,
                                  **hp)
    assert len(kept) == 2                         # the scalars and a table
    for rate, n in ((3e-4, 2.0), (5e-5, 3.0)):
        want = adamw_plain(p, grad, m, v, rate, 0.9, 0.95, 1e-8, 0.1, n,
                           True, 0.5)
        lr.fill_(rate)
        step.fill_(n)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(p, want[0]) and torch.equal(m, want[1]) \
            and torch.equal(v, want[2])


def _tiny_train_pair(dev, kind, seed=7):
    """Two identical tiny bf16 models on the card with their trainers
    (AdamW at warmup then cosine, clipping; Llama: full remat, the
    chunked loss): (model, trainer, scheduler) twice."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         LlamaConfig, LlamaForCausalLM)
    from paddle_tpu_torch.parallel import SpmdTrainer
    out = []
    for _ in range(2):
        gen = torch.Generator(device=dev).manual_seed(seed)
        if kind == "llama":
            model = LlamaForCausalLM(LlamaConfig.tiny(
                vocab_size=97, hidden_size=128, layers=2, heads=2,
                kv_heads=1, seq=64), device=dev, generator=gen)
            loss = lambda m, i, l: m.forward_loss(i, l, loss_chunk_size=16)
            layers = list(model.model.layers)
        else:
            model = GPTForCausalLM(GPTConfig.tiny(
                vocab_size=97, hidden_size=128, layers=2, heads=2, seq=64,
                num_experts=4, moe_every=2), device=dev, generator=gen)
            for block in model.transformer.h:
                if block.is_moe:
                    block.mlp.dropless = True
            loss = lambda m, i, l: m.compute_loss(m(i), l)
            layers = None
        model.bfloat16()
        sched = O.lr.LinearWarmup(O.lr.CosineAnnealingDecay(1e-3, T_max=6),
                                  2, 0.0, 1e-3)
        opt = O.AdamW(learning_rate=sched, parameters=model.parameters(),
                      weight_decay=0.01, grad_clip=O.ClipGradByGlobalNorm(1))
        out += [model, SpmdTrainer(model, opt, loss, remat_layers=layers),
                sched]
    return out


def _train_ids(dev, shape=(4, 64), seed=8):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 97, shape)).to(dev)


@pytest.mark.parametrize("kind", ["llama", "gpt_moe"])
def test_captured_train_step_equals_eager(dev, kind):
    """The same 4 steps captured (``train_step``: the first eager on a side
    stream, then replays) and op by op (``_step_eager``): every loss,
    parameter and moment bit-equal, under a rate that changes every step
    (0 at the first: the parameters stay, so the rate reached the
    update); one graph, whose replays count one step's launches each."""
    m1, t1, s1, m2, t2, s2 = _tiny_train_pair(dev, kind)
    ids = _train_ids(dev)
    first = [p.detach().clone() for p in m1.parameters()]
    for i in range(4):
        K.reset_launches()
        a = t1.train_step(ids, ids)
        cap = dict(K.LAUNCHES)
        K.reset_launches()
        b = t2._step_eager(ids, ids)
        assert cap == dict(K.LAUNCHES), (i, cap, dict(K.LAUNCHES))
        assert torch.equal(a, b), (i, float(a), float(b))
        assert float(t1._lr) == float(np.float32(s1()))
        if i == 0:
            assert all(torch.equal(p, q) for p, q in zip(m1.parameters(),
                                                         first))
        s1.step()
        s2.step()
    torch.cuda.synchronize()
    assert len(t1._graphs) == 1 and not t2._graphs
    for p, q in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(p, q)
        sa, sb = t1.opt._state_of(p), t2.opt._state_of(q)
        assert torch.equal(sa["moment1"], sb["moment1"]) \
            and torch.equal(sa["moment2"], sb["moment2"])
    assert not any(torch.equal(p, q) for p, q in zip(m1.parameters(), first)
                   if p.dim() > 1)


def test_a_second_batch_signature_makes_a_second_graph(dev):
    """Two batch shapes, alternated: a graph each, each replay equal to the
    eager step on the same shape."""
    m1, t1, _, m2, t2, _ = _tiny_train_pair(dev, "llama")
    batches = [_train_ids(dev, (4, 64)), _train_ids(dev, (2, 32), 9)]
    for i in range(5):
        ids = batches[i % 2]
        assert torch.equal(t1.train_step(ids, ids), t2._step_eager(ids, ids))
    assert len(t1._graphs) == 2 and len(t1._staged) == 2
    assert all(c.pool_bytes >= 0 and c.tally["rms_norm_bwd"] > 0
               for c in t1._graphs.values())
    for p, q in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(p, q)


def test_resume_into_a_captured_trainer(dev):
    """State loaded (in place) into an optimizer whose trainer already
    captured its step: the next replays continue from the loaded state,
    as an eager trainer loaded from the same state does."""
    m1, t1, _, m2, t2, _ = _tiny_train_pair(dev, "llama")
    ids = _train_ids(dev)
    for _ in range(3):
        t1.train_step(ids, ids)
        t2._step_eager(ids, ids)
    saved = t2.opt.state_dict()
    weights = {n: p.detach().clone() for n, p in m2.named_parameters()}
    t2._step_eager(ids, ids)            # move on, then go back
    with torch.no_grad():
        for n, p in m1.named_parameters():
            p.copy_(weights[n])
        for n, p in m2.named_parameters():
            p.copy_(weights[n])
    t1.opt.set_state_dict(saved)
    t2.opt.set_state_dict(saved)
    for _ in range(2):
        assert torch.equal(t1.train_step(ids, ids), t2._step_eager(ids, ids))
    for p, q in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(p, q)


def test_a_second_signature_shares_the_first_ones_pool(dev):
    """A trainer captures every signature into one memory pool: a second,
    smaller signature adds at most a quarter of what the first capture
    added (a trainer of its own for that signature needs a pool of its
    own), and alternating replays still equal the eager steps."""
    m1, t1, _, m2, t2, _ = _tiny_train_pair(dev, "llama")
    big, small = _train_ids(dev, (16, 64)), _train_ids(dev, (8, 64), 9)
    for ids in (big, small, big, small):
        assert torch.equal(t1.train_step(ids, ids), t2._step_eager(ids, ids))
    first, second = (t1._graphs[((tuple(b.shape), b.dtype),) * 2]
                     for b in (big, small))
    _, alone, _, _, _, _ = _tiny_train_pair(dev, "llama")
    alone.train_step(small, small)
    alone.train_step(small, small)
    own = next(iter(alone._graphs.values())).pool_bytes
    print(f"pool bytes: first {first.pool_bytes}, second {second.pool_bytes},"
          f" the second signature alone {own}")
    assert first.pool_bytes > 0 and own > 0
    assert second.pool_bytes <= first.pool_bytes // 4
    for p, q in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(p, q)


def test_resume_into_a_fresh_trainer_that_captures(dev):
    """The usual resume: the model's, optimizer's and scheduler's state
    after 3 captured steps, loaded into a fresh model (other weights),
    optimizer, scheduler and trainer, whose first call runs eagerly and
    captures: its 2 steps equal the uninterrupted run's bit for bit
    (losses, parameters, moments), with one step's launches each."""
    m1, t1, s1, _, _, _ = _tiny_train_pair(dev, "llama")
    m3, t3, s3, _, _, _ = _tiny_train_pair(dev, "llama", seed=99)
    ids = _train_ids(dev)
    for _ in range(3):
        t1.train_step(ids, ids)
        s1.step()
    weights = {k: v.detach().clone() for k, v in m1.state_dict().items()}
    saved, sched = t1.opt.state_dict(), s1.state_dict()
    K.reset_launches()
    want, rates = [], []
    for _ in range(2):
        want.append(t1.train_step(ids, ids))
        rates.append(float(t1._lr))
        s1.step()
    per_step = {k: v // 2 for k, v in K.LAUNCHES.items()}
    m3.load_state_dict(weights)
    t3.opt.set_state_dict(saved)
    s3.set_state_dict(sched)
    for i in range(2):
        K.reset_launches()
        assert torch.equal(t3.train_step(ids, ids), want[i])
        assert dict(K.LAUNCHES) == per_step and float(t3._lr) == rates[i]
        s3.step()
    assert len(t3._graphs) == 1
    for p, q in zip(m1.parameters(), m3.parameters()):
        assert torch.equal(p, q)
        sa, sb = t1.opt._state_of(p), t3.opt._state_of(q)
        assert torch.equal(sa["moment1"], sb["moment1"]) \
            and torch.equal(sa["moment2"], sb["moment2"])


def test_swiglu_kernels_run_under_operator_stats(dev):
    """With operator-stats collection on, ``F.swiglu`` still launches its
    forward and backward kernels (and counts "silu" and "multiply"), with
    the same values as without it."""
    from paddle_tpu_torch.amp import debugging
    from paddle_tpu_torch.nn import functional as F
    g = torch.Generator(device=dev).manual_seed(15)
    gate = torch.randn(64, 256, device=dev, generator=g)
    up = torch.randn(64, 256, device=dev, generator=g)
    out = []
    for stats in (False, True):
        a, b = gate.clone().requires_grad_(), up.clone().requires_grad_()
        before = (K.LAUNCHES["swiglu_fwd"], K.LAUNCHES["swiglu_bwd"])
        if stats:
            debugging.enable_operator_stats_collection()
        try:
            y = F.swiglu(a, b)
        finally:
            counted = (debugging.disable_operator_stats_collection()
                       if stats else None)
        y.backward(torch.ones_like(y))
        torch.cuda.synchronize()
        assert (K.LAUNCHES["swiglu_fwd"], K.LAUNCHES["swiglu_bwd"]) == \
            (before[0] + 1, before[1] + 1)
        out.append((y.detach(), a.grad, b.grad))
    assert counted == {"silu(float32)": 1, "multiply(float32)": 1}
    assert all(torch.equal(x, z) for x, z in zip(*out))


@pytest.mark.parametrize("dtypes", [(torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.float32)],
                         ids=["f32-bf16", "bf16-f32"])
def test_swiglu_mixed_dtypes_match_the_two_ops(dev, dtypes):
    """Gate and up in two dtypes: the kernels give what ``silu(gate) *
    up`` gives (silu rounded to gate's dtype, the product in float32,
    each gradient in its input's dtype), also through ``F.swiglu`` under
    auto_cast O1, which leaves a float32 gate and a bf16 up as they are.
    Float32 results within 2e-5 of the largest value; bf16 ones each row
    within one ulp of its largest value, and where silu is rounded to bf16
    (a bf16 gate) two: Triton's exp may round it the other way."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import functional as F
    gd, ud = dtypes
    g = torch.Generator(device=dev).manual_seed(16)
    gate = (3 * torch.randn(96, 512, device=dev, generator=g)).to(gd)
    up = torch.randn(96, 512, device=dev, generator=g).to(ud)
    dy = torch.randn(96, 512, device=dev, generator=g)
    want = (fused.swiglu_plain(gate, up),
            *fused.swiglu_backward_plain(gate, up, dy))
    for route in ("fused", "auto_cast"):
        a, b = gate.clone().requires_grad_(), up.clone().requires_grad_()
        before = (K.LAUNCHES["swiglu_fwd"], K.LAUNCHES["swiglu_bwd"])
        if route == "fused":
            y = fused.swiglu(a, b)
        else:
            with amp.auto_cast(level="O1"):
                y = F.swiglu(a, b)
        y.backward(dy)
        torch.cuda.synchronize()
        assert (K.LAUNCHES["swiglu_fwd"], K.LAUNCHES["swiglu_bwd"]) == \
            (before[0] + 1, before[1] + 1)
        got = (y.detach(), a.grad, b.grad)
        assert [t.dtype for t in got] == [torch.float32, gd, ud]
        for x, ref in zip(got, want):
            if x.dtype == gd == torch.float32:
                assert float((x - ref).abs().max()) <= _tol(ref, x.dtype)
            else:
                _assert_rows_close(x, ref, 1 if gd == torch.float32 else 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_bias_gradient_sums_in_a_fixed_order(dev, dtype):
    """The MoE expert biases' gradient through tgmm: each group's rows
    summed in fp32, within 1e-5 of the largest value of an ``index_add_``
    in float64 (the exact sum, near enough), the padding rows left out,
    and the same bits on a second call (no atomics)."""
    from paddle_tpu_torch.kernels.gmm import ExpertBias
    g = torch.Generator(device=dev).manual_seed(14)
    sizes = torch.tensor([2048, 0, 1500, 2596, 2048, 2048, 3000, 3144],
                         dtype=torch.int32, device=dev)
    rows = int(sizes.sum()) + 96                    # 96 padding rows
    es = torch.repeat_interleave(torch.arange(8, device=dev),
                                 sizes.long())
    es = torch.cat([es, es.new_zeros(96)])
    b = torch.randn(8, 3072, device=dev, generator=g)
    dy = torch.randn(rows, 3072, device=dev, generator=g).to(dtype)
    dy[-96:] = 0          # as the FFN's padding rows' gradient always is
    out = []
    for _ in range(2):
        bb = b.clone().requires_grad_()
        y = ExpertBias.apply(bb, es, sizes, dtype)
        assert y.dtype == dtype and torch.equal(y.float(), b[es].to(dtype)
                                                .float())
        y.backward(dy)
        out.append(bb.grad)
    torch.cuda.synchronize()
    want = torch.zeros(8, 3072, dtype=torch.float64, device=dev) \
        .index_add_(0, es, dy.double())
    assert torch.equal(out[0], out[1])
    assert float((out[0].double() - want).abs().max()) \
        <= 1e-5 * float(want.abs().max())
    assert not out[0][1].any()                       # the empty group


# -- dropout and the fused LayerNorm ------------------------------------------------

def _rk(base, site):
    from paddle_tpu_torch.framework.random import RandomKey
    return RandomKey(base, site)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape,p", [((16384, 768), 0.1), ((3, 5, 7), 0.5),
                                     ((2, 4, 64, 64), 0.9)])
@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_kernel_matches_plain(dev, dtype, shape, p, mode):
    """The kernel's output and its backward (the same kernel on the
    gradient) equal the plain version bit for bit, from a host key and
    from a key tensor on the card; the keep fraction is within 5 sigma."""
    from paddle_tpu_torch.kernels import dropout as D
    g = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn(*shape, device=dev, generator=g).to(dtype)
    key = _rk((12345, 678), 3)
    want = D.dropout_plain(x, p, key, mode)
    before = K.LAUNCHES["dropout"]
    xx = x.clone().requires_grad_()
    y = D.dropout(xx, key, p, mode)
    y.backward(x)
    tkey = _rk(torch.tensor([12345, 678], device=dev), 3)
    again = D.dropout(x, tkey, p, mode)
    torch.cuda.synchronize()
    assert K.LAUNCHES["dropout"] == before + 3
    assert torch.equal(y, want) and torch.equal(again, want)
    assert torch.equal(xx.grad, want)
    n = x.numel()
    if n > 10000:
        frac = float(D.keep_mask_plain(shape, p, key, dev).float().mean())
        assert abs(frac - (1 - p)) <= 5 * (p * (1 - p) / n) ** 0.5


def test_dropout_axis_on_card(dev):
    from paddle_tpu_torch.kernels import dropout as D
    x = torch.randn(4, 6, 8, device=dev)
    key = _rk((1, 2), 7)
    got = D.dropout(x, key, 0.5, mask_shape=(1, 6, 1))
    assert torch.equal(got, D.dropout_plain(x, 0.5, key,
                                            mask_shape=(1, 6, 1)))


def test_dropout_replays_with_each_steps_key(dev):
    """``F.dropout`` under a key context over a key tensor, captured once:
    a replay after the tensor was rewritten gives the eager call's bits
    for the new key."""
    from paddle_tpu_torch.framework import random as R
    from paddle_tpu_torch.kernels import dropout as D
    from paddle_tpu_torch.nn import functional as F
    x = torch.randn(1000, 77, device=dev)
    keyt = torch.tensor([5, 6], device=dev)
    with R.key_context(keyt):
        F.dropout(x, 0.2)           # compiles the kernel
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph), R.key_context(keyt):
        out = F.dropout(x, 0.2)
    for words in ((5, 6), (2 ** 32 - 1, 9), (77, 0)):
        keyt.copy_(torch.tensor(words))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, D.dropout_plain(x, 0.2, _rk(words, 1)))


def _dln_inputs(dev, dtype, shape, seed=22):
    g = torch.Generator(device=dev).manual_seed(seed)
    n = shape[-1]
    x = torch.randn(*shape, device=dev, generator=g).to(dtype)
    r = torch.randn(*shape, device=dev, generator=g).to(dtype)
    b = (0.1 * torch.randn(n, device=dev, generator=g)).to(dtype)
    w = (1 + 0.1 * torch.randn(n, device=dev, generator=g)).to(dtype)
    nb = (0.1 * torch.randn(n, device=dev, generator=g)).to(dtype)
    dy = torch.randn(*shape, device=dev, generator=g).to(dtype)
    return x, r, b, w, nb, dy


def _close(got, want, dtype):
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= _tol(want, dtype)
    elif want.dim() > 1:
        _assert_rows_close(got, want, 1)
    else:
        assert float((got.float() - want.float()).abs().max()) \
            <= 2.0 ** -7 * float(want.float().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16384, 768), (3, 5, 130), (7, 64)])
@pytest.mark.parametrize("p,parts", [(0.1, "residual_bias"),
                                     (0.0, "residual_bias"),
                                     (0.0, "plain_ln")])
def test_dropout_add_layer_norm_matches_plain(dev, dtype, shape, p, parts):
    """Kernel 2 forward and backward: the normalised sum h bit-equal to
    the ops one by one (the dropout kernel's mask: the same key, the same
    bits), y and every gradient within the tolerance of the plain ops'
    autograd; two calls give the same bits."""
    from paddle_tpu_torch.kernels import dropout as D
    x, r, b, w, nb, dy = _dln_inputs(dev, dtype, shape)
    if parts == "plain_ln":
        r = b = None
    key = _rk((99, 1), 4) if p else None
    y, h = fused.dropout_add_layer_norm_forward(x, w, nb, 1e-5, r, b, p,
                                                key)
    y2, h2 = fused.dropout_add_layer_norm_forward(x, w, nb, 1e-5, r, b, p,
                                                  key)
    dropped = (x + b) if b is not None else x
    if p:
        dropped = D.dropout(dropped, key, p)
    want_h = dropped + r if r is not None else dropped
    assert torch.equal(h, want_h) and torch.equal(y, y2) and \
        torch.equal(h, h2)
    leaves = [t.clone().requires_grad_() if t is not None else None
              for t in (x, r, b, w, nb)]
    lx, lr, lb, lw, lnb = leaves
    before = (K.LAUNCHES["dropout_add_ln"], K.LAUNCHES["dropout_add_ln_bwd"])
    out = fused.dropout_add_layer_norm(lx, lw, lnb, 1e-5, lr, lb, p, key)
    out.backward(dy)
    torch.cuda.synchronize()
    assert (K.LAUNCHES["dropout_add_ln"], K.LAUNCHES["dropout_add_ln_bwd"]) \
        == (before[0] + 1, before[1] + 1)
    plain = [t.clone().requires_grad_() if t is not None else None
             for t in (x, r, b, w, nb)]
    px, pr, pb, pw, pnb = plain
    want = fused.dropout_add_layer_norm_plain(px, pw, pnb, 1e-5, pr, pb, p,
                                              key)
    want.backward(dy)
    _close(out.detach(), want.detach(), dtype)
    for a, c in zip(leaves, plain):
        if a is not None:
            _close(a.grad, c.grad, dtype)


def test_layer_norm_functional_takes_the_kernel(dev):
    """``nn.functional.layer_norm`` on CUDA tensors launches kernel 2 (two
    trailing axes as one), within the tolerance of the plain formula."""
    from paddle_tpu_torch.nn import functional as F
    x = torch.randn(4, 6, 10, device=dev)
    w = 1 + 0.1 * torch.randn(6, 10, device=dev)
    before = K.LAUNCHES["dropout_add_ln"]
    got = F.layer_norm(x, [6, 10], w, None, 1e-5)
    assert K.LAUNCHES["dropout_add_ln"] == before + 1
    want = fused.layer_norm_plain(x, w, None, 1e-5, n_axes=2)
    assert float((got - want).abs().max()) <= _tol(want, torch.float32)


def _tiny_ernie(dev, seed=31, dropout=0.1):
    import dataclasses
    from paddle_tpu_torch.models import ErnieConfig, ErnieForPretraining
    cfg = dataclasses.replace(ErnieConfig.tiny(hidden_size=128, heads=2,
                                               seq=64),
                              hidden_dropout_prob=dropout,
                              attention_probs_dropout_prob=dropout)
    return ErnieForPretraining(cfg, device=dev,
                               generator=torch.Generator(device=dev)
                               .manual_seed(seed))


def _ernie_batch(seed=0, b=4, s=64, vocab=128):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s))
    tt = np.zeros((b, s), np.int64)
    tt[:, s // 2:] = 1
    labels = np.where(rng.random((b, s)) < 0.15, ids, -100)
    nsp = np.arange(b) % 2
    return tuple(torch.from_numpy(a) for a in (ids, tt, labels, nsp))


def _ernie_trainer(model):
    from paddle_tpu_torch.models import ernie_pretrain_step
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import SpmdTrainer
    keys = ("input_ids", "token_type_ids", "mlm_labels", "nsp_labels")
    return SpmdTrainer(model, AdamW(learning_rate=1e-3,
                                    parameters=model.parameters()),
                       lambda m, *a: ernie_pretrain_step(m, dict(zip(keys,
                                                                     a))))


def test_tiny_ernie_with_dropout_trains_on_card_as_on_cpu(dev):
    """A tiny float32 ERNIE at dropout 0.1 (head_dim 64), 3 steps captured
    on the card against the CPU trainer from the same seed: the masks are
    the same bits, losses 1e-5 relative, weights within 3 lr and within
    1e-5 for 99.9% of the elements."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import load_numpy_state
    cpu = _tiny_ernie("cpu")
    gpu = _tiny_ernie(dev)
    load_numpy_state(gpu, {n: p.detach().numpy()
                           for n, p in cpu.named_parameters()})
    batch = _ernie_batch()
    runs = []
    for model, b in ((cpu, batch), (gpu, tuple(t.to(dev) for t in batch))):
        ptt.seed(7)
        tr = _ernie_trainer(model)
        K.reset_launches()
        runs.append([float(tr.train_step(*b)) for _ in range(3)])
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-5)
    assert K.LAUNCHES["dropout"] > 0 and K.LAUNCHES["dropout_add_ln"] > 0
    assert K.LAUNCHES["sdpa_dense"] > 0 and K.LAUNCHES["flash_fwd"] == 0
    close = total = 0
    for (n, p), q in zip(cpu.named_parameters(), gpu.parameters()):
        d = (q.detach().cpu() - p.detach()).abs()
        assert float(d.max()) <= 3e-3, n
        close += int((d <= 1e-5).sum())
        total += d.numel()
    assert close >= 0.999 * total, (close, total)


def test_captured_ernie_step_with_dropout_equals_eager(dev):
    """The ERNIE step at dropout 0.1 captured and op by op from the same
    random state: losses, parameters and moments bit-equal over 3 steps;
    the replays draw new masks each step (the losses differ from a run
    whose key is held)."""
    from paddle_tpu_torch.framework import random as R
    m1 = _tiny_ernie(dev)
    m2 = _tiny_ernie(dev)
    m2.load_state_dict(m1.state_dict())
    t1, t2 = _ernie_trainer(m1), _ernie_trainer(m2)
    batch = tuple(t.to(dev) for t in _ernie_batch(1))
    R.seed(3)
    for _ in range(3):
        state = R.get_rng_state()
        a = t1.train_step(*batch)
        R.set_rng_state(state)
        b = t2._step_eager(*batch)
        assert torch.equal(a, b)
    assert len(t1._graphs) == 1
    for p, q in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(p, q)
        sa, sb = t1.opt._state_of(p), t2.opt._state_of(q)
        assert torch.equal(sa["moment1"], sb["moment1"])


def test_ernie_eval_takes_flash_and_a_mask_the_dense_route(dev):
    """ErnieForSequenceClassification in eval at head_dim 64: without a
    mask one flash forward a layer; with a padding mask the dense route
    (one ``sdpa_dense`` a layer) and no flash."""
    import dataclasses
    from paddle_tpu_torch.models import (ErnieConfig,
                                         ErnieForSequenceClassification)
    cfg = dataclasses.replace(ErnieConfig.tiny(hidden_size=128, heads=2,
                                               seq=64))
    model = ErnieForSequenceClassification(cfg, num_classes=3, device=dev)
    model.eval()
    ids, tt = (t.to(dev) for t in _ernie_batch(2)[:2])
    mask = torch.ones(4, 1, 1, 64, dtype=torch.bool, device=dev)
    mask[1, ..., 50:] = False
    with torch.no_grad():
        K.reset_launches()
        model(ids, tt)
        assert K.LAUNCHES["flash_fwd"] == 2 and K.LAUNCHES["sdpa_dense"] == 0
        K.reset_launches()
        model(ids, tt, mask)
        assert K.LAUNCHES["flash_fwd"] == 0 and K.LAUNCHES["sdpa_dense"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_table_gradient_is_the_same_bits_every_run(dev, dtype):
    """ERNIE's token-type table, whose 4 ids each take thousands of the
    step's 16384 rows: its gradient (one fp32 matmul with the ids' one-hot
    matrix) the same bits twice and from a graph replay, and within the
    tolerance of the fp32 scatter-add."""
    from paddle_tpu_torch.models.ernie import _SegmentEmbedding
    g = torch.Generator(device=dev).manual_seed(4)
    ids = torch.randint(0, 4, (32, 512), device=dev, generator=g)
    dy = torch.randn(32, 512, 256, device=dev, generator=g).to(dtype)
    table = _SegmentEmbedding(4, 256, device=dev, dtype=dtype)

    def grad():
        return torch.autograd.grad(table(ids), table.weight, dy)[0]
    got = grad()
    assert torch.equal(got, grad())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        grad()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cap = grad()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, cap)
    want = torch.zeros(4, 256, dtype=torch.float32, device=dev).index_add_(
        0, ids.reshape(-1), dy.reshape(-1, 256).float()).to(dtype)
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-4 * max(
            1.0, float(want.abs().max()))
    else:
        _assert_rows_close(got, want, 1)


def test_decoder_layer_norm_on_the_bf16_state_equals_the_fp32_form(dev):
    """The GPT decoders' LayerNorm (``generation._ln``: the kernel on the
    bf16 hidden state) bit-equal to the kernel run in fp32 and rounded
    after."""
    from paddle_tpu_torch import generation
    g = torch.Generator(device=dev).manual_seed(8)
    x = (4 * torch.randn(512, 768, device=dev, generator=g)).bfloat16()
    w = torch.randn(768, device=dev, generator=g).bfloat16()
    b = torch.randn(768, device=dev, generator=g).bfloat16()
    want = fused.dropout_add_layer_norm(x.float(), w.float(), b.float(),
                                        1e-5).to(x.dtype)
    assert torch.equal(generation._ln(x, w, b, 1e-5), want)


def _gn_inputs(dev, dtype, shape, seed=3, affine=True):
    g = torch.Generator(device=dev).manual_seed(seed)
    c = shape[1]
    x = (3 + 2 * torch.randn(*shape, device=dev, generator=g)).to(dtype)
    w = (1 + 0.2 * torch.randn(c, device=dev, generator=g)).to(dtype) \
        if affine else None
    b = (0.2 * torch.randn(c, device=dev, generator=g)).to(dtype) \
        if affine else None
    dy = torch.randn(*shape, device=dev, generator=g).to(dtype)
    return x, w, b, dy


def _gn_close(got, want, dtype, ulps, scale=0.0):
    """fp32: within 2e-5 of the largest of 1, the reference and ``scale``
    (dx's own: rstd * |dy * w|, whose rounding it carries where a group's
    variance is 0 and dx is 0 in exact arithmetic); bf16: ``ulps`` ulps
    of each row's largest value."""
    if dtype == torch.float32:
        tol = 2e-5 * max(1.0, float(want.abs().max()), scale)
        assert float((got - want).abs().max()) <= tol
    elif want.dim() > 1:
        _assert_rows_close(got, want, ulps)
    else:
        assert float((got.float() - want.float()).abs().max()) \
            <= ulps * 2.0 ** -7 * float(want.float().abs().max())


_GN_CASES = [((4, 320, 64, 64), 32, "NCHW"), ((2, 1280, 8, 8), 32, "NCHW"),
             ((3, 12, 5, 7), 3, "NCHW"), ((2, 8, 1, 1), 8, "NCHW"),
             ((2, 6, 9), 1, "NCHW"), ((2, 96, 33, 17), 1, "NCHW"),
             ((2, 320, 32, 32), 32, "NHWC"), ((3, 12, 5, 7), 3, "NHWC"),
             ((2, 96, 33, 17), 1, "NHWC")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups,layout", _GN_CASES)
@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_matches_plain(dev, dtype, shape, groups, layout, silu):
    """The GroupNorm kernels, forward and backward, with and without the
    SiLU, channels first and last, against the plain formula's autograd:
    fp32 within 2e-5 of the largest value, bf16 each row within one ulp
    of its largest plain value (two with the SiLU: the rounded norm it
    reads may sit one ulp apart); two calls give the same bits."""
    from paddle_tpu_torch.kernels import group_norm as GN
    x, w, b, dy = _gn_inputs(dev, dtype, shape)
    last = layout == "NHWC"
    if last:
        x, dy = (t.permute(0, 2, 3, 1).contiguous() for t in (x, dy))
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    before = (K.LAUNCHES["group_norm"], K.LAUNCHES["group_norm_bwd"])
    out = GN.group_norm(leaves[0], groups, leaves[1], leaves[2], 1e-5, last,
                        silu)
    out.backward(dy)
    torch.cuda.synchronize()
    assert (K.LAUNCHES["group_norm"], K.LAUNCHES["group_norm_bwd"]) == \
        (before[0] + 1, before[1] + 1)
    again = [t.clone().requires_grad_() for t in (x, w, b)]
    out2 = GN.group_norm(again[0], groups, again[1], again[2], 1e-5, last,
                         silu)
    out2.backward(dy)
    assert torch.equal(out, out2)
    assert all(torch.equal(a.grad, c.grad) for a, c in zip(leaves, again))
    plain = [t.clone().requires_grad_() for t in (x, w, b)]
    want = GN.group_norm_plain(plain[0], groups, plain[1], plain[2], 1e-5,
                               last, silu)
    want.backward(dy)
    ulps = 2 if silu else 1
    _gn_close(out.detach(), want.detach(), dtype, ulps)
    xg = (x.movedim(-1, 1) if last else x).float().reshape(shape[0], groups,
                                                           -1)
    rstd = float((xg.var(-1, unbiased=False) + 1e-5).rsqrt().max())
    dx_scale = rstd * float((dy.float().abs().max() * w.float().abs().max()))
    for a, c, scale in zip(leaves, plain, (dx_scale, 0.0, 0.0)):
        _gn_close(a.grad, c.grad, dtype, 2, scale)


def test_group_norm_without_affine_and_out_dtype(dev):
    """No weight and no bias (ones and zeros stand in), and a bf16 input
    written in fp32 and an fp32 input written in bf16."""
    from paddle_tpu_torch.kernels import group_norm as GN
    x, _, _, _ = _gn_inputs(dev, torch.bfloat16, (2, 64, 16, 16),
                            affine=False)
    got = GN.group_norm(x, 8, out_dtype=torch.float32)
    want = GN.group_norm_plain(x, 8, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) <= _tol(want, torch.float32)
    got = GN.group_norm(x.float(), 8, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _assert_rows_close(got, want.bfloat16(), 1)


@pytest.mark.parametrize("shape", [(2, 320, 64, 64), (2, 1280, 8, 8)])
def test_group_norm_fused_silu_is_the_o2_composition(dev, shape):
    """Under ``amp.auto_cast(level="O2")`` with bf16 x and parameters, the
    fused call (``then="silu"``: the kernel reads bf16 and writes the bf16
    SiLU) against the separate ops (the black-listed norm in fp32, then
    the SiLU on its cast), all three forwards on the cluster kernel: the
    norm's output and the fused SiLU's bit-equal (the kernel's fp32 SiLU
    is PyTorch's), every gradient within one bf16 ulp of each value."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import functional as F
    x, w, b, dy = _gn_inputs(dev, torch.bfloat16, shape)
    fused_in = [t.clone().requires_grad_() for t in (x, w, b)]
    sep_in = [t.clone().requires_grad_() for t in (x, w, b)]
    before = K.LAUNCHES["group_norm_cluster"]
    with amp.auto_cast(level="O2"):
        y = F.group_norm(fused_in[0], 32, 1e-5, fused_in[1], fused_in[2],
                         then="silu")
        norm = F.group_norm(sep_in[0], 32, 1e-5, sep_in[1], sep_in[2])
        want = F.silu(norm)
        norm_cast = F.group_norm(x, 32, 1e-5, w, b, then="conv2d")
    assert K.LAUNCHES["group_norm_cluster"] - before == 3
    assert norm.dtype == torch.float32 and y.dtype == torch.bfloat16
    assert torch.equal(norm_cast, norm.to(torch.bfloat16))
    assert torch.equal(y, want)
    y.backward(dy)
    want.backward(dy)
    torch.cuda.synchronize()

    def within_one_ulp(a, c):
        a, c = a.float(), c.float()
        ulp = 2.0 ** -7 * c.abs().clamp(min=2.0 ** -126)
        assert bool(((a - c).abs() <= ulp).all())
    within_one_ulp(y, want)
    for a, c in zip(fused_in, sep_in):
        within_one_ulp(a.grad, c.grad)


def test_group_norm_replays_from_a_graph(dev):
    """Forward and backward captured in a CUDA graph: each replay after
    the input is rewritten equals an eager call bit for bit."""
    from paddle_tpu_torch.kernels import group_norm as GN
    x, w, b, dy = _gn_inputs(dev, torch.bfloat16, (2, 640, 32, 32))
    xs = x.clone().requires_grad_()

    def step():
        xs.grad = None
        y = GN.group_norm(xs, 32, w, b, 1e-5, silu=True)
        return y, torch.autograd.grad(y, xs, dy)[0]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_cap, dx_cap = step()
    for seed in (1, 2):
        with torch.no_grad():
            xs.copy_(_gn_inputs(dev, torch.bfloat16, (2, 640, 32, 32),
                                seed=seed)[0])
        graph.replay()
        y, dx = step()
        torch.cuda.synchronize()
        assert torch.equal(y_cap, y) and torch.equal(dx_cap, dx)


def test_pool_and_interpolate_backwards_are_deterministic(dev):
    """The ResNet stem's max pool (3 x 3, stride 2, padding 1) and the
    UNet's nearest upsampling: their backwards run under
    ``torch.use_deterministic_algorithms`` (PyTorch raises on an op it
    knows to be nondeterministic) and give the same bits twice."""
    from paddle_tpu_torch.nn import functional as F
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(8, 64, 56, 56, device=dev, generator=g)
    dy_pool = torch.randn(8, 64, 28, 28, device=dev, generator=g)
    dy_up = torch.randn(8, 64, 112, 112, device=dev, generator=g)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        grads = []
        for _ in range(2):
            xs = x.clone().requires_grad_()
            a = torch.autograd.grad(F.max_pool2d(xs, 3, 2, 1), xs,
                                    dy_pool)[0]
            c = torch.autograd.grad(F.interpolate(xs, scale_factor=2), xs,
                                    dy_up)[0]
            e = torch.autograd.grad(F.adaptive_avg_pool2d(xs, 1), xs,
                                    dy_pool[:, :, :1, :1])[0]
            grads.append((a, c, e))
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(prev)
    assert all(torch.equal(p, q) for p, q in zip(*grads))
    want = dy_up.reshape(8, 64, 56, 2, 56, 2).sum(dim=(3, 5))
    assert float((grads[0][1] - want).abs().max()) <= 1e-5


def test_tiny_unet_and_resnet_train_on_card_as_on_cpu(dev):
    """A tiny float32 UNet (AdamW lr 1e-4) and ResNet-18 (Momentum 1e-4,
    L2 decay; [8, 3, 64, 64], so that layer4's BatchNorms see 32 values),
    3 trainer steps each on the card (captured) against the CPU trainer
    from the same weights: losses 1e-5 relative, weights within 1e-5 for
    99.9% of the elements and 3 lr for all, the ResNet's running
    statistics within 1e-4 of each buffer's largest value (at least 1):
    layer4's BatchNorms take their statistics over 32 values, which
    magnifies the rounding differences of the layers before."""
    from paddle_tpu_torch.models import (UNet2DConditionModel, UNetConfig,
                                         load_numpy_state)
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import AdamW, Momentum
    from paddle_tpu_torch.parallel import SpmdTrainer
    from paddle_tpu_torch.regularizer import L2Decay
    from paddle_tpu_torch.vision.models import resnet18
    torch.backends.cudnn.deterministic = True
    rng = np.random.default_rng(4)
    cfg = UNetConfig.tiny(ch=(32, 64), cross=32, groups=8)
    unet_batch = [torch.from_numpy(a) for a in (
        rng.standard_normal((2, 4, 16, 16)).astype(np.float32),
        np.array([3, 900]), rng.standard_normal((2, 7, 32))
        .astype(np.float32),
        rng.standard_normal((2, 4, 16, 16)).astype(np.float32))]
    res_batch = [torch.from_numpy(rng.standard_normal((8, 3, 64, 64))
                                  .astype(np.float32)),
                 torch.from_numpy(rng.integers(0, 5, 8))]

    def unet_loss(m, x, t, ctx, noise):
        return ((m(x, t, ctx) - noise) ** 2).mean()

    ce = CrossEntropyLoss()
    cases = (
        (lambda d: UNet2DConditionModel(cfg, device=d),
         lambda m: AdamW(learning_rate=1e-4, parameters=m.parameters()),
         unet_loss, unet_batch, 1e-4),
        (lambda d: resnet18(num_classes=5, device=d),
         lambda m: Momentum(learning_rate=1e-4, momentum=0.9,
                            parameters=m.parameters(),
                            weight_decay=L2Decay(1e-4)),
         lambda m, x, y: ce(m(x), y), res_batch, 1e-4))
    for make, make_opt, loss_fn, batch, lr in cases:
        torch.manual_seed(0)
        cpu = make("cpu")
        gpu = make(dev)
        load_numpy_state(gpu, {k: v.numpy() for k, v in
                               cpu.state_dict().items()})
        losses = []
        for model, d in ((cpu, "cpu"), (gpu, dev)):
            tr = SpmdTrainer(model, make_opt(model), loss_fn)
            losses.append([float(tr.train_step(*(t.to(d) for t in batch)))
                           for _ in range(3)])
        np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
        want = cpu.state_dict()
        close = total = 0
        for k, v in gpu.state_dict().items():
            d = (v.cpu() - want[k]).abs()
            if "_mean" in k or "_variance" in k:
                tol = 1e-4 * max(1.0, float(want[k].abs().max()))
            else:
                tol = 3 * lr
            assert float(d.max()) <= tol, k
            close += int((d <= 1e-5).sum())
            total += d.numel()
        assert close >= 0.999 * total


# -- BatchNorm ---------------------------------------------------------------------

_BN_CASES = [((4, 6, 5, 5), "NCHW"), ((3, 5, 7), "NCL"), ((16, 12), "NC"),
             ((2, 3, 4, 3, 5), "NCDHW"), ((3, 5, 6, 8), "NHWC"),
             ((2, 4, 3, 5, 6), "NDHWC"), ((8, 64, 28, 28), "NCHW"),
             ((6, 96, 7, 7), "NCHW"), ((2, 7, 1, 1), "NCHW"),
             ((4, 9, 9, 40), "NHWC")]


def _bn_inputs(dev, dtype, shape, last, seed=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    c = shape[-1] if last else shape[1]
    x = (3 + 2 * torch.randn(*shape, device=dev, generator=g)).to(dtype)
    res = torch.randn(*shape, device=dev, generator=g)
    w = (1 + 0.2 * torch.randn(c, device=dev, generator=g)).to(dtype)
    b = (0.2 * torch.randn(c, device=dev, generator=g)).to(dtype)
    dy = torch.randn(*shape, device=dev, generator=g)
    stats = (0.1 * torch.randn(c, device=dev, generator=g),
             1 + 0.1 * torch.rand(c, device=dev, generator=g))
    return x, res, w, b, dy, stats


def _bn_dx_close(got, want, dtype, scale):
    """dx: as ``_gn_close``, and in bf16 also within 2e-5 of dx's own
    scale (rstd * |dy * w|): where a channel has two values its x-hat is
    +-1 whatever x is, dx is 0 in exact arithmetic, and both sides write
    rounding noise."""
    if dtype == torch.float32:
        _gn_close(got, want, dtype, 2, scale)
        return
    mag = want.float().abs().amax(-1, keepdim=True)
    tol = torch.clamp(2 * 2.0 ** -7 * mag, min=2e-5 * scale)
    assert bool(((got.float() - want.float()).abs() <= tol).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,fmt", _BN_CASES)
@pytest.mark.parametrize("form", ["plain", "relu", "residual_relu"])
@pytest.mark.parametrize("batch_stats", [True, False])
def test_batch_norm_matches_plain(dev, dtype, shape, fmt, form,
                                  batch_stats):
    """The BatchNorm kernels, forward and backward, unfused, with the ReLU
    and with the residual add and the ReLU, in training and on the
    running statistics, every layout: against the plain formula's
    autograd (fp32 within 2e-5 of the largest value, bf16 each row within
    one ulp of its largest plain value, two for the gradients), the
    running statistics within 2e-5; one launch each way; two calls give
    the same bits."""
    from paddle_tpu_torch.kernels import batch_norm as BN
    last = fmt.endswith("C") and fmt != "NCHW" and len(shape) > 2
    x, res, w, b, dy, stats = _bn_inputs(dev, dtype, shape, last)
    res = res if form == "residual_relu" else None
    relu = form != "plain"
    out_dtype = torch.float32 if res is not None else dtype

    def run(fn, fused=True, grad=None):
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        r = None if res is None else res.clone().requires_grad_()
        rm, rv = (t.clone() for t in stats)
        y = fn(leaves[0], rm, rv, leaves[1], leaves[2], batch_stats, 0.9,
               1e-5, last, r if fused else None, relu and fused, True,
               out_dtype if fused else dtype)
        y.backward(dy.to(y.dtype) if grad is None else grad.to(y.dtype))
        return [y.detach()] + [t.grad for t in leaves] + \
            [None if r is None or not fused else r.grad, rm, rv]
    before = (K.LAUNCHES["batch_norm"], K.LAUNCHES["batch_norm_bwd"])
    got = run(BN.batch_norm)
    torch.cuda.synchronize()
    assert (K.LAUNCHES["batch_norm"], K.LAUNCHES["batch_norm_bwd"]) == \
        (before[0] + 1, before[1] + 1)
    again = run(BN.batch_norm)
    assert all(a is None or torch.equal(a, c) for a, c in zip(got, again))
    # the gradients: the plain norm's autograd from the gradient the
    # kernel's own output lets through the ReLU (a value within rounding of
    # 0 may fall on the other side in the plain forward), which is also
    # the residual's gradient
    dyo = dy.to(got[0].dtype).float()
    g = torch.where(got[0] <= 0, 0.0, dyo) if relu else dyo
    want = run(BN.batch_norm_plain, fused=False, grad=g)
    plain = run(BN.batch_norm_plain)[0]
    if res is not None and dtype == torch.bfloat16:
        # the norm rounded to bf16 before the fp32 add: the two sides'
        # roundings may sit one bf16 ulp of the norm's value apart
        tol = 2.0 ** -7 * float(want[0].float().abs().max()) \
            + 2e-5 * float(plain.abs().max())
        assert float((got[0] - plain).abs().max()) <= tol
    else:
        _gn_close(got[0], plain, got[0].dtype, 1)
    if res is not None:
        assert got[4].dtype == res.dtype and torch.equal(got[4], g)
    ch = len(shape) - 1 if last else 1
    axes = tuple(i for i in range(len(shape)) if i != ch)
    var = stats[1] if not batch_stats else \
        x.float().var(dim=axes, unbiased=False)
    dx_scale = float((var + 1e-5).rsqrt().max()) * float(
        dy.abs().max() * w.float().abs().max())
    _bn_dx_close(got[1], want[1], dtype, dx_scale)
    n = x.numel() // x.shape[ch]
    for a, c in zip(got[2:4], want[2:4]):
        # a sum over n values: fp32 rounding of n terms
        tol = 2e-5 * max(1.0, float(c.float().abs().max())) * max(
            1.0, n ** 0.5 / 8)
        if dtype == torch.bfloat16:
            tol = max(tol, 2 * 2.0 ** -7 * float(c.float().abs().max()))
        assert float((a.float() - c.float()).abs().max()) <= tol
    for a, c in zip(got[5:], want[5:]):
        assert float((a - c).abs().max()) <= 2e-5 * max(
            1.0, float(c.abs().max()))


@pytest.mark.parametrize("level", [None, "O1", "O2"])
@pytest.mark.parametrize("shape", [(8, 64, 28, 28), (4, 256, 7, 7),
                                   (6, 16, 5, 5)])
def test_batch_norm_fused_is_the_composition(dev, level, shape):
    """Through ``nn.functional.batch_norm`` with bf16 x, fp32 weights and
    an fp32 residual (ResNet's dtypes under amp O1), with and without
    ``auto_cast``: ``then="relu"`` with and without ``residual`` against
    the kernel's unfused output followed by PyTorch's add and ReLU,
    output, dx, dresidual, dweight, dbias and the running statistics all
    bit-equal."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import functional as F
    x, res, w, b, dy, stats = _bn_inputs(dev, torch.bfloat16, shape, False)
    w, b = w.float(), b.float()
    for with_res in (True, False):
        runs = []
        for fused in (True, False):
            xi = x.clone().requires_grad_()
            ri = res.clone().requires_grad_()
            wi, bi = w.clone().requires_grad_(), b.clone().requires_grad_()
            rm, rv = (t.clone() for t in stats)
            ctx = amp.auto_cast(level=level) if level else \
                torch.enable_grad()
            with ctx:
                if fused:
                    y = F.batch_norm(xi, rm, rv, wi, bi, training=True,
                                     residual=ri if with_res else None,
                                     then="relu")
                else:
                    z = F.batch_norm(xi, rm, rv, wi, bi, training=True)
                    y = F.relu(z + ri if with_res else z)
            y.backward(dy.to(y.dtype))
            runs.append((y, xi.grad, ri.grad, wi.grad, bi.grad, rm, rv))
        torch.cuda.synchronize()
        for a, c in zip(*runs):
            assert (a is None) == (c is None)
            if a is not None:
                assert a.dtype == c.dtype and torch.equal(a, c)


def test_batch_norm_replays_from_a_graph_with_running_statistics(dev):
    """Forward (residual and ReLU fused) and backward captured in a CUDA
    graph with the running statistics: each replay after the input is
    rewritten equals an eager call bit for bit, and each moves the running
    statistics as the eager call does."""
    from paddle_tpu_torch.kernels import batch_norm as BN
    x, res, w, b, dy, stats = _bn_inputs(dev, torch.bfloat16,
                                         (8, 128, 14, 14), False)
    w, b = w.float(), b.float()
    xs = x.clone().requires_grad_()
    rm, rv = (t.clone() for t in stats)

    def step(m, v):
        xs.grad = None
        y = BN.batch_norm(xs, m, v, w, b, True, 0.9, 1e-5, False, res,
                          True, False, torch.float32)
        return y, torch.autograd.grad(y, xs, dy)[0]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(rm.clone(), rv.clone())
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_cap, dx_cap = step(rm, rv)
    em, ev = (t.clone() for t in stats)
    rm.copy_(stats[0])
    rv.copy_(stats[1])
    for seed in (1, 2):
        with torch.no_grad():
            xs.copy_(_bn_inputs(dev, torch.bfloat16, (8, 128, 14, 14),
                                False, seed=seed)[0])
        graph.replay()
        y, dx = step(em, ev)
        torch.cuda.synchronize()
        assert torch.equal(y_cap, y) and torch.equal(dx_cap, dx)
        assert torch.equal(rm, em) and torch.equal(rv, ev)


@pytest.mark.parametrize("shape", [(2, 6, 33, 17), (3, 4, 9), (2, 3, 4, 5, 6),
                                   (5, 3)])
def test_instance_norm_runs_the_group_norm_kernel(dev, shape):
    """``instance_norm`` on the card is GroupNorm with one channel a group
    (the plan's ``Cg = 1``): one ``group_norm`` launch each way, output
    and gradients as the plain version's (fp32 2e-5; bf16 one ulp of each
    row's largest, two for the gradients), under O1 an fp32 output."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.kernels import group_norm as GN
    from paddle_tpu_torch.nn import functional as F
    for dtype in (torch.float32, torch.bfloat16):
        x, w, b, dy = _gn_inputs(dev, dtype, shape)
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        before = (K.LAUNCHES["group_norm"], K.LAUNCHES["group_norm_bwd"])
        y = F.instance_norm(leaves[0], weight=leaves[1], bias=leaves[2])
        y.backward(dy)
        torch.cuda.synchronize()
        assert (K.LAUNCHES["group_norm"], K.LAUNCHES["group_norm_bwd"]) == \
            (before[0] + 1, before[1] + 1)
        plain = [t.clone().requires_grad_() for t in (x, w, b)]
        want = GN.group_norm_plain(plain[0], shape[1], plain[1], plain[2])
        want.backward(dy)
        _gn_close(y.detach(), want.detach(), dtype, 1)
        xg = x.float().reshape(shape[0], shape[1], -1)
        rstd = float((xg.var(-1, unbiased=False) + 1e-5).rsqrt().max())
        scale = rstd * float(dy.float().abs().max() * w.float().abs().max())
        for a, c, s in zip(leaves, plain, (scale, 0.0, 0.0)):
            _gn_close(a.grad, c.grad, dtype, 2, s)
    with amp.auto_cast(level="O1"):
        assert F.instance_norm(x, weight=w, bias=b).dtype == torch.float32


# -- CTC and RNN-T (kernels/seq_loss.py) --------------------------------------
#
# Tolerances: each sample's nll within 1e-5 of max(1, |nll|) (the same fp32
# recursion; exp and log1p differ in the last ulps). dx element by element:
# the plain dx is glp - p * sum(glp) (glp the plain gradient on the
# log-probabilities, p the softmax), and each element may differ by 2e-3
# of the size of its two terms, |glp| + p * |sum(glp)| (the adjoints are
# exps of fp32 sums near -1000; chip_smoke.py prints the worst share at
# phase 16's shapes), plus 1e-12 of the largest such size (values near
# the denormal range), plus in bfloat16 one ulp of the plain value (both
# round an fp32 value). In fp32 the check must reject the plain gradient
# with its softmax term 1% off, and with its rows (lattice cells) of less
# than the median size 1% off. Two calls give the same bits (no atomics),
# and a captured call its eager call's.


def _seq_close(nll, dx, pn, x, glp):
    finite = pn < 1e29
    rel = ((nll - pn).abs() / pn.abs().clamp(min=1.0))[finite]
    assert torch.isfinite(nll).all() and float(rel.max()) <= 1e-5
    assert torch.equal(nll[~finite], pn[~finite])
    assert torch.isfinite(dx).all()
    p = torch.softmax(x.float(), -1)
    total = glp.sum(-1, keepdim=True)
    want = glp - p * total
    size = glp.abs() + p * total.abs()
    tol = 2e-3 * size + 1e-12 * float(size.max())
    if dx.dtype != torch.float32:
        want = want.to(dx.dtype).float()
        tol += 2.0 ** -7 * want.abs()
    assert bool(((dx.float() - want).abs() <= tol).all())
    if dx.dtype == torch.float32:
        assert not bool((0.01 * p * total.abs() <= tol).all())
        rows = size.amax(-1)
        low = (rows > 0) & (rows < rows[rows > 0].median())
        if low.any():
            assert not bool((0.01 * want.abs() <= tol)[low].all())


def _ctc_case(dev, dtype, T, B, C, L, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(T, B, C, device=dev, generator=g) * 2).to(dtype)
    lab = torch.randint(1, C, (B, L), device=dev, generator=g,
                        dtype=torch.int32)
    if L >= 3:
        lab[1, 1:3] = lab[1, 0]                   # repeated labels
    il = torch.randint(T * 4 // 5, T + 1, (B,), device=dev, generator=g,
                       dtype=torch.int32)
    ll = torch.randint(0, L + 1, (B,), device=dev, generator=g,
                       dtype=torch.int32)
    ll[0] = 0                                     # an empty sequence
    il[-1], ll[-1] = 2, min(L, 5)                 # infeasible
    w = torch.rand(B, device=dev, generator=g)
    return x, lab, il, ll, w


@pytest.mark.parametrize("norm_by_times", [False, True])
@pytest.mark.parametrize("shape", [(50, 6, 29, 12), (60, 4, 300, 20),
                                   (500, 32, 29, 200), (30, 3, 16, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ctc_kernels_match_plain(dev, dtype, shape, norm_by_times):
    """Forward and backward, one launch each, against the plain loops;
    ragged lengths, an empty and an infeasible sample, repeated labels;
    two calls bit-equal."""
    from paddle_tpu_torch.kernels import seq_loss as SL
    x, lab, il, ll, w = _ctc_case(dev, dtype, *shape, seed=sum(shape))
    before = (K.LAUNCHES["ctc_fwd"], K.LAUNCHES["ctc_bwd"])
    nll, lse, alpha = SL.ctc_forward(x, lab, il, ll)
    dx = SL.ctc_backward(x, lab, il, ll, lse, alpha, w, 0, norm_by_times)
    torch.cuda.synchronize()
    assert (K.LAUNCHES["ctc_fwd"], K.LAUNCHES["ctc_bwd"]) == \
        (before[0] + 1, before[1] + 1)
    assert dx.dtype == dtype and nll.dtype == torch.float32
    pn, pa = SL.ctc_forward_plain(x, lab, il, ll)
    glp = SL.ctc_log_prob_grad_plain(x, lab, il, ll, pa, w, 0, norm_by_times)
    _seq_close(nll, dx, pn, x, glp)
    nll2, lse2, alpha2 = SL.ctc_forward(x, lab, il, ll)
    dx2 = SL.ctc_backward(x, lab, il, ll, lse2, alpha2, w, 0, norm_by_times)
    assert torch.equal(nll, nll2) and torch.equal(dx, dx2)


def _rnnt_case(dev, dtype, B, T, U, V, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, T, U + 1, V, device=dev, generator=g).to(dtype)
    lab = torch.randint(1, V, (B, U), device=dev, generator=g,
                        dtype=torch.int32)
    il = torch.randint(max(1, T * 3 // 4), T + 1, (B,), device=dev,
                       generator=g, dtype=torch.int32)
    ll = torch.randint(0, U + 1, (B,), device=dev, generator=g,
                       dtype=torch.int32)
    ll[0] = 0
    w = torch.rand(B, device=dev, generator=g)
    return x, lab, il, ll, w


@pytest.mark.parametrize("lam", [0.0, 0.01])
@pytest.mark.parametrize("shape", [(4, 20, 8, 33), (2, 30, 10, 128),
                                   (3, 7, 0, 16), (16, 200, 60, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rnnt_kernels_match_plain(dev, dtype, shape, lam):
    """Forward and backward (vectorised rows where V allows, single values
    elsewhere), one launch each, against the plain lattice loops; ragged
    lengths, an empty label sequence, ``fastemit_lambda``; two calls
    bit-equal."""
    from paddle_tpu_torch.kernels import seq_loss as SL
    x, lab, il, ll, w = _rnnt_case(dev, dtype, *shape, seed=sum(shape))
    before = (K.LAUNCHES["rnnt_fwd"], K.LAUNCHES["rnnt_bwd"])
    nll, *saved = SL.rnnt_forward(x, lab, il, ll)
    dx = SL.rnnt_backward(x, lab, il, ll, *saved, w, 0, lam)
    torch.cuda.synchronize()
    assert (K.LAUNCHES["rnnt_fwd"], K.LAUNCHES["rnnt_bwd"]) == \
        (before[0] + 1, before[1] + 1)
    pn, pa = SL.rnnt_forward_plain(x, lab, il, ll)
    glp = SL.rnnt_log_prob_grad_plain(x, lab, il, ll, pa, w, 0, lam)
    _seq_close(nll, dx, pn, x, glp)
    del pa, glp
    nll2, *saved2 = SL.rnnt_forward(x, lab, il, ll)
    dx2 = SL.rnnt_backward(x, lab, il, ll, *saved2, w, 0, lam)
    assert torch.equal(nll, nll2) and torch.equal(dx, dx2)


@pytest.mark.parametrize("loss", ["ctc", "rnnt"])
def test_seq_losses_replay_from_a_graph(dev, loss):
    """The functional's forward and backward (through the autograd
    functions) captured in a CUDA graph: each replay after the logits are
    rewritten equals an eager call bit for bit."""
    from paddle_tpu_torch.nn import functional as F
    if loss == "ctc":
        x, lab, il, ll, _ = _ctc_case(dev, torch.float32, 40, 5, 29, 10, 3)
        fn = lambda t: F.ctc_loss(t, lab, il, ll, norm_by_times=True)  # noqa: E731
    else:
        x, lab, il, ll, _ = _rnnt_case(dev, torch.float32, 3, 16, 6, 64, 4)
        fn = lambda t: F.rnnt_loss(t, lab, il, ll)  # noqa: E731
    xs = x.clone().requires_grad_()

    def step():
        v = fn(xs)
        return v, torch.autograd.grad(v, xs)[0]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        v_cap, g_cap = step()
    for seed in (1, 2):
        with torch.no_grad():
            xs.copy_(torch.randn(x.shape, device=dev,
                                 generator=torch.Generator(device=dev)
                                 .manual_seed(seed)))
        graph.replay()
        v, g = step()
        torch.cuda.synchronize()
        assert torch.equal(v_cap, v) and torch.equal(g_cap, g)


def test_seq_losses_refuse_other_dtypes(dev):
    from paddle_tpu_torch.kernels import seq_loss as SL
    x, lab, il, ll, _ = _ctc_case(dev, torch.float32, 10, 2, 5, 3, 5)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        SL.ctc_forward(x.half(), lab, il, ll)


# -- the dense attention's middle (X2) -------------------------------------------

def _x2_mask(dev, form, b, h, sq, sk, seed):
    """A mask of ``form``: bool or additive at [sq, sk], [b, 1, 1, sk],
    [b, 1, sq, sk] or [b, h, sq, sk] (a bool one with a whole row hidden)."""
    if form is None:
        return None
    kind, where = form
    shape = {"2d": (sq, sk), "pad": (b, 1, 1, sk), "rows": (b, 1, sq, sk),
             "full": (b, h, sq, sk)}[where]
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "bool":
        m = torch.rand(shape, device=dev, generator=g) < 0.7
        m[..., 0, :] = False
        return m
    return torch.randn(shape, device=dev, generator=g) * 2


def _x2_close(got, want, size):
    """Each element within 2e-5 of its size (fp32 sums in another order)."""
    err = (got - want).abs()
    assert bool((err <= 2e-5 * size + 1e-30).all()), float(
        (err / (size + 1e-30)).max())


X2_FORMS = [None] + [(k, w) for k in ("bool", "add")
                     for w in ("2d", "pad", "rows", "full")]


@pytest.mark.parametrize("form", X2_FORMS,
                         ids=lambda f: "none" if f is None else "-".join(f))
@pytest.mark.parametrize("causal,sq,sk,p", [
    (False, 64, 64, 0.1), (True, 40, 130, 0.0), (True, 33, 9, 0.1),
    (False, 5, 10001, 0.1), (True, 3, 16384, 0.0)])
def test_dense_softmax_kernels_match_plain(dev, form, causal, sq, sk, p):
    """X2 forward and backward against its plain version: the probs and ds
    element by element, the dropped probs bit-equal to the kernel's probs
    under ``keep_mask_plain``; rows longer than one block (aligned and
    not), causal with sq != sk, a row without a key; one launch each."""
    from paddle_tpu_torch.framework.random import RandomKey
    from paddle_tpu_torch.kernels import dense_attention as DA
    from paddle_tpu_torch.kernels import dropout as D
    b, h = 2, 3
    g = torch.Generator(device=dev).manual_seed(sq + sk)
    scores = torch.randn(b, h, sq, sk, device=dev, generator=g) * 4
    gy = torch.randn(b, h, sq, sk, device=dev, generator=g)
    mask = _x2_mask(dev, form, b, h, sq, sk, sk)
    key = RandomKey(torch.tensor([5, 6], device=dev), 9) if p else None
    before = dict(K.LAUNCHES)
    probs, dropped = DA.dense_softmax_forward(scores, mask, causal, 0.3, p,
                                              key)
    ds, _ = DA.dense_softmax_backward(gy, probs, mask, causal, 0.3, p, key)
    assert K.LAUNCHES["dense_softmax"] == before["dense_softmax"] + 1
    assert K.LAUNCHES["dense_softmax_bwd"] == before["dense_softmax_bwd"] + 1
    sp = scores.clone().requires_grad_()
    pp, dp = DA.dense_softmax_plain(sp, mask, causal, 0.3, p, key)
    (want_ds,) = torch.autograd.grad(dp, sp, gy)
    _x2_close(probs, pp.detach(), pp.detach().abs())
    scale = D.scale_of(p, "upscale_in_train") if p else 1.0
    if p:
        keep = D.keep_mask_plain(tuple(scores.shape), p, key, dev)
        assert torch.equal(dropped, torch.where(
            keep, probs * scale, torch.zeros((), device=dev)))
    gp = gy * (dropped != 0) * scale
    size = probs * (gp.abs() + (gp.abs() * probs).sum(-1, keepdim=True))
    _x2_close(ds, want_ds, 0.3 * size)


def test_dense_softmax_additive_mask_gradient_matches_plain(dev):
    """An additive mask that needs a gradient gets the softmax input's
    gradient summed to its shape."""
    from paddle_tpu_torch.kernels import dense_attention as DA
    g = torch.Generator(device=dev).manual_seed(3)
    scores = torch.randn(2, 4, 16, 48, device=dev, generator=g)
    mask = torch.randn(2, 1, 16, 48, device=dev, generator=g)
    gy = torch.randn(2, 4, 16, 48, device=dev, generator=g)
    grads = []
    for fn in (DA.dense_softmax, lambda *a: DA.dense_softmax_plain(*a)[1]):
        s, m = scores.clone().requires_grad_(), mask.clone().requires_grad_()
        grads.append(torch.autograd.grad(fn(s, m, True, 0.5), (s, m), gy))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=2e-5 * float(b.abs().max()))


def test_dense_softmax_twice_and_replayed_are_bit_equal(dev):
    """Two calls give the same bits; a forward and backward captured in a
    CUDA graph and replayed with a new key (in its device tensor) and new
    scores equal eager calls for that key."""
    from paddle_tpu_torch.framework.random import RandomKey
    from paddle_tpu_torch.kernels import dense_attention as DA
    g = torch.Generator(device=dev).manual_seed(4)
    scores = torch.randn(4, 2, 64, 64, device=dev, generator=g)
    mask = torch.randn(4, 1, 1, 64, device=dev, generator=g)
    gy = torch.randn(4, 2, 64, 64, device=dev, generator=g)
    keyt = torch.tensor([1, 2], device=dev)

    def step():
        s = scores.clone().requires_grad_()
        y = DA.dense_softmax(s, mask, False, 0.125, 0.2, RandomKey(keyt, 3))
        return y, torch.autograd.grad(y, s, gy)[0]
    a, b = step(), step()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_cap, d_cap = step()
    for words in ((7, 8), (2 ** 32 - 1, 5)):
        keyt.copy_(torch.tensor(words))
        scores.copy_(torch.randn(scores.shape, device=dev, generator=g))
        graph.replay()
        y, d = step()
        torch.cuda.synchronize()
        assert torch.equal(y_cap, y) and torch.equal(d_cap, d)


def test_dense_softmax_refuses_what_it_does_not_take(dev):
    """The wrapper refuses what neither kernel takes; the CUDA forward
    refuses rows off a multiple of 4 keys or past its 256 (a launch that
    would fail raises, it does not fall back)."""
    from paddle_tpu_torch.kernels import dense_attention as DA
    with pytest.raises(ValueError, match="fp32"):
        DA.dense_softmax_forward(torch.zeros(2, 3, 4, device=dev))
    with pytest.raises(ValueError, match="fp32"):
        DA.dense_softmax_forward(torch.zeros(1, 1, 2, 3, device=dev,
                                             dtype=torch.bfloat16))
    for sk in (6, 260, 2048):
        s = torch.zeros(1, 1, 2, sk, device=dev)
        with pytest.raises(RuntimeError, match="dense_softmax CUDA kernel"):
            DA._cuda_forward(s, 0, None, (0, 0, 0, 0), False, 1.0, None, 0,
                             0, 1.0, False, torch.empty_like(s),
                             torch.empty_like(s))


@pytest.mark.parametrize("route", ["sdpa", "unpadded", "flashmask_dropout"])
def test_attention_routes_run_x2_on_the_card(dev, route):
    """The dense attention routes launch X2 on CUDA tensors and equal the
    same call on the CPU (the plain version)."""
    from paddle_tpu_torch.nn import functional as F
    g = torch.Generator().manual_seed(6)
    if route == "unpadded":
        qkv = torch.randn(40, 3, 2, 64, generator=g)
        cu = torch.tensor([0, 11, 40], dtype=torch.int32)
        fn = lambda t, c: F.flash_attn_varlen_qkvpacked(  # noqa: E731
            t, c, c, 29, 29, 0.2, causal=True)[0]
        args = (qkv, cu)
    else:
        q, k, v = (torch.randn(2, 32, 2, 64, generator=g) for _ in range(3))
        mask = torch.rand(2, 1, 32, 32, generator=g) < 0.8
        if route == "sdpa":
            fn = lambda a, b, c, m: F.scaled_dot_product_attention(  # noqa
                a, b, c, attn_mask=m)
            args = (q, k, v, mask)
        else:
            se = torch.full((2, 1, 32, 1), 32, dtype=torch.int32)
            se[:, :, :16] = 16
            fn = lambda a, b, c, s: F.flashmask_attention(  # noqa: E731
                a, b, c, s, dropout=0.1, causal=True)
            args = (q, k, v, se)
    import paddle_tpu_torch as ptt
    ptt.seed(3)
    want = fn(*args)
    before = K.LAUNCHES["dense_softmax"]
    ptt.seed(3)
    got = fn(*(a.to(dev) for a in args))
    assert K.LAUNCHES["dense_softmax"] == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_sparse_attention_twice_on_the_card_is_bit_equal(dev):
    """``sparse_attention``'s reductions run in a fixed order on the card
    (segment by segment, the k/v gradients through a stable sort): two
    calls give the same output and gradients, and they equal the CPU's
    within 1e-5 of the largest value."""
    from paddle_tpu_torch.nn import functional as F
    g = torch.Generator().manual_seed(8)
    b, h, s, d, per = 2, 4, 128, 32, 24
    qkv = [torch.randn(b, h, s, d, generator=g) for _ in range(3)]
    cols = torch.sort(torch.stack([torch.randperm(s, generator=g)[:per]
                                   for _ in range(b * h * s)]), -1)[0]
    cols = cols.reshape(b, h, s * per).int()
    off = torch.arange(0, s * per + 1, per, dtype=torch.int32).repeat(b, h, 1)
    kpm = (torch.rand(b, s, generator=g) > 0.1).float()
    am = (torch.rand(s, s, generator=g) > 0.1).float()
    gy = torch.randn(b, h, s, d, generator=g)
    runs = []
    for device in ("cpu", dev, dev):
        ts = [t.to(device).requires_grad_() for t in qkv]
        out = F.sparse_attention(*ts, off.to(device), cols.to(device),
                                 kpm.to(device), am.to(device))
        runs.append([out] + list(torch.autograd.grad(out, ts,
                                                     gy.to(device))))
    runs = [[t.detach() for t in r] for r in runs]
    assert all(torch.equal(a, c) for a, c in zip(runs[1], runs[2]))
    for a, c in zip(runs[1], runs[0]):
        torch.testing.assert_close(a.cpu(), c, rtol=0,
                                   atol=1e-5 * float(c.abs().max()))


# -- the recurrence (kernels/rnn.py, csrc/rnn_recurrence.cu) ------------------

_RNN_SHAPES = [(1, 5, 24, 40), (7, 37, 24, 40), (4, 130, 64, 96)]


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _rnn_case(mode, T, B, n_in, H, dev, seed=0):
    """(xw, h0, c0, W_hh, b_hc) on ``dev`` from ``seed``."""
    from paddle_tpu_torch.kernels import rnn as R
    g = torch.Generator().manual_seed(seed)
    G = R.GATES[mode]

    def u(*shape):
        return ((torch.rand(*shape, generator=g) * 2 - 1) * H ** -0.5).to(dev)
    xw = torch.randn(T, B, G * H, generator=g).to(dev)
    h0 = (torch.randn(B, H, generator=g) * 0.5).to(dev)
    c0 = (torch.randn(B, H, generator=g) * 0.5).to(dev) \
        if mode == "lstm" else None
    return xw, h0, c0, u(G * H, H), (u(H) if mode == "gru" else None)


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", _RNN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_rnn_kernels_match_plain(dev, mode, reverse, shape):
    """The kernels (through ``rnn_scan``'s Function) against torch's
    autograd through the plain loop on the card: every output and the
    gradients of xw, h0, c0, W_hh and b_hc; the forward's and the
    backward's launches as their plans say (one on a persistent kernel,
    one a step on the forward's step kernel, two a step on the backward's
    step route); two calls bit-equal."""
    from paddle_tpu_torch.kernels import rnn as R
    T = shape[0]
    case = _rnn_case(mode, *shape, dev)
    plan = R.rnn_forward_plan(mode, T, shape[1], shape[3], _sms(dev))
    bplan = R.rnn_backward_plan(mode, T, shape[1], shape[3], _sms(dev))

    def run(fn):
        args = [None if t is None else t.clone().requires_grad_()
                for t in case]
        outs = [o for o in fn(mode, *args, reverse=reverse) if o is not None]
        cots = [torch.randn(o.shape, generator=torch.Generator(
            device=dev).manual_seed(i), device=dev)
            for i, o in enumerate(outs)]
        leaves = [t for t in args if t is not None]
        return [o.detach() for o in outs] + list(torch.autograd.grad(
            outs, leaves, cots))
    keys = ("rnn_fwd", "rnn_bwd", "rnn_bwd_gates", "rnn_bwd_step")
    before = [K.LAUNCHES[k] for k in keys]
    got = run(R.rnn_scan)
    assert tuple(K.LAUNCHES[k] - b for k, b in zip(keys, before)) == \
        (plan.launches,) + ((1, 0, 0) if bplan.route == "persistent"
                            else (0, T, T))
    again = run(R.rnn_scan)
    want = run(R.rnn_scan_plain)
    n_out = 3 if mode == "lstm" else 2
    for i, (a, b, w) in enumerate(zip(got, again, want)):
        assert torch.equal(a, b)
        tol = 1e-5 if i < n_out else 1e-4
        assert float((a - w).abs().max()) <= tol * max(1.0, float(
            w.abs().max())), i


def test_rnn_kernels_replay_from_a_graph(dev):
    """Forward and backward of one LSTM and one GRU layer captured in a
    CUDA graph: the replay equal to an eager call bit for bit."""
    from paddle_tpu_torch.kernels import rnn as R
    for mode in ("lstm", "gru"):
        xw, h0, c0, w, b = _rnn_case(mode, 6, 40, 0, 64, dev, 3)
        dy = torch.randn(6, 40, 64, device=dev)

        def call():
            y, hT, cT, saved, cs = R.rnn_forward(mode, xw, h0, c0, w, b)
            dxw, dhc, dh0, dc0 = R.rnn_backward(mode, dy, None, None, saved,
                                                cs, h0, c0, y, w)
            return [t for t in (y, hT, cT, dxw, dhc, dh0, dc0)
                    if t is not None]
        eager = call()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static = call()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(eager, static)), mode


def test_rnn_kernels_refuse_what_they_do_not_take(dev):
    from paddle_tpu_torch.kernels import rnn as R
    xw, h0, _, w, _ = _rnn_case("gru", 2, 3, 0, 8, dev)
    with pytest.raises(TypeError):
        R.rnn_forward("gru", xw.double(), h0.double(), None, w.double())
    with pytest.raises(ValueError):
        R.rnn_forward("gru", xw, h0.cpu(), None, w)


@pytest.mark.parametrize("cls", ["LSTM", "GRU", "SimpleRNN"])
def test_stacked_layers_on_the_card_equal_the_cpu(dev, cls):
    """A 2-layer bidirectional layer built from one framework seed on
    each device: outputs and the input's gradient within 1e-5 / 1e-4 of
    the largest CPU value."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import nn
    x = torch.randn(5, 9, 12, generator=torch.Generator().manual_seed(4))
    got = []
    for d in ("cpu", dev):
        ptt.seed(5)
        m = getattr(nn, cls)(12, 16, num_layers=2, direction="bidirect",
                             device=d)
        xt = x.to(d).requires_grad_()
        y = m(xt)[0]
        (gx,) = torch.autograd.grad(y.square().sum(), xt)
        got.append((y.detach().cpu(), gx.cpu()))
    (y_c, g_c), (y_d, g_d) = got
    assert float((y_d - y_c).abs().max()) <= 1e-5 * max(1.0, float(
        y_c.abs().max()))
    assert float((g_d - g_c).abs().max()) <= 1e-4 * max(1.0, float(
        g_c.abs().max()))


def test_beam_decode_on_the_card_equals_the_cpu(dev):
    """BeamSearchDecoder (beam 4) and dynamic_decode over a GRU cell, its
    embedding and output layer made on the CPU from one seed and moved:
    tokens and lengths equal to the CPU's."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import nn
    h0 = torch.randn(3, 8, generator=torch.Generator().manual_seed(6))
    runs = []
    for d in ("cpu", dev):
        ptt.seed(7)
        gen = torch.Generator().manual_seed(8)
        cell = nn.GRUCell(6, 8, device=d)
        emb = nn.Embedding(13, 6, device="cpu", generator=gen).to(d)
        out = nn.Linear(8, 13, device="cpu", generator=gen).to(d)
        dec = nn.BeamSearchDecoder(cell, 1, 2, 4, embedding_fn=emb,
                                   output_fn=out)
        with torch.no_grad():
            seqs, _, lens = nn.dynamic_decode(dec, inits=h0.to(d),
                                              max_step_num=9,
                                              return_length=True)
        runs.append((seqs.cpu(), lens.cpu()))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def test_rnn_function_takes_no_gradient_of_unused_outputs(dev):
    """Only the final state used (a cell's step): the kernels' backward
    runs with the outputs' gradient absent, not zeros, and gives the
    plain loop's gradient within 1e-4 of the largest."""
    from paddle_tpu_torch.kernels import rnn as R
    xw, h0, _, w, b = _rnn_case("gru", 3, 6, 0, 16, dev, 14)
    xw.requires_grad_()
    (g,) = torch.autograd.grad(R.rnn_scan("gru", xw, h0, None, w, b)[1]
                               .sum(), xw)
    (g2,) = torch.autograd.grad(R.rnn_scan_plain("gru", xw, h0, None, w, b)
                                [1].sum(), xw)
    assert float((g - g2).abs().max()) <= 1e-4 * max(1.0, float(
        g2.abs().max()))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_rnn_scan_in_half_precision_computes_in_fp32(dev, mode, dtype):
    """A half-precision ``rnn_scan`` on the card (a cell under amp O2) is
    the kernels in fp32 on the exact fp32 values, its outputs and
    gradients rounded to the dtype: each tensor within one ulp of its
    largest value (the dtype's eps times it) of the plain loop run that
    way; float64 raises."""
    from paddle_tpu_torch.kernels import rnn as R
    case = [None if t is None else t.to(dtype)
            for t in _rnn_case(mode, 4, 9, 0, 24, dev, 15)]

    def run(fn, up):
        args = [None if t is None else (t.float() if up else t).detach()
                .requires_grad_() for t in case]
        outs = [o for o in fn(mode, *args) if o is not None]
        leaves = [t for t in args if t is not None]
        grads = torch.autograd.grad([o.float().sum() for o in outs], leaves)
        return [t.detach().to(dtype) for t in outs + list(grads)]
    got = run(R.rnn_scan, False)
    want = run(R.rnn_scan_plain, True)
    eps = torch.finfo(dtype).eps
    for a, e in zip(got, want):
        assert a.dtype == dtype
        assert float((a.float() - e.float()).abs().max()) <= eps * float(
            e.float().abs().max())
    with pytest.raises(TypeError):
        R.rnn_scan(mode, *[None if t is None else t.double() for t in case])


@pytest.mark.parametrize("cls", ["LSTMCell", "GRUCell", "SimpleRNNCell"])
def test_cells_under_amp_o2_on_the_card_equal_the_cpu(dev, cls):
    """Two steps of a cell under ``auto_cast(level="O2")`` (bf16) on each
    device from one framework seed: the same dtypes; outputs within 2^-6
    and the input's and weights' gradients within 2^-5 of the largest
    CPU value (the CPU rounds each op of a step to bf16, the card only
    its outputs: up to 2 bf16 ulps of 1 and 0.01 of the largest
    gradient, emulated on the CPU at [128, 1024 -> 512])."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import amp, nn
    x = torch.randn(6, 12, generator=torch.Generator().manual_seed(16))
    got = []
    for d in ("cpu", dev):
        ptt.seed(17)
        m = getattr(nn, cls)(12, 16, device=d)
        xt = x.to(d).requires_grad_()
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            out, states = m(xt, m(xt)[1])
        grads = torch.autograd.grad(out.float().square().sum(),
                                    [xt, m.weight_ih, m.weight_hh])
        got.append([t.detach().cpu() for t in (out, *grads)])
    for i, (a, b) in enumerate(zip(got[1], got[0])):
        assert a.dtype == b.dtype
        tol = 2.0 ** -6 if i == 0 else 2.0 ** -5
        assert float((a.float() - b.float()).abs().max()) <= tol * max(
            1.0, float(b.float().abs().max())), i


# -- the forward's two kernels and BatchNorm's cluster backward, by plan ----

# (T, B, H): cell steps and sequences, B and H off the tiles (32 rows, 16
# units, 64 of the depth), H % 4 != 0 (4-byte copies, the step kernel),
# 64-row blocks (1700 rows)
_RNN_ROUTE_SHAPES = [(1, 37, 40), (1, 1700, 72), (9, 37, 40), (6, 130, 96),
                     (3, 5, 42), (2, 33, 516)]


def _replays_equal(call):
    """``call()`` eager, then captured in a CUDA graph and replayed twice:
    every output of each replay bit-equal to the eager call's."""
    eager = [t.clone() for t in call() if t is not None]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = [t for t in call() if t is not None]
    same = True
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        same = same and all(torch.equal(a, b) for a, b in zip(eager, static))
    return same


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", _RNN_ROUTE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_rnn_forward_routes_match_plain(dev, mode, reverse, shape):
    """The forward on its plan's kernel (persistent for T > 1 where it
    fits, else the step kernel) from given initial states against the
    plain loop: outputs within 1e-5 of the largest plain value, what the
    backward reads (lstm c_t and i, f, g, o; gru r, z, n, hc) within 1e-5
    of 1; the plan's launches, on the step kernel where it says so; two
    calls and graph replays bit-equal."""
    from paddle_tpu_torch.kernels import rnn as R
    T, B, H = shape
    xw, h0, c0, w, b = _rnn_case(mode, T, B, 0, H, dev, seed=T + B + H)
    plan = R.rnn_forward_plan(mode, T, B, H, _sms(dev))
    before = (K.LAUNCHES["rnn_fwd"], K.LAUNCHES["rnn_fwd_step"])
    out = R.rnn_forward(mode, xw, h0, c0, w, b, reverse)
    torch.cuda.synchronize()
    assert (K.LAUNCHES["rnn_fwd"] - before[0],
            K.LAUNCHES["rnn_fwd_step"] - before[1]) == \
        (plan.launches, plan.launches if plan.route == "step" else 0)
    again = R.rnn_forward(mode, xw, h0, c0, w, b, reverse)
    assert all(a is None or torch.equal(a, c) for a, c in zip(out, again))
    want = R.rnn_scan_plain(mode, xw, h0, c0, w, b, reverse)
    for a, e in zip(out[:3], want):
        if e is not None:
            assert float((a - e).abs().max()) <= 1e-5 * max(
                1.0, float(e.abs().max()))
    y, saved, cs = out[0], out[3], out[4]
    order = range(T - 1, -1, -1) if reverse else range(T)
    h, c = h0, c0
    for t in order:   # what the backward reads, step by step from the plain
        hp = h
        gh = hp @ w.t()
        if mode == "lstm":
            a = xw[t] + gh
            gates = [torch.sigmoid(a[:, :H]), torch.sigmoid(a[:, H:2 * H]),
                     torch.tanh(a[:, 2 * H:3 * H]),
                     torch.sigmoid(a[:, 3 * H:])]
        elif mode == "gru":
            hc = gh[:, 2 * H:] + b
            r = torch.sigmoid(xw[t, :, :H] + gh[:, :H])
            gates = [r, torch.sigmoid(xw[t, :, H:2 * H] + gh[:, H:2 * H]),
                     torch.tanh(xw[t, :, 2 * H:] + r * hc), hc]
        h, c = R.rnn_step_plain(mode, xw[t], hp, c, w, b)
        if saved is not None:
            assert float((saved[t] - torch.cat(gates, -1)).abs().max()) \
                <= 1e-5
        if cs is not None:
            assert float((cs[t] - c).abs().max()) <= 1e-5 * max(
                1.0, float(c.abs().max()))
        h = y[t]   # each step from the kernel's own carry
        c = cs[t] if cs is not None else None
    assert _replays_equal(lambda: R.rnn_forward(mode, xw, h0, c0, w, b,
                                                reverse))


# (shape, blocks a cluster the plan gives): one block a channel (7 x 7, N
# not a multiple of anything, many channels of two values), clusters of 2,
# 4 and 8
_BN_CLUSTER = [((6, 5, 7, 7), 1), ((37, 11, 5, 5), 1), ((13, 10, 3, 4), 1),
               ((1, 2048, 2, 1), 1), ((128, 24, 14, 14), 2),
               ((128, 8, 20, 20), 4), ((128, 4, 28, 28), 8)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape,cs", _BN_CLUSTER,
                         ids=lambda v: str(v).replace(" ", ""))
@pytest.mark.parametrize("form", ["plain", "relu", "residual_relu"])
@pytest.mark.parametrize("round_x", [False, True])
def test_batch_norm_cluster_backward_matches_two_pass(dev, dtype, shape, cs,
                                                      form, round_x):
    """The cluster kernel (one pass over a channel in shared memory, its
    sums in a fixed order, across a cluster through distributed shared
    memory) against the two-pass Triton backward on the same inputs: dx
    as BatchNorm's dx (one ulp of each row's largest value, two for the
    gradients), the residual's gradient equal, dweight and dbias within
    2e-5 x max(1, sqrt(n) / 8) of their largest; the plan's route, one
    launch, on the cluster kernel; two calls and graph replays
    bit-equal."""
    from paddle_tpu_torch.kernels import batch_norm as BN
    x, res, w, b, dy, stats = _bn_inputs(dev, dtype, shape, False, seed=5)
    res = res if form == "residual_relu" else None
    relu = form != "plain"
    rm, rv = (t.clone() for t in stats)
    y, st = BN.batch_norm_forward(x, w, b, rm, rv, True, 0.9, 1e-5, False, res,
                                  relu, round_x, torch.float32)
    rdt = None if res is None else res.dtype
    args = (x, w, st, dy, y, True, False, relu, round_x, rdt)
    plan = BN.batch_norm_backward_plan(
        shape[0], shape[1], shape[2] * shape[3], False, dtype, True,
        _sms(dev))
    assert plan[:2] == ("cluster", cs)
    before = (K.LAUNCHES["batch_norm_bwd"],
              K.LAUNCHES["batch_norm_bwd_cluster"])
    got = BN.batch_norm_backward(*args)
    torch.cuda.synchronize()
    assert (K.LAUNCHES["batch_norm_bwd"] - before[0],
            K.LAUNCHES["batch_norm_bwd_cluster"] - before[1]) == (1, 1)
    again = BN.batch_norm_backward(*args)
    assert all(a is None or torch.equal(a, c) for a, c in zip(got, again))
    want = (torch.empty_like(x), None if rdt is None else torch.empty(
        x.shape, dtype=rdt, device=dev),
        torch.zeros(2, shape[1], dtype=torch.float32, device=dev))
    BN._two_pass_backward(x, w, st, dy, y, True, False, relu, round_x, *want)
    want = want[:2] + (want[2][0], want[2][1])
    var = x.float().var(dim=(0, 2, 3), unbiased=False)
    scale = float((var + 1e-5).rsqrt().max()) * float(
        dy.abs().max() * w.float().abs().max())
    _bn_dx_close(got[0], want[0], dtype, scale)
    if res is not None:
        assert got[1].dtype == res.dtype and torch.equal(got[1], want[1])
    n = x.numel() // shape[1]
    for a, c in zip(got[2:], want[2:]):
        assert float((a - c).abs().max()) <= 2e-5 * max(
            1.0, float(c.abs().max())) * max(1.0, n ** 0.5 / 8)
    assert _replays_equal(lambda: BN.batch_norm_backward(*args))


# -- the redesigned backward recurrence and BatchNorm's cluster forward ------

# (T, B, H): the persistent backward (B and H off its 32 rows and 16 units;
# H past 512 for a second pass of columns; T 1), the step route (H % 4 !=
# 0, a depth of one to 16 stages; 1700 rows, more blocks than SMs)
_RNN_BWD_SHAPES = [(9, 37, 40), (6, 130, 96), (3, 33, 516), (1, 37, 40),
                   (1, 37, 42), (1, 20, 510), (1, 1700, 72), (4, 5, 42)]


@pytest.mark.parametrize("mode,absent", [
    (m, a) for m in ("lstm", "gru", "rnn_tanh", "rnn_relu")
    for a in ("none", "dy", "dhT") + (("dcT",) if m == "lstm" else ())])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", _RNN_BWD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_rnn_backward_routes_match_plain(dev, mode, absent, reverse, shape):
    """The backward on its plan's route (the persistent kernel where it
    fits, else the gate and product kernels a step) from given
    initial states, with ``dy``, ``dhT`` or ``dcT`` absent (None): dxw,
    dh0, dc0 and the weight products (W_hh's, b_hc's) against torch's
    autograd through the plain loop, within 1e-4 of the largest plain
    value; the plan's launches, each counter only its own kernel; two
    calls and graph replays bit-equal."""
    from paddle_tpu_torch.kernels import rnn as R
    T, B, H = shape
    xw, h0, c0, w, b = _rnn_case(mode, T, B, 0, H, dev, seed=T * B + H)
    plan = R.rnn_backward_plan(mode, T, B, H, _sms(dev))
    y, hT, cT, saved, cs = R.rnn_forward(mode, xw, h0, c0, w, b, reverse)
    g = torch.Generator(device=dev).manual_seed(7)
    ups = {k: None if k == absent else torch.randn(
        t.shape, device=dev, generator=g)
        for k, t in (("dy", y), ("dhT", hT), ("dcT", cT)) if t is not None}
    args = (mode, ups["dy"], ups["dhT"], ups.get("dcT"), saved, cs, h0, c0,
            y, w, reverse)
    keys = ("rnn_bwd", "rnn_bwd_gates", "rnn_bwd_step")
    before = [K.LAUNCHES[k] for k in keys]
    got = R.rnn_backward(*args)
    torch.cuda.synchronize()
    want_launches = (1, 0, 0) if plan.route == "persistent" else (0, T, T)
    assert tuple(K.LAUNCHES[k] - n for k, n in zip(keys, before)) == \
        want_launches
    assert plan.route == ("step" if H % 4 or B > 1000 else "persistent")
    again = R.rnn_backward(*args)
    assert all(a is None or torch.equal(a, c) for a, c in zip(got, again))
    dxw, dhc, dh0, dc0 = got
    dw, db = R.weight_grads(dxw, dhc, h0, y, reverse, b is not None)
    leaves = [t.clone().requires_grad_() for t in (xw, h0, c0, w, b)
              if t is not None]
    it = iter(leaves)
    pl = [None if t is None else next(it) for t in (xw, h0, c0, w, b)]
    outs = R.rnn_scan_plain(mode, *pl, reverse=reverse)
    used = [(o, ups[k]) for o, k in zip(outs, ("dy", "dhT", "dcT"))
            if o is not None and ups.get(k) is not None]
    want = torch.autograd.grad([o for o, _ in used], leaves,
                               [u for _, u in used])
    mine = [dxw, dh0] + ([dc0] if mode == "lstm" else []) + [dw] \
        + ([db] if b is not None else [])
    for i, (a, e) in enumerate(zip(mine, want)):
        assert float((a - e).abs().max()) <= 1e-4 * max(
            1.0, float(e.abs().max())), i
    assert _replays_equal(lambda: R.rnn_backward(*args))


# (shape, blocks a cluster the forward's plan gives): one block a channel
# (7 x 7, N of no special size, many channels of two values; S odd, even,
# a multiple of 4 and of 8), a cluster of 2 (N odd), of 8
_BN_FWD_CLUSTER = [((6, 5, 7, 7), 1), ((37, 11, 5, 5), 1),
                   ((13, 10, 3, 4), 1), ((1, 2048, 2, 1), 1),
                   ((9, 6, 14, 14), 1), ((75, 3, 28, 28), 2),
                   ((77, 2, 56, 56), 8)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape,cs", _BN_FWD_CLUSTER,
                         ids=lambda v: str(v).replace(" ", ""))
@pytest.mark.parametrize("form", ["plain", "relu", "residual_relu"])
@pytest.mark.parametrize("round_x", [False, True])
def test_batch_norm_cluster_forward_matches_plain(dev, dtype, shape, cs,
                                                  form, round_x):
    """The forward cluster kernel (x read once into shared memory, the mean
    and then M2 about it summed in a fixed order, across a cluster
    through distributed shared memory) against the plain formula and the
    Triton kernels on the same inputs, training, out in fp32 (amp O1's)
    or x's dtype: y within the plain version's tolerances, the saved
    (mean, rstd) and the running statistics within 2e-5 of the Triton
    kernels'; the plan's route, one launch, on the cluster kernel; two
    calls and graph replays bit-equal."""
    from paddle_tpu_torch.kernels import batch_norm as BN
    x, res, w, b, _, stats = _bn_inputs(dev, dtype, shape, False, seed=6)
    res = res if form == "residual_relu" else None
    relu = form != "plain"
    out_dtype = torch.float32 if res is not None or round_x else dtype
    plan = BN.batch_norm_forward_plan(
        shape[0], shape[1], shape[2] * shape[3], False, dtype, True,
        _sms(dev))
    assert plan[:2] == ("cluster", cs)
    args = (True, 0.9, 1e-5, False, res, relu, round_x, out_dtype)

    def forward(rm, rv):
        return BN.batch_norm_forward(x, w, b, rm, rv, *args)
    rm, rv = (t.clone() for t in stats)
    before = (K.LAUNCHES["batch_norm"], K.LAUNCHES["batch_norm_cluster"])
    y, st = forward(rm, rv)
    torch.cuda.synchronize()
    assert (K.LAUNCHES["batch_norm"] - before[0],
            K.LAUNCHES["batch_norm_cluster"] - before[1]) == (1, 1)
    rm2, rv2 = (t.clone() for t in stats)
    y2, st2 = forward(rm2, rv2)
    assert all(torch.equal(a, c) for a, c in
               ((y, y2), (st, st2), (rm, rm2), (rv, rv2)))
    tm, tv = (t.clone() for t in stats)
    ty = torch.empty_like(y)
    tst = torch.empty_like(st)
    BN._triton_forward(x, w, b, tm, tv, True, 0.9, 1e-5, False, res, relu,
                       round_x, ty, tst)
    for a, c in ((st[0], tst[0]), (st[1], tst[1]), (rm, tm), (rv, tv)):
        assert float((a - c).abs().max()) <= 2e-5 * max(
            1.0, float(c.abs().max()))
    pm, pv = (t.clone() for t in stats)
    plain = BN.batch_norm_plain(x, pm, pv, w, b, *args)
    if res is not None or round_x:
        # the norm may round to x's dtype one ulp of its value apart
        tol = 2.0 ** -7 * float(plain.float().abs().max()) \
            + 2e-5 * max(1.0, float(plain.abs().max()))
        assert float((y.float() - plain.float()).abs().max()) <= tol
    else:
        _gn_close(y, plain, y.dtype, 1)
    assert _replays_equal(lambda: forward(rm.clone(), rv.clone()))


# -- the redesigned LayerNorm and GroupNorm backwards --------------------------

# (rows, n): each model's LayerNorm widths (ERNIE's and GPT's 768, the UNet's
# 320, 640 and 1280, Transformer-base's 512) and the present test's shapes
_LN_WARP_SHAPES = [(4096, 320), (4096, 512), (2048, 640), (16384, 768),
                   (1024, 1280), (256, 1280), (7, 64), (15, 768)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rows,n", _LN_WARP_SHAPES)
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_layer_norm_warp_backward_matches_plain(dev, dtype, rows, n, p):
    """The CUDA LayerNorm backward (a warp a row) at the models' widths:
    dx, dh and the three vector gradients within the plain autograd's
    tolerance (as ``test_dropout_add_layer_norm_matches_plain``), one call
    counted once and on the CUDA kernel, two calls and a graph replay
    bit-equal, and the Triton route within the same tolerance."""
    from paddle_tpu_torch.kernels import dropout as D
    x, r, b, w, nb, dy = _dln_inputs(dev, dtype, (rows, n))
    key = _rk(torch.tensor([99, 1], device=dev), 4) if p else None
    _, h = fused.dropout_add_layer_norm_forward(x, w, nb, 1e-5, r, b, p, key)
    assert fused.layer_norm_backward_plan(rows, n, dtype, 132).route \
        == "warp"
    before = (K.LAUNCHES["dropout_add_ln_bwd"],
              K.LAUNCHES["dropout_add_ln_bwd_warp"])
    got = fused.dropout_add_layer_norm_backward(h, w, dy, 1e-5, p, key)
    torch.cuda.synchronize()
    assert (K.LAUNCHES["dropout_add_ln_bwd"] - before[0],
            K.LAUNCHES["dropout_add_ln_bwd_warp"] - before[1]) == (1, 1)
    again = fused.dropout_add_layer_norm_backward(h, w, dy, 1e-5, p, key)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    dh_t = torch.empty_like(h)
    dx_t = torch.empty_like(h) if p else dh_t
    sums = torch.empty(3 * n, device=dev)
    fused._triton_backward(h, w, dy, dh_t, dx_t, sums, 1e-5, p, key,
                           "upscale_in_train",
                           fused._triton_plan(rows, n, 132))
    tri = (dx_t, dh_t, sums[:n], sums[n:2 * n], sums[2 * n:])
    assert K.LAUNCHES["dropout_add_ln_bwd_warp"] - before[1] == 2
    leaves = [t.clone().requires_grad_() if t is not None else None
              for t in (x, r, b, w, nb)]
    lx, lr, lb, lw, lnb = leaves
    fused.dropout_add_layer_norm_plain(lx, lw, lnb, 1e-5, lr, lb, p,
                                       key).backward(dy)
    dx, dh, dw, dnb, db = got
    for a, c in ((dx, lx.grad), (dh, lr.grad), (dw.to(dtype), lw.grad),
                 (dnb.to(dtype), lnb.grad), (db.to(dtype), lb.grad)):
        _close(a, c, dtype)
    for a, c in zip(got, tri):
        _close(a.to(dtype), c.to(dtype), dtype)
    if p:
        keep = D.keep_mask_plain((rows, n), p, key, dev)
        assert torch.equal(dx != 0, keep & (dh != 0))
    assert _replays_equal(lambda: fused.dropout_add_layer_norm_backward(
        h, w, dy, 1e-5, p, key))


@pytest.mark.parametrize("start,count", [(0, 4096), (8 * 768, 768),
                                         (4, 1001), (2 ** 33, 64),
                                         (2 ** 34 + 8, 77), (2 ** 36, 130)])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_cuda_keep_mask_is_the_plain_mask(dev, start, count, p):
    """The CUDA LayerNorm backward's Philox4x32-10 draws
    ``dropout.keep_mask_plain``'s bits, a block a thread as the kernel's
    rows (whose starts are multiples of 8), past 2^34 elements too, where
    the block's counter takes its second word; the dense attention's CUDA
    forward (the same ``csrc/philox_common.cuh``) draws them too, over the
    windows a call can hold (up to 2^20 elements). Rows off a multiple of 8
    (the unaligned layout) take the Triton kernel, which
    ``test_dropout_add_layer_norm_matches_plain`` holds at width 130."""
    from paddle_tpu_torch.kernels import dropout as D
    key = _rk(torch.tensor([12345, 678], device=dev), 9)
    if start + count <= 1 << 20:
        want = D.keep_mask_plain((start + count,), p, key, dev)[start:]
    else:      # the window alone, by the plain version's Philox
        e = torch.arange(start, start + count, device=dev)
        grp = e >> 2
        words = torch.stack(D.philox_plain(
            grp & D.M32, grp >> 32, torch.full_like(grp, 9),
            torch.zeros_like(grp), 12345, 678), dim=-1)
        want = (words.gather(1, (e & 3)[:, None])[:, 0] >> 8) \
            >= D.threshold(p)
    assert torch.equal(fused.keep_mask_cuda(count, p, key, start), want)
    if start + count <= 1 << 20:
        # the dense attention's CUDA forward draws the same words: on equal
        # scores every probability is 1 / 64, so the kept ones are the
        # dropped probs that are not 0
        from paddle_tpu_torch.kernels import dense_attention as DA
        rows = -(-(start + count) // 64)
        before = K.LAUNCHES["dense_softmax_cuda"]
        _, dropped = DA.dense_softmax_forward(
            torch.zeros(1, 1, rows, 64, device=dev), p=p, key=key)
        assert K.LAUNCHES["dense_softmax_cuda"] == before + 1
        assert torch.equal(dropped.reshape(-1)[start:start + count] != 0,
                           want)


def test_layer_norm_functional_backward_takes_the_warp_kernel(dev):
    """``nn.functional.layer_norm``'s backward at a model's width runs the
    CUDA kernel once a call; a width off a multiple of 8 runs the Triton
    kernel."""
    from paddle_tpu_torch.nn import functional as F
    for n, warp in ((768, 1), (130, 0)):
        x = torch.randn(64, n, device=dev, requires_grad=True)
        w = (1 + 0.1 * torch.randn(n, device=dev)).requires_grad_()
        before = (K.LAUNCHES["dropout_add_ln_bwd"],
                  K.LAUNCHES["dropout_add_ln_bwd_warp"])
        F.layer_norm(x, [n], w, None, 1e-5).sum().backward()
        assert (K.LAUNCHES["dropout_add_ln_bwd"] - before[0],
                K.LAUNCHES["dropout_add_ln_bwd_warp"] - before[1]) == (1, warp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,n,p", [(16384, 768, 0.1), (4096, 320, 0.0),
                                      (4096, 512, 0.1), (1024, 1280, 0.0),
                                      (15, 768, 0.1), (300, 136, 0.1)])
def test_layer_norm_split_sums_are_the_kernels(dev, dtype, rows, n, p):
    """``layer_norm_column_sums_split_plain`` on the kernel's own addends
    (dy; dx) gives the CUDA kernel's dnorm_bias and dbias bit for bit: the
    order of its column sums. dweight's addends (dy x-hat) are the
    kernel's fp32 arithmetic (fused multiply-adds): the emulation's
    dweight is within 1e-5 of the sum of its terms' magnitudes."""
    x, r, b, w, nb, dy = _dln_inputs(dev, dtype, (rows, n))
    key = _rk(torch.tensor([99, 1], device=dev), 4) if p else None
    _, h = fused.dropout_add_layer_norm_forward(x, w, nb, 1e-5, r, b, p, key)
    plan = fused.layer_norm_backward_plan(rows, n, dtype, K.sm_count(dev))
    assert plan.route == "warp"
    dx, _, dw, dnb, db = fused.dropout_add_layer_norm_backward(
        h, w, dy, 1e-5, p, key)
    sums = fused.layer_norm_column_sums_split_plain(
        torch.stack([dy.float(), dx.float()]), plan)
    assert torch.equal(sums[0], dnb) and torch.equal(sums[1], db)
    emu = fused.layer_norm_backward_split_plain(h, w, dy, 1e-5, plan, p,
                                                key)[0]
    hd = h.double()
    xh = (hd - hd.mean(-1, keepdim=True)) / torch.sqrt(
        hd.var(-1, unbiased=False, keepdim=True) + 1e-5)
    mag = (dy.double().abs() * xh.abs()).sum(0)
    assert bool(((dw.double() - emu.double()).abs() <= 1e-5 * mag
                 + 1e-30).all())


@pytest.mark.parametrize("shape", [(4, 960, 64, 64), (4, 320, 64, 64),
                                   (4, 2560, 8, 8), (2, 640, 32, 32),
                                   (3, 96, 16, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_group_norm_split_sums_are_the_kernels(dev, shape):
    """``group_norm_column_sums_split_plain`` on the kernel's own addends
    (dy, without the SiLU) gives the cluster kernel's dbias bit for bit:
    the order of its sums over a channel's threads, the cluster's ranks
    and the samples. dweight's addends (dy x-hat) are the kernel's fp32
    arithmetic (fused multiply-adds, the forward's statistics): the
    emulation's dweight is within 1e-5 of the sum of its terms'
    magnitudes."""
    from paddle_tpu_torch.kernels import group_norm as GN
    x, w, b, dy = _gn_inputs(dev, torch.bfloat16, shape)
    n, c = shape[:2]
    s = x.numel() // (n * c)
    plan = GN.group_norm_backward_plan(c // 32, s, False, torch.bfloat16)
    assert plan.route == "cluster"
    _, stats = GN.group_norm_forward(x, w, b, 32, 1e-5, False, False)
    before = K.LAUNCHES["group_norm_bwd_cluster"]
    _, dw, db = GN.group_norm_backward(x, w, b, stats, dy, 32, False, False)
    assert K.LAUNCHES["group_norm_bwd_cluster"] - before == 1
    assert torch.equal(db, GN.group_norm_column_sums_split_plain(
        dy.float().reshape(n, c, s), 32, plan.cs))
    emu = GN.group_norm_backward_split_plain(x, 32, w, b, dy, plan.cs)[0]
    xd = x.double().reshape(n, 32, -1)
    xh = ((xd - xd.mean(-1, keepdim=True)) / torch.sqrt(
        xd.var(-1, unbiased=False, keepdim=True) + 1e-5)).reshape(n, c, s)
    mag = (dy.double().reshape(n, c, s).abs() * xh.abs()).sum((0, 2))
    assert bool(((dw.double() - emu.double()).abs() <= 1e-5 * mag
                 + 1e-30).all())


# the UNet's GroupNorm shapes at batch 4 (the largest and the widest) and
# the present test's
_GN_CLUSTER_SHAPES = [(4, 960, 64, 64), (4, 2560, 8, 8), (4, 320, 64, 64),
                      (4, 1920, 32, 32), (4, 2560, 16, 16), (2, 1280, 8, 8),
                      (2, 640, 32, 32), (3, 96, 16, 8)]


@pytest.mark.parametrize("shape", _GN_CLUSTER_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_cluster_backward_matches_plain(dev, shape, dtype, silu):
    """The cluster GroupNorm backward: on its route (one call counted once
    and on the cluster kernel), dx, dweight and dbias against the plain
    autograd (each row within 2 ulps of its largest value, as
    ``test_group_norm_matches_plain``) and against the Triton kernels (the
    same tolerance), two calls and a graph replay bit-equal."""
    from paddle_tpu_torch.kernels import group_norm as GN
    x, w, b, dy = _gn_inputs(dev, dtype, shape)
    n, c = shape[:2]
    s = x.numel() // (n * c)
    assert GN.group_norm_backward_plan(c // 32, s, False, dtype).route \
        == "cluster"
    _, stats = GN.group_norm_forward(x, w, b, 32, 1e-5, False, silu)
    before = (K.LAUNCHES["group_norm_bwd"],
              K.LAUNCHES["group_norm_bwd_cluster"])
    got = GN.group_norm_backward(x, w, b, stats, dy, 32, False, silu)
    torch.cuda.synchronize()
    assert (K.LAUNCHES["group_norm_bwd"] - before[0],
            K.LAUNCHES["group_norm_bwd_cluster"] - before[1]) == (1, 1)
    again = GN.group_norm_backward(x, w, b, stats, dy, 32, False, silu)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    tri = (torch.empty_like(x), torch.zeros(2 * c, device=dev))
    GN._triton_backward(x, w, b, stats, dy, 32, False, silu, *tri)
    tri = (tri[0], tri[1][:c], tri[1][c:])
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    GN.group_norm_plain(leaves[0], 32, leaves[1], leaves[2], 1e-5, False,
                        silu).backward(dy)
    for a, pl, t in zip(got, leaves, tri):
        _gn_close(a.to(dtype), pl.grad, dtype, 2)
        _gn_close(a.to(dtype), t.to(dtype), dtype, 2)
    assert _replays_equal(lambda: GN.group_norm_backward(
        x, w, b, stats, dy, 32, False, silu))


@pytest.mark.parametrize("shape", [(4, 320, 64, 64), (4, 960, 64, 64),
                                   (2, 1280, 8, 8)])
def test_group_norm_cluster_fused_silu_is_bit_equal_to_the_o2_ops(dev, shape):
    """Under ``amp.auto_cast(level="O2")`` on the cluster kernels, the
    fused SiLU's output and gradients (dz drawn in the kernel, rounded where
    PyTorch's SiLU backward rounds) equal the separate ops' bit for bit:
    the same plans whatever the output's and dy's dtypes (dz is kept in
    fp32)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import functional as F
    x, w, b, dy = _gn_inputs(dev, torch.bfloat16, shape)
    fused_in = [t.clone().requires_grad_() for t in (x, w, b)]
    sep_in = [t.clone().requires_grad_() for t in (x, w, b)]
    before = (K.LAUNCHES["group_norm_cluster"],
              K.LAUNCHES["group_norm_bwd_cluster"])
    with amp.auto_cast(level="O2"):
        y = F.group_norm(fused_in[0], 32, 1e-5, fused_in[1], fused_in[2],
                         then="silu")
        want = F.silu(F.group_norm(sep_in[0], 32, 1e-5, sep_in[1],
                                   sep_in[2]))
    y.backward(dy)
    want.backward(dy)
    torch.cuda.synchronize()
    assert (K.LAUNCHES["group_norm_cluster"] - before[0],
            K.LAUNCHES["group_norm_bwd_cluster"] - before[1]) == (2, 2)
    assert torch.equal(y, want), int((y != want).sum())
    for a, c in zip(fused_in, sep_in):
        assert torch.equal(a.grad, c.grad)


# -- GroupNorm's cluster forward, X2's CUDA forward -----------------------------

@pytest.mark.parametrize("shape", _GN_CLUSTER_SHAPES + [(2, 6, 16, 16)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_group_norm_cluster_forward_matches_plain(dev, shape, dtype):
    """The cluster GroupNorm forward, on its route (counted once and on
    the cluster kernel), with and without the SiLU: y against the plain
    formula (each row within one ulp of its largest value, two with the
    SiLU) and against the Triton kernels (the same tolerance); its
    statistics bit-equal to ``group_stats_cluster_plain``'s (rstd its fp32
    ``1 / sqrt(var + eps)`` on the card); two calls and a graph replay
    bit-equal; the
    cluster backward on these statistics against the plain gradients (two
    ulps). (2, 6, 16, 16) is instance norm's one channel a group."""
    from paddle_tpu_torch.kernels import group_norm as GN
    groups = 32 if shape[1] % 32 == 0 else shape[1]
    x, w, b, dy = _gn_inputs(dev, dtype, shape)
    n, c = shape[:2]
    s = x.numel() // (n * c)
    plan = GN.group_norm_forward_plan(c // groups, s, False, dtype)
    assert plan.route == "cluster"
    mean, var = GN.group_stats_cluster_plain(x, groups, plan.cs)
    for silu in (False, True):
        before = (K.LAUNCHES["group_norm"], K.LAUNCHES["group_norm_cluster"])
        y, stats = GN.group_norm_forward(x, w, b, groups, 1e-5, False, silu)
        torch.cuda.synchronize()
        assert (K.LAUNCHES["group_norm"] - before[0],
                K.LAUNCHES["group_norm_cluster"] - before[1]) == (1, 1)
        # fp32 ops on the card (the CPU's sqrt may differ in the last bits)
        v = var.reshape(-1)
        rstd = torch.ones_like(v) / torch.sqrt(v + torch.full_like(v, 1e-5))
        assert torch.equal(stats[:, 0], mean.reshape(-1)), int(
            (stats[:, 0] != mean.reshape(-1)).sum())
        assert torch.equal(stats[:, 1], rstd), int((stats[:, 1] != rstd).sum())
        y2, stats2 = GN.group_norm_forward(x, w, b, groups, 1e-5, False,
                                           silu)
        assert torch.equal(y, y2) and torch.equal(stats, stats2)
        ulps = 2 if silu else 1
        _gn_close(y, GN.group_norm_plain(x, groups, w, b, 1e-5, False, silu),
                  dtype, ulps)
        ty, ts = torch.empty_like(x), torch.empty_like(stats)
        GN._triton_forward(x, w, b, ty, ts, groups, 1e-5, False, silu)
        _gn_close(y, ty, dtype, ulps)
        assert _replays_equal(lambda: GN.group_norm_forward(
            x, w, b, groups, 1e-5, False, silu))
    got = GN.group_norm_backward(x, w, b, stats, dy, groups, False, True)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    GN.group_norm_plain(leaves[0], groups, leaves[1], leaves[2], 1e-5,
                        False, True).backward(dy)
    for a, pl in zip(got, leaves):
        _gn_close(a.to(dtype), pl.grad, dtype, 2)


def test_group_norm_cluster_forward_without_affine_and_out_dtype(dev):
    """No weight and no bias (fp32 ones and zeros stand in), and a bf16 x
    written in fp32, bf16 and fp16, with and without the SiLU, on the
    cluster kernel: the same statistics whatever the output's dtype, fp32
    within 2e-5 of the largest value, 16 bits one ulp of each row's largest
    (two with the SiLU)."""
    from paddle_tpu_torch.kernels import group_norm as GN
    x, _, _, _ = _gn_inputs(dev, torch.bfloat16, (2, 64, 16, 16),
                            affine=False)
    before = K.LAUNCHES["group_norm_cluster"]
    stats = []
    for od in (torch.float32, torch.bfloat16, torch.float16):
        for silu in (False, True):
            got = GN.group_norm(x, 8, out_dtype=od, silu=silu)
            want = GN.group_norm_plain(x, 8, out_dtype=od, silu=silu)
            assert got.dtype == od
            _gn_close(got, want, od, 2 if silu else 1)
            w = torch.ones(64, device=dev)
            stats.append(GN.group_norm_forward(x, w, torch.zeros_like(w), 8,
                                               out_dtype=od, silu=silu)[1])
    assert K.LAUNCHES["group_norm_cluster"] - before == 12
    assert all(torch.equal(stats[0], t) for t in stats)


def test_group_norm_cluster_kernels_launch_from_threads(dev):
    """The cluster forward and backward launched from 6 host threads at
    once, 20 rounds each, at three shapes whose blocks take different
    shared memory on the same kernel (bf16 with the SiLU): every launch
    succeeds and gives the bits of the same call made alone. The kernels'
    shared memory limit is the function's, so a limit set per launch let
    one thread's smaller size land between another's setting and its
    launch (invalid argument)."""
    from concurrent.futures import ThreadPoolExecutor
    from paddle_tpu_torch.kernels import group_norm as GN
    shapes = [(4, 320, 64, 64), (4, 960, 64, 64), (4, 1280, 8, 8)]
    smems = {GN.group_norm_forward_plan(s[1] // 32, s[2] * s[3], False,
                                        torch.bfloat16).smem for s in shapes}
    assert len(smems) == 3
    inputs = [_gn_inputs(dev, torch.bfloat16, s) for s in shapes]

    def run(i):
        x, w, b, dy = inputs[i]
        y, stats = GN.group_norm_forward(x, w, b, 32, 1e-5, False, True)
        dx = GN.group_norm_backward(x, w, b, stats, dy, 32, False, True)[0]
        torch.cuda.current_stream().synchronize()
        return y, stats, dx

    alone = [run(i) for i in range(len(shapes))]
    with ThreadPoolExecutor(6) as ex:
        got = list(ex.map(run, [k % len(shapes) for k in range(120)]))
    for k, outs in enumerate(got):
        for a, want in zip(outs, alone[k % len(shapes)]):
            assert torch.equal(a, want), k


def test_group_norm_forward_takes_triton_off_its_plan(dev):
    """NHWC, fp32, a spatial size off a multiple of 8 and an x not 16-byte
    aligned take the Triton kernels (not counted on the cluster kernel);
    the cluster kernel itself raises on a spatial size it cannot take."""
    from paddle_tpu_torch.kernels import group_norm as GN
    before = K.LAUNCHES["group_norm_cluster"]
    for dtype, shape, last in ((torch.float32, (2, 64, 8, 8), False),
                               (torch.bfloat16, (2, 8, 8, 64), True),
                               (torch.bfloat16, (2, 64, 5, 7), False)):
        x = torch.randn(shape, device=dev).to(dtype)
        GN.group_norm_forward(x, torch.ones(64, device=dev),
                              torch.zeros(64, device=dev), 8, 1e-5, last)
    off = torch.randn(2 * 64 * 64 + 1, device=dev).bfloat16()[1:].view(
        2, 64, 8, 8)
    y, _ = GN.group_norm_forward(off, torch.ones(64, device=dev),
                                 torch.zeros(64, device=dev), 8)
    _gn_close(y, GN.group_norm_plain(off, 8), torch.bfloat16, 1)
    assert K.LAUNCHES["group_norm_cluster"] == before
    x = torch.randn(2, 64, 5, 7, device=dev).bfloat16()
    stats = torch.empty(16, 2, device=dev)
    with pytest.raises(RuntimeError, match="group_norm_fwd cluster kernel"):
        GN._cluster_forward(x, torch.ones(64, device=dev),
                            torch.zeros(64, device=dev), torch.empty_like(x),
                            stats, 8, 1e-5, False, GN.GnFwdPlan("cluster", 1,
                                                                4096))


@pytest.mark.parametrize("form", X2_FORMS,
                         ids=lambda f: "none" if f is None else "-".join(f))
@pytest.mark.parametrize("causal,sq,sk,p", [
    (False, 64, 64, 0.1), (True, 64, 64, 0.1), (True, 40, 128, 0.0),
    (True, 70, 32, 0.1), (False, 9, 20, 0.5), (False, 33, 128, 0.1),
    (True, 17, 256, 0.1), (False, 5, 200, 0.1)])
def test_dense_softmax_cuda_forward_matches_plain(dev, form, causal, sq, sk,
                                                  p):
    """X2's CUDA forward on its route (counted once, on the CUDA kernel):
    the probs element by element within 2e-5 of their size against the
    plain version and the Triton kernel; its keep mask
    ``keep_mask_plain``'s bit for bit (the dropped probs its probs under
    it); the Triton backward on its output against the plain version's
    autograd; rows without a key (causal with sq > sk), rows of 20 keys
    (8 lanes) and of 200 and 256 (two chunks a lane, the second partly
    past the row), every mask form through its strides."""
    from paddle_tpu_torch.framework.random import RandomKey
    from paddle_tpu_torch.kernels import dense_attention as DA
    from paddle_tpu_torch.kernels import dropout as D
    b, h = 2, 3
    assert DA.dense_softmax_forward_plan(sk) == "cuda"
    g = torch.Generator(device=dev).manual_seed(sq + sk + 1)
    scores = torch.randn(b, h, sq, sk, device=dev, generator=g) * 4
    gy = torch.randn(b, h, sq, sk, device=dev, generator=g)
    mask = _x2_mask(dev, form, b, h, sq, sk, sk)
    key = RandomKey(torch.tensor([5, 6], device=dev), 9) if p else None
    before = (K.LAUNCHES["dense_softmax"], K.LAUNCHES["dense_softmax_cuda"])
    probs, dropped = DA.dense_softmax_forward(scores, mask, causal, 0.3, p,
                                              key)
    assert (K.LAUNCHES["dense_softmax"] - before[0],
            K.LAUNCHES["dense_softmax_cuda"] - before[1]) == (1, 1)
    pp, _ = DA.dense_softmax_plain(scores, mask, causal, 0.3, p, key)
    _x2_close(probs, pp, pp.abs())
    args = (*DA._mask_args(mask, scores.shape, dev), causal, 0.3,
            *DA._drop_args(p, key, scores.device))
    tp = torch.empty_like(scores)
    td = torch.empty_like(scores) if p else tp
    DA._triton_forward(scores, *args, tp, td)
    _x2_close(probs, tp, tp.abs())
    scale = D.scale_of(p, "upscale_in_train") if p else 1.0
    if p:
        keep = D.keep_mask_plain(tuple(scores.shape), p, key, dev)
        assert torch.equal(dropped, torch.where(
            keep, probs * scale, torch.zeros((), device=dev)))
        assert torch.equal(td != 0, keep & (tp != 0))
    ds, _ = DA.dense_softmax_backward(gy, probs, mask, causal, 0.3, p, key)
    sp = scores.clone().requires_grad_()
    (want_ds,) = torch.autograd.grad(
        DA.dense_softmax_plain(sp, mask, causal, 0.3, p, key)[1], sp, gy)
    gp = gy * (dropped != 0) * scale
    size = probs * (gp.abs() + (gp.abs() * probs).sum(-1, keepdim=True))
    _x2_close(ds, want_ds, 0.3 * size)
    again = DA.dense_softmax_forward(scores, mask, causal, 0.3, p, key)
    assert torch.equal(probs, again[0]) and torch.equal(dropped, again[1])


def test_dense_softmax_cuda_forward_replays_with_new_keys(dev):
    """Transformer-base's decoder middle ([64, 8, 64, 64], the additive
    [64, 1, 64, 64] mask, p 0.1) on the CUDA forward, captured with its
    Triton backward in a CUDA graph: replays with a new key and new scores
    equal eager calls bit for bit."""
    from paddle_tpu_torch.framework.random import RandomKey
    from paddle_tpu_torch.kernels import dense_attention as DA
    g = torch.Generator(device=dev).manual_seed(8)
    scores = torch.randn(64, 8, 64, 64, device=dev, generator=g)
    mask = torch.triu(torch.full((64, 64), -1e9, device=dev), 1) \
        + torch.randn(64, 1, 64, 64, device=dev, generator=g)
    gy = torch.randn(64, 8, 64, 64, device=dev, generator=g)
    keyt = torch.tensor([1, 2], device=dev)

    def step():
        s = scores.clone().requires_grad_()
        y = DA.dense_softmax(s, mask, False, 0.125, 0.1, RandomKey(keyt, 3))
        return y, torch.autograd.grad(y, s, gy)[0]
    before = K.LAUNCHES["dense_softmax_cuda"]
    a = step()
    assert K.LAUNCHES["dense_softmax_cuda"] == before + 1
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_cap, d_cap = step()
    for words in ((7, 8), (2 ** 32 - 1, 5)):
        keyt.copy_(torch.tensor(words))
        scores.copy_(torch.randn(scores.shape, device=dev, generator=g))
        graph.replay()
        y, d = step()
        torch.cuda.synchronize()
        assert torch.equal(y_cap, y) and torch.equal(d_cap, d)
    assert not torch.equal(a[0], y)
