"""Drive paddle_tpu_torch's serving path on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--seed N] [--out DIR]

Phases, each printing its own lines:
  1. the card (nvidia-smi name and power limit) and the versions;
  2. the build: every CUDA source compiled by nvcc for sm_90a, the Triton
     kernels compiled by their first launch;
  3. every kernel against its plain PyTorch version on the card, at the
     shapes the serving path gives it, with its time, its bound and a
     single PyTorch call for the same function where there is one; then
     a tiny float32 Llama served on the card must return the CPU engine's
     greedy tokens;
  4. Llama-2-7B at full width in bf16 (random weights from a seeded
     generator) served by the continuous-batching engine: the launch
     counts are zeroed just before and read just after, every request
     must return all its tokens, and one ragged step through the kernels
     must agree with the same step through the plain versions (in bf16
     and in float32);
  5. a JSON line of every kernel, the card line again, and the final
     {"ok": true, ...} line.
Any failure raises and exits non-zero. Without a CUDA device it exits
non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from contextlib import ExitStack
from unittest import mock

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS = 67e12              # H100 SXM fp32 outside the tensor cores
ULP_BF16 = 2.0 ** -7            # one bf16 ulp, relative
JSON_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters=20, reps=5):
    """Device time of one call: ``iters`` calls captured in a CUDA graph,
    replayed ``reps`` times between CUDA events, so the host's launch
    cost is not in the number (eager back-to-back launches of a kernel
    this short measure the host instead)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * iters)
    del graph
    return ms


def _bound(nbytes, flops, peak_flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _check(name, got, want, tol):
    err = float((got.float() - want.float()).abs().max())
    ok = math.isfinite(err) and err <= tol
    print(f"  {name}: max_abs_err={err:.6g} tol={tol:.6g} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({err} > {tol})")
    return err


# -- phase 3: kernels against their plain versions ------------------------------

def _ragged_case(torch, dev, kvh, contexts, chunk, budget, seed, bs=16,
                 heads=32, d=128):
    """A packed step at the engine's shapes: one decode token per context
    in ``contexts``, then ``chunk`` prefill tokens of a sequence whose
    chunk ends at the last context, padded with invalid rows to
    ``budget`` rows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n_slots = len(contexts)
    mp = max(-(-c // bs) for c in contexts)
    tables = torch.full((n_slots, mp), -1, dtype=torch.int32)
    perm = torch.randperm(sum(-(-c // bs) for c in contexts),
                          generator=torch.Generator().manual_seed(seed))
    nxt = 0
    for s, c in enumerate(contexts):
        n = -(-c // bs)
        tables[s, :n] = perm[nxt:nxt + n].to(torch.int32)
        nxt += n
    p_total = nxt
    slot, pos = [], []
    for s, c in enumerate(contexts[:-1] if chunk else contexts):
        slot.append(s)
        pos.append(c - 1)
    if chunk:
        last = contexts[-1]
        slot += [n_slots - 1] * chunk
        pos += list(range(last - chunk, last))
    n_valid = len(slot)
    slot += [0] * (budget - n_valid)
    pos += [0] * (budget - n_valid)
    valid = [True] * n_valid + [False] * (budget - n_valid)
    dt = torch.bfloat16
    q = torch.randn(budget, heads, d, device=dev, generator=g).to(dt)
    kp = torch.randn(p_total, kvh, bs, d, device=dev, generator=g).to(dt)
    vp = torch.randn(p_total, kvh, bs, d, device=dev, generator=g).to(dt)
    args = (q, kp, vp, tables.to(dev), torch.tensor(slot, dtype=torch.int32,
                                                    device=dev),
            torch.tensor(pos, dtype=torch.int32, device=dev),
            torch.tensor(valid, device=dev))
    # bytes the function must move: q of the valid rows, the output of
    # every row, the pages the valid tokens can see (each once) and their
    # table entries, positions and valid of every row, slot ids of the
    # valid rows; flops: q.k and p.v over every visible slot of every
    # valid token
    seen = set()
    flops = 0
    for s_i, p_i in zip(slot[:n_valid], pos[:n_valid]):
        cols = p_i // bs + 1
        seen.update(int(x) for x in tables[s_i, :cols])
        flops += 4 * heads * d * (p_i + 1)
    q_row = heads * d * 2
    nbytes = (q_row * (n_valid + budget) + len(seen) * (2 * kvh * bs * d * 2
                                                        + 4)
              + budget * 5 + n_valid * 4)
    return args, heads // kvh, nbytes, flops


def _sdpa_yardstick(torch, args, rep):
    """F.scaled_dot_product_attention over K/V gathered per valid token
    (gathered outside the timed call). Used only as a yardstick."""
    import torch.nn.functional as F
    q, kp, vp, tables, slot, pos, valid = args
    bs = kp.shape[2]
    rows = torch.nonzero(valid).squeeze(1)
    length = (int(pos[rows].max()) // bs + 1) * bs
    tab = tables[slot[rows].long()][:, :length // bs].long().clamp(min=0)
    kg = kp[tab].permute(0, 2, 1, 3, 4).flatten(2, 3)   # [n, kvh, L, D]
    vg = vp[tab].permute(0, 2, 1, 3, 4).flatten(2, 3)
    if rep > 1:
        kg = kg.repeat_interleave(rep, dim=1)
        vg = vg.repeat_interleave(rep, dim=1)
    mask = (torch.arange(length, device=q.device)[None, :]
            <= pos[rows, None])[:, None, None, :]
    qq = q[rows][:, :, None, :]

    def call():
        return F.scaled_dot_product_attention(qq, kg, vg, attn_mask=mask)
    ms = _graph_ms(call, iters=5)
    del kg, vg
    return ms


def phase_kernels(torch, results):
    from paddle_tpu_torch.kernels import fused
    from paddle_tpu_torch.kernels.ragged_attention import (
        ragged_attention, ragged_attention_plain)
    dev = torch.device("cuda")
    budget = 256
    contexts = [97, 300, 511, 803, 1024, 1500, 1801, 2040]
    cases = {
        "decode_mha": dict(kvh=32, contexts=contexts, chunk=0),
        "decode_gqa": dict(kvh=8, contexts=contexts, chunk=0),
        "mixed_mha": dict(kvh=32, contexts=contexts[:7] + [960], chunk=249),
    }
    print("phase 3: kernels against their plain versions (bf16; tolerance "
          "one bf16 ulp of the largest reference value, 2^-7 of it)",
          flush=True)
    for i, (case, spec) in enumerate(cases.items()):
        args, rep, nbytes, flops = _ragged_case(torch, dev, budget=budget,
                                                seed=10 + i, **spec)
        got = ragged_attention(*args, rep=rep)
        torch.cuda.synchronize()
        want = ragged_attention_plain(*args, rep=rep)
        err = _check(f"ragged_attention[{case}]", got, want,
                     ULP_BF16 * float(want.float().abs().max()))
        ms = _graph_ms(lambda: ragged_attention(*args, rep=rep))
        eager_ms = _time_ms(lambda: ragged_attention(*args, rep=rep), 50)
        plain_ms = _time_ms(lambda: ragged_attention_plain(*args, rep=rep), 3,
                            warmup=1)
        lib_ms = _sdpa_yardstick(torch, args, rep)
        bound_ms, bound_by = _bound(nbytes, flops, BF16_FLOPS)
        results[f"ragged_attention[{case}]"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=lib_ms, eager_ms=eager_ms)
        print(f"  ragged_attention[{case}]: ms={ms:.4f} eager_ms="
              f"{eager_ms:.4f} plain_ms="
              f"{plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) "
              f"sdpa_ms={lib_ms:.4f} valid_rows="
              f"{int(args[-1].sum())}/{budget}", flush=True)
        del args, got, want
        torch.cuda.empty_cache()

    g = torch.Generator(device=dev).manual_seed(20)
    hidden, eps = 4096, 1e-5
    x = torch.randn(budget, 1, hidden, device=dev, generator=g) \
        .to(torch.bfloat16)
    r = torch.randn(budget, 1, hidden, device=dev, generator=g) \
        .to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn(hidden, device=dev, generator=g)) \
        .to(torch.bfloat16)
    row_bytes = budget * hidden * 2
    f_rms = getattr(torch.nn.functional, "rms_norm", None)

    got = fused.rms_norm(x, w, eps)
    want = fused.rms_norm_plain(x, w, eps)
    err = _check("rms_norm", got, want, ULP_BF16 * float(want.abs().max()))
    bound_ms, bound_by = _bound(2 * row_bytes + hidden * 2,
                                4 * budget * hidden, FP32_FLOPS)
    results["rms_norm"] = dict(
        max_abs_err=err, ms=_graph_ms(lambda: fused.rms_norm(x, w, eps)),
        eager_ms=_time_ms(lambda: fused.rms_norm(x, w, eps), 200),
        plain_ms=_time_ms(lambda: fused.rms_norm_plain(x, w, eps), 50),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None if f_rms is None else _graph_ms(
            lambda: f_rms(x, (hidden,), w, eps)))

    s, got = fused.add_rms_norm(x, r, w, eps)
    ws, want = fused.add_rms_norm_plain(x, r, w, eps)
    err = max(_check("rms_norm_residual (norm)", got, want,
                     ULP_BF16 * float(want.abs().max())),
              _check("rms_norm_residual (sum)", s, ws, 0.0))
    bound_ms, bound_by = _bound(4 * row_bytes + hidden * 2,
                                5 * budget * hidden, FP32_FLOPS)
    results["rms_norm_residual"] = dict(
        max_abs_err=err,
        ms=_graph_ms(lambda: fused.add_rms_norm(x, r, w, eps)),
        eager_ms=_time_ms(lambda: fused.add_rms_norm(x, r, w, eps), 200),
        plain_ms=_time_ms(lambda: fused.add_rms_norm_plain(x, r, w, eps), 50),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)

    heads, d = 32, 128
    q = torch.randn(1, budget, heads, d, device=dev, generator=g) \
        .to(torch.bfloat16)
    k = torch.randn(1, budget, heads, d, device=dev, generator=g) \
        .to(torch.bfloat16)
    ang = torch.rand(budget, d // 2, device=dev, generator=g) * 2000.0
    cos, sin = torch.cos(ang), torch.sin(ang)
    gq, gk = fused.fused_rope(q, k, cos, sin)
    wq, wk = fused.fused_rope_plain(q, k, cos, sin)
    err = max(_check("rope (q)", gq, wq, ULP_BF16 * float(wq.abs().max())),
              _check("rope (k)", gk, wk, ULP_BF16 * float(wk.abs().max())))
    bound_ms, bound_by = _bound(4 * q.numel() * 2 + 2 * cos.numel() * 4,
                                6 * 2 * q.numel(), FP32_FLOPS)
    results["rope"] = dict(
        max_abs_err=err,
        ms=_graph_ms(lambda: fused.fused_rope(q, k, cos, sin)),
        eager_ms=_time_ms(lambda: fused.fused_rope(q, k, cos, sin), 200),
        plain_ms=_time_ms(lambda: fused.fused_rope_plain(q, k, cos, sin), 50),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    for name in ("rms_norm", "rms_norm_residual", "rope"):
        m = results[name]
        lib = "n/a" if m["library_ms"] is None else f"{m['library_ms']:.4f}"
        print(f"  {name}: ms={m['ms']:.4f} eager_ms={m['eager_ms']:.4f} "
              f"plain_ms={m['plain_ms']:.4f} "
              f"bound_ms={m['bound_ms']:.4f} ({m['bound_by']}) "
              f"library_ms={lib}", flush=True)


def phase_tiny_reference(torch):
    """A tiny float32 Llama: the engine on the card (kernels) must return
    the CPU engine's greedy tokens (plain versions) exactly."""
    import numpy as np
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         load_numpy_state)
    from paddle_tpu_torch.serving import EngineConfig, ServingEngine
    cfg = LlamaConfig.tiny(vocab_size=256, hidden_size=256, layers=2,
                           heads=4, kv_heads=2, seq=256)
    cpu = LlamaForCausalLM(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(7))
    gpu = LlamaForCausalLM(cfg, device="cuda")
    load_numpy_state(gpu, {n: p.detach().numpy()
                           for n, p in cpu.named_parameters()})
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 256, (n,)).tolist()
               for n in (3, 17, 40, 66, 9, 25)]
    ecfg = dict(max_seqs=4, token_budget=32, block_size=16)
    want = ServingEngine(cpu, EngineConfig(**ecfg), device="cpu") \
        .generate_batch(prompts, max_new_tokens=8)
    got = ServingEngine(gpu, EngineConfig(**ecfg), device="cuda") \
        .generate_batch(prompts, max_new_tokens=8)
    same = sum(a == b for a, b in zip(got, want))
    print(f"  tiny f32 Llama on the card vs the CPU engine: {same}/"
          f"{len(prompts)} requests token-identical", flush=True)
    if got != want:
        raise AssertionError(f"GPU tokens {got} != CPU tokens {want}")


# -- phase 4: full-width serving --------------------------------------------------

def _plain_patches(stack):
    """Route the decoder through the plain versions for one comparison
    step (the wrappers would launch the kernels on CUDA tensors)."""
    from paddle_tpu_torch.kernels import fused
    from paddle_tpu_torch.kernels.ragged_attention import \
        ragged_attention_plain
    from paddle_tpu_torch.serving import ragged
    stack.enter_context(mock.patch.object(fused, "rms_norm",
                                          fused.rms_norm_plain))
    stack.enter_context(mock.patch.object(fused, "add_rms_norm",
                                          fused.add_rms_norm_plain))
    stack.enter_context(mock.patch.object(fused, "fused_rope",
                                          fused.fused_rope_plain))
    stack.enter_context(mock.patch.object(ragged, "ragged_attention",
                                          ragged_attention_plain))


def phase_serving(torch, args, launches_out):
    import numpy as np
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import EngineConfig, ServingEngine
    card = _card_line()
    cfg = LlamaConfig.llama2_7b()
    print(f"phase 4: Llama-2-7B width (hidden {cfg.hidden_size}, "
          f"{cfg.num_hidden_layers} layers, {cfg.num_attention_heads} heads, "
          f"vocab {cfg.vocab_size}) bf16, random weights seed {args.seed} "
          f"[{card}]", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    model = LlamaForCausalLM(
        cfg, device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(args.seed))
    torch.cuda.synchronize()
    print(f"  init {time.monotonic() - t0:.2f}s, "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f}B params",
          flush=True)
    ecfg = EngineConfig(max_seqs=8, token_budget=256, block_size=16,
                        max_model_len=2048)
    eng = ServingEngine(model, ecfg)
    rng = np.random.default_rng(args.seed)
    lens = np.linspace(16, 1000, 12).astype(int)
    rng.shuffle(lens)
    prompts = [rng.integers(1, cfg.vocab_size, (n,)).tolist() for n in lens]
    max_new = 32
    eng.generate_batch([list(range(1, 17))], max_new_tokens=2)  # warm-up

    K.reset_launches()
    steps0, fed0, gen0 = eng.steps, eng.tokens_fed, eng.tokens_generated
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    per_step = []
    t_run = time.monotonic()
    while True:
        f0, g0, ts = eng.tokens_fed, eng.tokens_generated, time.monotonic()
        more = eng.step()
        torch.cuda.synchronize()
        per_step.append((eng.tokens_fed - f0, eng.tokens_generated - g0,
                         time.monotonic() - ts))
        if not more:
            break
    t_run = time.monotonic() - t_run
    launches = dict(K.LAUNCHES)
    launches_out.update(launches)
    steps = eng.steps - steps0
    n_l = cfg.num_hidden_layers
    expect = {"ragged_attention": n_l * steps, "rms_norm": (n_l + 1) * steps,
              "rms_norm_residual": n_l * steps, "rope": n_l * steps}
    print(f"  launches over {steps} steps: {launches} (expected {expect})",
          flush=True)
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    outs = [r.result(timeout=0) for r in reqs]
    if any(len(o) != max_new or not all(0 <= t < cfg.vocab_size for t in o)
           for o in outs):
        raise AssertionError("a request did not return all of its tokens")
    fed, gen = eng.tokens_fed - fed0, eng.tokens_generated - gen0
    dec = [(f, g, dt) for f, g, dt in per_step if f and f == g]
    mix = [(f, g, dt) for f, g, dt in per_step if f and f != g]
    dec_tps = sum(g for _, g, _ in dec) / max(sum(d for _, _, d in dec), 1e-9)
    pre_tps = sum(f - g for f, g, _ in mix) / max(sum(d for *_, d in mix),
                                                  1e-9)
    dec_ms = 1e3 * sum(d for *_, d in dec) / max(len(dec), 1)
    mix_ms = 1e3 * sum(d for *_, d in mix) / max(len(mix), 1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    serving = dict(
        requests=len(reqs), prompt_tokens=int(sum(lens)),
        max_new_tokens=max_new, steps=steps, tokens_fed=fed,
        tokens_generated=gen, seconds=t_run, decode_steps=len(dec),
        decode_step_ms=dec_ms, decode_tokens_per_s=dec_tps,
        prefill_steps=len(mix), prefill_step_ms=mix_ms,
        prefill_tokens_per_s=pre_tps, peak_memory_gb=peak_gb,
        preemptions=sum(r.preemptions for r in reqs), card=card)
    print("  serving: " + json.dumps(serving), flush=True)

    serving["breakdown"] = _profile_steps(torch, eng, cfg, args.seed,
                                          args.out)
    del eng, reqs, outs
    torch.cuda.empty_cache()
    serving.update(_step_agreement(torch, model, cfg, ecfg, args.seed))
    return serving


def _kernel_group(name):
    if "ragged_attention" in name:
        return "ragged_attention"
    if "rms_norm" in name:
        return "rms_norm"
    if "rope" in name:
        return "rope"
    if any(k in name.lower() for k in ("gemm", "gemv", "xmma", "cutlass",
                                       "nvjet", "cublas")):
        return "matmul"
    return "other"


def _profile(torch, step, n):
    """Wall ms per step and device ms per step by kernel group, from a
    torch.profiler trace of ``n`` calls of ``step``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    groups, launches = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            g = _kernel_group(e.name)
            groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us() / 1e3
            launches += 1
    busy = sum(groups.values())
    return prof, dict(wall_ms=1e3 * wall / n, device_ms=busy / n,
                      idle_share=1 - busy / (1e3 * wall) if wall else None,
                      device_launches=launches / n,
                      by_group_ms={k: v / n for k, v in sorted(
                          groups.items(), key=lambda kv: -kv[1])})


def _profile_steps(torch, eng, cfg, seed, out_dir):
    """Where a step's time goes: a profiler trace of two prefill steps
    (8 prompts of 512 tokens, 256 tokens a step) and of four decode steps
    of the same 8 sequences. Chrome traces go to ``out_dir``."""
    import numpy as np
    rng = np.random.default_rng(seed + 1)
    reqs = [eng.submit(rng.integers(1, cfg.vocab_size, (512,)).tolist(),
                       max_new_tokens=16) for _ in range(8)]
    out = {}
    prof, out["prefill"] = _profile(torch, eng.step, 2)
    prof.export_chrome_trace(os.path.join(out_dir,
                                          "prefill_steps_trace.json"))
    sched = eng.sched
    while sched.waiting or any(r.pos < len(r.seq) - 1 for r in sched.running):
        eng.step()
    prof, out["decode"] = _profile(torch, eng.step, 4)
    prof.export_chrome_trace(os.path.join(out_dir,
                                          "decode_steps_trace.json"))
    eng.run_until_idle()
    if not all(len(r.result(timeout=0)) == 16 for r in reqs):
        raise AssertionError("a profiled request did not finish")
    for kind, m in out.items():
        print(f"  {kind} step breakdown: wall {m['wall_ms']:.3f} ms, device "
              f"{m['device_ms']:.3f} ms (idle share {m['idle_share']:.3f}), "
              f"{m['device_launches']:.0f} kernels; by group (ms): "
              + ", ".join(f"{k} {v:.3f}" for k, v in m["by_group_ms"].items()),
              flush=True)
    return out


def _step_agreement(torch, model, cfg, ecfg, seed):
    """One mixed ragged step (7 decode tokens, contexts up to 2000, and a
    64-token prefill chunk) through the kernels and through the plain
    versions, in bf16 and in float32 (the same bf16-valued weights and
    pools, upcast). float32: the two paths differ only in summation
    order, so they must agree to 1e-3 of the largest logit. bf16: both
    paths round at the same places, so the kernel path must be no further
    from the float32 step than the plain bf16 path is, within a factor 2."""
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.generation import _decoder_for
    from paddle_tpu_torch.serving import engine as E
    dev = torch.device("cuda")
    t_args, _, _, _ = _ragged_case(
        torch, dev, kvh=cfg.num_attention_heads,
        contexts=[60, 300, 700, 1100, 1500, 1800, 2000, 700], chunk=64,
        budget=ecfg.token_budget, seed=seed)
    _, kp0, vp0, tables, slot, pos, valid = t_args
    layers = cfg.num_hidden_layers
    kp = kp0[None].expand(layers, *kp0.shape).contiguous()
    vp = vp0[None].expand(layers, *vp0.shape).contiguous()
    del t_args, kp0, vp0
    tokens = torch.randint(1, cfg.vocab_size, (ecfg.token_budget,),
                           generator=torch.Generator().manual_seed(seed)) \
        .to(dev)
    dec = _decoder_for(model)
    w16 = dec.weights(model)

    def run(w, dtype, plain):
        kpc, vpc = kp.to(dtype), vp.to(dtype)
        before = dict(K.LAUNCHES)
        with ExitStack() as stack, torch.inference_mode():
            if plain:
                _plain_patches(stack)
            logits = E._engine_step_impl(dec, w, tokens, slot, pos, valid,
                                         tables, kpc, vpc)
            torch.cuda.synchronize()
        if plain and K.LAUNCHES != before:
            raise AssertionError("the plain step launched a kernel")
        return logits[valid].float()

    kb = run(w16, torch.bfloat16, False)
    pb = run(w16, torch.bfloat16, True)
    w32 = {k: v.float() for k, v in w16.items()}
    kf = run(w32, torch.float32, False)
    pf = run(w32, torch.float32, True)
    del w32
    torch.cuda.empty_cache()
    scale = float(pf.abs().max())
    err32 = float((kf - pf).abs().max())
    err_k = float((kb - pf).abs().max())
    err_p = float((pb - pf).abs().max())
    err16 = float((kb - pb).abs().max())
    agree32 = float((kf.argmax(-1) == pf.argmax(-1)).float().mean())
    agree16 = float((kb.argmax(-1) == pb.argmax(-1)).float().mean())
    finite = all(bool(torch.isfinite(x).all()) for x in (kb, pb, kf, pf))
    print(f"  step_ragged kernels vs plain, float32: max_abs_err={err32:.4g} "
          f"tol={1e-3 * scale:.4g} (max |logit| {scale:.4g}), argmax "
          f"agreement {agree32:.4f}", flush=True)
    print(f"  step_ragged bf16 vs the float32 step: kernels {err_k:.4g}, "
          f"plain {err_p:.4g} (tol: kernels <= 2 x plain); kernels vs plain "
          f"bf16 {err16:.4g}, argmax agreement {agree16:.4f}; "
          f"finite={finite}", flush=True)
    if not (finite and err32 <= 1e-3 * scale and err_k <= 2 * err_p):
        raise AssertionError("the kernel step disagrees with the plain step")
    return dict(step_logits_err_f32=err32, step_logits_err_bf16=err16,
                step_bf16_err_vs_f32_kernels=err_k,
                step_bf16_err_vs_f32_plain=err_p,
                step_argmax_agreement_f32=agree32,
                step_argmax_agreement_bf16=agree16)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, prompts and inputs")
    ap.add_argument("--out", default="smoke_out",
                    help="directory for the JSON record and the traces")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    # fails, before any result, where the checkout is not beside this file
    from paddle_tpu_torch.kernels import _build, fused

    card = _card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    print(f"phase 1: card [{card}] python {sys.version.split()[0]} torch "
          f"{torch.__version__} cuda {torch.version.cuda} triton "
          f"{triton_version} devices {torch.cuda.device_count()}", flush=True)

    t0 = time.monotonic()
    built = _build.build_all()
    nvcc_s = time.monotonic() - t0
    for name, info in built.items():
        print(f"phase 2: built {name} in {info['seconds']:.2f}s -> "
              f"{os.path.relpath(info['path'])}", flush=True)
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")
    t1 = time.monotonic()
    x = torch.randn(4, 4096, device="cuda", dtype=torch.bfloat16)
    w = torch.ones(4096, device="cuda", dtype=torch.bfloat16)
    fused.rms_norm(x, w)
    fused.add_rms_norm(x, x, w)
    q = torch.randn(1, 4, 32, 128, device="cuda", dtype=torch.bfloat16)
    c = torch.ones(4, 64, device="cuda")
    fused.fused_rope(q, q, c, c)
    torch.cuda.synchronize()
    print(f"phase 2: nvcc {nvcc_s:.2f}s, triton compile "
          f"{time.monotonic() - t1:.2f}s", flush=True)

    os.makedirs(args.out, exist_ok=True)
    results = {}
    phase_kernels(torch, results)
    phase_tiny_reference(torch)
    launches = {}
    serving = phase_serving(torch, args, launches)

    replaces = {
        "ragged_attention": ("cuda", "paddle_tpu_torch/csrc/ragged_attention.cu",
                             "paddle_tpu/kernels/ragged_pallas.py:134"),
        "rms_norm": ("triton", "paddle_tpu_torch/kernels/fused.py",
                     "paddle_tpu/kernels/fused_pallas.py:156"),
        "rms_norm_residual": ("triton", "paddle_tpu_torch/kernels/fused.py",
                              "paddle_tpu/kernels/fused_pallas.py:143"),
        "rope": ("triton", "paddle_tpu_torch/kernels/fused.py",
                 "paddle_tpu/kernels/fused_pallas.py:89"),
    }
    kernels = []
    for name, (route, source, tpu) in replaces.items():
        m = results["ragged_attention[mixed_mha]" if name == "ragged_attention"
                    else name]
        kernels.append(dict(name=name, route=route, source=source,
                            replaces=tpu, launches=launches[name],
                            **{k: m[k] for k in JSON_KEYS}))
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": results, "serving": serving,
                   "launches": launches}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
