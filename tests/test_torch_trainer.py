"""paddle_tpu_torch's SpmdTrainer against paddle_tpu's SpmdTrainer
(mesh=None), on the CPU.

The same tiny Llama (weights carried across as numpy) trains 3 steps in
each package with AdamW, full remat of every layer and the chunked loss;
per-step losses and the final weights must agree.

Tolerances. float32: losses 1e-5 relative; weights atol 2e-6 for at
least 99.9% of the elements (three updates of at most ~lr = 1e-3 each,
from gradients that agree to ~1e-6 relative), and every element within
3 lr: Adam divides a gradient element by its own magnitude, so an element
whose gradient is near zero amplifies the fp32 summation-order difference
into up to lr an update (one element of 22496 here). bf16 (weights and
rope tables in bf16, moments fp32): losses 2e-3 relative (the logits agree
to a few bf16 ulps, see test_torch_training.py, and the loss averages
them); weights: at least 80% of the elements equal and every element within
2 bf16 ulps (2^-6 of its magnitude) plus 3 lr, since each update is below
one bf16 ulp of most weights and a near tie rounds either way, and a
gradient element near zero turns an update (about +-lr) around.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.parallel.trainer import SpmdTrainer as JaxTrainer

from paddle_tpu_torch import kernels as K
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     load_numpy_state)
from paddle_tpu_torch.parallel import SpmdTrainer
from paddle_tpu_torch.parallel.trainer import _clip_grads_functional

VOCAB = 61
LR = 1e-3


def _models(bf16, kv_heads=2):
    paddle.seed(5)
    jcfg = JaxConfig.tiny(vocab_size=VOCAB, hidden_size=32, layers=2,
                          heads=4, kv_heads=kv_heads, seq=32)
    jm = JaxLlama(jcfg)
    pm = LlamaForCausalLM(LlamaConfig.tiny(vocab_size=VOCAB, hidden_size=32,
                                           layers=2, heads=4,
                                           kv_heads=kv_heads, seq=32),
                          device="cpu")
    if bf16:
        jm.bfloat16()
        pm.bfloat16()
    load_numpy_state(pm, {n: np.asarray(t._data)
                          for n, t in jm.named_state().items()})
    return jm, pm


def _loss_fn(m, ids, labels):
    return m.forward_loss(ids, labels, loss_chunk_size=8)


def _batch():
    rng = np.random.default_rng(9)
    ids = rng.integers(0, VOCAB, (4, 24)).astype(np.int32)
    labels = ids.copy()
    labels[1, 20:] = -100
    return ids, labels


def _assert_f32_weights_close(pw, jw):
    close = total = 0
    for name, w in jw.items():
        d = np.abs(pw[name] - w)
        assert np.all(d <= 3 * LR), name
        close += int((d <= 2e-6).sum())
        total += w.size
    assert close >= 0.999 * total, (close, total)


def _train(bf16, accumulate=1, clip=None, kv_heads=2, steps=3):
    jm, pm = _models(bf16, kv_heads)
    ids, labels = _batch()
    jtr = JaxTrainer(jm, jopt.AdamW(learning_rate=LR, parameters=jm.parameters(),
                                    weight_decay=0.01,
                                    grad_clip=None if clip is None
                                    else jopt.ClipGradByGlobalNorm(clip)),
                     _loss_fn, mesh=None, remat_layers=list(jm.model.layers),
                     remat_policy="full", accumulate_steps=accumulate)
    ptr = SpmdTrainer(pm, opt.AdamW(learning_rate=LR,
                                    parameters=pm.parameters(),
                                    weight_decay=0.01,
                                    grad_clip=None if clip is None
                                    else opt.ClipGradByGlobalNorm(clip)),
                      _loss_fn, remat_layers=list(pm.model.layers),
                      accumulate_steps=accumulate)
    want, got = [], []
    for _ in range(steps):
        want.append(float(jtr.train_step(paddle.to_tensor(ids),
                                         paddle.to_tensor(labels)).numpy()))
        got.append(float(ptr.train_step(torch.from_numpy(ids),
                                        torch.from_numpy(labels))))
    ptr.block()
    jw = {n: np.asarray(p._data.astype("float32"))
          for n, p in jm.named_parameters()}
    pw = {n: p.detach().float().numpy() for n, p in pm.named_parameters()}
    return want, got, jw, pw


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_trainer_f32_matches_jax(kv_heads):
    want, got, jw, pw = _train(False, kv_heads=kv_heads)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    _assert_f32_weights_close(pw, jw)


def test_trainer_accumulate_and_global_clip_match_jax():
    """accumulate_steps=2 (fp32 sum of two micro-batch gradients, / 2)
    and ClipGradByGlobalNorm at a norm below the gradient's, so it clips."""
    want, got, jw, pw = _train(False, accumulate=2, clip=0.05)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_f32_weights_close(pw, jw)


def test_trainer_bf16_matches_jax():
    want, got, jw, pw = _train(True)
    np.testing.assert_allclose(got, want, rtol=2e-3)
    same = total = 0
    for name, w in jw.items():
        tol = 2.0 ** -6 * np.abs(w) + 3 * LR
        assert np.all(np.abs(pw[name] - w) <= tol), name
        same += int((pw[name] == w).sum())
        total += w.size
    assert same >= 0.8 * total, same / total


def test_trainer_launches_nothing_on_cpu_and_keeps_grad_buffers():
    _, pm = _models(False)
    ids, labels = _batch()
    tr = SpmdTrainer(pm, opt.AdamW(learning_rate=LR,
                                   parameters=pm.parameters()), _loss_fn)
    before = K.kernel_launches()
    tr.train_step(torch.from_numpy(ids), torch.from_numpy(labels))
    ptrs = {n: g.data_ptr() for n, g in tr._grads.items()}
    tr.train_step(torch.from_numpy(ids), torch.from_numpy(labels))
    assert K.kernel_launches() == before
    assert {n: g.data_ptr() for n, g in tr._grads.items()} == ptrs
    assert tr.opt._global_step == 2


def test_trainer_clips_into_its_grad_buffers():
    """With ClipGradByGlobalNorm the update still receives the trainer's
    persistent gradient buffers (the pointers the AdamW kernel's table is
    cached by), holding the clipped gradients."""
    _, pm = _models(False)
    ids, labels = _batch()
    tr = SpmdTrainer(pm, opt.AdamW(learning_rate=LR,
                                   parameters=pm.parameters(),
                                   grad_clip=opt.ClipGradByGlobalNorm(0.05)),
                     _loss_fn)
    seen = []
    update = tr.opt._update_all

    def spy(params, grads, lr, mults, step):
        seen.append(([g.data_ptr() for g in grads],
                     float(torch.sqrt(sum((g.float() ** 2).sum()
                                          for g in grads)))))
        return update(params, grads, lr, mults, step)

    tr.opt._update_all = spy
    for _ in range(2):
        tr.train_step(torch.from_numpy(ids), torch.from_numpy(labels))
    ptrs = [tr._grads[n].data_ptr() for n in tr._param_list]
    assert [s[0] for s in seen] == [ptrs, ptrs]
    assert all(norm <= 0.05 * (1 + 1e-5) for _, norm in seen), seen


@pytest.mark.parametrize("option", ["mesh", "zero_stage", "seq_axis",
                                    "aot_cache", "memwatch"])
def test_trainer_refuses_unported_options(option):
    _, pm = _models(False)
    with pytest.raises(NotImplementedError):
        SpmdTrainer(pm, opt.AdamW(parameters=pm.parameters()), _loss_fn,
                    **{option: 1})


def test_trainer_refuses_unported_remat_and_bad_batches():
    """A remat policy outside the JAX trainer's REMAT_POLICIES raises its
    ValueError ("dots", once refused, is ported: see
    test_remat_policy_matches_full_and_jax), as does a batch that
    accumulate_steps does not divide."""
    _, pm = _models(False)
    o = opt.AdamW(parameters=pm.parameters())
    with pytest.raises(ValueError, match="remat_policy"):
        SpmdTrainer(pm, o, _loss_fn, remat_layers=list(pm.model.layers),
                    remat_policy="dots_and_more")
    SpmdTrainer(pm, o, _loss_fn, remat_layers=list(pm.model.layers),
                remat_policy="dots")
    tr = SpmdTrainer(pm, o, _loss_fn, accumulate_steps=3)
    ids, labels = _batch()
    with pytest.raises(ValueError, match="accumulate_steps"):
        tr.train_step(torch.from_numpy(ids), torch.from_numpy(labels))


def test_optimizer_refuses_unported_options():
    """The three options the port once refused now compute what the JAX
    package computes: a scheduler as the learning rate, multi_precision
    (ignored: no fp32 master weights) and apply_decay_param_fun (on
    parameter names; an unnamed parameter's is "")."""
    import jax.numpy as jnp
    from paddle_tpu.tensor import Parameter
    rng = np.random.default_rng(12)
    w = rng.standard_normal(6).astype(np.float32)
    g = rng.standard_normal(6).astype(np.float32)
    cases = (
        lambda m, ps: m.AdamW(learning_rate=m.lr.LinearWarmup(
            m.lr.CosineAnnealingDecay(0.1, T_max=4), 2, 0.0, 0.1),
            parameters=ps),
        lambda m, ps: m.Adam(learning_rate=0.1, parameters=ps,
                             multi_precision=True),
        lambda m, ps: m.AdamW(learning_rate=0.1, parameters=ps,
                              weight_decay=0.5,
                              apply_decay_param_fun=lambda n: n == ""))
    for build in cases:
        jp = Parameter(jnp.asarray(w))
        pp = torch.nn.Parameter(torch.from_numpy(w.copy()))
        jo, po = build(jopt, [jp]), build(opt, [pp])
        for _ in range(3):
            jp.grad = paddle.to_tensor(g)
            pp.grad = torch.from_numpy(g.copy())
            jo.step()
            po.step()
            if isinstance(jo._learning_rate, jopt.lr.LRScheduler):
                jo._learning_rate.step()
                po._learning_rate.step()
        np.testing.assert_allclose(pp.detach().numpy(), np.asarray(jp._data),
                                   rtol=1e-6)
        assert not np.array_equal(pp.detach().numpy(), w)


@pytest.mark.parametrize("clip", ["value", "norm", "global"])
def test_clip_grads_match_jax(clip):
    import jax.numpy as jnp
    from paddle_tpu.parallel.trainer import _clip_grads_functional as jclip
    rng = np.random.default_rng(11)
    grads = {n: rng.standard_normal(s).astype(np.float32)
             for n, s in (("a", (5, 3)), ("b", (7,)))}
    jc, pc = {"value": (jopt.ClipGradByValue(0.5),
                        opt.ClipGradByValue(0.5)),
              "norm": (jopt.ClipGradByNorm(1.0), opt.ClipGradByNorm(1.0)),
              "global": (jopt.ClipGradByGlobalNorm(1.0),
                         opt.ClipGradByGlobalNorm(1.0))}[clip]
    want = jclip(jc, {}, {n: jnp.asarray(g) for n, g in grads.items()})
    got = _clip_grads_functional(pc, {n: None for n in grads},
                                 {n: torch.from_numpy(g)
                                  for n, g in grads.items()})
    for n in grads:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   rtol=1e-6, err_msg=n)


def test_eager_adamw_step_matches_jax_eager():
    """The eager optimizer path (loss.backward(); step(); clear_grad())
    against the JAX eager AdamW, two steps, fp32."""
    jm, pm = _models(False)
    ids, labels = _batch()
    jo = jopt.AdamW(learning_rate=LR, parameters=jm.parameters())
    po = opt.AdamW(learning_rate=LR, parameters=pm.parameters())
    for _ in range(2):
        jl = _loss_fn(jm, paddle.to_tensor(ids), paddle.to_tensor(labels))
        jl.backward()
        jo.step()
        jo.clear_grad()
        pl = _loss_fn(pm, torch.from_numpy(ids), torch.from_numpy(labels))
        pl.backward()
        po.step()
        po.clear_grad()
        np.testing.assert_allclose(float(pl.detach()), float(jl.numpy()),
                                   rtol=1e-5)
    _assert_f32_weights_close(
        {n: p.detach().numpy() for n, p in pm.named_parameters()},
        {n: np.asarray(p._data) for n, p in jm.named_parameters()})


# -- the training surface: schedulers, regularizers, rates, rules, remat -------

def _annotate(jm, pm):
    """The recipe's parameter attributes in both packages: the norms
    named (so apply_decay_param_fun leaves them out), the embedding at half
    the rate, the last MLP projection with its own L1Decay."""
    from paddle_tpu import regularizer as jreg
    from paddle_tpu_torch import regularizer as preg
    from paddle_tpu_torch.nn.initializer import ParamAttr, set_param_attr
    jps, pps = dict(jm.named_parameters()), dict(pm.named_parameters())
    for n in jps:
        if "norm" in n:
            jps[n].name = n
            set_param_attr(pps[n], ParamAttr(name=n))
    jps["model.embed_tokens.weight"].optimize_attr["learning_rate"] = 0.5
    set_param_attr(pps["model.embed_tokens.weight"],
                   ParamAttr(learning_rate=0.5))
    last = "model.layers.1.mlp.down_proj.weight"
    jps[last].regularizer = jreg.L1Decay(0.02)
    pps[last].regularizer = preg.L1Decay(0.02)


def _recipe(m, ps):
    sched = m.lr.LinearWarmup(m.lr.CosineAnnealingDecay(3e-3, T_max=4), 2,
                              0.0, 3e-3)
    return m.AdamW(learning_rate=sched, parameters=ps, weight_decay=0.1,
                   apply_decay_param_fun=lambda name: "norm" not in name,
                   grad_clip=m.ClipGradByGlobalNorm(1.0))


TRAINER_RULES = {
    "recipe": _recipe,
    "Momentum": lambda m, ps: m.Momentum(learning_rate=0.05, momentum=0.9,
                                         parameters=ps, weight_decay=0.01),
    "Lamb": lambda m, ps: m.Lamb(learning_rate=1e-2, parameters=ps,
                                 lamb_weight_decay=0.01),
}


def _train_rule(rule, bf16, policy="full", steps=3, annotate=True):
    jm, pm = _models(bf16)
    if annotate:
        _annotate(jm, pm)
    ids, labels = _batch()
    jo = TRAINER_RULES[rule](jopt, jm.parameters())
    po = TRAINER_RULES[rule](opt, pm.parameters())
    # donate=False: the JAX Lamb's state holds one zeros array twice, which
    # a donating step refuses ("donate the same buffer twice")
    jtr = JaxTrainer(jm, jo, _loss_fn, mesh=None, donate=False,
                     remat_layers=list(jm.model.layers), remat_policy=policy)
    ptr = SpmdTrainer(pm, po, _loss_fn, remat_layers=list(pm.model.layers),
                      remat_policy=policy)
    want, got, rates = [], [], []
    for _ in range(steps):
        rates.append((jo.get_lr(), po.get_lr()))
        want.append(float(jtr.train_step(paddle.to_tensor(ids),
                                         paddle.to_tensor(labels)).numpy()))
        got.append(float(ptr.train_step(torch.from_numpy(ids),
                                        torch.from_numpy(labels))))
        for o in (jo, po):
            if isinstance(o._learning_rate, (jopt.lr.LRScheduler,
                                             opt.lr.LRScheduler)):
                o._learning_rate.step()
    jw = {n: np.asarray(p._data.astype("float32"))
          for n, p in jm.named_parameters()}
    pw = {n: p.detach().float().numpy() for n, p in pm.named_parameters()}
    return want, got, jw, pw, rates


@pytest.mark.parametrize("rule", sorted(TRAINER_RULES))
def test_trainer_rule_matches_jax_f32(rule):
    want, got, jw, pw, rates = _train_rule(rule, False)
    assert all(a == b for a, b in rates)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    lr = max(r for r, _ in rates)
    close = total = 0
    for name, w in jw.items():
        d = np.abs(pw[name] - w)
        assert np.all(d <= 3 * lr), name
        close += int((d <= 2e-6).sum())
        total += w.size
    assert close >= 0.999 * total, (close, total)


def test_trainer_recipe_matches_jax_bf16():
    """The recipe in bf16 weights (fp32 moments): the bf16 gates of
    test_trainer_bf16_matches_jax, with the L1Decay penalty computed in
    bf16 (the JAX trainer's fused program may keep it in fp32 between
    its two operations, which the 2-ulp gate covers)."""
    want, got, jw, pw, rates = _train_rule("recipe", True)
    np.testing.assert_allclose(got, want, rtol=2e-3)
    lr = max(r for r, _ in rates)
    same = total = 0
    for name, w in jw.items():
        tol = 2.0 ** -6 * np.abs(w) + 3 * lr
        assert np.all(np.abs(pw[name] - w) <= tol), name
        same += int((pw[name] == w).sum())
        total += w.size
    assert same >= 0.8 * total, same / total


def test_trainer_recipe_excludes_norms_and_halves_the_embedding_rate():
    """What the recipe's attributes do on the port alone: a norm weight
    sees no decay (zero gradient: it stays exactly), the embedding moves
    at half the rate (Adam's first step moves each element by the rate)."""
    _, pm = _models(False)
    jm, _ = _models(False)
    _annotate(jm, pm)
    o = _recipe(opt, pm.parameters())
    o._learning_rate.step()
    o._learning_rate.step()           # past the warmup: rate 3e-3
    tr = SpmdTrainer(pm, o, _loss_fn)
    norm = pm.model.norm.weight
    emb = pm.model.embed_tokens.weight
    before_n, before_e = norm.detach().clone(), emb.detach().clone()
    captured = []
    update = o._update_all
    o._update_all = lambda ps, gs, lr, mults, step: (
        captured.append((lr, mults)), update(ps, gs, lr, mults, step))
    ids, labels = _batch()
    tr.train_step(torch.from_numpy(ids), torch.from_numpy(labels))
    lr, mults = captured[0]
    assert lr == o.get_lr() == 3e-3
    names = tr._param_list
    assert mults[names.index("model.embed_tokens.weight")] == 0.5
    assert o._wd_coeff(norm) == 0.0 and o._wd_coeff(emb) == 0.1
    # Adam's first step moves an element by the rate, plus the decoupled
    # decay's rate * 0.1 * |w| (|w| < 0.2 here)
    moved = (emb.detach() - before_e).abs()
    assert 0.5 * 3e-3 * 0.99 <= float(moved.max()) <= 0.5 * 3e-3 * 1.02
    assert not torch.equal(before_n, norm.detach())


@pytest.mark.parametrize("policy", ["dots", "dots_no_batch", "nothing"])
def test_remat_policy_matches_full_and_jax(policy):
    """Every remat policy gives the port's "full" losses and weights bit
    for bit (recompute changes no value) and the JAX trainer's under the
    same policy at the f32 tolerances."""
    want, got, jw, pw, _ = _train_rule("recipe", False, policy)
    _, full, _, fw, _ = _train_rule("recipe", False, "full")
    assert got == full
    assert all(np.array_equal(pw[n], fw[n]) for n in fw)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_remat_dots_keeps_the_products_and_recomputes_the_kernels():
    """Counted in the backward of one step: under "dots" the recompute
    runs no matrix product (as many as with no remat at all) but every
    RMSNorm and RoPE op again (as under "full")."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from paddle_tpu_torch.parallel.trainer import _wrap_remat

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            k = str(func).split(".")[1]
            self.n[k] = self.n.get(k, 0) + 1
            return func(*args, **(kwargs or {}))

    ids, labels = _batch()
    counts = {}
    for policy in ("full", "dots", "dots_no_batch", None):
        _, pm = _models(False)
        if policy:
            for layer in pm.model.layers:
                _wrap_remat(layer, policy)
        loss = _loss_fn(pm, torch.from_numpy(ids), torch.from_numpy(labels))
        with Count() as c:
            loss.backward()
        counts[policy] = c.n
    assert counts["dots"]["mm"] == counts[None]["mm"] < counts["full"]["mm"]
    assert counts["dots"]["bmm"] == counts[None]["bmm"] \
        < counts["dots_no_batch"]["bmm"] == counts["full"]["bmm"]
    assert counts["dots_no_batch"]["mm"] == counts[None]["mm"]
    for k in ("rms_norm", "rope"):
        assert counts["dots"][k] == counts["full"][k] > counts[None].get(k, 0)


def test_trainer_resumes_from_saved_state(tmp_path):
    """3 steps, the model's, optimizer's and scheduler's state saved with
    framework.io, a fresh model, optimizer, scheduler and trainer loaded
    from it, 2 more steps: the losses and weights of 5 uninterrupted
    steps, bit for bit."""
    from paddle_tpu_torch.framework import io as pio

    def fresh():
        _, pm = _models(False)
        o = _recipe(opt, pm.parameters())
        return pm, o, SpmdTrainer(pm, o, _loss_fn,
                                  remat_layers=list(pm.model.layers))

    ids, labels = (torch.from_numpy(x) for x in _batch())
    runs = []
    for split in (False, True):
        pm, o, tr = fresh()
        losses = []
        for i in range(5):
            if split and i == 3:
                tr.sync_optimizer_state()
                pio.save({"model": pm.state_dict(), "opt": o.state_dict()},
                         str(tmp_path / "ck"))
                pm, o, tr = fresh()
                ck = pio.load(str(tmp_path / "ck"))
                pm.load_state_dict(ck["model"])
                o.set_state_dict(ck["opt"])
                assert tr._step_count == 0
                tr = SpmdTrainer(pm, o, _loss_fn,
                                 remat_layers=list(pm.model.layers))
                assert tr._step_count == 3
            losses.append(float(tr.train_step(ids, labels)))
            o._learning_rate.step()
        runs.append((losses, {n: p.detach().clone()
                              for n, p in pm.named_parameters()}))
    (want_l, want_w), (got_l, got_w) = runs
    assert got_l == want_l
    assert all(torch.equal(got_w[n], want_w[n]) for n in want_w)
