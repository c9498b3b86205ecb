"""paddle_tpu_torch.optimizer against paddle_tpu.optimizer, eagerly, on
the CPU.

The same tiny float32 Llama (weights carried across as numpy) takes 3
steps in each package: ``loss.backward()``, ``step()``,
``clear_grad()``. Each step the JAX model's gradients are carried into
the port's parameters before its ``step()``, so the comparison holds the
update rules (and the options around them) and not the models'
gradients, which ``test_torch_training.py`` compares. Both rules compute
in float32 with the same order of operations; they differ only where
torch and XLA round a pow or a sum differently. Tolerances: losses and
weights rtol 1e-5 (atol 1e-7 for weights near zero); Lamb's trust ratio
divides two norms summed in another order, which stays within the same
1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu import regularizer as jreg
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.tensor import Parameter

from paddle_tpu_torch import kernels as K
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch import regularizer as preg
from paddle_tpu_torch.framework import io as pio
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     load_numpy_optimizer_state,
                                     load_numpy_state)
from paddle_tpu_torch.nn.initializer import ParamAttr, set_param_attr

VOCAB = 61


def _pair():
    paddle.seed(5)
    jm = JaxLlama(JaxConfig.tiny(vocab_size=VOCAB, hidden_size=32, layers=2,
                                 heads=4, kv_heads=2, seq=32))
    pm = LlamaForCausalLM(LlamaConfig.tiny(vocab_size=VOCAB, hidden_size=32,
                                           layers=2, heads=4, kv_heads=2,
                                           seq=32), device="cpu")
    load_numpy_state(pm, {n: np.asarray(t._data)
                          for n, t in jm.named_state().items()})
    return jm, pm


def _batch():
    rng = np.random.default_rng(9)
    ids = rng.integers(0, VOCAB, (4, 24)).astype(np.int32)
    return ids, ids.copy()


def _jloss(jm):
    ids, labels = _batch()
    return jm.forward_loss(paddle.to_tensor(ids), paddle.to_tensor(labels),
                           loss_chunk_size=8)


def _ploss(pm):
    ids, labels = _batch()
    return pm.forward_loss(torch.from_numpy(ids), torch.from_numpy(labels),
                           loss_chunk_size=8)


def _carry_grads(jm, pm):
    jp = dict(jm.named_parameters())
    for n, p in pm.named_parameters():
        p.grad = torch.from_numpy(np.array(jp[n].grad._data))


def _weights(jm, pm):
    return ({n: np.asarray(p._data) for n, p in jm.named_parameters()},
            {n: p.detach().numpy() for n, p in pm.named_parameters()})


def _assert_close(jw, pw, rtol=1e-5):
    for n, w in jw.items():
        np.testing.assert_allclose(pw[n], w, rtol=rtol, atol=1e-7,
                                   err_msg=n)


def _run(build, steps=3, annotate=None, schedulers=None):
    """``steps`` eager steps of ``build(module, params)`` in both packages;
    ``annotate(params_by_name, module)`` sets parameter attributes;
    ``schedulers`` a (jax, port) pair stepped after each step. Returns
    (jax losses, port losses, jax weights, port weights)."""
    jm, pm = _pair()
    jps, pps = dict(jm.named_parameters()), dict(pm.named_parameters())
    if annotate is not None:
        annotate(jps, jopt)
        annotate(pps, opt)
    jo = build(jopt, [jps[n] for n in jps], schedulers and schedulers[0])
    po = build(opt, [pps[n] for n in jps], schedulers and schedulers[1])
    jl, pl = [], []
    for _ in range(steps):
        loss = _jloss(jm)
        loss.backward()
        jl.append(float(loss.numpy()))
        jo.step()
        loss = _ploss(pm)
        loss.backward()
        pl.append(float(loss.detach()))
        _carry_grads(jm, pm)
        po.step()
        jo.clear_grad()
        po.clear_grad()
        if schedulers:
            for s in schedulers:
                s.step()
    return (jl, pl) + _weights(jm, pm)


RULES = {
    "SGD": lambda m, ps, s: m.SGD(learning_rate=0.05, parameters=ps),
    "SGD_wd": lambda m, ps, s: m.SGD(learning_rate=0.05, parameters=ps,
                                     weight_decay=0.1),
    "Momentum": lambda m, ps, s: m.Momentum(learning_rate=0.05, momentum=0.8,
                                            parameters=ps, weight_decay=0.02),
    "Momentum_nesterov": lambda m, ps, s: m.Momentum(
        learning_rate=0.05, momentum=0.8, parameters=ps, use_nesterov=True),
    "Adam": lambda m, ps, s: m.Adam(learning_rate=1e-3, parameters=ps,
                                    weight_decay=0.01),
    "AdamW": lambda m, ps, s: m.AdamW(learning_rate=1e-3, parameters=ps,
                                      weight_decay=0.05),
    "Adagrad": lambda m, ps, s: m.Adagrad(learning_rate=0.01, parameters=ps,
                                          initial_accumulator_value=0.1),
    "Adadelta": lambda m, ps, s: m.Adadelta(learning_rate=1.0, rho=0.9,
                                            parameters=ps),
    "Adamax": lambda m, ps, s: m.Adamax(learning_rate=2e-3, parameters=ps,
                                        weight_decay=0.01),
    "RMSProp": lambda m, ps, s: m.RMSProp(learning_rate=1e-3, parameters=ps),
    "RMSProp_centered": lambda m, ps, s: m.RMSProp(
        learning_rate=1e-3, parameters=ps, momentum=0.5, centered=True),
    "Lamb": lambda m, ps, s: m.Lamb(
        learning_rate=1e-2, lamb_weight_decay=0.02, parameters=ps,
        exclude_from_weight_decay_fn=lambda p: p.ndim == 1),
    "NAdam": lambda m, ps, s: m.NAdam(learning_rate=2e-3, parameters=ps),
    "RAdam": lambda m, ps, s: m.RAdam(learning_rate=2e-3, parameters=ps,
                                      weight_decay=0.01),
    "Rprop": lambda m, ps, s: m.Rprop(learning_rate=1e-3, parameters=ps),
    "ASGD": lambda m, ps, s: m.ASGD(learning_rate=0.05, batch_num=2,
                                    parameters=ps),
}


def test_every_jax_optimizer_is_ported():
    assert set(jopt.__all__) <= set(opt.__all__)
    assert {r.split("_")[0] for r in RULES} | {"LBFGS"} == \
        set(jopt.__all__) - {"Optimizer", "lr"}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_matches_jax(rule):
    jl, pl, jw, pw = _run(RULES[rule])
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    _assert_close(jw, pw)
    assert any(not np.array_equal(jw[n], w) for n, w in
               _weights(*_pair())[0].items()), "the run changed nothing"


def _named_norms(ps, mod):
    for n, p in ps.items():
        if "norm" in n:
            if mod is jopt:
                p.name = n
            else:
                set_param_attr(p, ParamAttr(name=n))


def _l1_on_embedding(ps, mod):
    reg = jreg if mod is jopt else preg
    ps["model.embed_tokens.weight"].regularizer = reg.L1Decay(0.01)


def _l2_on_mlp(ps, mod):
    reg = jreg if mod is jopt else preg
    for n, p in ps.items():
        if "mlp" in n:
            p.regularizer = reg.L2Decay(0.05)


def _no_decay_on_norms(ps, mod):
    for n, p in ps.items():
        if "norm" in n:
            p.regularizer = False


def _half_rate_on_embedding(ps, mod):
    if mod is jopt:
        ps["model.embed_tokens.weight"].optimize_attr["learning_rate"] = 0.5
    else:
        set_param_attr(ps["model.embed_tokens.weight"],
                       ParamAttr(learning_rate=0.5))


def _no_clip_on_embedding(ps, mod):
    ps["model.embed_tokens.weight"].need_clip = False


def _adamw(**kw):
    return lambda m, ps, s: m.AdamW(learning_rate=1e-3, parameters=ps,
                                    **kw)


def _adamw_reg(name):
    def build(m, ps, s):
        reg = jreg if m is jopt else preg
        return m.AdamW(learning_rate=1e-3, parameters=ps,
                       weight_decay=getattr(reg, name)(0.05))
    return build


def _adam_reg(name):
    def build(m, ps, s):
        reg = jreg if m is jopt else preg
        return m.Adam(learning_rate=1e-3, parameters=ps,
                      weight_decay=getattr(reg, name)(0.05))
    return build


def _groups(m, ps, s):
    return m.AdamW(learning_rate=1e-3, weight_decay=0.05, parameters=[
        {"params": ps[:7], "learning_rate": 0.1},
        {"params": ps[7:], "weight_decay": 0.5}])


def _clipped(m, ps, s):
    return m.AdamW(learning_rate=1e-3, parameters=ps,
                   grad_clip=m.ClipGradByGlobalNorm(0.05))


# (build, annotate): what the JAX package computes for each option
OPTIONS = {
    "float_wd": (_adamw(weight_decay=0.1), None),
    "l1_adamw": (_adamw_reg("L1Decay"), None),
    "l2_adamw": (_adamw_reg("L2Decay"), None),
    "l1_adam": (_adam_reg("L1Decay"), None),
    "l2_adam": (_adam_reg("L2Decay"), None),
    "param_l1_under_adamw": (_adamw(weight_decay=0.1), _l1_on_embedding),
    "param_l2_under_momentum": (RULES["Momentum"], _l2_on_mlp),
    "regularizer_false": (_adamw(weight_decay=0.1), _no_decay_on_norms),
    "optimize_attr_rate": (_adamw(), _half_rate_on_embedding),
    "group_dicts": (_groups, None),
    "lr_ratio_ignored": (_adamw(lr_ratio=lambda p: 0.1), None),
    "multi_precision_ignored": (
        lambda m, ps, s: m.Adam(learning_rate=1e-3, parameters=ps,
                                multi_precision=True), None),
    "apply_decay_param_fun": (
        _adamw(weight_decay=0.2,
               apply_decay_param_fun=lambda name: "norm" not in name),
        _named_norms),
    "apply_decay_param_fun_unnamed": (
        _adamw(weight_decay=0.2, apply_decay_param_fun=lambda name: name),
        None),
    "need_clip": (_clipped, _no_clip_on_embedding),
    "sgd_optimize_attr": (RULES["SGD"], _half_rate_on_embedding),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_option_matches_jax(option):
    build, annotate = OPTIONS[option]
    jl, pl, jw, pw = _run(build, annotate=annotate)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    _assert_close(jw, pw)


def _schedulers(lr_mod):
    return lr_mod.LinearWarmup(lr_mod.CosineAnnealingDecay(3e-3, T_max=4),
                               2, 0.0, 3e-3)


@pytest.mark.parametrize("rule", ["AdamW", "Momentum"])
def test_scheduler_as_learning_rate_matches_jax(rule):
    scheds = (_schedulers(jopt.lr), _schedulers(opt.lr))

    def build(m, ps, s):
        if rule == "AdamW":
            return m.AdamW(learning_rate=s, parameters=ps, weight_decay=0.1)
        return m.Momentum(learning_rate=s, parameters=ps)
    jl, pl, jw, pw = _run(build, steps=4, schedulers=scheds)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    _assert_close(jw, pw)


def test_set_lr_set_lr_scheduler_minimize_and_clear():
    _, pm = _pair()
    o = opt.SGD(learning_rate=0.1, parameters=pm.parameters())
    o.set_lr(0.25)
    assert o.get_lr() == 0.25
    s = opt.lr.StepDecay(0.5, 1, gamma=0.5)
    o.set_lr_scheduler(s)
    s.step()
    assert o.get_lr() == 0.25 and o._learning_rate is s
    before = pm.model.norm.weight.detach().clone()
    o.minimize(_ploss(pm))
    assert o._global_step == 1
    assert not torch.equal(before, pm.model.norm.weight.detach())
    o.clear_gradients()
    assert all(p.grad is None for p in pm.parameters())


def _resume_run(rule, split, tmp_path):
    """(losses, weights) of 5 steps of ``rule``; with ``split``, 3 steps,
    the model's, optimizer's and scheduler's state saved with
    framework.io, then a fresh model, optimizer and scheduler loaded from
    the files for the last 2."""
    def fresh():
        _, pm = _pair()
        s = _schedulers(opt.lr)
        kw = {"weight_decay": 0.1} if rule == "AdamW" else {}
        return pm, s, getattr(opt, rule)(learning_rate=s,
                                         parameters=pm.parameters(), **kw)

    pm, sched, o = fresh()
    losses = []
    for i in range(5):
        if split and i == 3:
            pio.save({"model": pm.state_dict(), "opt": o.state_dict(),
                      "sched": sched.state_dict()}, str(tmp_path / "ck"))
            pm, sched, o = fresh()
            ck = pio.load(str(tmp_path / "ck"))
            pm.load_state_dict(ck["model"])
            o.set_state_dict(ck["opt"])
            sched.set_state_dict(ck["sched"])
        loss = _ploss(pm)
        loss.backward()
        o.step()
        o.clear_grad()
        sched.step()
        losses.append(float(loss.detach()))
    return losses, {n: p.detach().clone() for n, p in pm.named_parameters()}


@pytest.mark.parametrize("rule", ["AdamW", "NAdam", "ASGD"])
def test_state_dict_resume_equals_an_uninterrupted_run(rule, tmp_path):
    want_l, want_w = _resume_run(rule, False, tmp_path)
    got_l, got_w = _resume_run(rule, True, tmp_path)
    assert got_l == want_l
    assert all(torch.equal(got_w[n], want_w[n]) for n in want_w)


def test_state_dict_is_a_snapshot_and_round_trips_through_io(tmp_path):
    _, pm = _pair()
    s = _schedulers(opt.lr)
    o = opt.AdamW(learning_rate=s, parameters=pm.parameters())
    _ploss(pm).backward()
    o.step()
    state = o.state_dict()
    m1 = state["accumulators"]["param_0"]["moment1"].clone()
    _ploss(pm).backward()
    o.step()
    assert torch.equal(state["accumulators"]["param_0"]["moment1"], m1)
    pio.save(state, str(tmp_path / "o"))
    back = pio.load(str(tmp_path / "o"))
    assert back["global_step"] == 1 and back["LR_Scheduler"] == \
        state["LR_Scheduler"]
    for key, acc in state["accumulators"].items():
        assert back["accumulators"][key]["_step"] == 1
        for k, v in acc.items():
            if k != "_step":
                assert torch.equal(back["accumulators"][key][k], v)


@pytest.mark.parametrize("rule", ["AdamW", "Momentum", "NAdam", "Lamb"])
def test_jax_optimizer_state_continues_in_the_port(rule):
    """2 JAX steps; the JAX weights and the JAX optimizer's state_dict()
    (as numpy) go into a fresh port model and optimizer; both packages
    take a third step from the same gradients."""
    build = RULES[rule]
    jm, pm = _pair()
    jo = build(jopt, list(jm.parameters()), None)
    for _ in range(2):
        _jloss(jm).backward()
        jo.step()
        jo.clear_grad()
    state = jo.state_dict()
    numpy_state = {"global_step": state["global_step"], "accumulators": {
        key: {k: np.asarray(v._data) for k, v in acc.items()}
        for key, acc in state["accumulators"].items()}}
    load_numpy_state(pm, {n: np.asarray(t._data)
                          for n, t in jm.named_state().items()})
    po = build(opt, list(pm.parameters()), None)
    load_numpy_optimizer_state(po, numpy_state)
    assert po._global_step == 2
    _jloss(jm).backward()
    jo.step()
    _ploss(pm).backward()
    _carry_grads(jm, pm)
    po.step()
    jw, pw = _weights(jm, pm)
    _assert_close(jw, pw)
    assert all(a["_step"] == 3 for a in po._accumulators.values())


def test_optimizer_state_loader_refuses_what_does_not_fit():
    _, pm = _pair()
    po = opt.AdamW(parameters=pm.parameters())
    with pytest.raises(KeyError):
        load_numpy_optimizer_state(po, {"accumulators": {
            "nope": {"moment1": np.zeros(3, np.float32)}}})
    with pytest.raises(ValueError):
        load_numpy_optimizer_state(po, {"accumulators": {
            "param_0": {"moment1": np.zeros(3, np.float32)}}})
    assert po._accumulators == {}


def test_adam_launches_nothing_on_cpu_and_buckets_by_rate():
    """The eager Adam step groups parameters by (float32 rate, update
    count): a parameter at half the rate is one more multi_tensor_adamw
    call, and the CPU path launches no kernel."""
    _, pm = _pair()
    set_param_attr(pm.model.embed_tokens.weight, ParamAttr(learning_rate=0.5))
    o = opt.AdamW(learning_rate=1e-3, parameters=pm.parameters())
    calls = []
    adam = o._adam
    o._adam = lambda ps, gs, lr32, mults, step: (
        calls.append((len(ps), lr32, mults)), adam(ps, gs, lr32, mults, step))
    before = K.kernel_launches()
    _ploss(pm).backward()
    o.step()
    assert K.kernel_launches() == before
    n = len(list(pm.parameters()))
    assert sorted(calls) == sorted([(1, float(np.float32(5e-4)), [1.0]),
                                    (n - 1, float(np.float32(1e-3)),
                                     [1.0] * (n - 1))])


def _lbfgs_problem():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 6)).astype(np.float32)
    y = (x @ rng.standard_normal(6) + 0.3).astype(np.float32)[:, None]
    w0 = (0.1 * rng.standard_normal((6, 1))).astype(np.float32)
    return x, y, w0


@pytest.mark.parametrize("line_search", [None, "strong_wolfe"])
def test_lbfgs_matches_jax(line_search):
    """A least-squares fit, 2 LBFGS steps of up to 8 iterations each, with
    and without the strong-Wolfe search: the same losses and weights
    within 1e-4 (float32 dot products summed in another order steer the
    line search's decisions by as much; a loss near zero within 1e-7)."""
    x, y, w0 = _lbfgs_problem()
    jw = Parameter(jnp.asarray(w0))
    jb = Parameter(jnp.zeros(1, jnp.float32))
    jx, jy = paddle.to_tensor(x), paddle.to_tensor(y)
    jo = jopt.LBFGS(learning_rate=1.0, max_iter=8, history_size=5,
                    line_search_fn=line_search, parameters=[jw, jb])

    def jclosure():
        jo.clear_grad()
        loss = ((paddle.matmul(jx, jw) + jb - jy) ** 2).mean()
        loss.backward()
        return loss

    pw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    pb = torch.nn.Parameter(torch.zeros(1))
    px, py = torch.from_numpy(x), torch.from_numpy(y)
    po = opt.LBFGS(learning_rate=1.0, max_iter=8, history_size=5,
                   line_search_fn=line_search, parameters=[pw, pb],
                   weight_decay=0.5, grad_clip=opt.ClipGradByValue(1e-3))

    def pclosure():
        po.clear_grad()
        loss = ((px @ pw + pb - py) ** 2).mean()
        loss.backward()
        return loss

    for _ in range(2):
        jl = float(jo.step(jclosure).numpy())
        pl = float(po.step(pclosure))
        np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(pw.detach().numpy(), np.asarray(jw._data),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pb.detach().numpy(), np.asarray(jb._data),
                               rtol=1e-4, atol=1e-5)
    assert po.state["func_evals"] == jo.state["func_evals"]
    assert po.state["n_iter"] == jo.state["n_iter"]
    final = float(((px @ pw + pb - py) ** 2).mean())
    assert final < 1e-3
    restored = opt.LBFGS(parameters=[pw, pb])
    restored.set_state_dict(po.state_dict())
    assert restored.state["n_iter"] == po.state["n_iter"]
    assert torch.equal(restored.state["d"], po.state["d"])
