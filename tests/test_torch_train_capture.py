"""The trainer's step as a CUDA graph captures it, checked on the CPU.

``SpmdTrainer`` splits a step into a driver (stage the batch into static
buffers, write the rate and the step count into float32 0-d tensors, then
run or replay) and ``_step_body``, which reads only those buffers. On the
CPU the body runs eagerly (``_step_eager``): the same body the card
captures. These tests hold it to the JAX trainer over 3 steps under a
scheduler (tiny Llama, packed Llama with a new packing every step through
the same buffers, tiny GPT-MoE, ``accumulate_steps=2``, and each of the
thirteen rules), check that it makes no host round trip (no ``.item()``,
``.tolist()``, ``.cpu()``, ``nonzero`` or tensor made from host data once
the first step has made the optimizer's state and constants), and that
``set_state_dict`` loads into the live state tensors.

Tolerances are those of ``test_torch_trainer.py``: float32 losses 1e-5
relative; weights within 3 lr everywhere and within 2e-6 for 99.9% of the
elements (Adam-like rules divide a gradient element by its own magnitude,
so an element whose gradient is near zero turns the fp32 summation-order
difference into up to lr). The JAX trainer cannot train ASGD (its rule
reads the traced step count with ``int``, ROADMAP F9), so ASGD's reference
is the JAX eager step on the same losses' gradients, which computes the
same update.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.kernels import fused_pallas as fp
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.parallel.trainer import SpmdTrainer as JaxTrainer

from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch import regularizer as preg
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM, load_numpy_state)
from paddle_tpu_torch.nn.initializer import ParamAttr, set_param_attr
from paddle_tpu_torch.parallel import SpmdTrainer

VOCAB = 61
SEQ = 24


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(fp, "_INTERPRET", True)


def _llamas(seed=5):
    paddle.seed(seed)
    jm = JaxLlama(JaxConfig.tiny(vocab_size=VOCAB, hidden_size=32, layers=2,
                                 heads=4, kv_heads=2, seq=32))
    pm = LlamaForCausalLM(LlamaConfig.tiny(vocab_size=VOCAB, hidden_size=32,
                                           layers=2, heads=4, kv_heads=2,
                                           seq=32), device="cpu")
    load_numpy_state(pm, {n: np.asarray(t._data)
                          for n, t in jm.named_state().items()})
    return jm, pm


def _gpts(seed=3):
    paddle.seed(seed)
    kw = dict(vocab_size=VOCAB, hidden_size=32, layers=2, heads=2, seq=32,
              num_experts=4, moe_every=2)
    jm = JaxGPT(JaxGPTConfig.tiny(**kw))
    pm = GPTForCausalLM(GPTConfig.tiny(**kw), device="cpu")
    load_numpy_state(pm, {n: np.asarray(t._data)
                          for n, t in jm.named_state().items()})
    for m in (jm, pm):
        for block in m.transformer.h:
            if block.is_moe:
                block.mlp.dropless = True
    return jm, pm


def _ids(seed=9, shape=(4, SEQ)):
    return np.random.default_rng(seed).integers(0, VOCAB, shape) \
        .astype(np.int32)


def _packing(seed):
    """(labels, startend [4, 1, SEQ, 1]) of one random packing of ``_ids()``
    into documents of 3-12 tokens: each document's first label -100."""
    rng = np.random.default_rng(seed)
    ids = _ids()
    ends = np.empty((4, SEQ), np.int32)
    for r in range(4):
        start = 0
        while start < SEQ:
            end = min(SEQ, start + int(rng.integers(3, 13)))
            ends[r, start:end] = end
            start = end
    labels = ids.copy()
    labels[:, 1:][ends[:, 1:] != ends[:, :-1]] = -100
    return labels, ends[:, None, :, None]


def _llama_loss(m, ids, labels, se=None):
    return m.forward_loss(ids, labels, loss_chunk_size=8,
                          attn_startend_row_indices=se)


def _gpt_loss(m, ids, labels):
    return m.compute_loss(m(ids), labels)


def _sched(mod):
    return mod.lr.LinearWarmup(mod.lr.CosineAnnealingDecay(2e-3, T_max=4), 2,
                               0.0, 2e-3)


def _adamw(mod, ps, clip=None):
    return mod.AdamW(learning_rate=_sched(mod), parameters=ps,
                     weight_decay=0.01,
                     grad_clip=None if clip is None
                     else mod.ClipGradByGlobalNorm(clip))


def _run(models, loss_fn, build, batches, steps=3, accumulate=1,
         remat=True, jax_eager=False):
    """``steps`` steps in both packages, the port through
    ``_step_eager``; batches(i) gives step i's numpy arrays. Returns (JAX
    losses, port losses, JAX weights, port weights, the port trainer,
    the port's (lr, step) buffers as each step left them, the rates the
    schedulers gave)."""
    jm, pm = models
    jo, po = build(jopt, jm.parameters()), build(opt, pm.parameters())
    layers = lambda m: list(m.model.layers) if remat else None
    jtr = None if jax_eager else JaxTrainer(
        jm, jo, loss_fn, mesh=None, donate=False, remat_layers=layers(jm),
        remat_policy="full", accumulate_steps=accumulate)
    ptr = SpmdTrainer(pm, po, loss_fn, remat_layers=layers(pm),
                      accumulate_steps=accumulate)
    want, got, seen, rates = [], [], [], []
    for i in range(steps):
        arrays = batches(i)
        rates.append(po.get_lr())
        if jax_eager:
            loss = loss_fn(jm, *(paddle.to_tensor(a) for a in arrays))
            loss.backward()
            jo.step()
            jo.clear_grad()
            want.append(float(loss.numpy()))
        else:
            want.append(float(jtr.train_step(
                *(paddle.to_tensor(a) for a in arrays)).numpy()))
        got.append(float(ptr._step_eager(
            *(torch.from_numpy(a) for a in arrays))))
        seen.append((float(ptr._lr), float(ptr._step)))
        for o in (jo, po):
            if isinstance(o._learning_rate, (jopt.lr.LRScheduler,
                                             opt.lr.LRScheduler)):
                o._learning_rate.step()
    jw = {n: np.asarray(p._data.astype("float32"))
          for n, p in jm.named_parameters()}
    pw = {n: p.detach().float().numpy() for n, p in pm.named_parameters()}
    return want, got, jw, pw, ptr, seen, rates


def _assert_f32_close(want, got, jw, pw, lr):
    np.testing.assert_allclose(got, want, rtol=1e-5)
    close = total = 0
    for name, w in jw.items():
        d = np.abs(pw[name] - w)
        assert np.all(d <= 3 * lr), name
        close += int((d <= 2e-6).sum())
        total += w.size
    assert close >= 0.999 * total, (close, total)


def test_body_through_static_buffers_matches_jax_llama():
    """The body reads the rate and step count the driver wrote: float32 of
    the scheduler's rate, and the trainer's count."""
    ids = _ids()
    want, got, jw, pw, tr, seen, rates = _run(
        _llamas(), _llama_loss, _adamw, lambda i: (ids, ids))
    _assert_f32_close(want, got, jw, pw, max(rates))
    assert seen == [(float(np.float32(r)), float(i + 1))
                    for i, r in enumerate(rates)]
    assert len(tr._staged) == 1 and tr.opt._global_step == 3


def test_body_takes_a_new_packing_through_the_same_buffers():
    """Packed documents: every step a new packing (labels and FlashMask
    bounds) staged into the one signature's buffers."""
    ids = _ids()
    packings = [_packing(s) for s in (1, 2, 3)]
    want, got, jw, pw, tr, _, rates = _run(
        _llamas(), _llama_loss, _adamw,
        lambda i: (ids,) + packings[i])
    _assert_f32_close(want, got, jw, pw, max(rates))
    (static,) = tr._staged.values()
    assert np.array_equal(static[2].numpy(), packings[2][1])


def test_body_matches_jax_gpt_moe():
    ids = _ids(4)
    want, got, jw, pw, *_, rates = _run(
        _gpts(), _gpt_loss, _adamw, lambda i: (ids, ids), remat=False)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for name, w in jw.items():
        assert np.all(np.abs(pw[name] - w) <= 3 * max(rates)), name


def test_body_accumulates_and_clips_as_jax():
    """accumulate_steps=2 (the micro-batches' losses summed on the
    device) and a global-norm clip that clips."""
    ids = _ids()
    want, got, jw, pw, *_, rates = _run(
        _llamas(), _llama_loss, lambda m, ps: _adamw(m, ps, clip=0.05),
        lambda i: (ids, ids), accumulate=2)
    _assert_f32_close(want, got, jw, pw, max(rates))


RULES = {
    "SGD": lambda m, ps: m.SGD(learning_rate=_sched(m), parameters=ps,
                               weight_decay=0.1),
    "Momentum": lambda m, ps: m.Momentum(learning_rate=_sched(m),
                                         momentum=0.8, parameters=ps,
                                         weight_decay=0.02),
    "Adam": lambda m, ps: m.Adam(learning_rate=_sched(m), parameters=ps,
                                 weight_decay=0.01),
    "AdamW": _adamw,
    "Adagrad": lambda m, ps: m.Adagrad(learning_rate=_sched(m),
                                       parameters=ps,
                                       initial_accumulator_value=0.1),
    "Adadelta": lambda m, ps: m.Adadelta(learning_rate=1.0, rho=0.9,
                                         parameters=ps),
    "Adamax": lambda m, ps: m.Adamax(learning_rate=_sched(m), parameters=ps,
                                     weight_decay=0.01),
    "RMSProp": lambda m, ps: m.RMSProp(learning_rate=_sched(m),
                                       parameters=ps, momentum=0.5,
                                       centered=True),
    "Lamb": lambda m, ps: m.Lamb(learning_rate=_sched(m),
                                 lamb_weight_decay=0.02, parameters=ps),
    "NAdam": lambda m, ps: m.NAdam(learning_rate=_sched(m), parameters=ps),
    "RAdam": lambda m, ps: m.RAdam(learning_rate=_sched(m), parameters=ps,
                                   weight_decay=0.01),
    "Rprop": lambda m, ps: m.Rprop(learning_rate=1e-3, parameters=ps),
    "ASGD": lambda m, ps: m.ASGD(learning_rate=_sched(m), batch_num=2,
                                 parameters=ps),
}


def test_the_thirteen_rules_are_the_jax_packages():
    assert set(RULES) == set(jopt.__all__) - {"Optimizer", "lr", "LBFGS"}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_each_rule_through_the_body_matches_jax(rule):
    ids = _ids()
    want, got, jw, pw, *_, rates = _run(
        _llamas(), _llama_loss, RULES[rule], lambda i: (ids, ids),
        remat=False, jax_eager=rule == "ASGD")
    _assert_f32_close(want, got, jw, pw, max(rates))
    assert got[-1] < got[0]


# -- no host round trip in the body --------------------------------------------------

_HOST_READS = {"item", "tolist", "cpu", "numpy", "nonzero", "__bool__",
               "__float__", "__int__", "tensor", "as_tensor", "from_numpy"}


class _NoHostRoundTrip(TorchFunctionMode):
    """Raises on the calls a captured step cannot hold: reading a tensor on
    the host, and making one from host data."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in _HOST_READS:
            raise AssertionError(f"the step body called {name}")
        return func(*args, **(kwargs or {}))


def _guarded_body(pm, po, loss_fn, arrays, policy="full"):
    layers = list(pm.model.layers) if hasattr(pm, "model") else None
    tr = SpmdTrainer(pm, po, loss_fn, remat_layers=layers,
                     remat_policy=policy)
    batch = tuple(torch.from_numpy(a) for a in arrays)
    tr._step_eager(*batch)          # the first step makes state, constants
    static = tr._stage(batch)
    tr._begin_step()
    with _NoHostRoundTrip():
        tr._step_body(static)
    return tr


def test_guard_catches_a_host_read():
    with pytest.raises(AssertionError, match="item"):
        with _NoHostRoundTrip():
            torch.ones(2).sum().item()


def _recipe(m, ps):
    """AdamW at a scheduled rate, no decay on the named norms, the
    embedding at half the rate, an L1Decay and an L2Decay, clipping."""
    for p in ps:
        if p.dim() == 1:
            set_param_attr(p, ParamAttr(name=f"norm_{id(p)}"))
    ps[0].optimize_attr = {"learning_rate": 0.5}
    ps[1].regularizer = preg.L1Decay(0.02)
    ps[2].regularizer = preg.L2Decay(0.01)
    return m.AdamW(learning_rate=_sched(m), parameters=ps, weight_decay=0.1,
                   apply_decay_param_fun=lambda n: not n.startswith("norm"),
                   grad_clip=m.ClipGradByGlobalNorm(0.5))


@pytest.mark.parametrize("rule", sorted(RULES) + ["recipe"])
def test_body_makes_no_host_round_trip(rule):
    _, pm = _llamas()
    build = _recipe if rule == "recipe" else RULES[rule]
    ids = _ids()
    tr = _guarded_body(pm, build(opt, list(pm.parameters())), _llama_loss,
                       (ids, ids))
    assert tr._step_count == 2


@pytest.mark.parametrize("case", ["packed", "gpt_moe", "dots", "auto_cast"])
def test_model_paths_make_no_host_round_trip(case):
    from paddle_tpu_torch import amp
    ids = _ids()
    if case == "gpt_moe":
        _, pm = _gpts()
        _guarded_body(pm, _adamw(opt, pm.parameters()), _gpt_loss,
                      (ids, ids))
        return
    _, pm = _llamas()
    if case == "packed":
        _guarded_body(pm, _adamw(opt, pm.parameters()), _llama_loss,
                      (ids,) + _packing(1))
    elif case == "dots":
        _guarded_body(pm, _adamw(opt, pm.parameters()), _llama_loss,
                      (ids, ids), policy="dots")
    else:
        def cast_loss(m, i, l):
            with amp.auto_cast(level="O1", dtype="bfloat16"):
                return _llama_loss(m, i, l)
        _guarded_body(pm, _adamw(opt, pm.parameters()), cast_loss,
                      (ids, ids))


# -- optimizer state loaded in place ----------------------------------------------

@pytest.mark.parametrize("rule", ["AdamW", "NAdam", "ASGD"])
def test_set_state_dict_loads_into_the_live_tensors(rule):
    """A captured step updates the state tensors it captured: loading a
    checkpoint must write into them (same ``data_ptr``s), with the saved
    values."""
    _, pm = _llamas()
    po = RULES[rule](opt, pm.parameters())
    tr = SpmdTrainer(pm, po, _llama_loss)
    ids = torch.from_numpy(_ids())
    tr.train_step(ids, ids)
    saved = po.state_dict()
    tr.train_step(ids, ids)
    ptrs = {i: {k: v.data_ptr() for k, v in a.items() if torch.is_tensor(v)}
            for i, a in po._accumulators.items()}
    po.set_state_dict(saved)
    for i, a in po._accumulators.items():
        assert {k: v.data_ptr() for k, v in a.items()
                if torch.is_tensor(v)} == ptrs[i]
    for j, p in enumerate(po._parameter_list):
        for k, v in saved["accumulators"][f"param_{j}"].items():
            got = po._accumulators[id(p)][k]
            assert torch.equal(got, v) if torch.is_tensor(v) else got == v
    assert po._global_step == 1


def test_numpy_state_from_jax_loads_in_place():
    """``load_numpy_optimizer_state`` (a JAX optimizer's state as numpy)
    goes through ``set_state_dict``: into the live tensors too."""
    from paddle_tpu_torch.models import load_numpy_optimizer_state
    jm, pm = _llamas()
    jo = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    po = opt.AdamW(learning_rate=1e-3, parameters=pm.parameters())
    ids = _ids()
    loss = _llama_loss(jm, paddle.to_tensor(ids), paddle.to_tensor(ids))
    loss.backward()
    jo.step()
    tr = SpmdTrainer(pm, po, _llama_loss)
    tr.train_step(torch.from_numpy(ids), torch.from_numpy(ids))
    ptrs = [po._accumulators[id(p)]["moment1"].data_ptr()
            for p in po._parameter_list]
    state = jo.state_dict()
    load_numpy_optimizer_state(po, {
        "global_step": state["global_step"],
        "accumulators": {k: {n: np.asarray(jnp.asarray(
            t._data if hasattr(t, "_data") else t)) for n, t in a.items()}
            for k, a in state["accumulators"].items()}})
    assert [po._accumulators[id(p)]["moment1"].data_ptr()
            for p in po._parameter_list] == ptrs
    first = po._parameter_list[0]
    want = np.asarray(state["accumulators"]["param_0"]["moment1"]._data)
    np.testing.assert_array_equal(
        po._accumulators[id(first)]["moment1"].numpy(), want)
