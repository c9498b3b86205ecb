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
    update = tr.opt._update

    def spy(params, grads, step):
        seen.append(([g.data_ptr() for g in grads],
                     float(torch.sqrt(sum((g.float() ** 2).sum()
                                          for g in grads)))))
        return update(params, grads, step)

    tr.opt._update = spy
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
    _, pm = _models(False)
    o = opt.AdamW(parameters=pm.parameters())
    with pytest.raises(NotImplementedError):
        SpmdTrainer(pm, o, _loss_fn, remat_layers=list(pm.model.layers),
                    remat_policy="dots")
    tr = SpmdTrainer(pm, o, _loss_fn, accumulate_steps=3)
    ids, labels = _batch()
    with pytest.raises(ValueError, match="accumulate_steps"):
        tr.train_step(torch.from_numpy(ids), torch.from_numpy(labels))


def test_optimizer_refuses_unported_options():
    p = [torch.nn.Parameter(torch.zeros(3))]
    with pytest.raises(NotImplementedError):
        opt.AdamW(learning_rate=lambda: 0.1, parameters=p)
    with pytest.raises(NotImplementedError):
        opt.Adam(parameters=p, multi_precision=True)
    with pytest.raises(NotImplementedError):
        opt.AdamW(parameters=p, apply_decay_param_fun=lambda n: True)


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
