"""paddle_tpu_torch.amp against paddle_tpu.amp on the CPU.

``auto_cast``: the dtypes ops give under O1 and O2, with and without
custom lists, must be the JAX package's, and the tiny Llama's loss (float32
parameters) must agree with JAX's under ``auto_cast``: both round the
products' and attention's outputs to bf16 at the same places, so the
losses agree to 2e-3 relative (the bf16 trainer test's tolerance) and the
float32 run's differs from both by more than that. ``GradScaler``: the
scale and the good and bad step counts over a sequence with planted infs
are JAX's exactly. ``debugging``: counts, checks and reports as JAX's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import amp as jamp
from paddle_tpu import optimizer as jopt
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.parallel.trainer import SpmdTrainer as JaxTrainer
from paddle_tpu.tensor import Parameter

from paddle_tpu_torch import amp
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.amp import debugging
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     load_numpy_state)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.parallel import SpmdTrainer

VOCAB = 61


def _inputs():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 8)).astype(np.float32)
    w = rng.standard_normal((8, 8)).astype(np.float32)
    return x, w


def _jax_dtypes(kw):
    x, w = _inputs()
    jx, jw = paddle.to_tensor(x), paddle.to_tensor(w)
    with jamp.auto_cast(**kw):
        lin = JF.linear(jx, jw)
        mm = paddle.matmul(jx, jw)
        norm = JF.rms_norm(lin, jw[0])
        soft = JF.softmax(lin)
        add = jx + jx
        act = JF.silu(lin)
    return [str(t._data.dtype) for t in (lin, mm, norm, soft, add, act)]


def _port_dtypes(kw):
    x, w = _inputs()
    px, pw = torch.from_numpy(x), torch.from_numpy(w)
    with amp.auto_cast(**kw):
        lin = F.linear(px, pw)
        mm = px @ pw
        norm = F.rms_norm(lin, pw[0])
        soft = torch.softmax(lin, -1)
        add = px + px
        act = torch.nn.functional.silu(lin)
    return [str(t.dtype).replace("torch.", "") for t in
            (lin, mm, norm, soft, add, act)]


CAST_CASES = {
    "O1": {},
    "O2": {"level": "O2"},
    "O1_custom_black_linear": {"custom_black_list": ["linear"]},
    "O1_custom_white_silu": {"custom_white_list": ["silu", "add"]},
    "O2_custom_black_add": {"level": "O2", "custom_black_list": ["add"]},
    "off": {"enable": False},
}


@pytest.mark.parametrize("case", sorted(CAST_CASES))
def test_auto_cast_dtypes_match_jax(case):
    kw = CAST_CASES[case]
    assert _port_dtypes(kw) == _jax_dtypes(kw)


def test_auto_cast_is_a_scope_and_casts_above_autograd():
    x, w = _inputs()
    pw = torch.from_numpy(w).requires_grad_()
    with amp.auto_cast():
        y = F.linear(torch.from_numpy(x), pw)
    assert y.dtype == torch.bfloat16
    assert (torch.from_numpy(x) @ pw).dtype == torch.float32
    y.float().sum().backward()
    assert pw.grad.dtype == torch.float32
    assert not amp.amp_state.enabled and amp.amp_state.modes == 0


def _models():
    paddle.seed(5)
    jm = JaxLlama(JaxConfig.tiny(vocab_size=VOCAB, hidden_size=32, layers=2,
                                 heads=4, kv_heads=2, seq=32))
    pm = LlamaForCausalLM(LlamaConfig.tiny(vocab_size=VOCAB, hidden_size=32,
                                           layers=2, heads=4, kv_heads=2,
                                           seq=32), device="cpu")
    load_numpy_state(pm, {n: np.asarray(t._data)
                          for n, t in jm.named_state().items()})
    return jm, pm


def _ids():
    return np.random.default_rng(9).integers(0, VOCAB, (4, 24)) \
        .astype(np.int32)


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("chunked", [True, False])
def test_llama_loss_under_auto_cast_matches_jax(level, chunked):
    jm, pm = _models()
    ids = _ids()
    c = 8 if chunked else None
    with jamp.auto_cast(level=level):
        want = float(jm.forward_loss(paddle.to_tensor(ids),
                                     paddle.to_tensor(ids),
                                     loss_chunk_size=c).numpy())
    t = torch.from_numpy(ids)
    with amp.auto_cast(level=level):
        got = pm.forward_loss(t, t, loss_chunk_size=c)
    f32 = float(pm.forward_loss(t, t, loss_chunk_size=c))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=2e-3)
    assert abs(float(got) - f32) > 0.0


def test_llama_logits_dtype_under_auto_cast():
    _, pm = _models()
    t = torch.from_numpy(_ids())
    with amp.auto_cast():
        assert pm(t).dtype == torch.bfloat16
    with amp.auto_cast(custom_black_list=["linear"]):
        assert pm(t).dtype == torch.float32


def test_trainer_under_auto_cast_matches_jax():
    """3 trainer steps (AdamW, full remat) with the loss under auto_cast
    O1 in both packages: the recompute casts as the forward did, and the
    losses agree to the bf16 tolerance."""
    jm, pm = _models()
    ids = _ids()

    def jloss(m, i, l):
        with jamp.auto_cast():
            return m.forward_loss(i, l, loss_chunk_size=8)

    def ploss(m, i, l):
        with amp.auto_cast():
            return m.forward_loss(i, l, loss_chunk_size=8)

    jtr = JaxTrainer(jm, jopt.AdamW(learning_rate=1e-3,
                                    parameters=jm.parameters()),
                     jloss, mesh=None, remat_layers=list(jm.model.layers))
    ptr = SpmdTrainer(pm, opt.AdamW(learning_rate=1e-3,
                                    parameters=pm.parameters()),
                      ploss, remat_layers=list(pm.model.layers))
    want = [float(jtr.train_step(paddle.to_tensor(ids),
                                 paddle.to_tensor(ids)).numpy())
            for _ in range(3)]
    t = torch.from_numpy(ids)
    got = [float(ptr.train_step(t, t)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=2e-3)
    assert got[-1] < got[0]
    assert all(p.dtype == torch.float32 for p in pm.parameters())


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_decorate_matches_jax(level):
    jm, pm = _models()
    po = opt.AdamW(parameters=pm.parameters())
    jo = jopt.AdamW(parameters=jm.parameters())
    pm2, po2 = amp.decorate(pm, po, level=level)
    jm2, jo2 = jamp.decorate(jm, jo, level=level)
    assert pm2 is pm and po2 is po
    assert [str(p.dtype).replace("torch.", "") for p in pm.parameters()] == \
        [str(p._data.dtype) for p in jm.parameters()]
    assert amp.decorate([pm]) == [pm]


# a gradient per step; None where a step plants an inf
SCALER_STEPS = [0.5, None, 1.0, -2.0, None, None, 0.25, 3.0, 1.5, None, 0.1]


def test_grad_scaler_matches_jax():
    js = jamp.GradScaler(init_loss_scaling=1024.0, incr_every_n_steps=2,
                         decr_every_n_nan_or_inf=1)
    ps = amp.GradScaler(init_loss_scaling=1024.0, incr_every_n_steps=2,
                        decr_every_n_nan_or_inf=1)
    jp = Parameter(jnp.ones(3, jnp.float32))
    pp = torch.nn.Parameter(torch.ones(3))
    jo = jopt.SGD(learning_rate=0.1, parameters=[jp])
    po = opt.SGD(learning_rate=0.1, parameters=[pp])
    seen = []
    for g in SCALER_STEPS:
        grad = np.array([1.0, 2.0, 3.0], np.float32) * (g or 1.0)
        if g is None:
            grad[1] = np.inf
        jl = (jp * paddle.to_tensor(grad)).sum()
        js.scale(jl).backward()
        js.step(jo)
        jo.clear_grad()
        pl = (pp * torch.from_numpy(grad)).sum()
        ps.scale(pl).backward()
        ps.step(po)
        po.clear_grad()
        assert (ps._scale, ps._good_steps, ps._bad_steps) == \
            (js._scale, js._good_steps, js._bad_steps)
        np.testing.assert_array_equal(pp.detach().numpy(),
                                      np.asarray(jp._data))
        seen.append(ps._scale)
    assert min(seen) < 1024.0 and any(b > a for a, b in zip(seen, seen[1:]))
    assert ps.state_dict() == js.state_dict()
    again = amp.GradScaler()
    again.load_state_dict(ps.state_dict())
    assert again.state_dict() == ps.state_dict()
    assert amp.is_bfloat16_supported() and amp.is_float16_supported()


def test_grad_scaler_skips_the_step_and_halves_the_scale():
    pp = torch.nn.Parameter(torch.ones(4))
    po = opt.AdamW(learning_rate=0.1, parameters=[pp])
    sc = amp.GradScaler(init_loss_scaling=8.0)
    loss = (pp * torch.tensor([1.0, float("inf"), 1.0, 1.0])).sum()
    sc.minimize(po, sc.scale(loss))
    assert torch.equal(pp.detach(), torch.ones(4))
    assert sc._scale == 4.0 and po._global_step == 0


# -- debugging -----------------------------------------------------------------

def test_check_numerics_matches_jax():
    from paddle_tpu.amp import debugging as jdbg
    x = np.array([0.0, 1.0, np.nan, np.inf, -np.inf, 0.0], np.float32)
    want = [int(np.asarray(t._data)) for t in jdbg.check_numerics(
        paddle.to_tensor(x), debug_mode=jdbg.DebugMode.CHECK_NAN_INF)]
    got = [int(t) for t in debugging.check_numerics(
        torch.from_numpy(x), debug_mode=debugging.DebugMode.CHECK_NAN_INF)]
    assert got == want == [1, 2, 2]
    with pytest.raises(FloatingPointError):
        debugging.check_numerics(torch.from_numpy(x), "op", "x")


CORE_OPS = ("embedding", "linear", "rms_norm", "fused_rope", "sdpa",
            "chunked_causal_ce", "silu", "multiply", "add")


def test_operator_stats_count_the_jax_op_names():
    """The tiny Llama's forward loss counted op by op in both packages:
    the ops of the model's own code (projections, norms, rope, attention,
    loss, activation, products and residual sums) by the same names,
    dtypes and counts."""
    from paddle_tpu.amp import debugging as jdbg
    jm, pm = _models()
    ids = _ids()
    jdbg.enable_operator_stats_collection()
    jm.forward_loss(paddle.to_tensor(ids), paddle.to_tensor(ids),
                    loss_chunk_size=8)
    want = jdbg.disable_operator_stats_collection()
    t = torch.from_numpy(ids)
    with debugging.collect_operator_stats():
        pm.forward_loss(t, t, loss_chunk_size=8)
    got = debugging.disable_operator_stats_collection()
    assert got is None
    debugging.enable_operator_stats_collection()
    pm.forward_loss(t, t, loss_chunk_size=8)
    got = debugging.disable_operator_stats_collection()

    def core(stats):
        return {k: v for k, v in stats.items() if k.split("(")[0] in CORE_OPS}
    assert core(got) == core(want)
    assert core(got)["linear(float32)"] == 14
    assert amp.amp_state.modes == 0 and not amp.amp_state.observers


def test_tensor_checker_raises_on_a_nan_output():
    x = torch.tensor([[1.0, -1.0], [0.5, 2.0]])
    w = torch.tensor([[1.0, 0.0], [0.0, float("nan")]])
    debugging.enable_tensor_checker(debugging.TensorCheckerConfig())
    try:
        F.linear(x, torch.eye(2))
        with pytest.raises(FloatingPointError, match="linear"):
            F.linear(x, w)
        with pytest.raises(FloatingPointError, match="matmul"):
            x @ w
    finally:
        debugging.disable_tensor_checker()
    F.linear(x, w)
    debugging.enable_tensor_checker(debugging.TensorCheckerConfig(
        enable=False))
    F.linear(x, w)
    debugging.disable_tensor_checker()
    assert amp.amp_state.modes == 0 and amp.amp_state.checker is None


def test_check_layer_numerics():
    class Layer(torch.nn.Module):
        @debugging.check_layer_numerics
        def forward(self, x):
            return x * 2

    Layer()(torch.ones(2))
    with pytest.raises(FloatingPointError):
        Layer()(torch.tensor([1.0, float("nan")]))


def test_compare_accuracy_matches_jax(tmp_path):
    from paddle_tpu.amp import debugging as jdbg
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    rng = np.random.default_rng(2)
    for name, shape in (("x.npy", (3, 4)), ("y.npy", (5,)),
                        ("z.npy", (2, 2))):
        np.save(a / name, rng.standard_normal(shape).astype(np.float32))
        np.save(b / name, rng.standard_normal(
            shape if name != "z.npy" else (3,)).astype(np.float32))
    want = jdbg.compare_accuracy(str(a), str(b), str(tmp_path / "j.csv"))
    got = debugging.compare_accuracy(str(a), str(b), str(tmp_path / "p.csv"))
    assert got == want
    assert (tmp_path / "p.csv").read_text() == \
        (tmp_path / "j.csv").read_text()
