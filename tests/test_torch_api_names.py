"""Names the JAX API has, taken by the port's modules, against paddle_tpu
on the CPU: ``scaled_dot_product_attention(..., allow_flash=)``,
``LlamaConfig.use_flash_attention`` passed on as ``allow_flash``,
``LlamaConfig.llama2_13b()``, ``apply_rope``, ``build_rope_cache(...,
dtype=)``, ``config=`` on the Llama modules, ``sublayers=`` on
``LayerList``, ``framework.io.load(path, return_numpy=False,
**configs)``, ``ServingEngine(model, config, seed)`` (F16), a loaded
``jit`` artifact as an ``nn.Layer`` (F17) and ``Conv2D(padding_mode=)``
(F18).

Tolerances: attention and RoPE in float32 within 1e-5 of the largest
reference value (fp32 sums in another order); the rope tables within
2.5e-7 in float32 (two ulps of values up to 1: XLA's cos and sin and
PyTorch's round differently) and one ulp (2^-8) in bfloat16; presets and
loaded arrays exactly.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import llama as JL
from paddle_tpu.tensor import Tensor

from paddle_tpu_torch.framework import io as framework
from paddle_tpu_torch import kernels as K
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.models import (LlamaAttention, LlamaConfig,
                                     LlamaDecoderLayer, LlamaForCausalLM,
                                     LlamaMLP, LlamaModel, apply_rope,
                                     build_rope_cache)
from paddle_tpu_torch.nn import functional as F


def _close(got, want, tol=1e-5):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want._data if isinstance(want, Tensor) else want,
                      np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("allow_flash", [True, False])
def test_sdpa_allow_flash_matches_jax(allow_flash):
    """Without a mask: ``allow_flash`` routes to the flash entry (on the
    CPU its plain version) or, when False, to the dense reference, counted
    in ``sdpa_dense``; both equal the JAX function's values."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 6, 2, 64)).astype(np.float32)
               for _ in range(3))
    want = paddle.nn.functional.scaled_dot_product_attention(
        *(Tensor(jnp.asarray(a)) for a in (q, k, v)), is_causal=True,
        allow_flash=allow_flash)
    before = dict(K.LAUNCHES)
    got = F.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), is_causal=True,
        allow_flash=allow_flash)
    dense = K.LAUNCHES["sdpa_dense"] - before["sdpa_dense"]
    assert dense == (0 if allow_flash else 1)
    _close(got, want)


def test_llama_use_flash_attention_is_passed_as_allow_flash():
    """``use_flash_attention=False`` sends each layer's attention to the
    dense reference (one ``sdpa_dense`` a layer), with the logits of the
    flash route; the default keeps flash."""
    assert LlamaConfig().use_flash_attention is True
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 8)))
    logits = []
    for flash in (True, False):
        cfg = LlamaConfig.tiny(layers=2, hidden_size=128, heads=2,
                               kv_heads=2)
        cfg.use_flash_attention = flash
        model = LlamaForCausalLM(cfg, device="cpu")
        before = K.LAUNCHES["sdpa_dense"]
        logits.append(model(ids))
        assert K.LAUNCHES["sdpa_dense"] - before == (0 if flash else 2)
    _close(logits[1], logits[0].detach().numpy())


def test_llama_presets_match_jax():
    """``llama2_13b()`` and ``llama2_7b()`` hold the JAX presets' values
    for every field the port has (``sequence_parallel`` belongs to the
    distributed layer, which is not ported)."""
    port_fields = {f.name for f in dataclasses.fields(LlamaConfig)}
    jax_fields = {f.name for f in dataclasses.fields(JL.LlamaConfig)}
    assert jax_fields - port_fields == {"sequence_parallel"}
    for preset in ("llama2_13b", "llama2_7b"):
        got = dataclasses.asdict(getattr(LlamaConfig, preset)())
        want = dataclasses.asdict(getattr(JL.LlamaConfig, preset)())
        want.pop("sequence_parallel")
        assert got == want, preset
    assert LlamaConfig.llama2_13b().hidden_size == 5120


def test_apply_rope_and_rope_cache_match_jax():
    """``build_rope_cache(seq, head_dim, theta, dtype=)`` and the plain
    pair rotation ``apply_rope`` against the JAX functions."""
    for dtype in ("float32", "bfloat16"):
        jc, js = JL.build_rope_cache(16, 8, 500.0, dtype=getattr(jnp, dtype))
        pc, ps = build_rope_cache(16, 8, 500.0, dtype=getattr(torch, dtype))
        assert pc.dtype == getattr(torch, dtype)
        tol = 2.5e-7 if dtype == "float32" else 2.0 ** -8
        for got, want in ((pc, jc), (ps, js)):
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32), rtol=0,
                                       atol=tol)
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 16, 3, 8)).astype(np.float32)
    k = rng.standard_normal((2, 16, 1, 8)).astype(np.float32)
    jc, js = JL.build_rope_cache(16, 8)
    pc, ps = build_rope_cache(16, 8)
    jq, jk = JL.apply_rope(jnp.asarray(q), jnp.asarray(k), jc, js)
    pq, pk = apply_rope(torch.from_numpy(q), torch.from_numpy(k), pc, ps)
    _close(pq, jq)
    _close(pk, jk)
    pq16, _ = apply_rope(torch.from_numpy(q).bfloat16(),
                         torch.from_numpy(k).bfloat16(), pc, ps)
    assert pq16.dtype == torch.bfloat16


def test_llama_modules_take_config_by_keyword():
    """The JAX keyword ``config=`` on every Llama module (with the port's
    own ``device`` and ``dtype``); the parameter names are the JAX
    model's."""
    cfg = LlamaConfig.tiny(layers=1)
    jcfg = JL.LlamaConfig.tiny(layers=1)
    for pcls, jcls in ((LlamaModel, JL.LlamaModel),
                       (LlamaDecoderLayer, JL.LlamaDecoderLayer),
                       (LlamaAttention, JL.LlamaAttention),
                       (LlamaMLP, JL.LlamaMLP)):
        pm = pcls(config=cfg, device="cpu")
        jm = jcls(config=jcfg)
        assert sorted(n for n, _ in pm.named_parameters()) == \
            sorted(n for n, _ in jm.named_parameters())
    assert LlamaForCausalLM(config=cfg, device="cpu").config is cfg


def test_layer_list_takes_sublayers():
    layers = pnn.LayerList(sublayers=[pnn.ReLU(), pnn.Tanh()])
    jlayers = paddle.nn.LayerList(sublayers=[paddle.nn.ReLU(),
                                             paddle.nn.Tanh()])
    assert len(layers) == len(jlayers) == 2
    assert [type(m).__name__ for m in layers] == ["ReLU", "Tanh"]
    assert len(pnn.LayerList()) == 0


def test_framework_load_return_numpy_and_configs(tmp_path):
    """A file the JAX package saved: ``load(path)`` gives torch tensors
    (the JAX package's gives Tensors), ``return_numpy=True`` numpy
    arrays, each equal to the saved values; extra ``configs`` are
    accepted, as there."""
    rng = np.random.default_rng(4)
    state = {"w": rng.standard_normal((3, 4)).astype(np.float32),
             "nested": {"b": np.arange(5, dtype=np.int64)}}
    path = str(tmp_path / "state.pdparams")
    paddle.save({"w": paddle.to_tensor(state["w"]),
                 "nested": {"b": paddle.to_tensor(state["nested"]["b"])}},
                path)
    jt = paddle.load(path)
    got = framework.load(path, keep_name_table=True)
    assert isinstance(jt["w"], Tensor) and torch.is_tensor(got["w"])
    np.testing.assert_array_equal(got["w"].numpy(), state["w"])
    np.testing.assert_array_equal(got["nested"]["b"].numpy(),
                                  state["nested"]["b"])
    arrays = framework.load(path, return_numpy=True)
    jarrays = paddle.load(path, return_numpy=True)
    assert isinstance(arrays["w"], np.ndarray)
    np.testing.assert_array_equal(arrays["w"], np.asarray(jarrays["w"]))
    framework.save({"x": torch.ones(2)}, str(tmp_path / "x.pd"),
                   protocol=4, use_binary_format=True)
    assert torch.equal(framework.load(str(tmp_path / "x.pd"))["x"],
                       torch.ones(2))


def test_serving_engine_third_argument_is_the_seed():
    """F16: the JAX engine's signature is (model, config=None, seed=0):
    ``seed=`` is taken, a positional third argument is the seed (not a
    device), and ``device`` is keyword-only."""
    import inspect

    from paddle_tpu_torch.serving import EngineConfig, ServingEngine
    from paddle_tpu.serving.engine import ServingEngine as JaxEngine
    want = list(inspect.signature(JaxEngine).parameters)
    params = inspect.signature(ServingEngine).parameters
    assert list(params)[:3] == want == ["model", "config", "seed"]
    assert params["seed"].default == 0
    assert params["device"].kind is inspect.Parameter.KEYWORD_ONLY
    model = LlamaForCausalLM(LlamaConfig.tiny(vocab_size=64, hidden_size=32,
                                              layers=1, heads=4, kv_heads=2,
                                              seq=32), device="cpu")
    cfg = EngineConfig(max_seqs=2, token_budget=16, block_size=8)
    a = ServingEngine(model, cfg, seed=3, device="cpu")
    b = ServingEngine(model, cfg, 1, device="cpu")
    assert a.device.type == b.device.type == "cpu"
    ids = [[5, 6, 7, 8]]
    assert a.generate_batch(ids, max_new_tokens=4) \
        == b.generate_batch(ids, max_new_tokens=4)


class _Mlp(pnn.Layer):
    def __init__(self):
        super().__init__(device="cpu")
        self.l1 = pnn.Linear(6, 8, device="cpu")
        self.l2 = pnn.Linear(8, 3, device="cpu")

    def forward(self, x):
        return self.l2(F.relu(self.l1(x)))


# the JAX Layer methods a loaded artifact lacked before it became a Layer
_LAYER_METHODS = ("set_state_dict", "set_dict", "load_dict", "sublayers",
                  "named_sublayers", "named_state",
                  "register_forward_post_hook", "astype", "add_parameter",
                  "add_sublayer", "create_parameter", "create_tensor",
                  "swap_state")


def test_translated_layer_is_a_layer(tmp_path):
    """F17: ``jit.load`` returns an ``nn.Layer``, as the JAX
    ``TranslatedLayer`` is one: it has the Layer methods, its own
    ``state_dict`` (the program's state), ``set_state_dict`` copies into
    that state in place, and the outputs follow it."""
    from paddle_tpu.jit import TranslatedLayer as JaxTranslated
    from paddle_tpu_torch import jit
    torch.manual_seed(0)
    model = _Mlp()
    path = str(tmp_path / "mlp")
    jit.save(model, path, input_spec=[jit.InputSpec([None, 6], "float32")])
    loaded = jit.load(path, device="cpu")
    assert isinstance(loaded, pnn.Layer)
    assert issubclass(JaxTranslated, paddle.nn.Layer)
    for name in _LAYER_METHODS:
        assert callable(getattr(loaded, name)), name
        assert callable(getattr(JaxTranslated, name)), name
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (5, 6)).astype(np.float32))
    with torch.no_grad():
        live = model(x)
    assert torch.equal(loaded(x), live)
    state = loaded.state_dict()
    assert sorted(state) == sorted(model.state_dict())
    doubled = {k: 2 * v for k, v in state.items()}
    missing, unexpected = loaded.set_state_dict(doubled)
    assert missing == [] and unexpected == []
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, doubled[k])
    model.set_state_dict(doubled)
    with torch.no_grad():
        assert torch.equal(loaded(x), model(x))
    loaded.set_state_dict({k: v / 2 for k, v in doubled.items()})
    assert torch.equal(loaded(x), live)


@pytest.mark.parametrize("mode", ["reflect", "replicate", "circular"])
def test_conv2d_padding_mode_is_accepted_and_pads_with_zeros(mode):
    """F18: the JAX ``Conv2D`` stores ``padding_mode`` and never reads it,
    so every mode pads with zeros; the port's layer takes it too and gives
    the JAX layer's output on the same weights (float32, 1e-5 of the
    largest value: sums in another order)."""
    from paddle_tpu_torch.models import load_numpy_state
    paddle.seed(8)
    jl = paddle.nn.Conv2D(3, 4, 3, padding=1, padding_mode=mode)
    pl = pnn.Conv2D(3, 4, 3, padding=1, padding_mode=mode, device="cpu")
    assert pl._padding_mode == jl._padding_mode == mode
    load_numpy_state(pl, {n: np.asarray(t._data)
                          for n, t in jl.named_state().items()})
    x = np.random.default_rng(8).standard_normal((2, 3, 6, 5)) \
        .astype(np.float32)
    with torch.no_grad():
        got = pl(torch.from_numpy(x))
        zeros = pnn.Conv2D(3, 4, 3, padding=1, device="cpu")
        zeros.set_state_dict(pl.state_dict())
        assert torch.equal(got, zeros(torch.from_numpy(x)))
    _close(got, jl(Tensor(jnp.asarray(x))))
