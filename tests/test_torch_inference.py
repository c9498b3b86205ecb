"""paddle_tpu_torch.inference, the serving front door, against
paddle_tpu.inference on the CPU (as tests/test_serve_engine.py drives the
JAX one): the Config's serving knobs route to the engine without a
warning, the no-op knobs warn once, clones and pooled predictors share one
engine, and the padded outputs of ``create_llm_predictor`` equal the JAX
predictor's over the same weights."""
import functools
import warnings

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import inference as jax_inference
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama

from paddle_tpu_torch import inference
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     load_numpy_state)
from paddle_tpu_torch.serving import engine_from_config

VOCAB = 61


@functools.lru_cache(maxsize=None)
def _jax_model():
    paddle.seed(3)
    cfg = JaxConfig.tiny(vocab_size=VOCAB, hidden_size=32, layers=2, heads=4,
                         kv_heads=2, seq=64)
    cfg.use_flash_attention = False
    return JaxLlama(cfg)


@functools.lru_cache(maxsize=None)
def _port_model():
    model = LlamaForCausalLM(
        LlamaConfig.tiny(vocab_size=VOCAB, hidden_size=32, layers=2, heads=4,
                         kv_heads=2, seq=64), device="cpu")
    load_numpy_state(model, {n: np.asarray(t._data) for n, t in
                             _jax_model().named_state().items()})
    return model


def _config(package, max_seqs=3, block_size=8, capacity=24):
    conf = package.Config()
    conf.set_max_batch_size(max_seqs)
    conf.set_kv_cache_block_size(block_size)
    conf.set_kv_cache_capacity(capacity)
    return conf


def test_config_knobs_route_to_engine():
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # routed knobs must NOT warn
        pred = inference.create_llm_predictor(_port_model(),
                                              _config(inference),
                                              max_new_tokens=4, device="cpu")
    eng = pred.engine
    assert eng.config.max_seqs == 3
    assert eng.config.token_budget == 64       # max(8 * max_seqs, 64)
    assert eng.pool.block_size == 8
    assert eng.pool.num_blocks == 24
    assert pred.clone().engine is eng          # pool/scheduler shared


@pytest.mark.parametrize("max_seqs, budget", [(3, 64), (12, 96)])
def test_engine_from_config_token_budget(max_seqs, budget):
    conf = inference.Config()
    conf.set_max_batch_size(max_seqs)
    eng = engine_from_config(_port_model(), conf, device="cpu")
    assert (eng.config.max_seqs, eng.config.token_budget) == (max_seqs,
                                                              budget)
    eng = engine_from_config(_port_model(), conf, device="cpu",
                             token_budget=32)
    assert eng.config.token_budget == 32       # overrides win


def test_tensorrt_max_batch_size_routed():
    conf = inference.Config()
    with pytest.warns(UserWarning, match="routed to the serving engine"):
        conf.enable_tensorrt_engine(1 << 20, 5)
    assert conf.serving_options()["max_seqs"] == 5


@pytest.mark.parametrize("knob", ["switch_ir_optim", "enable_memory_optim",
                                  "enable_xpu",
                                  "set_cpu_math_library_num_threads"])
def test_noop_knobs_warn_once(knob, monkeypatch):
    monkeypatch.setattr(inference, "_warned_noops", set())
    conf = inference.Config()
    args = {"switch_ir_optim": (False,), "enable_memory_optim": (False,),
            "set_cpu_math_library_num_threads": (4,)}.get(knob, ())
    with pytest.warns(UserWarning, match="has no effect here"):
        getattr(conf, knob)(*args)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        getattr(conf, knob)(*args)             # once per process


@pytest.mark.parametrize("knob, device, use_gpu, device_id", [
    ("default", None, True, 0), ("enable_use_gpu", "cuda:1", True, 1),
    ("disable_gpu", "cpu", False, 0)])
def test_gpu_knobs_pick_the_predictors_device(knob, device, use_gpu,
                                              device_id):
    """enable_use_gpu / disable_gpu are routed, not warned: they name the
    device the Predictors run on, and set_model keeps it."""
    conf = inference.Config()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        if knob == "enable_use_gpu":
            conf.enable_use_gpu(100, 1)
        elif knob == "disable_gpu":
            conf.disable_gpu()
    conf.set_model("somewhere/model")
    assert (conf.device(), conf.use_gpu(), conf.gpu_device_id()) == \
        (device, use_gpu, device_id)


def test_disable_gpu_puts_the_engine_predictor_on_the_cpu():
    """create_llm_predictor with no device= serves on the config's
    device: after disable_gpu() the CPU, with no GPU asked for."""
    conf = inference.Config()
    conf.disable_gpu()
    pred = inference.create_llm_predictor(_port_model(), conf,
                                          max_new_tokens=2)
    assert pred.engine.device.type == "cpu"


@pytest.mark.parametrize("call", ["set_tensor_parallel_degree",
                                  "set_speculative_config",
                                  "create_predictor"])
def test_unported_front_door_raises(call):
    conf = inference.Config()
    if call == "set_speculative_config":
        # speculative decoding is ported: a method the JAX package lacks
        # raises as there (tests/test_torch_speculative.py routes the rest)
        with pytest.raises(ValueError, match="unknown speculative"):
            conf.set_speculative_config("medusa")
        return
    if call == "create_predictor":
        # the artifact Predictor is ported: a Config without a model path
        # raises as in the JAX package (tests/test_torch_predictor.py runs
        # the rest)
        with pytest.raises(ValueError, match="model path"):
            inference.PredictorPool(config=conf)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        conf.set_tensor_parallel_degree(2)


def test_predictor_pool_clones_share_one_engine():
    pred = inference.create_llm_predictor(_port_model(), _config(inference),
                                          max_new_tokens=3, device="cpu")
    pool = inference.PredictorPool(predictor=pred, size=3)
    assert len(pool) == 3 and pool.retrieve(0) is pred
    assert all(pool.retrieve(i).engine is pred.engine for i in range(3))
    with pytest.raises(ValueError):
        inference.PredictorPool(predictor=pred, size=0)


def _inputs(kind):
    rng = np.random.default_rng(2)
    if kind == "one":
        return rng.integers(1, VOCAB, (7,))
    if kind == "batch":
        return rng.integers(1, VOCAB, (3, 6))
    return [rng.integers(1, VOCAB, (n,)).tolist() for n in (9, 2, 5, 12)]


@pytest.mark.parametrize("kind", ["one", "batch", "ragged"])
def test_predictor_outputs_match_jax(kind):
    """Padded (-1) outputs of the engine-backed predictor, with an eos that
    cuts some rows short, equal the JAX predictor's."""
    ids = _inputs(kind)
    outs = []
    for package, model, kw in ((jax_inference, _jax_model(), {}),
                               (inference, _port_model(),
                                {"device": "cpu"})):
        pred = package.create_llm_predictor(model, _config(package),
                                            max_new_tokens=6, eos_id=17,
                                            **kw)
        assert pred.get_input_names() == ["input_ids"]
        (out,) = pred.run([ids])
        outs.append(out)
    assert outs[1].dtype == np.int32
    np.testing.assert_array_equal(outs[1], outs[0])


def test_predictor_refuses_3d_input():
    pred = inference.create_llm_predictor(_port_model(), device="cpu")
    with pytest.raises(ValueError, match="ndim=3"):
        pred.run([np.ones((1, 2, 3), np.int64)])
