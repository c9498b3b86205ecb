"""paddle_tpu_torch.inference's artifact Predictor, PredictorPool and
BatchingServer against paddle_tpu's, on the CPU: the cases of
``tests/test_serving.py``, and the server's delegation to the serving
engine.

An MLP and a tiny Llama are built in paddle_tpu and their weights carried
across as numpy; each package saves its own artifact. Outputs agree with
the JAX predictor's within 1e-5 (float32, sums in another order) and with
the port's live module exactly. Delegation: a BatchingServer over an
``EnginePredictor`` returns, for requests submitted from several threads,
the tokens of the engine's ``generate_batch``; a step that raises fails
every Future instead of leaving one waiting.
"""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import create_predictor as jax_create_predictor
from paddle_tpu.jit import InputSpec as JaxInputSpec
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama

from paddle_tpu_torch import jit
from paddle_tpu_torch.inference import (BatchingServer, Config,
                                        PredictorPool, create_llm_predictor,
                                        create_predictor)
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     load_numpy_state)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.serving import EngineConfig, ServingEngine


class _Linear(torch.nn.Module):
    def __init__(self, n_in, n_out):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.zeros(n_in, n_out))
        self.bias = torch.nn.Parameter(torch.zeros(n_out))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


def _saved_mlp(tmp_path, seed=5):
    """(live port MLP, its artifact's Config on the CPU, the JAX
    artifact's path) over the same weights."""
    paddle.seed(seed)
    jm = jnn.Sequential(jnn.Linear(10, 32), jnn.ReLU(), jnn.Linear(32, 4))
    pm = torch.nn.Sequential(_Linear(10, 32), torch.nn.ReLU(),
                             _Linear(32, 4))
    load_numpy_state(pm, {n: np.asarray(t._data)
                          for n, t in jm.named_state().items()})
    jpath, path = str(tmp_path / "jax_mlp"), str(tmp_path / "mlp")
    paddle.jit.save(jm, jpath,
                    input_spec=[JaxInputSpec([None, 10], "float32")])
    jit.save(pm, path, input_spec=[jit.InputSpec([None, 10], "float32")])
    conf = Config(path)
    conf.disable_gpu()
    return pm, conf, jpath


def _live(m, x):
    with torch.no_grad():
        return m(torch.from_numpy(x)).numpy()


def test_predictor_matches_jax_and_live(tmp_path):
    m, conf, jpath = _saved_mlp(tmp_path)
    pred = create_predictor(conf)
    jpred = jax_create_predictor(JaxConfig(jpath + ".pdmodel"))
    assert pred.get_input_names() == jpred.get_input_names() == ["input_0"]
    x = np.random.default_rng(2).standard_normal((5, 10)).astype(np.float32)
    # handle-style
    h = pred.get_input_handle("input_0")
    h.copy_from_cpu(x)
    assert h.shape == [5, 10]
    outs = pred.run()
    np.testing.assert_array_equal(outs[0], _live(m, x))
    np.testing.assert_allclose(outs[0], jpred.run([x])[0], rtol=1e-5,
                               atol=1e-5)
    out_h = pred.get_output_handle(pred.get_output_names()[0])
    np.testing.assert_array_equal(out_h.copy_to_cpu(), outs[0])
    # the list form
    np.testing.assert_array_equal(pred.run([x])[0], outs[0])
    with pytest.raises(ValueError, match="expects 1 inputs"):
        pred.run([x, x])


def test_llama_predictor_matches_jax(tmp_path):
    paddle.seed(0)
    kw = dict(vocab_size=64, hidden_size=32, layers=2, heads=4, kv_heads=2,
              seq=16)
    cfg = JaxLlamaConfig.tiny(**kw)
    cfg.use_flash_attention = False
    jm = JaxLlama(cfg)
    pm = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu")
    load_numpy_state(pm, {n: np.asarray(t._data)
                          for n, t in jm.named_state().items()})
    paddle.jit.save(jm, str(tmp_path / "j"),
                    input_spec=[JaxInputSpec([2, 16], "int32")])
    jit.save(pm, str(tmp_path / "p"),
             input_spec=[jit.InputSpec([None, None], "int32")])
    conf = Config(str(tmp_path / "p"))
    conf.disable_gpu()
    ids = np.random.default_rng(3).integers(0, 64, (2, 16)).astype(np.int32)
    got = create_predictor(conf).run([ids])[0]
    want = jax_create_predictor(JaxConfig(str(tmp_path / "j"))).run([ids])[0]
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_clone_shares_weights_private_handles(tmp_path):
    m, conf, _ = _saved_mlp(tmp_path)
    p1 = create_predictor(conf)
    p2 = p1.clone()
    assert p2._layer is p1._layer          # one program and one state
    x1 = np.random.default_rng(0).standard_normal((2, 10)).astype(np.float32)
    x2 = np.random.default_rng(1).standard_normal((3, 10)).astype(np.float32)
    p1.get_input_handle(p1.get_input_names()[0]).copy_from_cpu(x1)
    p2.get_input_handle(p2.get_input_names()[0]).copy_from_cpu(x2)
    o1 = p1.run()
    o2 = p2.run()
    np.testing.assert_array_equal(o1[0], _live(m, x1))
    np.testing.assert_array_equal(o2[0], _live(m, x2))


def test_pool_concurrent_clients(tmp_path):
    m, conf, _ = _saved_mlp(tmp_path)
    n_threads = 4
    pool = PredictorPool(conf, size=n_threads)
    assert len(pool) == n_threads
    assert len({id(pool.retrieve(i)._layer) for i in range(n_threads)}) == 1
    rng = np.random.default_rng(2)
    xs = [rng.standard_normal((2, 10)).astype(np.float32)
          for _ in range(n_threads)]
    results = [None] * n_threads
    errors = []

    def client(i):
        try:
            for _ in range(5):
                results[i] = pool.retrieve(i).run([xs[i]])[0]
        except Exception as e:  # noqa: BLE001  (surfaced below)
            errors.append((i, e))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    for got, x in zip(results, xs):
        np.testing.assert_array_equal(got, _live(m, x))


def test_batching_server_groups_requests(tmp_path):
    m, conf, _ = _saved_mlp(tmp_path)
    server = BatchingServer(create_predictor(conf), max_batch_size=8,
                            max_delay_ms=30.0)
    try:
        rng = np.random.default_rng(3)
        xs = [rng.standard_normal((10,)).astype(np.float32)
              for _ in range(16)]
        futs = [server.submit([x]) for x in xs]
        outs = [f.result(timeout=120) for f in futs]
        for x, o in zip(xs, outs):
            np.testing.assert_allclose(o[0], _live(m, x[None])[0],
                                       rtol=1e-6, atol=1e-6)
        assert server.requests_served == 16
        # grouped: fewer forwards than requests
        assert server.batches_run < 16, server.batches_run
    finally:
        server.close()


def test_batching_server_multithreaded_clients_and_shape_change(tmp_path):
    m, conf, _ = _saved_mlp(tmp_path)
    server = BatchingServer(create_predictor(conf), max_batch_size=4,
                            max_delay_ms=10.0)
    try:
        rng = np.random.default_rng(4)
        xs = [rng.standard_normal((10,)).astype(np.float32)
              for _ in range(12)]
        results = {}
        lock = threading.Lock()

        def client(i):
            out = server.submit([xs[i]]).result(timeout=120)
            with lock:
                results[i] = out[0]

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert len(results) == 12
        for i, o in results.items():
            np.testing.assert_allclose(o, _live(m, xs[i][None])[0],
                                       rtol=1e-6, atol=1e-6)
        # a late request runs in a group of its own
        x2 = rng.standard_normal((10,)).astype(np.float32)
        np.testing.assert_allclose(server.submit([x2]).result(timeout=120)[0],
                                   _live(m, x2[None])[0], rtol=1e-6,
                                   atol=1e-6)
    finally:
        server.close()


class _ShapeRecorder:
    """A predictor that records the stacked shapes it runs."""

    def __init__(self):
        self.runs = []

    def run(self, inputs):
        self.runs.append(tuple(a.shape for a in inputs))
        return [a * 2 for a in inputs]


def test_a_shape_change_flushes_the_group():
    """Requests of another shape or dtype are never stacked with the
    pending group: the group runs first, then the new one."""
    rec = _ShapeRecorder()
    server = BatchingServer(rec, max_batch_size=8, max_delay_ms=200.0)
    try:
        arrays = [np.ones(10, np.float32), np.ones(10, np.float32),
                  np.ones(5, np.float32), np.ones(5, np.float64),
                  np.ones(10, np.float32)]
        futs = [server.submit([a]) for a in arrays]
        for a, f in zip(arrays, futs):
            np.testing.assert_array_equal(f.result(timeout=60)[0], a * 2)
    finally:
        server.close()
    assert rec.runs == [((2, 10),), ((1, 5),), ((1, 5),), ((1, 10),)]


def test_server_rejects_after_close(tmp_path):
    _, conf, _ = _saved_mlp(tmp_path)
    server = BatchingServer(create_predictor(conf))
    server.close()
    with pytest.raises(RuntimeError, match="closed"):
        server.submit([np.zeros((10,), np.float32)])


def _tiny_llama():
    return LlamaForCausalLM(LlamaConfig.tiny(vocab_size=64, hidden_size=32,
                                             layers=2, heads=4, kv_heads=2,
                                             seq=64), device="cpu")


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 64, (int(rng.integers(2, 12)),)).tolist()
            for _ in range(n)]


def test_server_delegates_to_the_engine():
    """Over an EnginePredictor the server hands each request to the shared
    engine and its worker drives it: requests from 4 threads get the
    tokens of generate_batch on an engine of the same configuration."""
    model = _tiny_llama()
    prompts = _prompts(12)
    conf = Config()
    conf.set_max_batch_size(4)
    pred = create_llm_predictor(model, conf, max_new_tokens=6, device="cpu")
    want = ServingEngine(model, pred.engine.config, device="cpu") \
        .generate_batch(prompts, max_new_tokens=6)
    server = BatchingServer(pred)
    assert server.max_batch_size == 4
    futs = [None] * len(prompts)

    def client(i):
        for j in range(i, len(prompts), 4):
            futs[j] = server.submit([np.asarray(prompts[j])])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    try:
        got = [f.result(timeout=120)[0].tolist() for f in futs]
    finally:
        server.close()
    assert got == want
    assert server.requests_served == len(prompts)
    assert not pred.engine.has_work()


def test_failed_engine_step_fails_every_future():
    """A step that raises fails each live request through abort_all: every
    Future raises, none waits, the pages go back to the pool, and the
    server keeps serving."""
    model = _tiny_llama()
    pred = create_llm_predictor(model, max_new_tokens=4, device="cpu")
    eng = pred.engine
    free = eng.pool.free_blocks()
    real_step = eng._step
    calls = {"n": 0}

    def failing_step():
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected step fault")
        return real_step()

    eng._step = failing_step
    server = BatchingServer(pred)
    try:
        futs = [server.submit([np.asarray(p)]) for p in _prompts(3, seed=1)]
        for f in futs:
            with pytest.raises(RuntimeError, match="engine aborted"):
                f.result(timeout=60)
        assert eng.requests_failed == 3 and not eng.has_work()
        assert eng.pool.free_blocks() == free
        (out,) = server.submit([np.asarray([3, 4, 5])]).result(timeout=60)
        assert len(out) == 4
    finally:
        server.close()
    assert server.requests_served == 1


def test_predictor_needs_a_gpu_unless_asked_for_the_cpu(tmp_path):
    _, conf, _ = _saved_mlp(tmp_path)
    gpu_conf = Config(conf.model_path)
    assert gpu_conf.device() is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_predictor(gpu_conf)
    with pytest.raises(ValueError, match="model path"):
        create_predictor(Config())
