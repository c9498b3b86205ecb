"""paddle_tpu_torch.jit (save / load of a module's forward) against
paddle_tpu.jit, on the CPU: the cases of ``tests/test_export.py``.

The same weights go into a JAX module and a port module (carried across
as numpy). Each is saved with its package's ``jit.save`` and run through
its package's ``inference.create_predictor``: the outputs agree within
1e-5 (float32, sums in another order); the port's loaded artifact equals
its live module's forward exactly (the same ops on the same inputs). The
artifact is ``torch.export``'s program of the pure function of the state
and the inputs: the kernels enter it as ``torch.library`` ops, which run
their plain versions on CPU tensors, and the weights are on disk once.
"""
import json
import os
import subprocess
import sys

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
from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.framework import io as pio
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     load_numpy_state)
from paddle_tpu_torch.nn import functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Linear(torch.nn.Module):
    """A linear layer in Paddle's [in, out] layout, named as the JAX one."""

    def __init__(self, n_in, n_out):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.zeros(n_in, n_out))
        self.bias = torch.nn.Parameter(torch.zeros(n_out))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


def _mlp_pair(seed=5):
    paddle.seed(seed)
    jm = jnn.Sequential(jnn.Linear(10, 32), jnn.ReLU(), jnn.Linear(32, 4))
    pm = torch.nn.Sequential(_Linear(10, 32), torch.nn.ReLU(),
                             _Linear(32, 4))
    load_numpy_state(pm, {n: np.asarray(t._data)
                          for n, t in jm.named_state().items()})
    return jm, pm


def _predict(path, jax_side, x):
    conf = (JaxConfig if jax_side else Config)(path + ".pdmodel")
    if not jax_side:
        conf.disable_gpu()
    return (jax_create_predictor if jax_side else create_predictor)(
        conf).run([x])[0]


def test_save_load_same_outputs_as_live_and_jax(tmp_path):
    jm, pm = _mlp_pair()
    jpath, path = str(tmp_path / "jax_mlp"), str(tmp_path / "mlp")
    paddle.jit.save(jm, jpath,
                    input_spec=[JaxInputSpec([None, 10], "float32")])
    jit.save(pm, path, input_spec=[jit.InputSpec([None, 10], "float32")])
    for f in (".pdmodel", ".pdiparams", ".meta.json"):
        assert os.path.exists(path + f)
    loaded = jit.load(path, device="cpu")
    rng = np.random.default_rng(0)
    for b in (3, 7):                 # a symbolic batch: any size runs
        x = rng.standard_normal((b, 10)).astype(np.float32)
        with torch.no_grad():
            live = pm(torch.from_numpy(x))
        assert torch.equal(loaded(torch.from_numpy(x)), live)
        np.testing.assert_allclose(_predict(path, False, x),
                                   _predict(jpath, True, x), rtol=1e-5,
                                   atol=1e-5)


def test_meta_has_the_jax_keys(tmp_path):
    jm, pm = _mlp_pair()
    paddle.jit.save(jm, str(tmp_path / "j"),
                    input_spec=[JaxInputSpec([None, 10], "float32")])
    jit.save(pm, str(tmp_path / "p"),
             input_spec=[jit.InputSpec([None, 10], "float32")])
    with open(tmp_path / "j.meta.json") as f:
        want = json.load(f)
    with open(tmp_path / "p.meta.json") as f:
        got = json.load(f)
    assert set(want) <= set(got)
    assert got["param_names"] == want["param_names"]
    assert got["inputs"] == want["inputs"]
    assert got["out_spec"] == want["out_spec"]


def test_fresh_process_load(tmp_path):
    _, pm = _mlp_pair()
    x = np.random.default_rng(0).standard_normal((2, 10)).astype(np.float32)
    with torch.no_grad():
        ref = pm(torch.from_numpy(x)).numpy()
    path = str(tmp_path / "mlp")
    jit.save(pm, path, input_spec=[jit.InputSpec([None, 10], "float32")])
    np.save(str(tmp_path / "x.npy"), x)
    np.save(str(tmp_path / "ref.npy"), ref)
    prog = f"""
import sys; sys.path.insert(0, {REPO!r})
import numpy as np, torch
from paddle_tpu_torch import jit
x = np.load({str(tmp_path / 'x.npy')!r})
ref = np.load({str(tmp_path / 'ref.npy')!r})
out = jit.load({path!r}, device="cpu")(torch.from_numpy(x)).numpy()
np.testing.assert_array_equal(out, ref)
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'paddle_tpu')]
assert not bad, bad
print("fresh-process OK")
"""
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       timeout=240)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert b"fresh-process OK" in r.stdout


def _llama_pair(kv_heads):
    paddle.seed(0)
    kw = dict(vocab_size=64, hidden_size=32, layers=2, heads=4,
              kv_heads=kv_heads, seq=16)
    cfg = JaxLlamaConfig.tiny(**kw)
    cfg.use_flash_attention = False
    jm = JaxLlama(cfg)
    pm = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu")
    load_numpy_state(pm, {n: np.asarray(t._data)
                          for n, t in jm.named_state().items()})
    return jm, pm


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_export_llama_tiny(tmp_path, kv_heads):
    """[2, 16] int32 ids, as the JAX test saves them: the JAX artifact's
    logits within 2e-5; the same port model saved with symbolic batch and
    sequence dims runs other shapes, bounded by max_position_embeddings."""
    jm, pm = _llama_pair(kv_heads)
    ids = np.random.default_rng(3).integers(0, 64, (2, 16)).astype(np.int32)
    jpath, path = str(tmp_path / "jax_llama"), str(tmp_path / "llama")
    paddle.jit.save(jm, jpath, input_spec=[JaxInputSpec([2, 16], "int32")])
    jit.save(pm, path, input_spec=[jit.InputSpec([2, 16], "int32")])
    np.testing.assert_allclose(_predict(path, False, ids),
                               _predict(jpath, True, ids), rtol=2e-5,
                               atol=2e-5)
    dyn = str(tmp_path / "llama_dyn")
    jit.save(pm, dyn, input_spec=[jit.InputSpec([None, None], "int64")])
    layer = jit.load(dyn, device="cpu")
    for shape in ((1, 16), (3, 5)):
        x = torch.from_numpy(np.random.default_rng(4).integers(0, 64, shape))
        with torch.no_grad():
            assert torch.equal(layer(x), pm(x))
    with pytest.raises(Exception):
        layer(torch.zeros(1, 17, dtype=torch.long))    # past the rope table


def test_save_requires_input_spec(tmp_path):
    with pytest.raises(ValueError):
        jit.save(_mlp_pair()[1], str(tmp_path / "m"))


class _Add(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = _Linear(10, 4)

    def forward(self, x, y):
        return self.lin(x + y)


def test_shared_named_symbolic_dim(tmp_path):
    """Two inputs sharing a dynamic batch through one named symbol, against
    the JAX artifact of the same weights."""
    paddle.seed(1)

    class JaxAdd(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = jnn.Linear(10, 4)

        def forward(self, x, y):
            return self.lin(x + y)

    jm, pm = JaxAdd(), _Add()
    load_numpy_state(pm, {n: np.asarray(t._data)
                          for n, t in jm.named_state().items()})
    specs = dict(jax=[JaxInputSpec(["batch", 10], "float32")] * 2,
                 port=[jit.InputSpec(["batch", 10], "float32")] * 2)
    paddle.jit.save(jm, str(tmp_path / "jadd"), input_spec=specs["jax"])
    jit.save(pm, str(tmp_path / "add"), input_spec=specs["port"])
    layer = jit.load(str(tmp_path / "add"), device="cpu")
    jconf = JaxConfig(str(tmp_path / "jadd"))
    jpred = jax_create_predictor(jconf)
    rng = np.random.default_rng(0)
    for b in (2, 5):
        x, y = (rng.standard_normal((b, 10)).astype(np.float32)
                for _ in range(2))
        got = layer(torch.from_numpy(x), torch.from_numpy(y))
        with torch.no_grad():
            assert torch.equal(got, pm(torch.from_numpy(x),
                                       torch.from_numpy(y)))
        np.testing.assert_allclose(got.numpy(), jpred.run([x, y])[0],
                                   rtol=1e-5, atol=1e-5)
    with pytest.raises(Exception):                 # the batches must agree
        layer(torch.zeros(2, 10), torch.zeros(3, 10))


def test_cpu_artifact_runs_the_plain_versions_through_the_ops(tmp_path):
    """The program holds the kernels' ops (RMSNorm, RoPE, flash forward);
    on CPU tensors they run the plain versions: no kernel counted, nothing
    routed, the live forward's logits exactly. (head_dim 64, which the
    flash kernels take.)"""
    pm = LlamaForCausalLM(LlamaConfig.tiny(vocab_size=64, hidden_size=128,
                                           layers=2, heads=2, kv_heads=1,
                                           seq=16), device="cpu")
    path = str(tmp_path / "llama")
    jit.save(pm, path, input_spec=[jit.InputSpec([None, None], "int64")])
    layer = jit.load(path, device="cpu")
    code = layer._program.graph_module.code
    for op in ("ptt.rms_norm", "ptt.rope", "ptt.flash_fwd"):
        assert op in code, op
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, 64, (2, 9)))
    before = dict(K.LAUNCHES)
    got = layer(ids)
    assert K.LAUNCHES == before
    with torch.no_grad():
        assert torch.equal(got, pm(ids))


def test_artifact_loads_onto_another_device(tmp_path):
    """An artifact saved on the CPU is rewritten for the device it is
    loaded on (``meta`` here, which runs the ops' shape functions): its
    state lands there and the program runs there."""
    _, pm = _llama_pair(4)
    path = str(tmp_path / "llama")
    jit.save(pm, path, input_spec=[jit.InputSpec([None, None], "int64")])
    layer = jit.load(path, device="meta")
    assert all(t.device.type == "meta" for t in layer.state_dict().values())
    out = layer(torch.zeros(3, 7, dtype=torch.long, device="meta"))
    assert out.device.type == "meta" and tuple(out.shape) == (3, 7, 64)


def test_weights_are_on_disk_once(tmp_path):
    """The program takes the state as arguments: the .pdmodel archive
    holds no copy of the weights."""
    pm = LlamaForCausalLM(LlamaConfig.tiny(vocab_size=256, hidden_size=256,
                                           layers=2, heads=4, kv_heads=4,
                                           seq=32), device="cpu")
    path = str(tmp_path / "llama")
    jit.save(pm, path, input_spec=[jit.InputSpec([None, None], "int64")])
    params = os.path.getsize(path + ".pdiparams")
    assert params > 4 * sum(p.numel() for p in pm.parameters())
    assert os.path.getsize(path + ".pdmodel") < params / 4


def test_bf16_state_round_trips(tmp_path):
    """numpy has no bf16: the state is stored as its bits and read back to
    the same bf16 tensors, and the bf16 artifact equals its live forward."""
    _, pm = _llama_pair(2)
    model = pm.bfloat16()
    path = str(tmp_path / "llama_bf16")
    jit.save(model, path, input_spec=[jit.InputSpec([None, None], "int64")])
    state = pio.load(path + ".pdiparams")
    for n, p in model.named_parameters():
        assert state[n].dtype == torch.bfloat16 and torch.equal(state[n], p)
    ids = torch.from_numpy(np.random.default_rng(7).integers(0, 64, (2, 6)))
    with torch.no_grad():
        assert torch.equal(jit.load(path, device="cpu")(ids), model(ids))


def test_save_restores_the_training_flag_and_refuses_quantized(tmp_path):
    _, pm = _mlp_pair()
    pm.train()
    jit.save(pm, str(tmp_path / "m"),
             input_spec=[jit.InputSpec([None, 10], "float32")])
    assert pm.training
    pm.register_buffer("w8", torch.zeros(4, 4, dtype=torch.int8))
    with pytest.raises(NotImplementedError, match="quantized"):
        jit.save(pm, str(tmp_path / "q"),
                 input_spec=[jit.InputSpec([None, 10], "float32")])


def test_input_spec_from_tensor():
    spec = jit.InputSpec.from_tensor(torch.zeros(2, 3, dtype=torch.int32),
                                     name="ids")
    assert spec.shape == [2, 3] and spec.dtype == "int32"
    assert spec.name == "ids"
