"""paddle_tpu_torch stands alone: no module of it, nor chip_smoke.py,
imports JAX or paddle_tpu, importing it loads no JAX (nor Triton: the
kernels import it at their first launch), and its entry points refuse to
fall back to the CPU when no GPU is there."""
import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(os.path.join(REPO, "paddle_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_module_imports_no_jax(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "paddle_tpu"}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_import_loads_no_jax():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.serving, "
            "paddle_tpu_torch.models, paddle_tpu_torch.framework, "
            "paddle_tpu_torch.nn, paddle_tpu_torch.optimizer, "
            "paddle_tpu_torch.parallel, "
            "paddle_tpu_torch.kernels.flash_attention, "
            "paddle_tpu_torch.kernels.optimizer, "
            "paddle_tpu_torch.kernels.gmm, paddle_tpu_torch.models.gpt, "
            "paddle_tpu_torch.incubate.distributed.models.moe, "
            "paddle_tpu_torch.nn.initializer, paddle_tpu_torch.nn.functional, "
            "paddle_tpu_torch.models.llama, paddle_tpu_torch.inference, "
            "paddle_tpu_torch.generation, paddle_tpu_torch.quantization, "
            "paddle_tpu_torch.kernels.quant_matmul, "
            "paddle_tpu_torch.serving.speculative, paddle_tpu_torch.jit, "
            "paddle_tpu_torch.kernels.fused, paddle_tpu_torch.optimizer.lr, "
            "paddle_tpu_torch.optimizer.lbfgs, paddle_tpu_torch.regularizer, "
            "paddle_tpu_torch.amp, paddle_tpu_torch.amp.debugging, "
            "paddle_tpu_torch.framework.random, "
            "paddle_tpu_torch.kernels.dropout, paddle_tpu_torch.nn.layer, "
            "paddle_tpu_torch.distributed.fleet.meta_parallel, "
            "paddle_tpu_torch.incubate.nn.functional, "
            "paddle_tpu_torch.models.ernie, paddle_tpu_torch.models.unet, "
            "paddle_tpu_torch.vision, paddle_tpu_torch.vision.models, "
            "paddle_tpu_torch.vision.models.resnet, "
            "paddle_tpu_torch.kernels.group_norm, "
            "paddle_tpu_torch.nn.layer.conv, "
            "paddle_tpu_torch.nn.layer.activation, "
            "paddle_tpu_torch.nn.layer.pooling, "
            "paddle_tpu_torch.nn.layer.loss, paddle_tpu_torch.nn.layer.norm, "
            "paddle_tpu_torch.nn.layer.common, "
            "paddle_tpu_torch.nn.layer.layers, "
            "paddle_tpu_torch.nn.functional_loss, "
            "paddle_tpu_torch.nn.functional_common, "
            "paddle_tpu_torch.kernels.seq_loss, "
            "paddle_tpu_torch.kernels.rnn, paddle_tpu_torch.nn.layer.rnn, "
            "paddle_tpu_torch.nn.decode, paddle_tpu_torch.ops, "
            "paddle_tpu_torch.ops.special; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu', 'triton')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("package", ["optimizer", "amp"])
def test_optimizer_and_amp_import_no_jax_package(package):
    """The training surface (the optimizers, schedulers, LBFGS, the
    regularizers, amp and its debugging tools) keeps its own copy of what
    it needs: neither its files nor importing it bring in paddle_tpu."""
    root = os.path.join(REPO, "paddle_tpu_torch", package)
    files = [os.path.join(root, f) for f in os.listdir(root)
             if f.endswith(".py")]
    assert len(files) >= 2
    for path in files:
        assert not _imported_roots(path) & {"jax", "jaxlib", "paddle_tpu"}
    code = (f"import sys, paddle_tpu_torch.{package}; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_raise_without_cuda(monkeypatch):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine
    cfg = LlamaConfig.tiny(vocab_size=17, hidden_size=16, layers=1, heads=2,
                           kv_heads=1, seq=16)
    model = LlamaForCausalLM(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model)


def test_generate_and_front_door_raise_without_cuda(monkeypatch):
    """generate() and create_llm_predictor run on the GPU unless given
    device='cpu'; with it they run on the CPU."""
    from paddle_tpu_torch.generation import generate
    from paddle_tpu_torch.inference import create_llm_predictor
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.tiny(vocab_size=17, hidden_size=16, layers=1, heads=2,
                           kv_heads=1, seq=16)
    model = LlamaForCausalLM(cfg, device="cpu")
    ids = [[1, 2, 3]]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(model, ids, max_new_tokens=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_llm_predictor(model)
    toks, _ = generate(model, ids, max_new_tokens=2, device="cpu")
    assert toks.shape == (1, 2)
    (out,) = create_llm_predictor(model, max_new_tokens=2,
                                  device="cpu").run([ids[0]])
    assert out.shape == (1, 2)


def test_gpt_and_moe_raise_without_cuda(monkeypatch):
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    cfg = GPTConfig.tiny(vocab_size=17, hidden_size=16, layers=2, heads=2,
                         seq=16, num_experts=2)
    GPTForCausalLM(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForCausalLM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MoELayer(d_model=16, d_hidden=32, num_expert=2, dropless=True)


def test_training_follows_the_model_device():
    """The optimizer's state and the trainer's buffers live where the
    parameters do: a CPU model trains on the CPU and launches nothing."""
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import SpmdTrainer
    cfg = LlamaConfig.tiny(vocab_size=17, hidden_size=16, layers=1, heads=2,
                           kv_heads=1, seq=16)
    model = LlamaForCausalLM(cfg, device="cpu")
    tr = SpmdTrainer(model, AdamW(parameters=model.parameters()),
                     lambda m, i, l: m.forward_loss(i, l))
    before = K.kernel_launches()
    ids = torch.randint(0, 17, (2, 8))
    tr.train_step(ids, ids)
    assert K.kernel_launches() == before
    assert all(s["moment1"].device.type == "cpu"
               for s in tr.opt._accumulators.values())


def test_artifact_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """jit.load and create_predictor (and so PredictorPool) load onto the
    GPU unless the caller asks for the CPU; with it they run there."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.inference import (Config, PredictorPool,
                                            create_predictor)
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.tiny(vocab_size=17, hidden_size=16, layers=1, heads=2,
                           kv_heads=1, seq=16)
    model = LlamaForCausalLM(cfg, device="cpu")
    path = str(tmp_path / "m")
    jit.save(model, path, input_spec=[jit.InputSpec([None, 4], "int64")])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = Config(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        jit.load(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_predictor(conf)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PredictorPool(conf, size=2)
    conf.disable_gpu()
    (out,) = create_predictor(conf).run([[[1, 2, 3, 4]]])
    assert out.shape == (1, 4, 17)
    assert jit.load(path, device="cpu")(torch.ones(2, 4, dtype=torch.long)) \
        .shape == (2, 4, 17)


@pytest.mark.parametrize("module", ["models/unet.py", "vision",
                                    "kernels/group_norm.py", "nn/layer"])
def test_convolutional_slice_imports_no_jax_package(module):
    """The UNet, ResNet, the GroupNorm kernels and the nn layers they are
    built from: no file imports jax or paddle_tpu, and the GroupNorm
    module imports Triton only inside the function that launches."""
    root = os.path.join(REPO, "paddle_tpu_torch", module)
    files = [root] if root.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
        if f.endswith(".py")]
    assert files
    for path in files:
        assert not _imported_roots(path) & {"jax", "jaxlib", "paddle_tpu"}
        with open(path) as f:
            body = ast.parse(f.read()).body
        top = {a.name.split(".")[0] for node in body
               if isinstance(node, ast.Import) for a in node.names}
        top |= {node.module.split(".")[0] for node in body
                if isinstance(node, ast.ImportFrom) and node.level == 0}
        assert "triton" not in top, path


@pytest.mark.parametrize("module", ["kernels/batch_norm.py",
                                    "nn/functional.py", "nn/initializer.py",
                                    "nn/layer/activation.py",
                                    "nn/layer/norm.py", "models/llama.py",
                                    "framework/io.py"])
def test_norm_activation_initializer_slice_imports_no_jax_or_triton(module):
    """The BatchNorm kernels, the norms, activations and initializers and
    the F13 modules: no file imports jax or paddle_tpu, none imports
    Triton at its top level (the BatchNorm module imports it inside the
    function that launches), and importing them in a fresh process loads
    neither."""
    path = os.path.join(REPO, "paddle_tpu_torch", module)
    assert not _imported_roots(path) & {"jax", "jaxlib", "paddle_tpu"}
    with open(path) as f:
        body = ast.parse(f.read()).body
    top = {a.name.split(".")[0] for node in body
           if isinstance(node, ast.Import) for a in node.names}
    top |= {node.module.split(".")[0] for node in body
            if isinstance(node, ast.ImportFrom) and node.level == 0}
    assert "triton" not in top
    name = "paddle_tpu_torch." + module[:-3].replace("/", ".")
    code = (f"import sys, {name}; "
            "print(sorted(m for m in ('jax', 'triton', 'paddle_tpu') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


@pytest.mark.parametrize("module", [
    "kernels/dense_attention.py", "nn/layer/transformer.py",
    "nn/functional_common.py", "incubate/nn/functional.py",
    "incubate/nn/layer/fused_transformer.py", "incubate/nn/layer/__init__.py",
    "nn/__init__.py"])
def test_transformer_slice_imports_no_jax_or_triton(module):
    """The dense attention's kernels, the Transformer layers, the attention
    functionals and the fused Transformer layers: no file imports jax or
    paddle_tpu, none imports Triton at its top level (the dense attention
    module imports it inside the function that launches), and importing
    them in a fresh process loads neither."""
    path = os.path.join(REPO, "paddle_tpu_torch", module)
    assert not _imported_roots(path) & {"jax", "jaxlib", "paddle_tpu"}
    with open(path) as f:
        body = ast.parse(f.read()).body
    top = {a.name.split(".")[0] for node in body
           if isinstance(node, ast.Import) for a in node.names}
    top |= {node.module.split(".")[0] for node in body
            if isinstance(node, ast.ImportFrom) and node.level == 0}
    assert "triton" not in top
    name = "paddle_tpu_torch." + module[:-3].replace("/", ".").replace(
        ".__init__", "")
    code = (f"import sys, {name}; "
            "print(sorted(m for m in ('jax', 'triton', 'paddle_tpu') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


@pytest.mark.parametrize("module", [
    "kernels/rnn.py", "nn/layer/rnn.py", "nn/decode.py", "ops/special.py",
    "ops/__init__.py"])
def test_recurrent_slice_imports_no_jax_triton_or_build(module):
    """The recurrence kernels' module, the recurrent layers, the decoder
    and ``ops.special``: no file imports jax or paddle_tpu, none imports
    Triton at its top level, and importing them in a fresh process loads
    neither and builds or loads no CUDA library (nvcc runs at a kernel's
    first launch)."""
    path = os.path.join(REPO, "paddle_tpu_torch", module)
    assert not _imported_roots(path) & {"jax", "jaxlib", "paddle_tpu",
                                        "triton"}
    name = "paddle_tpu_torch." + module[:-3].replace("/", ".").replace(
        ".__init__", "")
    code = (f"import sys, {name}; "
            "from paddle_tpu_torch.kernels import _build; "
            "print(sorted(m for m in ('jax', 'triton', 'paddle_tpu') "
            "if m in sys.modules), sorted(_build._loaded))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[] []", out.stdout + out.stderr
