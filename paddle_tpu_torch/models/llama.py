"""Llama-2 model family: configuration, parameters and the dense forward.

Mirrors ``paddle_tpu/models/llama.py``: the same configuration fields and
presets, the same parameter names (``model.layers.{i}.self_attn.q_proj.
weight``, ...) and Paddle's linear layout ``[in, out]`` (computed as
``x @ w``), so a state carried across from the JAX model fills this one
name for name. Serving reads the parameters through
``generation._LlamaDecoder``; training runs ``forward`` /
``forward_loss`` below, whose RMSNorms, rotary embedding and attention
(dense causal, or FlashMask with packed-document bounds) are the port's
kernels on CUDA tensors (the plain versions on CPU tensors) and whose
matrix products go to ``torch.matmul`` (the projections through
``nn.functional.linear``, the JAX model's "linear" op); a dense
``attention_mask`` runs plain PyTorch attention, as the JAX model runs it
in XLA. ``load_numpy_state`` carries a JAX model's weights across and
``load_numpy_optimizer_state`` its optimizer's state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import amp, resolve_device
from ..kernels import fused
from ..nn import functional as F
from ..nn.layer.layers import Layer


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None  # GQA; None = MHA
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    use_flash_attention: bool = True
    dtype: str = "float32"

    @staticmethod
    def llama2_7b():
        return LlamaConfig()

    @staticmethod
    def llama2_13b():
        return LlamaConfig(hidden_size=5120, intermediate_size=13824,
                           num_hidden_layers=40, num_attention_heads=40)

    @staticmethod
    def tiny(vocab_size=256, hidden_size=64, layers=2, heads=4, kv_heads=2,
             seq=128):
        return LlamaConfig(vocab_size=vocab_size, hidden_size=hidden_size,
                           intermediate_size=hidden_size * 2,
                           num_hidden_layers=layers, num_attention_heads=heads,
                           num_key_value_heads=kv_heads,
                           max_position_embeddings=seq)


def build_rope_cache(seq_len: int, head_dim: int, theta: float = 10000.0,
                     dtype=torch.float32, device=None):
    """cos/sin tables [seq_len, head_dim / 2]: fp32 inverse frequencies,
    fp32 outer product, cos and sin in fp32, cast to ``dtype``."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                             dtype=torch.float32,
                                             device=device) / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def apply_rope(q, k, cos, sin):
    """The JAX package's plain rotation (``paddle_tpu/models/llama.py:87``)
    of q, k [b, s, h, d] by cos/sin [s, d/2]: each interleaved pair (x1,
    x2) becomes (x1 cos - x2 sin, x2 cos + x1 sin), in the promoted dtype
    and cast back to the input's."""
    def rotate(x):
        x1, x2 = x[..., 0::2], x[..., 1::2]
        c, s = cos[None, :, None, :], sin[None, :, None, :]
        out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
        return out.reshape(x.shape).to(x.dtype)
    return rotate(q), rotate(k)


@amp.op("fused_rope", 2)
def fused_rope(query, key, cos, sin):
    """Rotary embedding of q [b, s, h, d] and k [b, s, kvh, d] with the
    tables cos/sin [s, d/2] upcast to fp32 (the kernel's type; bf16 tables,
    as ``model.bfloat16()`` leaves them, keep their values exactly).
    Differentiable: on CUDA tensors forward and backward launch the RoPE
    kernel."""
    return fused.fused_rope(query, key, cos.float(), sin.float())


def _placement(config, device, dtype):
    """(device, dtype) of a module's parameters: None = the GPU (raises
    without one) and ``config.dtype``."""
    return resolve_device(device), dtype or getattr(torch, config.dtype)


def _param(*shape, device, dtype):
    return nn.Parameter(torch.empty(*shape, device=device, dtype=dtype))


class _Linear(Layer):
    """A bias-free linear layer's weight in Paddle's ``[in, out]`` layout."""

    def __init__(self, n_in, n_out, device, dtype):
        super().__init__()
        self.weight = _param(n_in, n_out, device=device, dtype=dtype)


class _Norm(Layer):
    def __init__(self, hidden, device, dtype, eps=1e-6):
        super().__init__()
        self.weight = _param(hidden, device=device, dtype=dtype)
        self.eps = eps

    def forward(self, x):
        return F.rms_norm(x, self.weight, epsilon=self.eps)


class _Embedding(Layer):
    def __init__(self, vocab, hidden, device, dtype):
        super().__init__()
        self.weight = _param(vocab, hidden, device=device, dtype=dtype)


class LlamaAttention(Layer):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        device, dtype = _placement(config, device, dtype)
        heads = config.num_attention_heads
        kvh = config.num_key_value_heads or heads
        hd = config.hidden_size // heads
        h = config.hidden_size
        self.config = config
        self.q_proj = _Linear(h, heads * hd, device, dtype)
        self.k_proj = _Linear(h, kvh * hd, device, dtype)
        self.v_proj = _Linear(h, kvh * hd, device, dtype)
        self.o_proj = _Linear(heads * hd, h, device, dtype)
        self.num_heads, self.num_kv_heads, self.head_dim = heads, kvh, hd

    def forward(self, hidden_states, rope_cache, attention_mask=None,
                startend_row_indices=None):
        b, s, _ = hidden_states.shape
        q = F.linear(hidden_states, self.q_proj.weight).reshape(
            b, s, self.num_heads, self.head_dim)
        k = F.linear(hidden_states, self.k_proj.weight).reshape(
            b, s, self.num_kv_heads, self.head_dim)
        v = F.linear(hidden_states, self.v_proj.weight).reshape(
            b, s, self.num_kv_heads, self.head_dim)
        cos, sin = rope_cache
        q, k = fused_rope(q, k, cos, sin)
        if startend_row_indices is not None:
            if attention_mask is not None:
                raise NotImplementedError(
                    "attention_mask cannot be combined with "
                    "attn_startend_row_indices; fold padding into the "
                    "column bounds (a padded key column is a fully-masked "
                    "band)")
            # packed documents: O(S) column bounds (raw, or prepared by
            # LlamaModel.forward), GQA handled inside
            out = F.flashmask_attention(q, k, v, startend_row_indices,
                                        causal=True)
            return F.linear(out.reshape(b, s, self.num_heads * self.head_dim),
                            self.o_proj.weight)
        if self.num_kv_heads != self.num_heads:
            # outside the kernel, so autograd sums dk/dv over the repeats
            rep = self.num_heads // self.num_kv_heads
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attention_mask, is_causal=True,
            allow_flash=self.config.use_flash_attention)
        return F.linear(out.reshape(b, s, self.num_heads * self.head_dim),
                        self.o_proj.weight)


class LlamaMLP(Layer):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        device, dtype = _placement(config, device, dtype)
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = _Linear(h, i, device, dtype)
        self.up_proj = _Linear(h, i, device, dtype)
        self.down_proj = _Linear(i, h, device, dtype)

    def forward(self, x):
        return F.linear(F.swiglu(F.linear(x, self.gate_proj.weight),
                                 F.linear(x, self.up_proj.weight)),
                        self.down_proj.weight)


class LlamaDecoderLayer(Layer):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        device, dtype = _placement(config, device, dtype)
        self.self_attn = LlamaAttention(config, device, dtype)
        self.mlp = LlamaMLP(config, device, dtype)
        self.input_layernorm = _Norm(config.hidden_size, device, dtype,
                                     config.rms_norm_eps)
        self.post_attention_layernorm = _Norm(config.hidden_size, device,
                                              dtype, config.rms_norm_eps)

    def forward(self, hidden_states, rope_cache, attention_mask=None,
                startend_row_indices=None):
        h = hidden_states + self.self_attn(
            self.input_layernorm(hidden_states), rope_cache, attention_mask,
            startend_row_indices)
        return h + self.mlp(self.post_attention_layernorm(h))


class LlamaModel(Layer):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        device, dtype = _placement(config, device, dtype)
        self.config = config
        self.embed_tokens = _Embedding(config.vocab_size, config.hidden_size,
                                       device, dtype)
        self.layers = nn.ModuleList(
            LlamaDecoderLayer(config, device, dtype)
            for _ in range(config.num_hidden_layers))
        self.norm = _Norm(config.hidden_size, device, dtype,
                          config.rms_norm_eps)
        cos, sin = build_rope_cache(
            config.max_position_embeddings,
            config.hidden_size // config.num_attention_heads,
            config.rope_theta, device=device)
        # fp32 whatever the model's dtype, as in the JAX model; like the
        # JAX Layer.to, model.bfloat16() casts them (the forward upcasts)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def forward(self, input_ids, attention_mask=None,
                attn_startend_row_indices=None):
        h = F.embedding(input_ids, self.embed_tokens.weight)
        s = input_ids.shape[1]
        rope = (self.rope_cos[:s], self.rope_sin[:s])
        bounds = attn_startend_row_indices
        if bounds is not None:
            # canonicalised and summarised once for every layer (and for
            # the remat recompute and the backward)
            attn = self.layers[0].self_attn
            bounds = F.prepare_flashmask(bounds.to(h.device), s,
                                         attn.num_heads, attn.num_kv_heads,
                                         causal=True)
        for layer in self.layers:
            h = layer(h, rope, attention_mask, bounds)
        return self.norm(h)


class LlamaForCausalLM(Layer):
    """Llama parameters on ``device`` (None = the GPU; raises without one),
    in ``dtype`` (None = ``config.dtype``), initialised from ``generator``
    (None = a generator seeded with 0): matrices and embeddings normal
    with std 0.02, norm weights one."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        dt = dtype or getattr(torch, config.dtype)
        self.config = config
        self.model = LlamaModel(config, dev, dt)
        self.lm_head = None if config.tie_word_embeddings else \
            _Linear(config.hidden_size, config.vocab_size, dev, dt)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        with torch.no_grad():
            for p in self.parameters():
                if p.dim() == 1:
                    p.fill_(1.0)
                else:
                    p.normal_(0.0, 0.02, generator=generator)

    @property
    def device(self) -> torch.device:
        return self.model.norm.weight.device

    def forward(self, input_ids, attention_mask=None,
                attn_startend_row_indices=None):
        """Logits [b, s, vocab] in the model's dtype. attention_mask: a
        dense mask broadcast to [b, heads, s, s] (bool, True = visible, or
        additive) on top of causal masking. attn_startend_row_indices:
        FlashMask column bounds [b, KH', s, {1, 2}] (causal forms: LTS, or
        LTS and LTE) for packed documents; not with attention_mask. RoPE
        runs on positions 0..s-1 in both, as in the JAX model."""
        h = self.model(input_ids, attention_mask, attn_startend_row_indices)
        return self._head(h)

    def generate(self, input_ids, attention_mask=None, **kwargs):
        """KV-cached autoregressive decoding (greedy / temperature / top-k
        / top-p; see generation.generate), on the model's device."""
        from ..generation import generate
        return generate(self, input_ids, attention_mask=attention_mask,
                        device=kwargs.pop("device", self.device), **kwargs)

    def _head(self, h):
        if self.lm_head is None:
            return h @ self.model.embed_tokens.weight.T
        return F.linear(h, self.lm_head.weight)

    def compute_loss(self, logits, labels):
        """Shifted next-token cross entropy."""
        b, s, v = logits.shape
        return F.cross_entropy(logits[:, :-1, :].reshape(b * (s - 1), v),
                               labels[:, 1:].reshape(b * (s - 1)))

    def forward_loss(self, input_ids, labels, loss_chunk_size=None,
                     attention_mask=None, attn_startend_row_indices=None):
        """Trunk forward + shifted cross entropy. With ``loss_chunk_size=c``
        the head matmul and log-softmax (fp32) run per chunk of c positions
        under ``torch.utils.checkpoint``, as the JAX code runs them under
        ``jax.checkpoint`` inside ``lax.scan``: only [b, c, vocab] logits
        are live at a time, in the forward and in the backward. Labels of
        -100 count for nothing."""
        if loss_chunk_size is None:
            return self.compute_loss(
                self(input_ids, attention_mask, attn_startend_row_indices),
                labels)
        h = self.model(input_ids, attention_mask, attn_startend_row_indices)
        tied = self.lm_head is None
        w = self.model.embed_tokens.weight if tied else self.lm_head.weight
        return _chunked_causal_ce(h, w, labels, int(loss_chunk_size), tied)

    def num_params(self):
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self, seq_len: int) -> float:
        """Approximate training FLOPs/token (6N + attention term): the
        attention matmuls (QK^T, AV) are 4*s*h per layer forward, x3 for
        forward and backward, halved by causal masking -> 6*L*h*s."""
        c = self.config
        attn = 6.0 * c.num_hidden_layers * c.hidden_size * seq_len
        return 6.0 * self.num_params() + attn


@amp.op("chunked_causal_ce", 3)
def _chunked_causal_ce(h, w, labels, c, tied):
    """The shifted cross entropy of the trunk's output ``h`` in chunks of
    ``c`` positions, each under ``torch.utils.checkpoint``."""
    hs = h[:, :-1, :]
    ys = labels[:, 1:].long()
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.int64, device=h.device)
    for i in range(0, hs.shape[1], c):
        s_, n_ = checkpoint(_chunk_nll, hs[:, i:i + c], w, ys[:, i:i + c],
                            tied, use_reentrant=False)
        tot = tot + s_
        cnt = cnt + n_
    return tot / cnt.clamp(min=1).float()


def _chunk_nll(hc, w, yc, tied):
    """(sum of the nll, count) of one chunk: the head matmul and the
    log-softmax in fp32 (w is [vocab, hidden] when tied, else
    [hidden, vocab])."""
    valid = yc != -100
    yc = torch.where(yc < 0, torch.zeros_like(yc), yc)
    wf = w.float()
    logits = hc.float() @ (wf.T if tied else wf)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, yc.unsqueeze(-1)).squeeze(-1)
    return torch.where(valid, nll, torch.zeros_like(nll)).sum(), valid.sum()


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":        # ml_dtypes' bfloat16, as JAX gives
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def load_numpy_state(model: nn.Module, state: Dict[str, np.ndarray]) -> None:
    """Fill ``model``'s parameters and buffers (the rope tables,
    BatchNorm's statistics, SpectralNorm's ``weight_u`` / ``weight_v``,
    where given) from ``{name: array}``, such as the JAX model's
    ``{n: np.asarray(t._data) for n, t in model.named_state().items()}``:
    any ``nn.Layer`` tree, whose names are the JAX tree's. Every parameter
    must be given; an unknown name, or a shape or dtype that differs,
    raises before anything is written."""
    params = dict(model.named_parameters())
    targets = {**params, **dict(model.named_buffers())}
    missing = sorted(set(params) - set(state))
    unknown = sorted(set(state) - set(targets))
    if missing or unknown:
        raise KeyError(f"state does not match the model: missing "
                       f"{missing[:8]}, unknown {unknown[:8]}")
    loaded = {}
    for name, arr in state.items():
        src = _to_tensor(np.require(arr, requirements=["C", "W"]))
        dst = targets[name]
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)}, model has "
                             f"{tuple(dst.shape)}")
        if src.dtype != dst.dtype:
            raise TypeError(f"{name}: dtype {src.dtype}, model has "
                            f"{dst.dtype}")
        loaded[name] = src
    with torch.no_grad():
        for name, src in loaded.items():
            targets[name].copy_(src)


def load_numpy_optimizer_state(optimizer, state) -> None:
    """Load into the port's ``optimizer`` a JAX optimizer's
    ``state_dict()`` with its tensors as numpy arrays (``{"global_step",
    "accumulators": {key: {name: array}}, "LR_Scheduler"}``, as
    ``{k: np.asarray(t._data)}`` turns each ``Tensor``): the optimizer-
    state counterpart of ``load_numpy_state``. Both packages key a
    parameter's state by ``param.name or f"param_{i}"`` in the order of
    the parameter list. Every key must name a parameter and every array
    match its state's shape; a mismatch raises before anything is
    loaded."""
    params = {getattr(p, "name", None) or f"param_{i}": p
              for i, p in enumerate(optimizer._parameter_list)}
    accs = {}
    for key, acc in state.get("accumulators", {}).items():
        if key not in params:
            raise KeyError(f"optimizer state for {key!r}, which the "
                           f"optimizer does not hold")
        p = params[key]
        want = optimizer._init_state(torch.empty(p.shape, dtype=p.dtype,
                                                 device="meta"))
        accs[key] = {}
        for name, arr in acc.items():
            if name == "_step":
                accs[key][name] = int(np.asarray(arr))
                continue
            t = _to_tensor(np.array(arr))
            if name not in want or tuple(t.shape) != tuple(want[name].shape):
                raise ValueError(f"{key}.{name}: shape {tuple(t.shape)} is "
                                 f"not the optimizer's")
            accs[key][name] = t
    optimizer.set_state_dict(dict(state, accumulators=accs))


__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "LlamaDecoderLayer", "LlamaAttention", "LlamaMLP",
           "build_rope_cache", "apply_rope",
           "load_numpy_state", "load_numpy_optimizer_state"]
