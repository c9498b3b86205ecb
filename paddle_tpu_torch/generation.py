"""KV-cached decoding of a Llama or GPT model over its weight tensors.

Mirrors ``paddle_tpu/generation.py``:

  * ``_LlamaDecoder`` / ``_GPTDecoder`` (pre-LN GPT-2, learned positions,
    erf GELU, and MoE blocks that run every expert densely over the rows
    and combine them through exact one-hot weights) ``.step_ragged``: one
    packed batch of tokens from many sequences (prefill chunks and decode
    tokens together) goes through every layer, writes its K/V into the
    paged pools and attends over them (the serving engine's step);
  * ``.step``: the dense KV-cache step of ``generate()``: per-row caches
    ``[L, B, kvh, M, hd]`` (heads-major, the layout the attention's
    products read in place) written at a slot held in a device tensor,
    attention in plain PyTorch with the JAX code's fp32 scores (the JAX
    package has no kernel for it either);
  * weight-only quantized decoding (``quant=``): the matmul weights of
    ``quant_plan`` become ``name::q`` / ``name::s`` leaves, quantized once
    per weight snapshot and cached on the model, which ``_mm`` reads
    through the weight-only GEMM (``kernels/quant_matmul.py``) on the card
    and its plain version on the CPU;
  * ``generate()``: the prefill, the decode loop and sampling (greedy,
    temperature, top-k, top-p, eos, the CTRL repetition penalty), and
    greedy beam search (``_BeamLoop``, the JAX ``_beam_impl``). The JAX
    package compiles the loop into one program per signature. Here the
    prefill runs op by op and, on the card, the decode step is a CUDA
    graph captured once per signature and replayed ``max_new_tokens``
    times: its counter, write position, key mask and sampling noise live
    on the card, and the tokens are read back once, at the end;
  * ``draft_greedy_batch``: greedy drafts of a speculative drafter, every
    context left-padded into one fixed window, so each (batch, window, k)
    signature is one captured decode graph.

The RMSNorms, the rotary embedding and the ragged attention go through the
port's kernels on CUDA tensors and through their plain versions on CPU
tensors; the large matrix products go to ``torch.matmul``.
"""
from __future__ import annotations

import math
import weakref
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import resolve_device
from .kernels import LAUNCHES, fused, uncount_since
from .kernels.quant_matmul import weight_only_gemm as _qmm
from .quantization._kernels import ALGO_BITS as _QUANT_BITS
from .quantization._kernels import quantize_weight_arrays as _wq

NEG_INF = -1e30


def _rms(x, w, eps):
    return fused.rms_norm(x, w, eps)


def _add_rms(h, o, w, eps):
    """(h + o, RMSNorm(h + o)): the residual add and the next norm in one
    pass; equals ``h = h + o; _rms(h, w, eps)`` in float32 and in bf16
    (the norm reads the sum rounded to h's dtype)."""
    return fused.add_rms_norm(h, o, w, eps)


def _rope_rows(q, k, cos, sin):
    """Rotate pairs of q [B, S, H, D] and k [B, S, kvh, D] with PER-ROW
    tables cos/sin [B, S, D/2] (already gathered at each row's position)."""
    b, s, h, d = q.shape
    oq, ok = fused.fused_rope(q.reshape(1, b * s, h, d),
                              k.reshape(1, b * s, k.shape[2], d),
                              cos.reshape(b * s, d // 2),
                              sin.reshape(b * s, d // 2))
    return oq.reshape(q.shape), ok.reshape(k.shape)


def _bmm_f32(a, b):
    """``a @ b`` (batched) with fp32 products, sums and result. bf16
    operands are read as they lie: on the card one ``bmm`` with an fp32
    output (cuBLAS accumulates in fp32), elsewhere the same products of
    the operands' exact fp32 values."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _attend(q, k, v, score_mask):
    """q: [B, S, H, D]; k/v: [B, H, T, D] (the cache's heads-major
    layout); score_mask: [B, 1, S, T] bool (True = visible). Returns
    [B, S, H, D]. fp32 scores and softmax, as the JAX function."""
    return _attend_gqa(q, k, v, score_mask, 1)


def _attend_gqa(q, k, v, score_mask, rep):
    """Grouped-query attention without expanding the KV cache. q:
    [B, S, G*rep, D]; k/v: [B, G, T, D]; score_mask: [B, 1, S, T].
    Returns [B, S, G*rep, D]. The ``rep`` query heads of a group and the
    S positions share one product against the group's keys, which is
    read in place in the cache's dtype: the scores, the softmax and the
    P.V sums in fp32. P keeps about fp32 precision against a bf16 cache:
    it is split into a bf16 head and a bf16 tail (P - head, rounded),
    whose rows go through one product with V and are summed after it
    (each element off by at most 2^-18 of itself, against 2^-9 for P
    rounded once)."""
    b, s, h, d = q.shape
    g = h // rep
    t = k.shape[2]
    qg = q.reshape(b, s, g, rep, d).permute(0, 2, 3, 1, 4) \
        .reshape(b * g, rep * s, d).to(k.dtype)
    scores = _bmm_f32(qg, k.reshape(b * g, t, d).transpose(1, 2)) \
        / math.sqrt(d)
    scores = torch.where(score_mask[:, None],
                         scores.reshape(b, g, rep, s, t), NEG_INF)
    p = torch.softmax(scores, dim=-1).reshape(b * g, rep * s, t)
    vg = v.reshape(b * g, t, d)
    if v.dtype == torch.float32:
        out = _bmm_f32(p, vg)
    else:
        head = p.to(v.dtype)
        tail = (p - head.float()).to(v.dtype)
        both = _bmm_f32(torch.cat([head, tail], dim=1), vg)
        out = both[:, :rep * s] + both[:, rep * s:]
    out = out.reshape(b, g, rep, s, d)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


# -- weight-only quantized decoding ---------------------------------------------
#
# The quantized matrix rides in the weights dict as two leaves, ``name::q``
# (the narrow matrix, in the layout of quantization/_kernels.py) and
# ``name::s`` (fp32 per-output-channel scales), and ``_mm`` reads them
# through the weight-only GEMM, which converts the narrow bytes in
# registers as XLA fuses the convert into the JAX package's dot.

def _quant_leaves(src, names, lm_from_embed=None, bits=8):
    """Quantize each 2-D matmul weight in ``names`` to ::q/::s leaves; with
    ``lm_from_embed`` (a tied head) add __lm::q/__lm::s from the
    embedding's transpose, so the logits product reads narrow bytes while
    the embedding gather keeps the full-precision table."""
    leaves = {}
    for n in names:
        leaves[n + "::q"], leaves[n + "::s"] = _wq(src[n], bits=bits)
    if lm_from_embed is not None:
        leaves["__lm::q"], leaves["__lm::s"] = _wq(src[lm_from_embed].T,
                                                   bits=bits)
    return leaves


def _mm(x, w, name):
    """x @ weight, reading the quantized form when the dict holds one."""
    q = w.get(name + "::q")
    if q is None:
        return x @ w[name]
    return _qmm(x, q, w[name + "::s"])


def _head_logits(w, h, tied, embed_key):
    """The LM-head matmul, shared by both decoders: the quantized tied
    head (__lm leaves), else the tied embedding's transpose, else the
    (possibly quantized) lm_head."""
    if "__lm::q" in w:
        return _qmm(h, w["__lm::q"], w["__lm::s"])
    if tied:
        return h @ w[embed_key].T
    return _mm(h, w, "lm_head.weight")


def _quant_weights_cached(dec, model, quant):
    """The decode weights with ``quant``'s leaves in place of the matmul
    weights of ``dec.quant_plan()``: the other weights (norms, biases,
    embeddings) are read from the model on every call; the leaves are
    quantized once per weight snapshot and cached on the model, per algo.
    The cache holds WEAKREFS to the source parameters, with each one's
    version counter and address (an in-place update, a ``load`` or a
    dtype change gives another snapshot; the port's AdamW bumps the
    counters it writes through), and strong references only to the narrow
    copies, which an engine's or a decode loop's captured graph reads."""
    src = dec.weights(model)
    params = dict(model.named_parameters())
    names, lm_key = dec.quant_plan()
    dtype = src[dec.embed_key].dtype
    if src[dec.embed_key].is_cuda and dtype != torch.bfloat16:
        raise TypeError(f"quant={quant!r} on the card serves a bf16 model "
                        f"(the weight-only GEMM reads bf16 activations), "
                        f"not {dtype}")
    watched = names if lm_key is None else [*names, lm_key]
    stamp = {k: (params[k]._version, params[k].data_ptr()) for k in watched}
    cache = model.__dict__.setdefault("_quant_weights_cache", {})
    leaves = None
    cached = cache.get(quant)
    if cached is not None:
        prev_refs, prev_leaves = cached
        if list(prev_refs) == watched and all(
                prev_refs[k][0]() is params[k] and prev_refs[k][1] == stamp[k]
                for k in watched):
            leaves = prev_leaves
    if leaves is None:
        with torch.no_grad():
            leaves = _quant_leaves(src, names, lm_from_embed=lm_key,
                                   bits=_QUANT_BITS[quant])
        cache[quant] = ({k: (weakref.ref(params[k]), stamp[k])
                         for k in watched}, leaves)
    drop = set(names)
    w = {k: v for k, v in src.items() if k not in drop}
    w.update(leaves)
    return w


class _LlamaDecoder:
    """Functions over a LlamaForCausalLM's weights; holds only the static
    configuration and, on the card, ``generate()``'s captured decode loops
    (``_loop_for``)."""

    def __init__(self, model):
        cfg = model.config
        self.cfg = cfg
        self.n_heads = cfg.num_attention_heads
        self.n_kv = cfg.num_key_value_heads or self.n_heads
        self.hd = cfg.hidden_size // self.n_heads
        self.eps = cfg.rms_norm_eps
        self.n_layers = cfg.num_hidden_layers
        self.tied = model.lm_head is None
        self.embed_key = "model.embed_tokens.weight"
        self.loops = OrderedDict()

    @staticmethod
    def weights(model):
        """{name: tensor}: parameters plus the rope tables, upcast to fp32
        (the RoPE kernel takes fp32 tables; after ``model.bfloat16()`` the
        buffers hold the JAX model's bf16-rounded values, which the upcast
        keeps exactly)."""
        w = {n: p.detach() for n, p in model.named_parameters()}
        w["__rope_cos"] = model.model.rope_cos.float()
        w["__rope_sin"] = model.model.rope_sin.float()
        return w

    @staticmethod
    def _lw(w, i, name):
        return w[f"model.layers.{i}.{name}"]

    _QUANT_SUFFIXES = ("self_attn.q_proj.weight", "self_attn.k_proj.weight",
                       "self_attn.v_proj.weight", "self_attn.o_proj.weight",
                       "mlp.gate_proj.weight", "mlp.up_proj.weight",
                       "mlp.down_proj.weight")

    def quant_plan(self):
        """(matmul weight names to quantize, tied-embed key or None)."""
        names = [f"model.layers.{i}.{sfx}" for i in range(self.n_layers)
                 for sfx in self._QUANT_SUFFIXES]
        if not self.tied:
            names.append("lm_head.weight")
        return names, (self.embed_key if self.tied else None)

    def _qkv_proj(self, w, i, x, b, s):
        pre = f"model.layers.{i}.self_attn."
        q = _mm(x, w, pre + "q_proj.weight").reshape(b, s, self.n_heads,
                                                     self.hd)
        k = _mm(x, w, pre + "k_proj.weight").reshape(b, s, self.n_kv,
                                                     self.hd)
        v = _mm(x, w, pre + "v_proj.weight").reshape(b, s, self.n_kv,
                                                     self.hd)
        return q, k, v

    def _post_attn(self, w, i, h, att):
        """Residual + output projection + SwiGLU MLP; att: [B, S, H*D]."""
        pre = f"model.layers.{i}."
        h, x2 = _add_rms(h, _mm(att, w, pre + "self_attn.o_proj.weight"),
                         self._lw(w, i, "post_attention_layernorm.weight"),
                         self.eps)
        gate = _mm(x2, w, pre + "mlp.gate_proj.weight")
        up = _mm(x2, w, pre + "mlp.up_proj.weight")
        swi = F.silu(gate.float()).to(up.dtype) * up
        return h + _mm(swi, w, pre + "mlp.down_proj.weight")

    def _layer(self, w, i, h, cos, sin, kc, vc, write_pos, score_mask):
        """One layer with its cache append; h: [B, S, H*D]; kc/vc:
        [B, kvh, M, hd] of this layer, written IN PLACE at cache slots
        ``write_pos .. write_pos + S - 1`` (write_pos: a long [1] tensor, so
        a captured step writes where the loop's counter says). Rows still
        inside their left padding write values that the score mask hides."""
        b, s, _ = h.shape
        x = _rms(h, self._lw(w, i, "input_layernorm.weight"), self.eps)
        q, k, v = self._qkv_proj(w, i, x, b, s)
        q, k = _rope_rows(q, k, cos, sin)
        slots = write_pos if s == 1 else \
            write_pos + torch.arange(s, device=h.device)
        kc.index_copy_(2, slots, k.transpose(1, 2).to(kc.dtype))
        vc.index_copy_(2, slots, v.transpose(1, 2).to(vc.dtype))
        if self.n_kv != self.n_heads:
            # grouped-query attention against the unexpanded cache
            att = _attend_gqa(q, kc, vc, score_mask,
                              self.n_heads // self.n_kv)
        else:
            att = _attend(q, kc, vc, score_mask)
        return self._post_attn(w, i, h, att.reshape(b, s, -1))

    def step(self, w, tokens, positions, kcs, vcs, write_pos, score_mask,
             last=False):
        """tokens: [B, S] int; positions: [B, S] int (rope positions);
        kcs/vcs: [L, B, kvh, M, hd], written in place; write_pos as in
        _layer; score_mask: [B, 1, S, M]. Returns logits [B, S, V], or
        [B, 1, V] of the last position with ``last`` (the prefill needs no
        other)."""
        h = w[self.embed_key][tokens]
        cos = w["__rope_cos"][positions]            # [B, S, hd/2]
        sin = w["__rope_sin"][positions]
        for i in range(self.n_layers):
            h = self._layer(w, i, h, cos, sin, kcs[i], vcs[i], write_pos,
                            score_mask)
        return self._logits(w, h[:, -1:].contiguous() if last else h)

    def _layer_ragged(self, w, i, h, cos, sin, kp, vp, scatter, attend):
        """One layer over a packed [T, 1, ...] batch. kp/vp: [P + 1, kvh,
        bs, D] pools of this layer, written IN PLACE (the JAX program
        donates them); scatter: (pages [T], offs [T]), every row's write
        target; attend(q [T, H, D], kp, vp) -> [T, H, D]."""
        t, s, _ = h.shape
        x = _rms(h, self._lw(w, i, "input_layernorm.weight"), self.eps)
        q, k, v = self._qkv_proj(w, i, x, t, s)
        q, k = _rope_rows(q, k, cos, sin)
        pages, offs = scatter
        kp[pages, :, offs, :] = k[:, 0].to(kp.dtype)
        vp[pages, :, offs, :] = v[:, 0].to(vp.dtype)
        att = attend(q[:, 0], kp, vp).reshape(t, 1, -1)
        return self._post_attn(w, i, h, att)

    def step_ragged(self, w, tokens, positions, k_pools, v_pools, scatter,
                    attend):
        """tokens/positions: [T] packed mixed-phase batch; k_pools/v_pools:
        [L, P + 1, kvh, bs, D], updated in place; scatter: (pages [T],
        offs [T]) per-token write targets; attend as in _layer_ragged.
        Returns logits [T, V].

        The JAX program's scatter drops the rows of page index P
        (mode="drop"). Here the pools carry one spare page past the
        ``KVBlockPool``'s P pages, which no page table names: those rows
        write there, so every row writes and the step never asks the host
        which rows to keep."""
        h = w[self.embed_key][tokens][:, None]          # [T, 1, H*D]
        cos = w["__rope_cos"][positions][:, None]       # [T, 1, hd/2]
        sin = w["__rope_sin"][positions][:, None]
        for i in range(self.n_layers):
            h = self._layer_ragged(w, i, h, cos, sin, k_pools[i], v_pools[i],
                                   scatter, attend)
        return self._logits(w, h)[:, 0]

    def _logits(self, w, h):
        h = _rms(h, w["model.norm.weight"], self.eps)
        return _head_logits(w, h, self.tied, self.embed_key)


def _ln(x, w, b, eps):
    """LayerNorm in fp32, rounded to x's dtype (the JAX ``_ln``): the
    LayerNorm kernel of ``kernels.fused`` on CUDA tensors (it reads x, w
    and b in their dtypes, normalises in fp32 and rounds once), its plain
    version (the JAX formula) on CPU tensors."""
    return fused.dropout_add_layer_norm(x, w, b, eps)


class _GPTDecoder:
    """Functions over a GPTForCausalLM's weights (pre-LN GPT-2: learned
    positions, fused-qkv biases, erf GELU). MoE blocks decode with NO-DROP
    routing: every expert runs densely over the rows and the top-k combine
    weights select through exact 0/1 masks, so a step's routing of a
    token does not depend on the other tokens of the batch. Holds the
    static configuration and, on the card, ``generate()``'s captured
    decode loops."""

    _QUANT_SUFFIXES = ("attn.qkv_proj.weight", "attn.out_proj.weight",
                       "mlp.fc_in.weight", "mlp.fc_out.weight")

    def __init__(self, model):
        from .incubate.distributed.models.moe.gate import BaseGate
        cfg = model.config
        self.moe_layers = {}
        for i, blk in enumerate(model.transformer.h):
            if not getattr(blk, "is_moe", False):
                continue
            if getattr(blk.mlp, "w1", None) is None:
                raise NotImplementedError(
                    "generate() supports batched-expert MoE blocks (stacked "
                    "w1/w2 banks); per-expert Layer lists have no stacked "
                    "weights to decode against")
            gate = blk.mlp.gate
            if type(gate).forward is not BaseGate.forward:
                raise NotImplementedError(
                    "generate() routes with the standard linear gate; "
                    f"{type(gate).__name__} overrides forward(), which the "
                    "decode step cannot reproduce from the weights")
            override = getattr(blk.mlp, "_capacity_override", None)
            if gate.capacity_factor(training=False) is not None \
                    and override is None:
                raise NotImplementedError(
                    f"generate() cannot reproduce {type(gate).__name__}'s "
                    "eval capacity dropping (routing depends on batch "
                    "composition). Use NaiveGate (unbounded), or set "
                    "mlp._capacity_override >= tokens-per-forward to make "
                    "eval routing no-drop")
            self.moe_layers[i] = {"top_k": gate.top_k, "act": blk.mlp._act,
                                  "has_bias": gate.bias is not None}
            # generate() and the engine check this bound against the
            # tokens of each forward
            if override is not None:
                self.min_capacity_override = min(
                    getattr(self, "min_capacity_override", override),
                    int(override))
        self.cfg = cfg
        self.n_heads = cfg.num_attention_heads
        self.n_kv = self.n_heads
        self.hd = cfg.hidden_size // self.n_heads
        self.eps = cfg.layer_norm_epsilon
        self.n_layers = cfg.num_hidden_layers
        self.tied = model.lm_head is None
        self.embed_key = "transformer.wte.weight"
        self.loops = OrderedDict()

    @staticmethod
    def weights(model):
        return {n: p.detach() for n, p in model.named_parameters()}

    def quant_plan(self):
        """(matmul weight names to quantize, tied-embed key or None). MoE
        blocks keep their expert banks in full precision; only their
        attention projections quantize."""
        names = [f"transformer.h.{i}.{sfx}" for i in range(self.n_layers)
                 for sfx in self._QUANT_SUFFIXES
                 if not (i in self.moe_layers and sfx.startswith("mlp."))]
        if not self.tied:
            names.append("lm_head.weight")
        return names, (self.embed_key if self.tied else None)

    def _qkv_proj(self, w, i, x, b, s):
        """The fused qkv projection; its output is [3, heads, hd]-major."""
        p = f"transformer.h.{i}."
        qkv = (_mm(x, w, p + "attn.qkv_proj.weight")
               + w[p + "attn.qkv_proj.bias"]) \
            .reshape(b, s, 3, self.n_heads, self.hd)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    def _post_attn(self, w, i, h, att):
        """Residual + out proj + (MoE-)MLP; att: [B, S, H*D]."""
        p = f"transformer.h.{i}."
        h = h + _mm(att, w, p + "attn.out_proj.weight") \
            + w[p + "attn.out_proj.bias"]
        x2 = _ln(h, w[p + "ln_2.weight"], w[p + "ln_2.bias"], self.eps)
        if i in self.moe_layers:
            return h + self._moe_mlp(w, i, x2)
        m = F.gelu((_mm(x2, w, p + "mlp.fc_in.weight")
                    + w[p + "mlp.fc_in.bias"]).float(),
                   approximate="none").to(h.dtype)
        return h + _mm(m, w, p + "mlp.fc_out.weight") \
            + w[p + "mlp.fc_out.bias"]

    def _moe_mlp(self, w, i, x2):
        """No-drop top-k expert mixing; x2: [B, S, D] -> [B, S, D]. Every
        expert's FFN runs on every row, one expert at a time (the JAX
        ``lax.scan`` over the bank), and the combine weights select
        through exact 0/1 masks. No host sync: the step captures."""
        p = f"transformer.h.{i}.mlp."
        meta = self.moe_layers[i]
        b, s, d = x2.shape
        xt = x2.reshape(b * s, d)
        logits = xt @ w[p + "gate.weight"]
        if meta["has_bias"]:
            logits = logits + w[p + "gate.bias"]
        probs = torch.softmax(logits.float(), dim=-1)
        topv, topi = torch.topk(probs, meta["top_k"], dim=-1)
        if meta["top_k"] > 1:
            topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
        # the top-k indices of a row are distinct: one weight per slot
        comb = torch.zeros_like(probs).scatter_(1, topi, topv)
        w1, b1, w2, b2 = (w[p + n] for n in ("w1", "b1", "w2", "b2"))
        y = torch.zeros_like(xt)
        for e in range(w1.shape[0]):
            hh = meta["act"](xt @ w1[e] + b1[e][None])
            y = y + comb[:, e, None].to(xt.dtype) * (hh @ w2[e] + b2[e][None])
        return y.reshape(b, s, d)

    def _layer(self, w, i, h, kc, vc, write_pos, score_mask):
        """One block with its cache append, as _LlamaDecoder._layer (no
        rope: positions enter through the wpe embedding)."""
        p = f"transformer.h.{i}."
        b, s, _ = h.shape
        x = _ln(h, w[p + "ln_1.weight"], w[p + "ln_1.bias"], self.eps)
        q, k, v = self._qkv_proj(w, i, x, b, s)
        slots = write_pos if s == 1 else \
            write_pos + torch.arange(s, device=h.device)
        kc.index_copy_(2, slots, k.transpose(1, 2).to(kc.dtype))
        vc.index_copy_(2, slots, v.transpose(1, 2).to(vc.dtype))
        att = _attend(q, kc, vc, score_mask)
        return self._post_attn(w, i, h, att.reshape(b, s, -1))

    def _layer_ragged(self, w, i, h, kp, vp, scatter, attend):
        """One block over a packed [T, 1, ...] batch; see
        _LlamaDecoder._layer_ragged."""
        p = f"transformer.h.{i}."
        t, s, _ = h.shape
        x = _ln(h, w[p + "ln_1.weight"], w[p + "ln_1.bias"], self.eps)
        q, k, v = self._qkv_proj(w, i, x, t, s)
        pages, offs = scatter
        kp[pages, :, offs, :] = k[:, 0].to(kp.dtype)
        vp[pages, :, offs, :] = v[:, 0].to(vp.dtype)
        att = attend(q[:, 0].contiguous(), kp, vp).reshape(t, 1, -1)
        return self._post_attn(w, i, h, att)

    def step_ragged(self, w, tokens, positions, k_pools, v_pools, scatter,
                    attend):
        """See _LlamaDecoder.step_ragged. Returns logits [T, V]."""
        h = (w["transformer.wte.weight"][tokens]
             + w["transformer.wpe.weight"][positions])[:, None]
        for i in range(self.n_layers):
            h = self._layer_ragged(w, i, h, k_pools[i], v_pools[i], scatter,
                                   attend)
        return self._logits(w, h)[:, 0]

    def step(self, w, tokens, positions, kcs, vcs, write_pos, score_mask,
             last=False):
        """See _LlamaDecoder.step."""
        h = w["transformer.wte.weight"][tokens] \
            + w["transformer.wpe.weight"][positions]
        for i in range(self.n_layers):
            h = self._layer(w, i, h, kcs[i], vcs[i], write_pos, score_mask)
        return self._logits(w, h[:, -1:].contiguous() if last else h)

    def _logits(self, w, h):
        h = _ln(h, w["transformer.ln_f.weight"], w["transformer.ln_f.bias"],
                self.eps)
        return _head_logits(w, h, self.tied, self.embed_key)


def _live_moe_struct(model):
    """Fingerprint of the model's CURRENT MoE block state: everything the
    decoder reads at construction, so a changed block (another mlp, top_k,
    gate or capacity override) rebuilds the decoder instead of decoding
    with stale routing."""
    blocks = getattr(getattr(model, "transformer", None), "h", None)
    if blocks is None:
        return ()
    fp = []
    for i, blk in enumerate(blocks):
        if getattr(blk, "is_moe", False):
            g = blk.mlp.gate
            fp.append((i, g.top_k, getattr(blk.mlp, "_act", None),
                       g.bias is not None,
                       getattr(blk.mlp, "w1", None) is None,
                       type(g).forward, g.capacity_factor(training=False),
                       getattr(blk.mlp, "_capacity_override", None)))
    return tuple(fp)


def _decoder_for(model):
    """The model's decoder (``_GPTDecoder`` for a GPTForCausalLM, else
    ``_LlamaDecoder``), built once per model instance and built again when
    the head's tying or the MoE blocks change (both are baked into the
    decoder and its captured loops)."""
    from .models.gpt import GPTForCausalLM
    cls = _GPTDecoder if isinstance(model, GPTForCausalLM) else _LlamaDecoder
    struct = (cls, model.lm_head is None, _live_moe_struct(model))
    dec = model.__dict__.get("_decode_cache")
    if dec is None or dec._struct != struct:
        dec = cls(model)
        dec._struct = struct
        model.__dict__["_decode_cache"] = dec
    return dec


def _check_capacity(dec, tokens, what):
    """A MoE capacity override below the tokens of one forward would make
    the full forward drop tokens, which the no-drop decode cannot
    reproduce: refuse, as the JAX package does."""
    mco = getattr(dec, "min_capacity_override", None)
    if mco is not None and mco < tokens:
        raise ValueError(
            f"MoE _capacity_override={mco} < tokens-per-forward {tokens} "
            f"({what}): the full forward would drop tokens, which the "
            "cached no-drop decode cannot reproduce; raise the override or "
            "shorten the request")


# -- sampling ------------------------------------------------------------------

def _filter_logits(logits, temperature, top_k, top_p):
    """The logits ``_sample`` draws from: fp32 over the temperature (a
    float or a device scalar), with NEG_INF outside the top ``top_k`` and
    outside the smallest set whose mass reaches ``top_p`` (its first token
    always kept)."""
    lg = logits.float() / torch.clamp(
        torch.as_tensor(temperature, dtype=torch.float32,
                        device=logits.device), min=1e-6)
    if top_k and top_k > 0:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = lg.masked_fill(lg < kth, NEG_INF)
    if top_p < 1.0:
        sorted_lg = torch.sort(lg, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_lg, dim=-1), dim=-1)
        keep = torch.roll(cum, 1, dims=-1) < top_p
        keep[..., 0] = True
        cutoff = torch.where(keep, sorted_lg, math.inf).amin(dim=-1,
                                                             keepdim=True)
        lg = lg.masked_fill(lg < cutoff, NEG_INF)
    return lg


def _sample(logits, noise, do_sample, temperature, top_k, top_p):
    """logits: [B, V] -> tokens [B] int32. Sampling is Gumbel-max, as
    ``jax.random.categorical`` is: the argmax of the filtered logits plus
    -log(-log(u)), u uniform in [0, 1) drawn into ``noise`` [B, V] fp32 by
    the caller (from a generator of its own)."""
    if not do_sample:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    lg = _filter_logits(logits, temperature, top_k, top_p)
    return torch.argmax(lg - torch.log(-torch.log(noise)),
                        dim=-1).to(torch.int32)


# -- generate ------------------------------------------------------------------

def _prefill(dec, w, ids, mask, max_new, kcs, vcs):
    """Shared prefill: left-padded positions, the key and prompt masks, and
    the prompt step, which writes kcs/vcs (zeroed first). Returns
    (key_mask [B, S + max_new], last_logits [B, V])."""
    b, s = ids.shape
    dev = ids.device
    positions = (torch.cumsum(mask, dim=1) - 1).clamp(min=0)
    kcs.zero_()
    vcs.zero_()
    t_idx = torch.arange(s + max_new, device=dev)[None, None, None, :]
    q_idx = torch.arange(s, device=dev)[None, None, :, None]
    key_mask = torch.cat([mask.bool(), torch.zeros(b, max_new,
                                                   dtype=torch.bool,
                                                   device=dev)], dim=1)
    pre_mask = (t_idx <= q_idx) & key_mask[:, None, None, :]
    logits = dec.step(w, ids, positions, kcs, vcs,
                      torch.zeros(1, dtype=torch.long, device=dev), pre_mask,
                      last=True)
    # left padding => the last REAL token sits at index s-1 for every row
    return key_mask, logits[:, -1]


class _DecodeLoop:
    """The decode loop of one generate() signature (batch, prompt length,
    max_new_tokens and the sampling switches): the caches and everything
    the JAX ``fori_loop`` carries, as tensors of fixed shape that ``_body``
    updates in place. ``capture`` records one ``_body`` as a CUDA graph,
    which ``step`` then replays; without it ``step`` runs ``_body`` op by
    op (the CPU's path, and the card's yardstick)."""

    def __init__(self, dec, w, b, s, max_new, do_sample, has_eos, top_k,
                 top_p, has_rep):
        self._init_state(dec, w, b, s, max_new, has_eos)
        dev, dt = self.kcs.device, self.kcs.dtype
        vocab = dec.cfg.vocab_size
        self.do_sample, self.has_rep = do_sample, has_rep
        self.top_k, self.top_p = top_k, top_p
        self.last_logits = torch.zeros(b, vocab, dtype=dt, device=dev)
        self.out = torch.zeros(b, max_new, dtype=torch.int32, device=dev)
        self.finished = torch.zeros(b, dtype=torch.bool, device=dev)
        self.seen = torch.zeros(b, vocab if has_rep else 1, dtype=torch.bool,
                                device=dev)
        self.temperature = torch.ones((), dtype=torch.float32, device=dev)
        self.rep = torch.ones((), dtype=torch.float32, device=dev)
        # the uniform draws of the latest step; a generator of the loop's
        # own, registered with the graph, so that each replay draws anew
        self.noise = torch.zeros(b, vocab, dtype=torch.float32, device=dev) \
            if do_sample else None
        self.gen = torch.Generator(device=dev) if do_sample else None

    def _init_state(self, dec, w, rows, s, max_new, has_eos):
        """What every loop carries, for ``rows`` cache rows: the weights
        and their addresses, the caches, the key mask, the step counter,
        the rows' prompt lengths and eos; no graph yet."""
        self.dec, self.w = dec, w          # the graph reads these tensors
        self.ptrs = _weight_ptrs(w)
        self.s, self.max_new, self.has_eos = s, max_new, has_eos
        emb = w[dec.embed_key]
        dev, dt = emb.device, emb.dtype
        self.kcs = torch.zeros(dec.n_layers, rows, dec.n_kv, s + max_new,
                               dec.hd, dtype=dt, device=dev)
        self.vcs = torch.zeros_like(self.kcs)
        self.key_mask = torch.zeros(rows, s + max_new, dtype=torch.bool,
                                    device=dev)
        self.t = torch.zeros(1, dtype=torch.long, device=dev)
        self.lengths = torch.zeros(rows, dtype=torch.long, device=dev)
        self.eos = torch.zeros((), dtype=torch.int32, device=dev)
        self.noise = self.gen = self.graph = None
        self.tally = {}

    def _body(self):
        """One iteration of the JAX ``_generate_impl`` loop body."""
        lg = self.last_logits
        if self.has_rep:
            lg = lg.float()
            lg = torch.where(self.seen, torch.where(lg > 0, lg / self.rep,
                                                    lg * self.rep), lg)
        if self.do_sample:
            torch.rand(self.noise.shape, generator=self.gen, out=self.noise)
        tok = _sample(lg, self.noise, self.do_sample, self.temperature,
                      self.top_k, self.top_p)
        if self.has_eos:
            tok = torch.where(self.finished, self.eos, tok)
            self.finished |= tok == self.eos
        self.out.index_copy_(1, self.t, tok[:, None])
        write_pos = self.t + self.s
        self.key_mask.index_fill_(1, write_pos, True)
        if self.has_rep:
            self.seen.scatter_(1, tok[:, None].long(), True)
        logits = self.dec.step(self.w, tok[:, None],
                               (self.lengths + self.t)[:, None], self.kcs,
                               self.vcs, write_pos,
                               self.key_mask[:, None, None, :])
        self.last_logits.copy_(logits[:, 0])
        self.t += 1

    def capture(self):
        """Record ``_body`` as a CUDA graph: a warm-up on a side stream
        first (Triton's compiles, cuBLAS's handles), then the capture.
        Each replay adds the launches the capture counted. Raises if
        capture fails."""
        dev = self.kcs.device
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side), torch.inference_mode():
            self._body()
        cur.wait_stream(side)
        self.t.zero_()
        graph = torch.cuda.CUDAGraph()
        if self.gen is not None:
            graph.register_generator_state(self.gen)
        before = dict(LAUNCHES)
        try:
            with torch.inference_mode(), torch.cuda.graph(graph):
                self._body()
        finally:
            self.tally = uncount_since(before)
        self.graph = graph

    def start(self, ids, mask, temperature, eos_id, rep_penalty, seed):
        """The prefill, and the loop's state for a new call."""
        with torch.inference_mode():
            key_mask, last = _prefill(self.dec, self.w, ids, mask,
                                      self.max_new, self.kcs, self.vcs)
            self.key_mask.copy_(key_mask)
            self.last_logits.copy_(last)
            self.lengths.copy_(mask.sum(dim=1))
            self.out.zero_()
            self.finished.zero_()
            self.t.zero_()
            self.temperature.fill_(float(temperature))
            self.eos.fill_(int(eos_id))
            self.rep.fill_(float(rep_penalty))
            if self.has_rep:
                # tokens of the prompt (not of its padding) count as seen
                hits = torch.zeros(self.seen.shape, dtype=torch.int32,
                                   device=ids.device)
                hits.scatter_add_(1, ids, mask.to(torch.int32))
                self.seen.copy_(hits > 0)
        if self.gen is not None:
            if seed is None:
                self.gen.seed()
            else:
                self.gen.manual_seed(int(seed))

    def step(self):
        if self.graph is None:
            with torch.inference_mode():
                self._body()
            return
        self.graph.replay()
        for name, n in self.tally.items():
            LAUNCHES[name] += n

    def result(self):
        """(tokens [B, max_new] int32, finished [B] bool) on the CPU, read
        back in one copy."""
        both = torch.cat([self.out, self.finished[:, None].to(torch.int32)],
                         dim=1).cpu()
        return both[:, :-1], both[:, -1].bool()


class _BeamLoop(_DecodeLoop):
    """The beam search of one generate() signature (batch B, prompt
    length, max_new_tokens, K beams, eos or not): the JAX ``_beam_impl``.
    The beams are an expanded batch of B * K rows (row ``i * K + j`` is
    beam j of prompt i); ``_body`` scores the K * V continuations of each
    prompt, keeps the top K (ties to the lower index, as ``lax.top_k``),
    and reorders the caches, ``out`` and ``finished`` along the beam axis.
    Beam 0 starts live and the others at NEG_INF, so step 0 picks K
    distinct tokens from beam 0; a finished beam offers only eos, at its
    frozen score. ``result`` picks each prompt's best beam by
    ``score / gen_len ** length_penalty``. Captured and replayed as
    ``_DecodeLoop``."""

    def __init__(self, dec, w, b, s, max_new, has_eos, num_beams):
        self._init_state(dec, w, b * num_beams, s, max_new, has_eos)
        dev = self.kcs.device
        self.b, self.k = b, num_beams
        self.vocab = vocab = dec.cfg.vocab_size
        # the reorder gathers one layer's rows at a time into this buffer,
        # which is copied back: the caches keep their addresses
        self.scratch = torch.zeros_like(self.kcs[0])
        self.last_lp = torch.zeros(b * num_beams, vocab, dtype=torch.float32,
                                   device=dev)
        self.scores = torch.zeros(b, num_beams, dtype=torch.float32,
                                  device=dev)
        self.out = torch.zeros(b, num_beams, max_new, dtype=torch.int32,
                               device=dev)
        self.finished = torch.zeros(b, num_beams, dtype=torch.bool,
                                    device=dev)
        self.length_penalty = torch.ones((), dtype=torch.float32,
                                         device=dev)
        self.row0 = torch.arange(b, device=dev)[:, None] * num_beams
        self.only_eos = torch.zeros(vocab, dtype=torch.float32, device=dev)

    def _reorder(self, rows):
        """Every layer's cache rows gathered to ``rows`` [B * K], through
        the scratch buffer: all of kcs and vcs read and written twice."""
        for caches in (self.kcs, self.vcs):
            for layer in caches:
                torch.index_select(layer, 0, rows, out=self.scratch)
                layer.copy_(self.scratch)

    def _body(self):
        """One iteration of the JAX ``_beam_impl`` loop body."""
        b, k, v = self.b, self.k, self.vocab
        lp = self.last_lp.view(b, k, v)
        if self.has_eos:
            lp = torch.where(self.finished[:, :, None], self.only_eos, lp)
        cand = (self.scores[:, :, None] + lp).view(b, k * v)
        top_sc, top_ix = torch.sort(cand, dim=-1, descending=True,
                                    stable=True)
        top_sc, top_ix = top_sc[:, :k], top_ix[:, :k]
        src = top_ix // v                                 # [B, K]
        tok = (top_ix % v).to(torch.int32)
        self._reorder((self.row0 + src).view(-1))
        self.out.copy_(torch.gather(
            self.out, 1, src[:, :, None].expand(-1, -1, self.max_new)))
        self.out.index_copy_(2, self.t, tok[:, :, None])
        if self.has_eos:
            self.finished.copy_(torch.gather(self.finished, 1, src)
                                | (tok == self.eos))
        self.scores.copy_(top_sc)
        write_pos = self.t + self.s
        self.key_mask.index_fill_(1, write_pos, True)
        logits = self.dec.step(self.w, tok.view(-1, 1),
                               (self.lengths + self.t)[:, None], self.kcs,
                               self.vcs, write_pos,
                               self.key_mask[:, None, None, :])
        self.last_lp.copy_(torch.log_softmax(logits[:, 0].float(), dim=-1))
        self.t += 1

    def start(self, ids, mask, temperature, eos_id, rep_penalty, seed,
              length_penalty=1.0):
        """The prefill of every beam (the prompts repeated K times), and
        the loop's state for a new call."""
        k = self.k
        with torch.inference_mode():
            ids_r = ids.repeat_interleave(k, dim=0)
            mask_r = mask.repeat_interleave(k, dim=0)
            key_mask, last = _prefill(self.dec, self.w, ids_r, mask_r,
                                      self.max_new, self.kcs, self.vcs)
            self.key_mask.copy_(key_mask)
            self.last_lp.copy_(torch.log_softmax(last.float(), dim=-1))
            self.lengths.copy_(mask_r.sum(dim=1))
            self.scores.fill_(NEG_INF)
            self.scores[:, 0] = 0.0
            self.out.zero_()
            self.finished.zero_()
            self.t.zero_()
            self.eos.fill_(int(eos_id))
            self.only_eos.fill_(NEG_INF)
            self.only_eos[int(eos_id)] = 0.0
            self.length_penalty.fill_(float(length_penalty))

    def result(self):
        """(tokens [B, max_new] int32, finished [B] bool) of each prompt's
        best beam by length-penalised score (a finished beam's length is
        its tokens up to and with its first eos), on the CPU."""
        with torch.inference_mode():
            if self.has_eos:
                hit = self.out == self.eos
                gen_len = torch.where(hit.any(dim=2),
                                      hit.int().argmax(dim=2) + 1,
                                      self.max_new).float()
            else:
                gen_len = torch.full(self.scores.shape, float(self.max_new),
                                     device=self.scores.device)
            norm = self.scores / gen_len ** self.length_penalty
            best = torch.argmax(norm, dim=1)
            toks = torch.gather(self.out, 1, best[:, None, None].expand(
                -1, 1, self.max_new))[:, 0]
            fin = torch.gather(self.finished, 1, best[:, None])
            both = torch.cat([toks, fin.to(torch.int32)], dim=1).cpu()
        return both[:, :-1], both[:, -1].bool()


def _new_loop(dec, w, b, s, max_new, do_sample, has_eos, top_k, top_p,
              has_rep, num_beams):
    """The loop of a generate() signature: beams or one row a prompt."""
    if num_beams > 1:
        return _BeamLoop(dec, w, b, s, max_new, has_eos, num_beams)
    return _DecodeLoop(dec, w, b, s, max_new, do_sample, has_eos, top_k,
                       top_p, has_rep)


def _weight_ptrs(w):
    """Where the weights live, the quantized leaves included: a captured
    loop reads them there. (The rope tables are constants of the
    configuration; the loop keeps its own fp32 copies.)"""
    return tuple(t.data_ptr() for n, t in w.items()
                 if not n.startswith("__rope"))


_LOOPS_MAX = 4      # captured loops a decoder keeps; each holds its caches


def _loop_for(dec, w, *signature):
    """The decoder's captured loop for ``signature`` (_new_loop's
    arguments after ``w``), captured at first use, as ``_jits_for`` keeps
    one compiled program per signature. A loop whose weight tensors were
    replaced is captured anew."""
    loop = dec.loops.pop(signature, None)
    if loop is None or loop.ptrs != _weight_ptrs(w):
        loop = _new_loop(dec, w, *signature)
        loop.capture()
    dec.loops[signature] = loop
    while len(dec.loops) > _LOOPS_MAX:
        dec.loops.popitem(last=False)
    return loop


def _decode(dec, w, ids, mask, max_new, do_sample=False, temperature=1.0,
            top_k=0, top_p=1.0, eos_token_id=None, seed=None,
            repetition_penalty=1.0, num_beams=1, length_penalty=1.0,
            capture=False):
    """generate()'s work on checked inputs (ids and mask [B, S] long on
    the weights' device): the captured loop with ``capture``, else the
    loop run op by op."""
    b, s = ids.shape
    signature = (b, s, int(max_new), bool(do_sample),
                 eos_token_id is not None, int(top_k), float(top_p),
                 repetition_penalty != 1.0, int(num_beams))
    loop = _loop_for(dec, w, *signature) if capture \
        else _new_loop(dec, w, *signature)
    extra = {"length_penalty": length_penalty} if num_beams > 1 else {}
    loop.start(ids, mask, temperature,
               eos_token_id if eos_token_id is not None else 0,
               repetition_penalty, seed, **extra)
    for _ in range(int(max_new)):
        loop.step()
    return loop.result()


def _host_long(x):
    """An id or mask array (tensor, numpy array or nested list) as a long
    tensor on the CPU, where generate() checks it."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().long()
    return torch.as_tensor(np.asarray(x)).long()


def generate(model, input_ids, attention_mask=None, max_new_tokens: int = 32,
             do_sample: bool = False, temperature: float = 1.0,
             top_k: int = 0, top_p: float = 1.0,
             eos_token_id: Optional[int] = None, seed: Optional[int] = None,
             num_beams: int = 1, length_penalty: float = 1.0,
             repetition_penalty: float = 1.0, quant: Optional[str] = None,
             device=None):
    """Greedy/sampled continuation of ``input_ids`` ([B, S] int, LEFT-padded
    for ragged batches with ``attention_mask`` [B, S] in {0, 1}).

    ``quant`` ("weight_only_int8", "weight_only_int4", "weight_only_fp8")
    decodes against per-channel narrow weight matrices, quantized once per
    weight snapshot and cached on the model; the matmuls read them through
    the weight-only GEMM on the card.

    Returns (tokens [B, max_new_tokens] int32, finished [B] bool), CPU
    tensors: rows that hit ``eos_token_id`` keep emitting it. ``device``
    None means the GPU (raises without one); the model must live there.
    ``num_beams`` > 1 runs greedy beam search (``_BeamLoop``) and returns
    each prompt's best beam by ``score / gen_len ** length_penalty``;
    sampling and the repetition penalty are refused under beams, as in
    the JAX package. On the GPU the decode step is one CUDA graph per
    (batch, prompt length, max_new_tokens, sampling switches, num_beams)
    signature, kept on the model's decoder."""
    if quant is not None and quant not in _QUANT_BITS:
        raise NotImplementedError(
            f"generate(quant={quant!r}): supported algos are "
            f"{sorted(_QUANT_BITS)}")
    if num_beams > 1:
        if do_sample:
            raise NotImplementedError(
                "beam search with sampling is not supported; use "
                "do_sample=False (greedy beams) or num_beams=1")
        if repetition_penalty != 1.0:
            raise NotImplementedError(
                "repetition_penalty under beam search is not supported")
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"the model lives on {model.device}, generate() "
                         f"was asked for {dev}")
    ids = _host_long(input_ids)
    b, s = ids.shape
    if attention_mask is None:
        mask = torch.ones(b, s, dtype=torch.long)
    else:
        mask = _host_long(attention_mask)
        # left padding is the contract: real tokens are a suffix
        lengths = mask.sum(dim=1)
        suffix = torch.arange(s)[None, :] >= (s - lengths[:, None])
        if not torch.equal(mask.bool(), suffix):
            raise ValueError(
                "generate() requires LEFT-padded prompts: attention_mask "
                "must mark a suffix of real tokens per row")
    if model.config.max_position_embeddings < s + max_new_tokens:
        raise ValueError(
            f"prompt {s} + max_new_tokens {max_new_tokens} exceeds "
            f"max_position_embeddings "
            f"{model.config.max_position_embeddings}")
    dec = _decoder_for(model)
    _check_capacity(dec, b * (s + max_new_tokens),
                    f"batch {b} x (prompt {s} + max_new_tokens "
                    f"{max_new_tokens})")
    w = _quant_weights_cached(dec, model, quant) if quant \
        else dec.weights(model)
    return _decode(dec, w, ids.to(model.device), mask.to(model.device),
                   max_new_tokens, do_sample, temperature, top_k, top_p,
                   eos_token_id, seed, repetition_penalty, max(num_beams, 1),
                   length_penalty, capture=model.device.type == "cuda")


def draft_greedy_batch(model, seqs, k: int, width: int = 64,
                       quant: Optional[str] = None):
    """Greedy k-token continuations of every ``seqs`` entry (a list of
    token ids each) in ONE generate() call: a speculative drafter drafts
    the whole decode batch a step. Each context is pinned into a FIXED
    left-padded window of ``width`` tokens, so a serving drafter uses one
    captured decode graph per (batch, width, k) signature instead of one
    per prompt length. A sequence longer than the window keeps its most
    recent tokens (the drafter only proposes; verification keeps the
    output exact). Returns a list of k-int lists, one per sequence."""
    if k < 1 or not seqs:
        return [[] for _ in seqs]
    max_pos = model.config.max_position_embeddings
    if max_pos <= k:
        raise ValueError(f"draft model caps at {max_pos} positions, cannot "
                         f"draft {k} tokens")
    width = int(min(width, max_pos - k))
    ids = np.zeros((len(seqs), width), np.int64)
    mask = np.zeros((len(seqs), width), np.int64)
    for b, seq in enumerate(seqs):
        ctx = [int(t) for t in seq[-width:]]
        ids[b, width - len(ctx):] = ctx
        mask[b, width - len(ctx):] = 1
    toks, _ = generate(model, ids, attention_mask=mask, max_new_tokens=k,
                       quant=quant, device=model.device)
    return toks.tolist()


def draft_greedy(model, seq, k: int, width: int = 64,
                 quant: Optional[str] = None):
    """Single-sequence convenience over ``draft_greedy_batch``."""
    if k < 1:
        return []
    return draft_greedy_batch(model, [seq], k, width=width, quant=quant)[0]


__all__ = ["generate", "draft_greedy", "draft_greedy_batch",
           "_LlamaDecoder", "_GPTDecoder", "_decoder_for"]
