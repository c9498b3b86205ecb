"""KV-cached decoding of a Llama model over its weight tensors.

Mirrors ``paddle_tpu/generation.py``:

  * ``_LlamaDecoder.step_ragged``: one packed batch of tokens from many
    sequences (prefill chunks and decode tokens together) goes through
    every layer, writes its K/V into the paged pools and attends over them
    (the serving engine's step);
  * ``_LlamaDecoder.step``: the dense KV-cache step of ``generate()``:
    per-row caches ``[L, B, M, kvh, hd]`` written in place at a slot held
    in a device tensor, attention in plain PyTorch with the JAX code's
    fp32 casts (the JAX package has no kernel for it either);
  * ``generate()``: the prefill, the decode loop and sampling (greedy,
    temperature, top-k, top-p, eos, the CTRL repetition penalty). The JAX
    package compiles the loop into one program per signature. Here the
    prefill runs op by op and, on the card, the decode step is a CUDA
    graph captured once per signature and replayed ``max_new_tokens``
    times: its counter, write position, key mask and sampling noise live
    on the card, and the tokens are read back once, at the end.

The RMSNorms, the rotary embedding and the ragged attention go through the
port's kernels on CUDA tensors and through their plain versions on CPU
tensors; the large matrix products go to ``torch.matmul``.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import resolve_device
from .kernels import LAUNCHES, fused, uncount_since

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


def _attend(q, k, v, score_mask):
    """q: [B, S, H, D]; k/v: [B, T, H, D]; score_mask: [B, 1, S, T] bool
    (True = visible). Returns [B, S, H, D]."""
    d = q.shape[-1]
    scores = torch.einsum("bshd,bthd->bhst", q.float(),
                          k.float()) / math.sqrt(d)
    scores = torch.where(score_mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, v.float()).to(q.dtype)


def _attend_gqa(q, k, v, score_mask, rep):
    """Grouped-query attention without expanding the KV cache. q:
    [B, S, G*rep, D]; k/v: [B, T, G, D]; score_mask: [B, 1, S, T].
    Returns [B, S, G*rep, D]."""
    b, s, h, d = q.shape
    qg = q.reshape(b, s, h // rep, rep, d)
    scores = torch.einsum("bsgrd,btgd->bgrst", qg.float(),
                          k.float()) / math.sqrt(d)
    scores = torch.where(score_mask[:, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrst,btgd->bsgrd", p, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def _head_logits(w, h, tied, embed_key):
    """The LM-head matmul: the tied embedding's transpose, or lm_head."""
    if tied:
        return h @ w[embed_key].T
    return h @ w["lm_head.weight"]


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

    def _qkv_proj(self, w, i, x, b, s):
        pre = f"model.layers.{i}.self_attn."
        q = (x @ w[pre + "q_proj.weight"]).reshape(b, s, self.n_heads,
                                                   self.hd)
        k = (x @ w[pre + "k_proj.weight"]).reshape(b, s, self.n_kv, self.hd)
        v = (x @ w[pre + "v_proj.weight"]).reshape(b, s, self.n_kv, self.hd)
        return q, k, v

    def _post_attn(self, w, i, h, att):
        """Residual + output projection + SwiGLU MLP; att: [B, S, H*D]."""
        pre = f"model.layers.{i}."
        h, x2 = _add_rms(h, att @ w[pre + "self_attn.o_proj.weight"],
                         self._lw(w, i, "post_attention_layernorm.weight"),
                         self.eps)
        gate = x2 @ w[pre + "mlp.gate_proj.weight"]
        up = x2 @ w[pre + "mlp.up_proj.weight"]
        swi = F.silu(gate.float()).to(up.dtype) * up
        return h + swi @ w[pre + "mlp.down_proj.weight"]

    def _layer(self, w, i, h, cos, sin, kc, vc, write_pos, score_mask):
        """One layer with its cache append; h: [B, S, H*D]; kc/vc:
        [B, M, kvh, hd] of this layer, written IN PLACE at cache slots
        ``write_pos .. write_pos + S - 1`` (write_pos: a long [1] tensor, so
        a captured step writes where the loop's counter says). Rows still
        inside their left padding write values that the score mask hides."""
        b, s, _ = h.shape
        x = _rms(h, self._lw(w, i, "input_layernorm.weight"), self.eps)
        q, k, v = self._qkv_proj(w, i, x, b, s)
        q, k = _rope_rows(q, k, cos, sin)
        slots = write_pos if s == 1 else \
            write_pos + torch.arange(s, device=h.device)
        kc.index_copy_(1, slots, k.to(kc.dtype))
        vc.index_copy_(1, slots, v.to(vc.dtype))
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
        kcs/vcs: [L, B, M, kvh, hd], written in place; write_pos as in
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


def _decoder_for(model):
    """The model's decoder, built once per model instance (Llama only)."""
    from .models.llama import LlamaForCausalLM
    if not isinstance(model, LlamaForCausalLM):
        raise NotImplementedError(
            f"the port serves Llama models only, not {type(model).__name__}")
    dec = model.__dict__.get("_decode_cache")
    if dec is None:
        dec = _LlamaDecoder(model)
        model.__dict__["_decode_cache"] = dec
    return dec


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
        self.dec, self.w = dec, w          # the graph reads these tensors
        self.ptrs = _weight_ptrs(w)
        self.s, self.max_new = s, max_new
        self.do_sample, self.has_eos, self.has_rep = do_sample, has_eos, \
            has_rep
        self.top_k, self.top_p = top_k, top_p
        emb = w[dec.embed_key]
        dev, dt = emb.device, emb.dtype
        vocab = emb.shape[0] if dec.tied else w["lm_head.weight"].shape[1]
        self.kcs = torch.zeros(dec.n_layers, b, s + max_new, dec.n_kv,
                               dec.hd, dtype=dt, device=dev)
        self.vcs = torch.zeros_like(self.kcs)
        self.last_logits = torch.zeros(b, vocab, dtype=dt, device=dev)
        self.key_mask = torch.zeros(b, s + max_new, dtype=torch.bool,
                                    device=dev)
        self.out = torch.zeros(b, max_new, dtype=torch.int32, device=dev)
        self.finished = torch.zeros(b, dtype=torch.bool, device=dev)
        self.seen = torch.zeros(b, vocab if has_rep else 1, dtype=torch.bool,
                                device=dev)
        self.t = torch.zeros(1, dtype=torch.long, device=dev)
        self.lengths = torch.zeros(b, dtype=torch.long, device=dev)
        self.temperature = torch.ones((), dtype=torch.float32, device=dev)
        self.eos = torch.zeros((), dtype=torch.int32, device=dev)
        self.rep = torch.ones((), dtype=torch.float32, device=dev)
        # the uniform draws of the latest step; a generator of the loop's
        # own, registered with the graph, so that each replay draws anew
        self.noise = torch.zeros(b, vocab, dtype=torch.float32, device=dev) \
            if do_sample else None
        self.gen = torch.Generator(device=dev) if do_sample else None
        self.graph = None
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


def _weight_ptrs(w):
    """Where the parameters live: a captured loop reads them there. (The
    rope tables are constants of the configuration; the loop keeps its own
    fp32 copies.)"""
    return tuple(t.data_ptr() for n, t in w.items() if not n.startswith("__"))


_LOOPS_MAX = 4      # captured loops a decoder keeps; each holds its caches


def _loop_for(dec, w, *signature):
    """The decoder's captured loop for ``signature`` (_DecodeLoop's
    arguments after ``w``), captured at first use, as ``_jits_for`` keeps
    one compiled program per signature. A loop whose weight tensors were
    replaced is captured anew."""
    loop = dec.loops.pop(signature, None)
    if loop is None or loop.ptrs != _weight_ptrs(w):
        loop = _DecodeLoop(dec, w, *signature)
        loop.capture()
    dec.loops[signature] = loop
    while len(dec.loops) > _LOOPS_MAX:
        dec.loops.popitem(last=False)
    return loop


def _decode(dec, w, ids, mask, max_new, do_sample=False, temperature=1.0,
            top_k=0, top_p=1.0, eos_token_id=None, seed=None,
            repetition_penalty=1.0, capture=False):
    """generate()'s work on checked inputs (ids and mask [B, S] long on
    the weights' device): the captured loop with ``capture``, else the
    loop run op by op."""
    b, s = ids.shape
    signature = (b, s, int(max_new), bool(do_sample),
                 eos_token_id is not None, int(top_k), float(top_p),
                 repetition_penalty != 1.0)
    loop = _loop_for(dec, w, *signature) if capture \
        else _DecodeLoop(dec, w, *signature)
    loop.start(ids, mask, temperature,
               eos_token_id if eos_token_id is not None else 0,
               repetition_penalty, seed)
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

    Returns (tokens [B, max_new_tokens] int32, finished [B] bool), CPU
    tensors: rows that hit ``eos_token_id`` keep emitting it. ``device``
    None means the GPU (raises without one); the model must live there.
    On the GPU the decode step is one CUDA graph per (batch, prompt
    length, max_new_tokens, sampling switches) signature, kept on the
    model's decoder. Beam search and ``quant`` are not ported."""
    if quant is not None:
        raise NotImplementedError(
            f"generate(quant={quant!r}): quantized decoding is not ported "
            "to paddle_tpu_torch yet (see ROADMAP.md)")
    if num_beams > 1:
        raise NotImplementedError(
            "generate(num_beams > 1): beam search is not ported to "
            "paddle_tpu_torch yet (see ROADMAP.md)")
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
    return _decode(dec, dec.weights(model), ids.to(model.device),
                   mask.to(model.device), max_new_tokens, do_sample,
                   temperature, top_k, top_p, eos_token_id, seed,
                   repetition_penalty, capture=model.device.type == "cuda")


__all__ = ["generate", "_LlamaDecoder", "_decoder_for"]
