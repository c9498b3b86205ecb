"""Drive paddle_tpu_torch's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--out DIR]

Phases, each printing its own lines and its seconds:
  1. the card (nvidia-smi name and power limit) and the versions;
  2. the build: every CUDA source compiled by nvcc for sm_90a (one nvcc
     per source, all started together; ptxas's registers and spills
     printed), the Triton kernels compiled by their first launch; the
     HGMMA (wgmma), UTMALDG (TMA load), UBLKCP (bulk copy) and HMMA
     (mma.sync) instructions of each bf16 flash, gmm, tgmm and ragged
     attention kernel, counted in cuobjdump's SASS: each must have HGMMA
     and UTMALDG and no HMMA, and the ragged kernels bulk copies and
     tensor-core products; the weight-only GEMM's fifteen wgmma
     instantiations (3 formats x tiles of 8, 64, 128, 256 tokens by 128
     channels and 256 by 64) must have HGMMA and UTMALDG and no HMMA, its
     six mma.sync ones (the route of shapes TMA cannot read) HMMA and
     LDGSTS (cp.async);
  3. every kernel against its plain PyTorch version on the card, at the
     shapes the serving and training paths give it, with its time, its
     bound and a single PyTorch call for the same function where there is
     one (ragged attention: decode and mixed steps, MHA and GQA, each with
     its CUDA-graph and eager ms, the fraction of its bound, the SDPA
     yardstick, the plan's items and the CUDA kernels a call launches;
     then one call captured in a CUDA graph and replayed after its
     metadata is rewritten in place must equal the eager call, and two
     calls each other, bit for bit; and GPT-2's 12 heads of 64); the
     weight-only GEMM (int8, int4, fp8) at every quantized matrix shape of
     Llama-2-7B and GPT-2 and M = 8, 256 and 4096: the wgmma kernel on its
     plan, the mma.sync kernel beside it at the Llama shapes, the plain
     version, the bound and torch.matmul on the bf16 weight as the
     yardstick; then a tiny float32
     Llama served on the
     CPU engine's greedy tokens, and a tiny float32 Llama trained 3 steps
     on the card must match the port's CPU trainer (flash also at the
     GPT-MoE shape, and in bf16 at ragged lengths, sq < sk and
     non-causal; each timed case with its TFLOP/s); the MoE kernels (gmm,
     its dx form and tgmm) at the GPT-MoE slice's shapes, bench.py's
     gmm_probe shapes and a skewed routing, one MoE layer's forward and
     backward with no host sync, and a tiny float32 GPT-MoE trained 3
     steps on the card against the CPU trainer; the FlashMask kernels
     (tile-summary pre-pass, forward, dq, dk/dv) at bench.py's
     flashmask_probe shape, the packed slice's shape, float32 cases
     (non-causal bands, a window, bounds per head, rows that see no key)
     and bf16 ones (ragged lengths at d 64 and 128, rows without a key),
     and a tiny float32 Llama on packed documents trained 3 steps on the
     card against the CPU trainer; FlashMask calls the kernels do not take
     (causal q_len > kv_len, q_len < kv_len, head_dim 32) routed to the
     plain versions on the card (one ``sdpa_plain`` each, no kernel),
     equal to the CPU's; the elementwise passes XLA fuses into the JAX
     training step, as Triton kernels (RMSNorm's backward over [16384,
     2048], SwiGLU's forward and backward over [16384, 5632], bf16) against
     their plain versions, timed beside their bound and, for RMSNorm, the
     autograd of F.rms_norm; the dropout kernel over the ERNIE step's
     hidden states ([16384, 768] bf16) and attention probabilities ([32,
     12, 512, 512] fp32) bit-equal to its plain version (Philox4x32-10 in
     both), beside torch's F.dropout, and a captured call replayed with
     new keys equal to eager calls; LayerNorm(residual + dropout(x +
     bias)) forward and backward over [16384, 768] bf16, with the dropout
     and as a plain LayerNorm, beside F.layer_norm and its autograd;
     GroupNorm with and without the SiLU, forward and backward, at the
     UNet's [4, 320, 64, 64], [4, 960, 64, 64] and [4, 1280, 8, 8] in
     bf16, [4, 320, 64, 64] in fp32 and [4, 64, 64, 320] NHWC, against
     its plain version, replayed from a graph, and (bf16) against the O2
     composition (the norm in fp32, the SiLU on its cast), timed beside
     its bound, F.group_norm (+ F.silu) and its autograd; BatchNorm with
     the ReLU, with the residual add and the ReLU, and alone, forward
     (training and eval) and backward, at ResNet-50's [128, 64, 112,
     112], [128, 256, 56, 56], [128, 2048, 7, 7], [128, 1024, 14, 14] and
     [128, 512, 28, 28] in bf16 under O1's dtypes (fp32 weights, residual
     and output), one fp32 and one NHWC case, the forward's and the
     backward's routes printed (``batch_norm_forward_plan``: the cluster
     kernel of ``csrc/batch_norm_fwd.cu`` for training at 56 x 56 and
     below;
     ``batch_norm_backward_plan``: the cluster kernel of
     ``csrc/batch_norm_bwd.cu`` at 28 x 28 and below), against its plain
     version, two calls and a graph replay with
     the running statistics bit-equal, the fused calls bit-equal to the
     unfused kernel followed by PyTorch's add and ReLU under amp O1,
     timed beside its bound, the plain version and cuDNN's F.batch_norm
     (+ add, + F.relu) and its autograd; an InstanceNorm2D through the
     GroupNorm kernel against its plain version; the CTC and RNN-T
     kernels (a pass over the rows and a recursion each way) against
     their plain loops at phase 16's shapes, fp32 and bf16, ragged
     lengths, an empty label sequence, norm_by_times and fastemit_lambda,
     two runs bit-equal, timed beside their bounds, the plain loops and
     F.ctc_loss; X2, the dense attention's middle (scale, masks, fp32
     softmax, dropout; Triton), forward and backward against its plain
     version at the UNet's [4, 8, 4096, 4096], ERNIE's [32, 12, 512, 512]
     (a padding mask, p 0.1) and Transformer-base's [64, 8, 64, 64] (its
     float causal mask plus padding, p 0.1), each timed beside its bound,
     the plain version and torch.softmax alone, and at causal sq < sk,
     a bool mask with a row that sees no key, an additive mask with a
     gradient, rows longer than one block and flash_attn_unpadded's
     segments: the probs and ds element by element, the dropout's keep
     mask bit-equal to kernels/dropout.py's, two calls bit-equal (each
     call form compiled at its first call); the new losses, common
     functionals and layers, the attention functionals, the Transformer
     and fused Transformer layers on the card against the same calls on
     the CPU, and sparse_attention twice bit-equal; the recurrence kernels
     (``csrc/rnn_recurrence.cu``: the forward's route printed from
     ``rnn_forward_plan``, one persistent launch a layer or one step-kernel
     launch a step; the backward's from ``rnn_backward_plan``, one
     persistent launch a layer or cell call where it fits, else a gates
     and a product launch a step)
     against their plain loop, fp32, forward and backward with every
     gradient, at the IWSLT'15 model's shapes (an LSTM, GRU and tanh RNN
     layer at [T 50, B 128, in 512, H 512], the decoder's first cell at in
     1024, a beam step at B 1280; each timed by graph replay beside its
     bound, the plain loop and cuDNN's layer on the same weights; the step
     route's two kernels each by a profiler trace) and at small shapes in
     every mode and direction, two runs bit-equal and each case captured
     and replayed equal to its eager call; the recurrent layers, sequence_mask,
     gather_tree and a beam decode on the card against the CPU;
  4. Llama-2-7B at full width in bf16 (random weights from a seeded
     generator) served by the continuous-batching engine, twice over the
     same 12 requests: with its step run op by op (the yardstick), then
     replayed from the CUDA graph the engine captured at construction
     (the main path). For each, the launch counts are zeroed just before
     and read just after and must be exact, every request must return all
     its tokens, and decode and prefill step ms, tokens/s, the host's
     share (schedule, pack, device step, emit), time to first token and
     request latency (p50, p99) are printed, with a profile of prefill and
     decode steps (device ms by group, idle share, one ragged plan a
     step). The two runs' tokens must be equal, every step's logits
     bit-equal and the pools' real pages equal; so must a float32 pair
     (2 layers at full width). Then the front door
     (``create_llm_predictor`` with ``set_max_batch_size(8)``) must return
     ``generate_batch``'s tokens; ``generate()`` (batch 8, left-padded
     prompts of 16-512 tokens, 32 new tokens) must give the same greedy
     tokens from its captured decode graph as from the loop run op by op,
     with exact launch counts, step ms, tokens/s, a profile and the dense
     attention's ms; sampled (temperature 0.8, top-k 50, top-p 0.9, a
     seed) two runs must be equal, in the vocabulary, with new noise each
     step; the decode step with a dense attention that copies K and V to
     fp32 is timed beside the current one (the bf16 cache read in place);
     a BatchingServer over an EnginePredictor, 12 requests from 4 client
     threads, must return generate_batch's tokens;
     ``generate(num_beams=4)`` (batch 8, prompts left-padded to 512, 32
     new tokens, eos) must give the same tokens, finished flags, beam
     scores and beams from its captured beam loop as from the loop run op
     by op, with exact launch counts, prefill and step ms and the cache
     reorder's ms alone, and a float32 2-layer pair's beams must equal the
     CPU's; and one ragged step through the kernels must agree with the
     same step through the plain versions (in bf16 and in float32);
     4b. ``LlamaConfig.llama2_13b()`` at full width in bf16 (26 GB of
     seeded random weights) served through the engine's captured step,
     6 requests, exact launch counts, decode and prefill ms;
  5. the llama-1.1b-b8 training recipe at full width (bf16 weights, fp32
     moments, full remat, chunked loss), its step captured in one CUDA
     graph (the trainer's first call runs the step and captures it): 2
     warm-up and 5 timed steps with exact launch counts (each replay
     adding the launches the capture counted), finite and falling losses,
     the graph's pool, a profile of one step by kernel group with the
     "other" group split by kernel (top 12); then 3 captured steps against
     3 steps of the same trainer run op by op (``_step_eager``) from one
     snapshot of its weights, buffers, optimizer state and random state,
     losses, parameters and moments bit-equal, with the eager step's ms
     and profile; 5 steps
     captured anew under TF32 matmuls (the fp32 head; the setting reset
     after); and one step through the kernels against the plain versions
     at the same widths with 2 layers (and, recorded only, with TF32);
  6. GPT-MoE (GPTConfig.gpt_moe(8): GPT-2-small widths, 8 experts top-2 in
     every second block, dropless) trained at full width (bf16 weights,
     fp32 moments, no remat, batch 8 x 1024), captured as phase 5: 2
     warm-up and 5 timed steps with exact launch counts, finite and
     falling losses, a profile of one step (the "other" group split),
     captured against eager as phase 5 (bit-equal; both step ms and idle
     shares), and one step through the kernels against the plain versions
     at the same widths with 2 layers, on 8 seeds (routing flips make one
     seed's bf16 gradients a matter of chance);
  7. the llama-1.1b-b8 recipe of phase 5 on packed documents (lengths
     uniform in [64, 1024] packed into each 2048-token row; FlashMask
     column bounds keep attention inside each document; labels cut at the
     boundaries): the same captured steps, checks, profile, captured
     against eager and 2-layer agreement, with exact FlashMask launch
     counts and no dense flash launch;
  8. GPT-2 small and GPT-MoE (GPTConfig.gpt_moe(8)) in bf16 served at full
     width (engine max_seqs 8, budget 256, max_model_len 1024; 12 requests
     of 16-700 prompt tokens, 32 new tokens), eager then captured, with
     phase 4's checks; generate() captured against eager; a 2-layer
     float32 pair;
  9. phase 4's model, engine and requests with weight-only int8, int4 and
     fp8 weights, one engine at a time: captured against eager (tokens,
     logits bit-equal, exact launch counts with one weight-only GEMM a
     quantized matrix and none of it on the mma.sync kernel), step ms,
     tokens/s, idle share, a profile, the
     quantized bytes, the token agreement with the bf16 engine (printed)
     and one ragged step through the kernels against the plain versions;
     generate(quant="weight_only_int8");
  10. phase 4's model and requests with speculative decoding, k = 4
     (n-gram; the 1.1B Llama as draft model; the target drafting for
     itself): proposed, accepted, rollback pages, steps, step ms,
     tokens/s, the host's share; bf16 tokens against the non-speculative
     run (the two runs' logit difference at the positions before each
     request's first difference, the verify-row vs decode-row noise,
     within SPEC_NOISE_ULPS bf16 ulps of each row's largest logit; a first
     difference must be a near tie: both tokens their run's argmax, the
     non-speculative top-2 margin within twice that noise); in float32
     (2 layers) speculative tokens identical to non-speculative ones;
  11. the artifact path on the 1.1B Llama of phase 5 (bf16) at 11 of its
     22 layers (a depth cut for the smoke's time): ``jit.save``
     with InputSpec([None, None], "int64") into a directory under --out,
     ``create_predictor`` on the card, a batch of 4 x 512: logits equal to
     the live model's forward bit for bit, exact launches (a flash
     forward, two RMSNorms and a RoPE a layer, the final RMSNorm; nothing
     routed; the MLP's SwiGLU) through the kernels' torch.library ops;
     then the same model
     saved on the CPU and loaded on the card, with the same checks; save,
     load and run seconds; the artifacts are deleted;
  12. the training surface on the llama-1.1b-b8 widths (bf16 weights,
     batch 8 x 2048) at 6 of its 22 layers: the usual recipe (AdamW at
     warmup then cosine, no decay on the named norms, the embedding at
     half the rate, global-norm clipping) 5 steps, captured, the rate each replay read
     equal to the scheduler's and exact launch counts; the same run saved
     after 3 steps (model, optimizer, scheduler through framework.io), one
     step more, then the save loaded in place into the same model,
     optimizer and scheduler, whose captured graph goes on, and into a
     fresh model, optimizer, scheduler and trainer, whose first call runs
     eagerly and captures: each 2 steps bit-equal to the uninterrupted
     run, with exact launch counts, save and load seconds; the same 5 steps
     under remat "dots", bit-equal, with step ms and peak memory beside
     "full"; 3 steps of float32 weights under auto_cast O1 (flash through
     the bf16 kernel); every trainer's graph dropped (its pool given back)
     before the next is built; a 2-layer recipe (bf16, and auto_cast) no
     further from float32 through the kernels than through the plain
     versions (1.1x overall, 1.25x per parameter); GradScaler skipping a
     step with an inf; every optimizer rule and LBFGS on a tiny float32
     Llama equal to the CPU's within rtol 1e-5;
  13. ERNIE-base pretraining (BASELINE configuration 3) at its published
     widths, uncut (vocab 18000, hidden 768, 12 layers, dropout 0.1 /
     0.1; bf16 weights, fp32 moments, AdamW, batch 32 x 512): (a) the
     step captured, 2 warm-up and 5 timed steps with exact launch counts
     (AdamW 1, dropout 2 (the embeddings'), LayerNorm 26 + 26 backward,
     12 dense attention calls through X2, 12 + 12, the probabilities'
     dropout inside it; no flash), finite and falling losses, step ms,
     tokens/s, MFU, peak memory, pool, a profile by kernel group; 3
     captured steps against 3 eager ones from one snapshot, bit-equal; one
     step from one snapshot twice under one seed (bit-equal) and once
     under another (a different loss); the 12 dense middles' device ms
     through X2 and through the separate ops' composition (the plain
     version), in
     the same call; (b) the same
     at dropout 0 (flash 12 + 12 a step, nothing dense); (c) one step at 2
     layers through the kernels against the plain versions (the phase 5
     gate; every path draws the same masks); (d) a tiny float32 ERNIE at
     dropout 0.1 trained 3 steps on the card against the CPU trainer;
     (e) ErnieForSequenceClassification in eval at [32, 512] bf16,
     through flash without a mask and the dense route with one, logits
     no further from float32 than the plain path's (2x);
  14. the Stable Diffusion UNet (BASELINE configuration 5, SD 1.5 uncut:
     channels 320 / 640 / 1280 / 1280, 810M parameters, random weights
     from the seed), bf16 under amp O2: (a) one denoising forward at
     batch 2 x [4, 64, 64] (timesteps 999, a [2, 77, 768] context), exact
     launch counts (61 GroupNorms, 45 with the SiLU; 48 LayerNorms; 32
     dense attention calls, each through X2), ms (median of 20), a
     profile, peak memory; (b) the training step at batch 4, AdamW,
     captured, timed with cuDNN's own choice and under
     cudnn.deterministic, exact launch counts (X2 32 + 32), images/s,
     MFU, peak, pool, a profile, then 3 replayed steps against 3 eager
     ones from one snapshot, bit-equal; the 32 dense middles' device ms
     through X2 and through the ops' composition; (c) a 2-level UNet at its
     widths through the kernels against the plain versions (the phase 5
     gate); (d) a tiny float32 UNet on the card against the CPU trainer;
  15. ResNet-50 (BASELINE configuration 1) at ImageNet shape, batch 128 x
     [3, 224, 224], float32 weights under amp O1, Momentum with L2Decay,
     captured: step ms with cuDNN's own choice and deterministic,
     images/s, MFU, peak, a profile, exact launch counts (53 BatchNorm
     forwards and 53 backwards a step, the ReLU and the residual add
     fused; those on the cluster kernels as the plans say), the 53
     BatchNorms' device ms alone through the kernels and through the
     composition of PyTorch ops they replaced, in the same call; 3 replayed steps against 3 eager ones from one snapshot,
     bit-equal with every running statistic; an eval forward at batch
     128 (53 BatchNorm launches); a tiny float32 ResNet-18 on the card
     against the CPU trainer;
  16. sequence-loss training through the captured trainer with AdamW,
     no plain loop allowed to run: CTC at DeepSpeech2's English output
     (features [500, 32, 1024] -> Linear(1024, 29) -> CTCLoss, input
     lengths 400-500, labels 100-200) and over a 4,200-character Mandarin
     vocabulary ([250, 32, 1024], labels up to 40); RNN-T at a
     Conformer-Transducer's joint (encoder [16, 200, 512] and prediction
     network [16, 61, 640] each to 640, added, tanh, Linear(640, 1024),
     RNNTLoss on [16, 200, 61, 1024] fp32, input lengths 150-200, labels
     30-60): for each, exact launch counts (the loss's forward and
     backward kernels and AdamW, one each a step), step ms, a profile
     (the loss kernels' share), 2 replayed steps against 2 eager ones,
     bit-equal; a tiny float32 CTC head and joint on the card against the
     CPU trainer;
  17. Transformer-base (Vaswani et al., 2017, Table 3 "base") at full
     width on nn.Transformer's defaults (d 512, 8 heads, 6 + 6 layers,
     FFN 2048, ReLU, post-norm, dropout 0.1), a shared 37,000-token
     vocabulary tied to the output, label-smoothed cross entropy, Adam
     (0.9, 0.98, 1e-9) on NoamDecay(512, 4000), bf16 under amp O1, 64
     sentence pairs of 16-64 tokens padded to 64 with their padding and
     subsequent masks: the step captured, exact launch counts (X2 18 +
     18, the dropout, LayerNorm and AdamW kernels, nothing on flash or
     the plain path), step ms, tokens/s, MFU, peak memory, a profile, the
     dense middles' ms through X2 and the ops' composition; 3 replayed
     steps against 3 eager ones, bit-equal; an eval forward built at
     dropout 0 without padding (flash for the encoder's self-attention
     and the cross-attention, X2 for the decoder's masked
     self-attention); a tiny float32 Transformer on the card against the
     CPU trainer;
  18. attention-based LSTM translation on IWSLT'15 English-Vietnamese at
     full width, as PaddleNLP's examples/machine_translation/seq2seq
     builds it (tensorflow/nmt's iwslt15 setting; vocabularies 17,191 /
     7,709, width 512, 2 layers, dropout 0.2, uniform init 0.1): the
     encoder nn.LSTM, the decoder nn.RNN over two LSTMCells with input
     feeding and Luong attention, the loss masked by sequence_mask, Adam
     with global-norm clipping at 5, fp32, 128 pairs of 10-50 tokens:
     the step captured, exact launch counts (rnn_fwd 102: the encoder's 2
     layers one persistent launch each, the decoder's 100 cells on the
     step kernel; rnn_bwd 102: the encoder's layers and the decoder's
     cells one persistent launch each; dropout 202, AdamW 1 a step; no
     attention kernel), step ms,
     tokens/s, MFU, peak memory, a profile, 3 replayed steps against 3
     eager ones bit-equal; beam search (beam 10, at most 50 steps, 2
     rnn_fwd a step on the step kernel) as built and with the EOS logit
     held at 0; a tiny float32 model on the card against the CPU trainer,
     its beam 1 against the greedy chain and its beam 4 against the
     CPU's;
  then a JSON line of every kernel, the card line again, and the final
  {"ok": true, ...} line. Phases 4-10 also hold the routing of attention
  to plain versions (``LAUNCHES["sdpa_plain"]``, ``["ragged_plain"]``:
  shapes the kernels do not take) at 0, and the weight-only GEMM's
  mma.sync kernel (``LAUNCHES["weight_only_gemm_sm80"]``: shapes TMA
  cannot read) at 0 (on the card the GEMM launches one of its two kernels
  or raises).
Any failure raises and exits non-zero. Without a CUDA device it exits
non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import functools
import gc
import json
import math
import os
import subprocess
import sys
import time
from contextlib import ExitStack
from unittest import mock

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS = 67e12              # H100 SXM fp32 outside the tensor cores
ULP_BF16 = 2.0 ** -7            # one bf16 ulp, relative
JSON_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# library: (pattern of a kernel's mangled name, its name from the match,
# the number of kernels); the bf16 kernels written for Hopper
WGMMA_KERNELS = {
    "flash_attention_bf16": (
        r"(fwd|bwd_dq|bwd_dkv)_wgmma_kernelILi(\d+)ELb(\d)",
        lambda m: (f"{'flashmask' if m.group(3) == '1' else 'flash'}_"
                   f"{m.group(1)} d{m.group(2)}"), 12),
    "gmm": (r"\d(t?gmm)_wgmma_kernel(?:ILb(\d)E)?",
            lambda m: m.group(1) + (" trans_w" if m.group(2) == "1" else ""),
            3),
    "ragged_attention_bf16": (r"ragged_attention_wgmma_kernelILi(\d+)E",
                              lambda m: f"ragged_attention d{m.group(1)}", 2),
}
SASS_OPS = ("HGMMA", "UTMALDG", "UBLKCP", "HMMA")


def _wgmma_sass(built):
    """{kernel: {op: n for op in SASS_OPS}} for every bf16 kernel of
    ``WGMMA_KERNELS`` in the built libraries, counted in ``cuobjdump
    --dump-sass``. Raises unless each kernel issues wgmma (HGMMA) and TMA
    loads (UTMALDG) and no mma.sync (HMMA), and unless the ragged attention
    kernels issue bulk async copies and tensor-core products."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    counts = {}
    for lib, (pattern, name_of, expected) in WGMMA_KERNELS.items():
        sass = subprocess.run([tool, "--dump-sass", built[lib]["path"]],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        found, name = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                m = re.search(pattern, line)
                name = name_of(m) if m else None
                if name:
                    found[name] = {op: 0 for op in SASS_OPS}
            elif name:
                for op in found[name]:
                    found[name][op] += bool(re.search(rf"\b{op}\b", line))
        if len(found) != expected:
            raise AssertionError(f"{lib}: {len(found)} bf16 kernels in the "
                                 f"SASS, expected {expected}: {found}")
        counts.update(found)
    for k, c in sorted(counts.items()):
        print(f"phase 2: sass {k}: " + " ".join(f"{op} {c[op]}"
                                               for op in SASS_OPS),
              flush=True)
    if any(c["HGMMA"] == 0 or c["UTMALDG"] == 0 or c["HMMA"]
           for c in counts.values()):
        raise AssertionError(f"the bf16 flash, gmm and ragged kernels are "
                             f"not all wgmma with TMA loads: {counts}")
    for k, c in sorted(counts.items()):
        if k.startswith("ragged_attention"):
            copies = c["UBLKCP"] + c["UTMALDG"]
            products = c["HGMMA"] + c["HMMA"]
            print(f"phase 2: {k}: bulk async copies (UBLKCP + UTMALDG) "
                  f"{copies}, tensor-core products (HGMMA + HMMA) {products}",
                  flush=True)
            if not (copies > 0 and products > 0):
                raise AssertionError(f"{k} issues no bulk copy or no "
                                     f"tensor-core product: {c}")
    return counts


GEMM_SASS_OPS = ("HGMMA", "UTMALDG", "HMMA", "LDGSTS", "I2F", "F2FP")
# (pattern of the mangled name, its name from the match, the number of
# instantiations, the ops each must issue, the ops none may issue)
GEMM_KERNELS = {
    "wgmma": (r"weight_only_gemm_wgmma_kernelILi(\d)ELi(\d+)ELi(\d)E",
              lambda m, fmt: f"weight_only_gemm {fmt[m.group(1)]} "
                             f"{m.group(2)}x{64 * int(m.group(3))}",
              15, ("HGMMA", "UTMALDG"), ("HMMA",)),
    "sm80": (r"weight_only_gemm_kernelILi(\d)ELi(\d+)ELi(\d+)",
             lambda m, fmt: f"weight_only_gemm_sm80 {fmt[m.group(1)]} "
                            f"{m.group(2)}x{m.group(3)}",
             6, ("HMMA", "LDGSTS"), ()),
}


def _gn_silu_sass(built):
    """The static SASS instructions of GroupNorm's cluster forward
    (``cuobjdump --dump-sass``) for each output dtype with and without the
    SiLU, and the SiLU's instructions an element: the two bf16
    instantiations' difference over the 8 values a thread writes a vector
    (the element loop is unrolled; the IEEE division's slow path, rarely
    taken, counts once)."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass",
                           built["group_norm_fwd"]["path"]],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    dts = {"0": "fp32", "1": "bf16", "2": "fp16"}
    found, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"ptt_gn_fwd_cluster_kernelILi(\d)ELb(\d)E", line)
            name = f"{dts[m.group(1)]}{' +SiLU' if m.group(2) == '1' else ''}" \
                if m else None
            if name:
                found[name] = 0
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line):
            found[name] += 1
    if len(found) != 6:
        raise AssertionError(f"group_norm_fwd: {len(found)} instantiations "
                             f"in the SASS, expected 6: {found}")
    per = (found["bf16 +SiLU"] - found["bf16"]) / 8
    print(f"phase 2: sass group_norm_fwd cluster kernel instructions "
          f"{found}; the SiLU's ~{per:.1f} instructions an element (static)",
          flush=True)
    return dict(found, silu_per_element=per)


def _gemm_sass(built):
    """{kernel: {op: n}} of the weight-only GEMM's instantiations, counted
    in ``cuobjdump --dump-sass``: the wgmma kernel's fifteen (int8, int4,
    fp8 x tiles of 8, 64, 128, 256 tokens by 128 channels and 256 by 64)
    must issue wgmma (HGMMA) and TMA loads (UTMALDG) and no mma.sync
    (HMMA); the mma.sync kernel's six (the route of shapes TMA cannot
    read) mma.sync and cp.async (LDGSTS)."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass",
                           built["weight_only_gemm"]["path"]],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    fmt = {"0": "int8", "1": "int4", "2": "fp8"}
    found, kind, name = {}, {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = None
            for k, (pattern, name_of, *_) in GEMM_KERNELS.items():
                m = re.search(pattern, line)
                if m:
                    name = name_of(m, fmt)
                    kind[name] = k
                    found[name] = {op: 0 for op in GEMM_SASS_OPS}
        elif name:
            for op in found[name]:
                found[name][op] += bool(re.search(rf"\b{op}\b", line))
    for k, c in sorted(found.items()):
        print(f"phase 2: sass {k}: " + " ".join(f"{op} {c[op]}"
                                               for op in GEMM_SASS_OPS),
              flush=True)
    for k, (_, _, expected, need, refuse) in GEMM_KERNELS.items():
        mine = {n: c for n, c in found.items() if kind[n] == k}
        if len(mine) != expected or any(
                any(c[op] == 0 for op in need) or any(c[op] for op in refuse)
                for c in mine.values()):
            raise AssertionError(f"the weight-only GEMM's {k} kernels: "
                                 f"{len(mine)} of {expected}, each must "
                                 f"issue {need} and no {refuse}: {mine}")
    return found


def _time_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters=20, reps=5):
    """Device time of one call: ``iters`` calls captured in a CUDA graph,
    replayed ``reps`` times between CUDA events, so the host's launch
    cost is not in the number (eager back-to-back launches of a kernel
    this short measure the host instead)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * iters)
    del graph
    return ms


def _bound(nbytes, flops, peak_flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _check(name, got, want, tol):
    err = float((got.detach().float() - want.detach().float()).abs().max())
    ok = math.isfinite(err) and err <= tol
    print(f"  {name}: max_abs_err={err:.6g} tol={tol:.6g} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({err} > {tol})")
    return err


def _check_rows(name, got, want, ulps):
    """Kernel against plain in bf16, row by row (a row is the last axis):
    each row within ``ulps`` bf16 ulps (2^-7 each, relative) of that row's
    largest plain value. A row whose values are all below 2^-8 of the
    tensor's largest (dq of a query that sees one key: exactly 0 but for
    rounding noise) is held to 2^-8 of the tensor's largest instead.
    Returns the largest absolute error."""
    import torch
    g, w = got.detach().float(), want.detach().float()
    mag = w.abs().amax(-1)
    tol = ulps * ULP_BF16 * mag.clamp(min=2.0 ** -8 * float(mag.max()))
    err = (g - w).abs().amax(-1)
    worst = float((err / tol).max())
    ok = bool(torch.isfinite(g).all()) and worst <= 1.0
    print(f"  {name}: max_abs_err={float(err.max()):.6g}, worst row at "
          f"{worst:.3g} of its tolerance ({ulps} bf16 ulps of the row's "
          f"largest value) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (a row at {worst} of its tolerance)")
    return float(err.max())


def _check_vs_f32(name, got, plain, ref32, factor=1.1):
    """The kernel's relative L2 distance from a float32 reference (the
    plain version on the upcast inputs) may be at most ``factor`` times
    the plain bf16 version's: both round at the same places."""
    norm = float(ref32.norm())
    d_k = float((got.float() - ref32).norm()) / norm
    d_p = float((plain.float() - ref32).norm()) / norm
    ok = math.isfinite(d_k) and d_k <= factor * d_p
    print(f"  {name}: relative L2 distance from float32: kernel {d_k:.5g}, "
          f"plain {d_p:.5g} (tol: kernel <= {factor} x plain) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: the kernel is further from float32 "
                             f"than the plain version ({d_k} > {factor} x "
                             f"{d_p})")
    return d_k, d_p


# -- phase 3: kernels against their plain versions ------------------------------

def _ragged_case(torch, dev, kvh, contexts, chunk, budget, seed, bs=16,
                 heads=32, d=128):
    """A packed step at the engine's shapes: one decode token per context
    in ``contexts``, then ``chunk`` prefill tokens of a sequence whose
    chunk ends at the last context, padded with invalid rows to
    ``budget`` rows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n_slots = len(contexts)
    mp = max(-(-c // bs) for c in contexts)
    tables = torch.full((n_slots, mp), -1, dtype=torch.int32)
    perm = torch.randperm(sum(-(-c // bs) for c in contexts),
                          generator=torch.Generator().manual_seed(seed))
    nxt = 0
    for s, c in enumerate(contexts):
        n = -(-c // bs)
        tables[s, :n] = perm[nxt:nxt + n].to(torch.int32)
        nxt += n
    p_total = nxt
    slot, pos = [], []
    for s, c in enumerate(contexts[:-1] if chunk else contexts):
        slot.append(s)
        pos.append(c - 1)
    if chunk:
        last = contexts[-1]
        slot += [n_slots - 1] * chunk
        pos += list(range(last - chunk, last))
    n_valid = len(slot)
    slot += [0] * (budget - n_valid)
    pos += [0] * (budget - n_valid)
    valid = [True] * n_valid + [False] * (budget - n_valid)
    dt = torch.bfloat16
    q = torch.randn(budget, heads, d, device=dev, generator=g).to(dt)
    kp = torch.randn(p_total, kvh, bs, d, device=dev, generator=g).to(dt)
    vp = torch.randn(p_total, kvh, bs, d, device=dev, generator=g).to(dt)
    args = (q, kp, vp, tables.to(dev), torch.tensor(slot, dtype=torch.int32,
                                                    device=dev),
            torch.tensor(pos, dtype=torch.int32, device=dev),
            torch.tensor(valid, device=dev))
    # bytes the function must move: q of the valid rows, the output of
    # every row, the pages the valid tokens can see (each once) and their
    # table entries, positions and valid of every row, slot ids of the
    # valid rows; flops: q.k and p.v over every visible slot of every
    # valid token
    seen = set()
    flops = 0
    for s_i, p_i in zip(slot[:n_valid], pos[:n_valid]):
        cols = p_i // bs + 1
        seen.update(int(x) for x in tables[s_i, :cols])
        flops += 4 * heads * d * (p_i + 1)
    q_row = heads * d * 2
    nbytes = (q_row * (n_valid + budget) + len(seen) * (2 * kvh * bs * d * 2
                                                        + 4)
              + budget * 5 + n_valid * 4)
    return args, heads // kvh, nbytes, flops


def _sdpa_yardstick(torch, args, rep):
    """F.scaled_dot_product_attention over K/V gathered per valid token
    (gathered outside the timed call). Used only as a yardstick."""
    import torch.nn.functional as F
    q, kp, vp, tables, slot, pos, valid = args
    bs = kp.shape[2]
    rows = torch.nonzero(valid).squeeze(1)
    length = (int(pos[rows].max()) // bs + 1) * bs
    tab = tables[slot[rows].long()][:, :length // bs].long().clamp(min=0)
    kg = kp[tab].permute(0, 2, 1, 3, 4).flatten(2, 3)   # [n, kvh, L, D]
    vg = vp[tab].permute(0, 2, 1, 3, 4).flatten(2, 3)
    if rep > 1:
        kg = kg.repeat_interleave(rep, dim=1)
        vg = vg.repeat_interleave(rep, dim=1)
    mask = (torch.arange(length, device=q.device)[None, :]
            <= pos[rows, None])[:, None, None, :]
    qq = q[rows][:, :, None, :]

    def call():
        return F.scaled_dot_product_attention(qq, kg, vg, attn_mask=mask)
    ms = _graph_ms(call, iters=5)
    del kg, vg
    return ms


RAGGED_BUDGET = 256
RAGGED_CONTEXTS = [97, 300, 511, 803, 1024, 1500, 1801, 2040]
GPT2_CONTEXTS = [97, 300, 511, 803, 1000, 640, 1024, 900]
# phase 3's ragged cases, at the engine's shapes (Llama-2-7B's 32 heads of
# 128; kvh 8 for GQA): decode tokens alone, or beside a 249-row prefill
# chunk whose sequence ends at 960 keys
RAGGED_CASES = {
    "decode_mha": dict(kvh=32, contexts=RAGGED_CONTEXTS, chunk=0),
    "decode_gqa": dict(kvh=8, contexts=RAGGED_CONTEXTS, chunk=0),
    "mixed_mha": dict(kvh=32, contexts=RAGGED_CONTEXTS[:7] + [960],
                      chunk=249),
    "mixed_gqa": dict(kvh=8, contexts=RAGGED_CONTEXTS[:7] + [960],
                      chunk=249),
    # GPT-2's 12 heads of 64 (MHA), contexts within its 1024 positions
    "decode_gpt2": dict(kvh=12, heads=12, d=64,
                        contexts=GPT2_CONTEXTS, chunk=0),
    "mixed_gpt2": dict(kvh=12, heads=12, d=64,
                       contexts=GPT2_CONTEXTS[:7] + [960], chunk=249),
}


def _ragged_plan_items(torch, args, rep):
    """The number of work items of the bf16 kernels' plan for ``args``
    (the plan kernel's count, read back here only)."""
    from paddle_tpu_torch.kernels import ragged_attention as RA
    q, kp, _, tables, slot, pos, valid = args
    _, count, _ = RA.ragged_plan(slot, pos, valid, kp.shape[1], kp.shape[2],
                                 tables.shape[1], rep)
    return int(count.item())


def _kernels_a_call(torch, fn, calls=10):
    """{CUDA kernel name: [launches a call, device ms a call]} of ``fn``,
    from a profile of ``calls`` calls (between spin bursts, as
    ``_profile``)."""
    import re
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _spins(torch)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        _spins(torch)
    names = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and "spin_kernel" not in e.name):
            m = re.search(r"\w*ragged_attention\w*", e.name)
            key = m.group(0) if m else e.name[:60]
            c = names.setdefault(key, [0, 0.0])
            c[0] += 1 / calls
            c[1] += e.time_range.elapsed_us() / 1e3 / calls
    return {k: [round(n, 3), round(ms, 5)] for k, (n, ms) in names.items()}


def _ragged_graph_replay(torch, dev):
    """One bf16 ragged call at the serving shapes captured in a CUDA graph;
    slot_ids, positions and valid rewritten in place to another batch (a
    longer chunk of another sequence, more valid rows); the replay must
    equal an eager call on the new batch, and two eager calls each other."""
    from paddle_tpu_torch.kernels.ragged_attention import (
        ragged_attention, ragged_attention_plain)
    args, rep, _, _ = _ragged_case(torch, dev, budget=RAGGED_BUDGET, seed=30,
                                   **RAGGED_CASES["mixed_mha"])
    q, kp, vp, tables, slot, pos, valid = args
    n_slots = tables.shape[0]
    # the second batch: every slot's decode token, then 200 rows of slot 3
    # at positions 500..699 (its table covers 803 keys)
    slot2 = list(range(n_slots)) + [3] * 200
    pos2 = [c - 1 for c in RAGGED_CONTEXTS[:7]] + [959] \
        + list(range(500, 700))
    n2 = len(slot2)
    slot2 += [0] * (RAGGED_BUDGET - n2)
    pos2 += [0] * (RAGGED_BUDGET - n2)
    valid2 = [True] * n2 + [False] * (RAGGED_BUDGET - n2)
    call = lambda: ragged_attention(*args, rep=rep)  # noqa: E731
    first = call()
    same = torch.equal(first, call())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    graph.replay()
    torch.cuda.synchronize()
    replay_first = torch.equal(out, first)
    slot.copy_(torch.tensor(slot2, dtype=torch.int32, device=dev))
    pos.copy_(torch.tensor(pos2, dtype=torch.int32, device=dev))
    valid.copy_(torch.tensor(valid2, device=dev))
    graph.replay()
    torch.cuda.synchronize()
    want = call()
    replay_second = torch.equal(out, want)
    plain = ragged_attention_plain(*args, rep=rep)
    err = float((out.float() - plain.float()).abs().max())
    tol = ULP_BF16 * float(plain.float().abs().max())
    ok = same and replay_first and replay_second and err <= tol
    print(f"  ragged_attention graph replay (mixed_mha, then {n2} valid rows "
          f"written in place): two eager calls bit-equal {same}, replay = "
          f"eager {replay_first} / after rewrite {replay_second}, vs plain "
          f"{err:.4g} (tol {tol:.4g}) {'ok' if ok else 'FAIL'}", flush=True)
    del graph
    if not ok:
        raise AssertionError("ragged_attention: graph replay or repeat "
                             "calls disagree")


def phase_kernels(torch, results):
    from paddle_tpu_torch.kernels import fused
    from paddle_tpu_torch.kernels.ragged_attention import (
        ragged_attention, ragged_attention_plain)
    dev = torch.device("cuda")
    budget = RAGGED_BUDGET
    card = _card_line()
    print(f"phase 3: kernels against their plain versions (bf16; tolerance "
          f"one bf16 ulp of the largest reference value, 2^-7 of it) "
          f"[{card}]", flush=True)
    for i, (case, spec) in enumerate(RAGGED_CASES.items()):
        args, rep, nbytes, flops = _ragged_case(torch, dev, budget=budget,
                                                seed=10 + i, **spec)
        got = ragged_attention(*args, rep=rep)
        torch.cuda.synchronize()
        want = ragged_attention_plain(*args, rep=rep)
        err = _check(f"ragged_attention[{case}]", got, want,
                     ULP_BF16 * float(want.float().abs().max()))
        if got[~args[-1]].any():
            raise AssertionError(f"ragged_attention[{case}]: an invalid "
                                 f"row is not 0")
        ms = _graph_ms(lambda: ragged_attention(*args, rep=rep))
        eager_ms = _time_ms(lambda: ragged_attention(*args, rep=rep), 50)
        plain_ms = _time_ms(lambda: ragged_attention_plain(*args, rep=rep), 3,
                            warmup=1)
        lib_ms = _sdpa_yardstick(torch, args, rep)
        bound_ms, bound_by = _bound(nbytes, flops, BF16_FLOPS)
        items = _ragged_plan_items(torch, args, rep)
        kernels = _kernels_a_call(torch,
                                  lambda: ragged_attention(*args, rep=rep))
        results[f"ragged_attention[{case}]"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=lib_ms, eager_ms=eager_ms,
            plan_items=items, cuda_kernels_a_call=kernels)
        print(f"  ragged_attention[{case}]: ms={ms:.4f} (graph replay) "
              f"eager_ms={eager_ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bound_ms:.4f} ({bound_by}; {bound_ms / ms:.3f} of "
              f"it reached) sdpa_ms={lib_ms:.4f} plan_items={items} "
              f"valid_rows={int(args[-1].sum())}/{budget} CUDA kernels a "
              f"call {sum(n for n, _ in kernels.values()):g} (launches, ms "
              f"each, profiled): {kernels} [{card}]", flush=True)
        del args, got, want
        torch.cuda.empty_cache()
    _ragged_graph_replay(torch, dev)

    g = torch.Generator(device=dev).manual_seed(20)
    hidden, eps = 4096, 1e-5
    x = torch.randn(budget, 1, hidden, device=dev, generator=g) \
        .to(torch.bfloat16)
    r = torch.randn(budget, 1, hidden, device=dev, generator=g) \
        .to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn(hidden, device=dev, generator=g)) \
        .to(torch.bfloat16)
    row_bytes = budget * hidden * 2
    f_rms = getattr(torch.nn.functional, "rms_norm", None)

    got = fused.rms_norm(x, w, eps)
    want = fused.rms_norm_plain(x, w, eps)
    err = _check("rms_norm", got, want, ULP_BF16 * float(want.abs().max()))
    bound_ms, bound_by = _bound(2 * row_bytes + hidden * 2,
                                4 * budget * hidden, FP32_FLOPS)
    results["rms_norm"] = dict(
        max_abs_err=err, ms=_graph_ms(lambda: fused.rms_norm(x, w, eps)),
        eager_ms=_time_ms(lambda: fused.rms_norm(x, w, eps), 200),
        plain_ms=_time_ms(lambda: fused.rms_norm_plain(x, w, eps), 50),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None if f_rms is None else _graph_ms(
            lambda: f_rms(x, (hidden,), w, eps)))

    s, got = fused.add_rms_norm(x, r, w, eps)
    ws, want = fused.add_rms_norm_plain(x, r, w, eps)
    err = max(_check("rms_norm_residual (norm)", got, want,
                     ULP_BF16 * float(want.abs().max())),
              _check("rms_norm_residual (sum)", s, ws, 0.0))
    bound_ms, bound_by = _bound(4 * row_bytes + hidden * 2,
                                5 * budget * hidden, FP32_FLOPS)
    results["rms_norm_residual"] = dict(
        max_abs_err=err,
        ms=_graph_ms(lambda: fused.add_rms_norm(x, r, w, eps)),
        eager_ms=_time_ms(lambda: fused.add_rms_norm(x, r, w, eps), 200),
        plain_ms=_time_ms(lambda: fused.add_rms_norm_plain(x, r, w, eps), 50),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)

    heads, d = 32, 128
    q = torch.randn(1, budget, heads, d, device=dev, generator=g) \
        .to(torch.bfloat16)
    k = torch.randn(1, budget, heads, d, device=dev, generator=g) \
        .to(torch.bfloat16)
    ang = torch.rand(budget, d // 2, device=dev, generator=g) * 2000.0
    cos, sin = torch.cos(ang), torch.sin(ang)
    gq, gk = fused.fused_rope(q, k, cos, sin)
    wq, wk = fused.fused_rope_plain(q, k, cos, sin)
    err = max(_check("rope (q)", gq, wq, ULP_BF16 * float(wq.abs().max())),
              _check("rope (k)", gk, wk, ULP_BF16 * float(wk.abs().max())))
    bound_ms, bound_by = _bound(4 * q.numel() * 2 + 2 * cos.numel() * 4,
                                6 * 2 * q.numel(), FP32_FLOPS)
    results["rope"] = dict(
        max_abs_err=err,
        ms=_graph_ms(lambda: fused.fused_rope(q, k, cos, sin)),
        eager_ms=_time_ms(lambda: fused.fused_rope(q, k, cos, sin), 200),
        plain_ms=_time_ms(lambda: fused.fused_rope_plain(q, k, cos, sin), 50),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    for name in ("rms_norm", "rms_norm_residual", "rope"):
        m = results[name]
        lib = "n/a" if m["library_ms"] is None else f"{m['library_ms']:.4f}"
        print(f"  {name}: ms={m['ms']:.4f} eager_ms={m['eager_ms']:.4f} "
              f"plain_ms={m['plain_ms']:.4f} "
              f"bound_ms={m['bound_ms']:.4f} ({m['bound_by']}) "
              f"library_ms={lib}", flush=True)


# the weight-only GEMM's cases: (K, N) of every quantized matrix of the
# served models, at M = 8 (generate()'s decode), 256 (the engine's step) and
# 4096 (generate()'s prefill, 8 x 512)
GEMM_SHAPES = {
    "llama_qkvo": (4096, 4096), "llama_gate_up": (4096, 11008),
    "llama_down": (11008, 4096), "llama_head": (4096, 32000),
    "gpt2_qkv": (768, 2304), "gpt2_out": (768, 768),
    "gpt2_fc_in": (768, 3072), "gpt2_fc_out": (3072, 768),
}
GEMM_ROWS = (8, 256, 4096)
QUANT_ALGOS = ("weight_only_int8", "weight_only_int4", "weight_only_fp8")
ROTATE_BYTES = 120e6      # weights a timing cycles over: beyond the L2


def _rotated_ms(torch, fn, operands, nbytes):
    """Device ms of one ``fn(*operands[i])`` call, the calls cycling over
    enough copies of the operands that their ``nbytes`` each exceed
    ``ROTATE_BYTES`` together (at most 64): a decode step finds each
    weight cold, not in the L2 a repeated call would leave it in."""
    n = int(min(64, max(1, math.ceil(ROTATE_BYTES / nbytes))))
    copies = [operands] + [tuple(t.clone() for t in operands)
                           for _ in range(n - 1)]
    calls = max(n, 8)
    state = {"i": 0}

    def call():
        fn(*copies[state["i"] % n])
        state["i"] += 1
    ms = _graph_ms(call, iters=calls, reps=3)
    del copies
    return ms, n


def phase_gemm_kernels(torch, results):
    """The weight-only GEMM against its plain version at every served
    shape and format: each row within 2 bf16 ulps of its largest plain
    value (the two differ in summation order only; bf16 reductions of the
    plain matmul held to fp32). ms by CUDA-graph replay over rotated
    weights of the wgmma kernel (the route of every served shape, on its
    plan) and, at the Llama-2-7B shapes, of the mma.sync kernel beside it
    (the route of unaligned shapes; held to the same
    rows); the bound (bytes over 3.35 TB/s or flops over the bf16 peak,
    the larger), the plain version's ms and ``torch.matmul`` on the bf16
    weight (the yardstick)."""
    card = _card_line()
    dev = torch.device("cuda")
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        _gemm_cases(torch, results, dev, card)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            reduced


def _gemm_cases(torch, results, dev, card):
    from paddle_tpu_torch.kernels import quant_matmul as QM
    from paddle_tpu_torch.quantization import weight_quantize
    from paddle_tpu_torch.quantization._kernels import quant_matmul_arrays
    print(f"phase 3: the weight-only GEMM against its plain version (bf16 "
          f"activations; each row within 2 bf16 ulps of its largest plain "
          f"value) [{card}]", flush=True)
    g = torch.Generator(device=dev).manual_seed(40)
    rows = []
    for name, (k, n) in GEMM_SHAPES.items():
        w = (torch.randn(k, n, device=dev, generator=g) * 0.02) \
            .to(torch.bfloat16)
        for algo in QUANT_ALGOS:
            q, s = weight_quantize(w, algo)
            wbytes = q.numel() * q.element_size() + s.numel() * 4
            plan_of = QM.card_capacity(dev, {"int4": 1, "fp8": 2}.get(
                algo[12:], 0))
            for m in GEMM_ROWS:
                x = torch.randn(m, k, device=dev, generator=g) \
                    .to(torch.bfloat16)
                plan = QM.weight_only_gemm_plan(m, n, k, plan_of)
                if not QM.weight_only_gemm_takes(x, q, s):
                    raise AssertionError(f"{name}: a served shape the wgmma "
                                         f"kernel does not take")
                got = QM.weight_only_gemm(x, q, s)
                torch.cuda.synchronize()
                want = quant_matmul_arrays(x, q, s)
                case = f"weight_only_gemm[{name} {algo[12:]} M={m}]"
                err = _check_rows(case, got, want, 2)
                nbytes = x.numel() * 2 + wbytes + m * n * 2
                flops = 2 * m * k * n
                bound_ms, bound_by = _bound(nbytes, flops, BF16_FLOPS)
                ms, copies = _rotated_ms(torch, QM.weight_only_gemm,
                                         (x, q, s), wbytes)
                sm80_ms = None
                if name.startswith("llama"):
                    _check_rows(case + " mma.sync kernel",
                                QM.weight_only_gemm_sm80(x, q, s), want, 2)
                    sm80_ms, _ = _rotated_ms(torch, QM.weight_only_gemm_sm80,
                                             (x, q, s), wbytes)
                plain_ms = _time_ms(lambda: quant_matmul_arrays(x, q, s), 3,
                                    warmup=1)
                lib_ms, _ = _rotated_ms(torch, torch.matmul, (x, w),
                                        w.numel() * 2)
                res = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=lib_ms, sm80_ms=sm80_ms, m=m, k=k, n=n,
                           plan=list(plan), weight_bytes=wbytes,
                           rotated_copies=copies, tflops=flops / ms / 1e9)
                results[case] = res
                rows.append((case, res))
                old = "" if sm80_ms is None else \
                    f" mma.sync kernel {sm80_ms:.4f} ({sm80_ms / ms:.2f}x)"
                print(f"  {case}: ms={ms:.4f} (tile {plan.token_tile}x"
                      f"{plan.channel_tile}, {plan.splits} splits){old} "
                      f"bound_ms={bound_ms:.4f} "
                      f"({bound_by}; {bound_ms / ms:.3f} of it reached) "
                      f"plain_ms={plain_ms:.4f} ({plain_ms / ms:.2f}x) "
                      f"torch.matmul bf16 library_ms={lib_ms:.4f} "
                      f"({lib_ms / ms:.2f}x the kernel's ms) weights {wbytes} "
                      f"bytes x {copies} copies [{card}]", flush=True)
                if ms >= plain_ms:
                    print(f"  {case}: the kernel is not below its plain "
                          f"version", flush=True)
                del x, got, want
            del q, s
        del w
        torch.cuda.empty_cache()
    for m in GEMM_ROWS:
        for algo in QUANT_ALGOS:
            sel = [r for c, r in rows if r["m"] == m and algo[12:] in c]
            old = [r["sm80_ms"] for r in sel if r["sm80_ms"] is not None]
            print(f"  weight_only_gemm {algo[12:]} M={m}: kernel "
                  f"{sum(r['ms'] for r in sel):.4f} ms over the "
                  f"{len(sel)} shapes (mma.sync kernel over the Llama ones "
                  f"{sum(old):.4f} against "
                  f"{sum(r['ms'] for r in sel if r['sm80_ms'] is not None):.4f}),"
                  f" bound {sum(r['bound_ms'] for r in sel):.4f}, plain "
                  f"{sum(r['plain_ms'] for r in sel):.4f}, torch.matmul "
                  f"bf16 {sum(r['library_ms'] for r in sel):.4f}",
                  flush=True)


def phase_tiny_reference(torch):
    """A tiny float32 Llama: the engine on the card (kernels) must return
    the CPU engine's greedy tokens (plain versions) exactly."""
    import numpy as np
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         load_numpy_state)
    from paddle_tpu_torch.serving import EngineConfig, ServingEngine
    cfg = LlamaConfig.tiny(vocab_size=256, hidden_size=256, layers=2,
                           heads=4, kv_heads=2, seq=256)
    cpu = LlamaForCausalLM(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(7))
    gpu = LlamaForCausalLM(cfg, device="cuda")
    load_numpy_state(gpu, {n: p.detach().numpy()
                           for n, p in cpu.named_parameters()})
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 256, (n,)).tolist()
               for n in (3, 17, 40, 66, 9, 25)]
    ecfg = dict(max_seqs=4, token_budget=32, block_size=16)
    want = ServingEngine(cpu, EngineConfig(**ecfg), device="cpu") \
        .generate_batch(prompts, max_new_tokens=8)
    got = ServingEngine(gpu, EngineConfig(**ecfg), device="cuda") \
        .generate_batch(prompts, max_new_tokens=8)
    same = sum(a == b for a, b in zip(got, want))
    print(f"  tiny f32 Llama on the card vs the CPU engine: {same}/"
          f"{len(prompts)} requests token-identical", flush=True)
    if got != want:
        raise AssertionError(f"GPU tokens {got} != CPU tokens {want}")


# -- phase 4: full-width serving --------------------------------------------------

def _plain_patches(stack):
    """Route the decoder through the plain versions for one comparison
    step (the wrappers would launch the kernels on CUDA tensors)."""
    from paddle_tpu_torch import generation as G
    from paddle_tpu_torch.kernels import fused
    from paddle_tpu_torch.quantization._kernels import quant_matmul_arrays
    from paddle_tpu_torch.kernels.ragged_attention import \
        ragged_attention_plain
    from paddle_tpu_torch.serving import ragged
    stack.enter_context(mock.patch.object(fused, "rms_norm",
                                          fused.rms_norm_plain))
    stack.enter_context(mock.patch.object(fused, "add_rms_norm",
                                          fused.add_rms_norm_plain))
    stack.enter_context(mock.patch.object(fused, "fused_rope",
                                          fused.fused_rope_plain))
    stack.enter_context(mock.patch.object(
        ragged, "ragged_attention",
        lambda *a, plan=None, **k: ragged_attention_plain(*a, **k)))
    stack.enter_context(mock.patch.object(G, "_qmm", quant_matmul_arrays))
    _plain_fusion_patches(stack)


def _nothing_routed(launches, phase):
    """A main path takes the kernels: no attention call of it went to the
    plain path (the counts of ``kernels.ROUTED``, asserted 0)."""
    from paddle_tpu_torch import kernels as K
    routed = {n: launches[n] for n in K.ROUTED}
    print(f"  {phase}: attention calls routed to the plain path {routed} "
          f"(must be 0)", flush=True)
    if any(routed.values()):
        raise AssertionError(f"{phase}: the main path routed attention to "
                             f"the plain path: {routed}")


def _pct(xs):
    """(p50, p99) of ``xs`` (numpy's linear interpolation)."""
    import numpy as np
    return float(np.percentile(xs, 50)), float(np.percentile(xs, 99))


def _serve_requests(torch, eng, prompts, max_new, keep_logits=False):
    """Submit ``prompts`` at once and step ``eng`` until idle, a
    synchronize after each step. The launch counts are zeroed just before
    and read just after. Returns (stats, outputs, launches, the logits of
    every step when ``keep_logits``)."""
    from paddle_tpu_torch import kernels as K
    K.reset_launches()
    steps0 = eng.steps
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    per_step, logits = [], []
    t_run = time.monotonic()
    while True:
        f0, g0 = eng.tokens_fed, eng.tokens_generated
        h0 = dict(eng.host_seconds)
        ts = time.monotonic()
        more = eng.step()
        torch.cuda.synchronize()
        dt = time.monotonic() - ts
        per_step.append((eng.tokens_fed - f0, eng.tokens_generated - g0, dt,
                         {k: eng.host_seconds[k] - h0[k] for k in h0}))
        if keep_logits:
            logits.append(eng._logits.clone())
        if not more:
            break
    t_run = time.monotonic() - t_run
    launches = dict(K.LAUNCHES)
    outs = [r.result(timeout=0) for r in reqs]
    stats = dict(steps=eng.steps - steps0, seconds=t_run,
                 rids=[r.rid for r in reqs],
                 tokens_fed=sum(f for f, *_ in per_step),
                 tokens_generated=sum(g for _, g, *_ in per_step),
                 preemptions=sum(r.preemptions for r in reqs))
    # decode steps feed only decode tokens; the others carry prefill
    for kind, rows in (("decode", [s for s in per_step if s[0] == s[1]]),
                       ("prefill", [s for s in per_step if s[0] != s[1]])):
        secs = sum(s[2] for s in rows)
        toks = sum(s[1] if kind == "decode" else s[0] - s[1] for s in rows)
        stats[f"{kind}_steps"] = len(rows)
        stats[f"{kind}_step_ms"] = 1e3 * secs / max(len(rows), 1)
        stats[f"{kind}_tokens_per_s"] = toks / max(secs, 1e-9)
        stats[f"{kind}_host_ms"] = {
            k: 1e3 * sum(s[3][k] for s in rows) / max(len(rows), 1)
            for k in eng.host_seconds}
    ttft = [r.first_token_at - r.arrival for r in reqs]
    lat = [r.finished_at - r.arrival for r in reqs]
    stats["ttft_ms_p50"], stats["ttft_ms_p99"] = (1e3 * x for x in _pct(ttft))
    stats["latency_ms_p50"], stats["latency_ms_p99"] = (1e3 * x
                                                        for x in _pct(lat))
    return stats, outs, launches, logits


def _serve_pair(torch, model, ecfg, prompts, max_new, per_step, tag, args,
                launches_out=None, keep_pages=True):
    """The same requests through two engines of ``ecfg`` in turn: the step
    run op by op (the yardstick), then replayed from the CUDA graph
    captured at construction (the main path). For each, the launch counts
    are zeroed just before and read just after and must equal
    ``per_step`` (launches a step) times the steps, nothing may be routed
    to a plain version, and every request must return all its tokens; step
    ms, tokens/s, the host's share, TTFT, latency and a profile are
    printed. The runs' tokens must be equal and every step's logits
    bit-equal, and with ``keep_pages`` (both engines kept at once) the
    pools' real pages equal. Returns (stats by kind, the captured run's
    outputs)."""
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.serving import ServingEngine
    card = _card_line()
    vocab = model.config.vocab_size
    serving, engines, outs, logits = {}, {}, {}, {}
    for kind in ("eager", "captured"):
        eng = ServingEngine(model, ecfg)
        if kind == "eager":
            eng._step = eng._step_eager
        else:
            print(f"  {tag}: captured the step at construction in "
                  f"{eng.capture_seconds:.3f}s, graph pool "
                  f"{eng.graph_pool_bytes} bytes; launches a replay "
                  f"{eng._tally}", flush=True)
            if eng._tally != {k: v for k, v in per_step.items() if v}:
                raise AssertionError(f"{tag}: a replay launches "
                                     f"{eng._tally}, not {per_step}")
        eng.generate_batch([list(range(1, 17))], max_new_tokens=2)  # warm-up
        stats, outs[kind], launches, logits[kind] = _serve_requests(
            torch, eng, prompts, max_new, keep_logits=True)
        steps = stats["steps"]
        expect = {n: per_step.get(n, 0) * steps for n in K.LAUNCHES}
        print(f"  {tag} {kind}: launches over {steps} steps: {launches} "
              f"(expected {expect})", flush=True)
        _nothing_routed(launches, f"{tag} ({kind})")
        if launches != expect:
            raise AssertionError(f"{tag} {kind}: launch counts {launches} "
                                 f"!= {expect}")
        if any(len(o) != max_new or not all(0 <= t < vocab for t in o)
               for o in outs[kind]):
            raise AssertionError(f"{tag} {kind}: a request did not return "
                                 f"all of its tokens")
        if kind == "captured":
            if launches_out is not None:
                for n, c in launches.items():
                    launches_out[n] = launches_out.get(n, 0) + c
            stats.update(capture_seconds=eng.capture_seconds,
                         graph_pool_bytes=eng.graph_pool_bytes)
        stats.pop("rids")
        stats["prompt_tokens"] = int(sum(len(p) for p in prompts))
        stats["card"] = card
        print(f"  {tag} {kind} serving: " + json.dumps(stats), flush=True)
        stats["breakdown"] = _profile_steps(
            torch, eng, vocab, args.seed, f"{tag.replace(' ', '_')}_{kind}")
        for step_kind, m in stats["breakdown"].items():
            # the profiler's own cost lengthens a traced step: the idle
            # share against the untraced step's wall time as well
            m["idle_share_untraced"] = 1 - m["device_ms"] / stats[
                f"{step_kind}_step_ms"]
        serving[kind] = stats
        if keep_pages:
            engines[kind] = eng
        del eng
        torch.cuda.empty_cache()
    same_tokens = outs["eager"] == outs["captured"]
    same_logits = len(logits["eager"]) == len(logits["captured"]) and all(
        torch.equal(a, b) for a, b in zip(logits["eager"],
                                          logits["captured"]))
    same_pages = True
    if keep_pages:
        p_real = engines["eager"].pool.num_blocks
        same_pages = all(
            torch.equal(getattr(engines["eager"], n)[:, :p_real],
                        getattr(engines["captured"], n)[:, :p_real])
            for n in ("_kp", "_vp"))
    ok = same_tokens and same_logits and same_pages
    print(f"  {tag} captured vs eager: tokens equal for "
          f"{sum(a == b for a, b in zip(outs['eager'], outs['captured']))}/"
          f"{len(prompts)} requests, logits bit-equal at every one of "
          f"{len(logits['captured'])} steps {same_logits}"
          + (f", real pages equal {same_pages}" if keep_pages else "")
          + f" {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{tag}: the captured step disagrees with the "
                             f"eager step")
    e, c = serving["eager"], serving["captured"]
    for kind in ("decode", "prefill"):
        print(f"  {tag} {kind} steps, eager -> captured: "
              f"{e[kind + '_step_ms']:.3f} -> {c[kind + '_step_ms']:.3f} ms, "
              f"{e[kind + '_tokens_per_s']:.1f} -> "
              f"{c[kind + '_tokens_per_s']:.1f} tokens/s, idle share "
              f"{e['breakdown'][kind]['idle_share']:.3f} -> "
              f"{c['breakdown'][kind]['idle_share']:.3f} traced, "
              f"{e['breakdown'][kind]['idle_share_untraced']:.3f} -> "
              f"{c['breakdown'][kind]['idle_share_untraced']:.3f} against "
              f"the untraced step; host ms a step "
              f"{_fmt_host(e[kind + '_host_ms'])} -> "
              f"{_fmt_host(c[kind + '_host_ms'])} [{card}]", flush=True)
    print(f"  {tag} TTFT p50/p99 ms eager {e['ttft_ms_p50']:.1f}/"
          f"{e['ttft_ms_p99']:.1f}, captured {c['ttft_ms_p50']:.1f}/"
          f"{c['ttft_ms_p99']:.1f}; latency p50/p99 ms eager "
          f"{e['latency_ms_p50']:.1f}/{e['latency_ms_p99']:.1f}, captured "
          f"{c['latency_ms_p50']:.1f}/{c['latency_ms_p99']:.1f} "
          f"({len(prompts)} requests submitted at once) [{card}]",
          flush=True)
    del engines, logits
    torch.cuda.empty_cache()
    return serving, outs["captured"]


def _llama_serving_setup(torch, args):
    """Phase 4's model (Llama-2-7B width, bf16, seeded random weights),
    engine configuration and 12 requests (prompts of 16-1000 tokens, 32
    new tokens each); phases 9 and 10 serve the same."""
    import numpy as np
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import EngineConfig
    cfg = LlamaConfig.llama2_7b()
    t0 = time.monotonic()
    model = LlamaForCausalLM(
        cfg, device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(args.seed))
    torch.cuda.synchronize()
    print(f"  init {time.monotonic() - t0:.2f}s, "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f}B params",
          flush=True)
    ecfg = dict(max_seqs=8, token_budget=256, block_size=16,
                max_model_len=2048)
    rng = np.random.default_rng(args.seed)
    lens = np.linspace(16, 1000, 12).astype(int)
    rng.shuffle(lens)
    prompts = [rng.integers(1, cfg.vocab_size, (n,)).tolist() for n in lens]
    return cfg, model, ecfg, prompts, 32


def _llama_per_step(n_l, quant=False):
    """Kernel launches of one Llama serving step."""
    per = dict(ragged_attention=n_l, rms_norm=n_l + 1, rms_norm_residual=n_l,
               rope=n_l)
    if quant:                  # 7 matrices a layer and the (untied) head
        per["weight_only_gemm"] = 7 * n_l + 1
    return per


def phase_serving(torch, args, launches_out, beam_launches_out):
    """Llama-2-7B served by two engines in turn over the same 12 requests:
    the step run op by op (the yardstick) and the step replayed from the
    CUDA graph captured at construction (the main path). Tokens equal,
    every step's logits bit-equal, the pools' real pages equal; exact
    launch counts; step ms, tokens/s, the host's share, TTFT and latency
    for each; a profile of each; then the front door, generate() and the
    kernel step against the plain step; the BatchingServer over the
    engine; beam search (``beam_launches_out`` gets its launches)."""
    from paddle_tpu_torch.serving import EngineConfig
    card = _card_line()
    torch.cuda.reset_peak_memory_stats()
    cfg, model, ecfg, prompts, max_new = _llama_serving_setup(torch, args)
    print(f"phase 4: Llama-2-7B width (hidden {cfg.hidden_size}, "
          f"{cfg.num_hidden_layers} layers, {cfg.num_attention_heads} heads, "
          f"vocab {cfg.vocab_size}) bf16, random weights seed {args.seed} "
          f"[{card}]", flush=True)
    serving, outs = _serve_pair(
        torch, model, EngineConfig(**ecfg), prompts, max_new,
        _llama_per_step(cfg.num_hidden_layers), "phase 4", args,
        launches_out)
    serving["outputs"] = outs
    serving["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    serving["front_door"] = _front_door(torch, model, prompts[:4], max_new)
    serving["batching_server"] = _server_delegation(
        torch, model, ecfg, prompts, max_new, outs)
    n_l = cfg.num_hidden_layers
    per_call = dict(rms_norm=n_l + 1, rms_norm_residual=n_l, rope=n_l)
    serving["generate"] = _generate_checks(
        torch, model, cfg, args, launches_out, per_call)
    serving["beams"] = _beam_checks(
        torch, model, cfg, args, beam_launches_out, per_call)
    serving.update(_step_agreement(torch, model, cfg,
                                   EngineConfig(**ecfg), args.seed))
    del model
    torch.cuda.empty_cache()
    serving["captured_step_f32"] = _captured_step_f32(
        torch, _llama_f32_pair(cfg), args.seed)
    serving["beams_f32"] = _beams_f32_pair(torch, _llama_f32_pair(cfg),
                                           args.seed)
    return serving


def phase_llama13b_serving(torch, args, launches_out):
    """``LlamaConfig.llama2_13b()`` (the JAX preset: hidden 5120, 40
    layers, 40 heads; BASELINE configuration 2's larger model) at full
    width in bf16 (26 GB of random weights from the seed) served through
    the engine's captured step: 6 requests of 64-700 prompt tokens, 16
    new tokens each; exact launch counts, nothing routed, every request
    its tokens; decode and prefill step ms at a batch of at most 6
    requests: a latency check of the preset, not a serving rate (phase 4
    measures that)."""
    import numpy as np
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import EngineConfig, ServingEngine
    card = _card_line()
    cfg = LlamaConfig.llama2_13b()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    model = LlamaForCausalLM(
        cfg, device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(args.seed + 3))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"phase 4b: Llama-2-13B (llama2_13b(): hidden {cfg.hidden_size}, "
          f"{cfg.num_hidden_layers} layers, {cfg.num_attention_heads} "
          f"heads) bf16, {n_params / 1e9:.3f}B random parameters from seed "
          f"{args.seed + 3}, init {time.monotonic() - t0:.2f}s [{card}]",
          flush=True)
    eng = ServingEngine(model, EngineConfig(max_seqs=6, token_budget=256,
                                            block_size=16,
                                            max_model_len=1024))
    per_step = _llama_per_step(cfg.num_hidden_layers)
    if eng._tally != {k: v for k, v in per_step.items() if v}:
        raise AssertionError(f"phase 4b: a replay launches {eng._tally}, "
                             f"not {per_step}")
    eng.generate_batch([list(range(1, 17))], max_new_tokens=2)  # warm-up
    rng = np.random.default_rng(args.seed + 3)
    prompts = [rng.integers(1, cfg.vocab_size, (int(n),)).tolist()
               for n in np.linspace(64, 700, 6)]
    stats, outs, launches, _ = _serve_requests(torch, eng, prompts, 16)
    expect = {n: per_step.get(n, 0) * stats["steps"] for n in K.LAUNCHES}
    _nothing_routed(launches, "phase 4b")
    ok = launches == expect and all(
        len(o) == 16 and all(0 <= t < cfg.vocab_size for t in o)
        for o in outs)
    for n, c in launches.items():
        launches_out[n] = launches_out.get(n, 0) + c
    for k in ("rids", "decode_tokens_per_s", "prefill_tokens_per_s"):
        stats.pop(k)
    stats.update(params=n_params, capture_seconds=eng.capture_seconds,
                 peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                 card=card)
    print(f"  phase 4b Llama-2-13B captured: {stats['steps']} steps, decode "
          f"{stats['decode_step_ms']:.3f} ms a step, prefill "
          f"{stats['prefill_step_ms']:.3f} ms a step (latencies at a batch "
          f"of at most 6 requests, not a serving rate), capture "
          f"{eng.capture_seconds:.2f}s, peak {stats['peak_memory_gb']:.2f} "
          f"GB; launches {launches} (expected {expect}) "
          f"{'ok' if ok else 'FAIL'} [{card}]", flush=True)
    if not ok:
        raise AssertionError("phase 4b: launch counts or tokens wrong")
    del eng, model
    _free(torch)
    return stats


def _fmt_host(h):
    return "/".join(f"{h[k]:.2f}" for k in ("schedule", "pack", "device",
                                            "emit"))


def _front_door(torch, model, prompts, max_new):
    """``create_llm_predictor`` with ``set_max_batch_size(8)`` must return
    the tokens of ``generate_batch`` on an engine built by hand with the
    routed configuration (max_seqs 8, token_budget max(8 * 8, 64))."""
    from paddle_tpu_torch.inference import Config, create_llm_predictor
    from paddle_tpu_torch.serving import EngineConfig, ServingEngine
    conf = Config()
    conf.set_max_batch_size(8)
    pred = create_llm_predictor(model, conf, max_new_tokens=max_new)
    routed = (pred.engine.config.max_seqs, pred.engine.config.token_budget)
    (got,) = pred.run([prompts])
    del pred
    torch.cuda.empty_cache()
    want = ServingEngine(model, EngineConfig(max_seqs=8, token_budget=64)) \
        .generate_batch(prompts, max_new_tokens=max_new)
    torch.cuda.empty_cache()
    ok = got.tolist() == want and routed == (8, 64)
    print(f"  front door: create_llm_predictor(max_batch_size 8 -> "
          f"max_seqs, token_budget {routed}) over {len(prompts)} prompts: "
          f"tokens equal to generate_batch {got.tolist() == want} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the front door disagrees with generate_batch")
    return dict(requests=len(prompts), routed=routed, tokens_equal=True)


def _timed_loop(torch, loop, ids, mask, max_new):
    """(tokens, prefill ms, decode ms a step) of one greedy run of a
    decode loop."""
    t0 = time.monotonic()
    loop.start(ids, mask, 1.0, 0, 1.0, None)
    torch.cuda.synchronize()
    t1 = time.monotonic()
    for _ in range(max_new):
        loop.step()
    torch.cuda.synchronize()
    t2 = time.monotonic()
    toks, _ = loop.result()
    return toks, 1e3 * (t1 - t0), 1e3 * (t2 - t1) / max_new


def _attend_einsum(q, k, v, score_mask):
    """generate()'s dense attention in its einsum form (fp32 casts of the
    whole cache, then einsums that copy them again into their layouts),
    kept here only to time it beside the current ``generation._attend``."""
    import torch
    d = q.shape[-1]
    scores = torch.einsum("bshd,bthd->bhst", q.float(),
                          k.float()) / math.sqrt(d)
    scores = torch.where(score_mask, scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, v.float()).to(q.dtype)


def _generate_checks(torch, model, cfg, args, launches_out, per_call,
                     tag="phase 4", quant=None, full=True):
    """generate() at full width: batch 8, left-padded prompts of 16-512
    tokens, 32 new tokens. Greedy: the captured decode graph against the
    same loop run op by op (tokens equal), step ms and tokens/s of each,
    exact launch counts (``per_call``: launches of the prefill and of each
    replay) and a profile of decode replays. With ``full``: the dense
    attention's device ms (the einsum and fp32-copy forms beside the
    current one, and a decode step with the fp32-copy form), and
    sampled runs (temperature 0.8, top-k 50, top-p 0.9, a seed): two runs
    equal, every token in the vocabulary, and each step's noise new."""
    import numpy as np
    from paddle_tpu_torch import generation as G
    from paddle_tpu_torch import kernels as K
    card = _card_line()
    dev = torch.device("cuda")
    b, width, max_new = 8, 512, 32
    rng = np.random.default_rng(args.seed + 2)
    lens = np.linspace(16, width, b).astype(int)
    rng.shuffle(lens)
    ids = np.zeros((b, width), np.int64)
    mask = np.zeros((b, width), np.int64)
    for i, n in enumerate(lens):
        ids[i, width - n:] = rng.integers(1, cfg.vocab_size, (n,))
        mask[i, width - n:] = 1
    ids_d, mask_d = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
    dec = G._decoder_for(model)
    w = G._quant_weights_cached(dec, model, quant) if quant \
        else dec.weights(model)
    t0 = time.monotonic()
    got, fin = G.generate(model, ids, attention_mask=mask,
                          max_new_tokens=max_new, quant=quant)
    first_s = time.monotonic() - t0
    sig = (b, width, max_new, False, False, 0, 1.0, False)
    loop = G._loop_for(dec, w, *sig, 1)
    K.reset_launches()
    toks_g, pre_g, step_g = _timed_loop(torch, loop, ids_d, mask_d, max_new)
    launches = dict(K.LAUNCHES)
    calls = 1 + max_new
    expect = {n: per_call.get(n, 0) * calls for n in K.LAUNCHES}
    _nothing_routed(launches, f"{tag} generate()")
    if launches != expect:
        raise AssertionError(f"{tag} generate(): launch counts {launches} "
                             f"!= {expect}")
    for n, c in launches.items():
        launches_out[n] = launches_out.get(n, 0) + c
    eager = G._DecodeLoop(dec, w, *sig)
    toks_e, pre_e, step_e = _timed_loop(torch, eager, ids_d, mask_d, max_new)
    del eager
    torch.cuda.empty_cache()
    ok = torch.equal(got, toks_g) and torch.equal(toks_g, toks_e) \
        and 0 <= int(got.min()) and int(got.max()) < cfg.vocab_size
    print(f"  {tag} generate(quant={quant}): batch {b}, prompts "
          f"{sorted(lens.tolist())} left-padded to {width}, {max_new} new "
          f"tokens; first call {first_s:.2f}s (capture included); greedy "
          f"tokens: graph = eager {torch.equal(toks_g, toks_e)}, generate() "
          f"= graph {torch.equal(got, toks_g)}; launches {launches} "
          f"(expected {expect}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{tag} generate(): the decode graph disagrees "
                             f"with the eager loop")
    # where a decode step's device time goes: a profile of 8 replays
    loop.start(ids_d, mask_d, 1.0, 0, 1.0, None)
    _, prof_m = _profile(torch, loop.step, 8)
    out = dict(batch=b, prompt_lens=sorted(lens.tolist()), width=width,
               max_new_tokens=max_new, quant=quant, first_call_s=first_s,
               graph_prefill_ms=pre_g, graph_step_ms=step_g,
               graph_tokens_per_s=b / (step_g / 1e3),
               eager_prefill_ms=pre_e, eager_step_ms=step_e,
               eager_tokens_per_s=b / (step_e / 1e3),
               decode_profile=prof_m, finished=int(fin.sum()), card=card,
               tokens=got.tolist())
    print(f"  {tag} generate() decode steps, eager -> graph: {step_e:.3f} -> "
          f"{step_g:.3f} ms, {b / (step_e / 1e3):.1f} -> "
          f"{b / (step_g / 1e3):.1f} tokens/s; prefill {pre_e:.1f} / "
          f"{pre_g:.1f} ms; replay profile: wall {prof_m['wall_ms']:.3f} ms, "
          f"device {prof_m['device_ms']:.3f} ms (idle "
          f"{prof_m['idle_share']:.3f}), by group (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in
                      prof_m["by_group_ms"].items()) + f" [{card}]",
          flush=True)
    if not full:
        dec.loops.clear()
        torch.cuda.empty_cache()
        return out
    # the dense attention of one decode step: every layer's _attend over
    # the [8, 544] cache, timed alone (CUDA-graph replay), beside the
    # einsum form and the fp32-copy form
    g = torch.Generator(device=dev).manual_seed(args.seed)
    n_l = cfg.num_hidden_layers
    h = cfg.num_attention_heads
    hd = cfg.hidden_size // h
    q = torch.randn(b, 1, h, hd, device=dev, generator=g).bfloat16()
    kc = torch.randn(b, h, width + max_new, hd, device=dev,
                     generator=g).bfloat16()          # heads-major cache
    vc = torch.randn_like(kc)
    smask = loop.key_mask[:, None, None, :]
    kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
    attn_ms = n_l * _graph_ms(lambda: G._attend(q, kc, vc, smask))
    attn_einsum_ms = n_l * _graph_ms(
        lambda: _attend_einsum(q, kt, vt, smask))
    attn_f32_ms = n_l * _graph_ms(
        lambda: _attend_f32_copies(q, kc, vc, smask, 1))
    ref = _attend_einsum(q, kt, vt, smask)
    same = _check("generate() _attend against the einsum form",
                  G._attend(q, kc, vc, smask), ref,
                  ULP_BF16 * float(ref.float().abs().max()))
    del q, kc, vc, kt, vt, ref
    toks_f32, step_f32, rows_f32 = _step_ms_f32_copy_attention(
        torch, dec, w, sig + (1,), ids_d, mask_d, max_new)
    # greedy tokens against the fp32-copy form: equal, or a first
    # difference only at a near tie (phase 10's rule)
    vs_f32 = _spec_compare(
        f"{tag} generate() greedy tokens against the fp32-copy attention",
        (toks_f32.tolist(), rows_f32),
        (toks_g.tolist(), _greedy_rows(torch, loop, ids_d, mask_d, max_new)),
        max_new, names=("fp32-copy", "in-place"))
    out.update(dense_attention_ms_a_step=attn_ms,
               dense_attention_einsum_ms_a_step=attn_einsum_ms,
               dense_attention_f32_copies_ms_a_step=attn_f32_ms,
               dense_attention_vs_einsum_err=same,
               graph_step_ms_f32_copy_attention=step_f32,
               tokens_equal_f32_copies_attention=torch.equal(toks_f32,
                                                             toks_g),
               vs_f32_copies_attention=vs_f32)
    print(f"  {tag} dense attention ({n_l} x _attend over [{b}, {h}, "
          f"{width + max_new}, {hd}], alone): {attn_ms:.3f} ms a step; the "
          f"fp32-copy form (K and V copied to fp32) {attn_f32_ms:.3f} ms, "
          f"the einsum form {attn_einsum_ms:.3f} ms; the captured decode "
          f"step with the fp32-copy form {step_f32:.3f} ms against "
          f"{step_g:.3f} ms now (greedy "
          f"tokens equal {torch.equal(toks_f32, toks_g)}) [{card}]",
          flush=True)
    # sampling
    kw = dict(attention_mask=mask, max_new_tokens=max_new, do_sample=True,
              temperature=0.8, top_k=50, top_p=0.9)
    s1, _ = G.generate(model, ids, seed=args.seed, **kw)
    s2, _ = G.generate(model, ids, seed=args.seed, **kw)
    sloop = G._loop_for(dec, w, b, width, max_new, True, False, 50, 0.9,
                        False, 1)
    sloop.start(ids_d, mask_d, 0.8, 0, 1.0, args.seed)
    draws = []
    for _ in range(4):
        sloop.step()
        draws.append(sloop.noise.clone())
    fresh = all(not torch.equal(draws[i], draws[i + 1]) for i in range(3))
    in_vocab = 0 <= int(s1.min()) and int(s1.max()) < cfg.vocab_size
    ok = torch.equal(s1, s2) and in_vocab and fresh
    print(f"  generate() sampled (temperature 0.8, top-k 50, top-p 0.9, seed "
          f"{args.seed}): two runs equal {torch.equal(s1, s2)}, tokens in "
          f"the vocabulary {in_vocab}, new noise every step {fresh}, "
          f"distinct tokens {len(set(s1.flatten().tolist()))}, tokens "
          f"differing from greedy {int((s1 != got).sum())}/{s1.numel()} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("generate(): the sampled checks failed")
    out.update(sampled_runs_equal=True, sampled_noise_fresh=True)
    del draws
    dec.loops.clear()
    torch.cuda.empty_cache()
    return out


def _llama_f32_pair(cfg):
    """A builder of phase 4's float32 check: cfg's widths with 2 layers."""
    import dataclasses
    from paddle_tpu_torch.models import LlamaForCausalLM
    small = dataclasses.replace(cfg, num_hidden_layers=2)

    def make(torch, seed):
        return LlamaForCausalLM(
            small, device="cuda", dtype=torch.float32,
            generator=torch.Generator(device="cuda").manual_seed(seed))
    return make


def _captured_step_f32(torch, make_model, seed, quant=None):
    """float32 at full width with 2 layers (``make_model(torch, seed)``):
    a captured engine and an eager one stepped together over 4 requests;
    every step's logits bit-equal and the same tokens."""
    import numpy as np
    from paddle_tpu_torch.serving import EngineConfig, ServingEngine
    model = make_model(torch, seed)
    ecfg = EngineConfig(max_seqs=4, token_budget=128, block_size=16,
                        max_model_len=1024, quant=quant)
    graph, eager = ServingEngine(model, ecfg), ServingEngine(model, ecfg)
    eager._step = eager._step_eager
    rng = np.random.default_rng(seed + 3)
    prompts = [rng.integers(1, model.config.vocab_size, (n,)).tolist()
               for n in (40, 200, 7, 130)]
    reqs = [[e.submit(p, max_new_tokens=8) for p in prompts]
            for e in (graph, eager)]
    more, steps, same = True, 0, True
    while more:
        more = graph.step()
        eager.step()
        steps += 1
        same = same and torch.equal(graph._logits, eager._logits)
    tokens = [r.result(0) for r in reqs[0]] == [r.result(0) for r in reqs[1]]
    print(f"  float32 (2 layers at full width): captured vs eager, logits "
          f"bit-equal at every one of {steps} steps {same}, tokens equal "
          f"{tokens} {'ok' if same and tokens else 'FAIL'}", flush=True)
    if not (same and tokens):
        raise AssertionError("float32: the captured step disagrees with the "
                             "eager step")
    del graph, eager, model
    torch.cuda.empty_cache()
    return dict(steps=steps, logits_bit_equal=True, tokens_equal=True)


def _kernel_group(name):
    for kind in ("ctc", "rnnt"):
        if f"{kind}_rows_kernel" in name or f"{kind}_alpha_kernel" in name:
            return f"{kind}_fwd"
        if f"{kind}_adjoint_kernel" in name or f"{kind}_grad_rows" in name:
            return f"{kind}_bwd"
    if "_dense_softmax_bwd_kernel" in name:
        return "dense_softmax_bwd"
    if "_dense_softmax_fwd_kernel" in name:
        return "dense_softmax"
    if "_bn_bwd_" in name:
        return "batch_norm_bwd"
    if "_bn_stats_kernel" in name or "_bn_fwd_" in name:
        return "batch_norm"
    if "_gn_bwd_" in name:
        return "group_norm_bwd"
    if "_gn_stats_kernel" in name or "_gn_fwd_" in name:
        return "group_norm"
    if any(k in name for k in ("fprop", "dgrad", "wgrad", "implicit_gemm",
                               "conv2d", "cudnn")):
        return "conv"
    if "weight_only_gemm" in name:
        return "weight_only_gemm"
    if "flashmask_summary" in name:
        return "flashmask_summary"
    if "flash_fwd" in name and "true>" in name:   # MASKED = true
        return "flashmask_fwd"
    if "flash_bwd" in name and "true>" in name:
        return "flashmask_bwd"
    if "tgmm_wgmma_kernel" in name or "tgmm_fma_kernel" in name:
        return "tgmm"
    if "gmm_wgmma_kernel" in name or "gmm_fma_kernel" in name:
        return "gmm"
    if "ragged_attention" in name:
        return "ragged_attention"
    if "flash_fwd" in name:
        return "flash_fwd"
    if "flash_bwd" in name:
        return "flash_bwd"
    if "adamw_kernel" in name:
        return "adamw"
    if "_rms_norm_bwd_kernel" in name:
        return "rms_norm_bwd"
    if "_col_sum_kernel" in name:   # _profile: its caller's group
        return "col_sum"
    if "_dln_fwd_kernel" in name:
        return "layer_norm"
    if "_dln_bwd_kernel" in name or "ln_bwd_warp_kernel" in name:
        return "layer_norm_bwd"
    if "_dropout_kernel" in name:
        return "dropout"
    if "_swiglu_" in name:
        return "swiglu"
    if "rnn_fwd_step_kernel" in name or "rnn_fwd_persistent_kernel" in name:
        return "rnn_fwd"
    if "rnn_bwd_" in name:   # persistent, gates, product
        return "rnn_bwd"
    if "sgemm" in name or "f32f32" in name:
        return "matmul_fp32"
    if "rms_norm" in name:
        return "rms_norm"
    if "rope" in name:
        return "rope"
    if any(k in name.lower() for k in ("gemm", "gemv", "xmma", "cutlass",
                                       "nvjet", "cublas")):
        return "matmul"
    return "other"


# the counted kernels a serving step's trace must hold as many times as
# their wrappers counted launches while it ran (one kernel a launch):
# LAUNCHES keys -> a test of a kernel's name
_STEP_TRACE_CHECKED = {
    ("rms_norm", "rms_norm_residual"): lambda k: "rms_norm" in k,
    ("rope",): lambda k: "rope" in k,
    ("ragged_attention",): lambda k: ("ragged_attention_wgmma_kernel" in k
                                      or "ragged_attention_kernel" in k),
}
PROFILE_TRACES = 8     # traces taken before a lossy one fails the phase
OUT_BUDGET_MIB = 48    # what --out may hold at the end of a run
SPINS = 64             # spin kernels before and after a trace's calls
SPIN_CYCLES = 10 ** 6  # ~0.5 ms each on an H100


def _spins(torch):
    """SPINS spin kernels (``torch.cuda._sleep``, ``spin_kernel``), waited
    for: the first and last records of a trace (``_profile``)."""
    for _ in range(SPINS):
        torch.cuda._sleep(SPIN_CYCLES)
    torch.cuda.synchronize()


def _profile(torch, step, n, checked=None):
    """Wall ms per step and device ms per step by kernel group, from a
    torch.profiler trace of ``n`` calls of ``step`` (kernels replayed from
    a CUDA graph appear in the trace as launched ones do). The tracer now
    and then loses a run of a trace's first kernel records (late in the
    smoke's process, the first trace after a pause: its first few dozen,
    ~20 ms of them, all of a short step's; a trace taken right after holds
    them all) or its last ones. The calls therefore run between two bursts
    of ``_spins`` (~32 ms each), which the counts and the wall time leave
    out. With ``checked`` (as ``_STEP_TRACE_CHECKED``) a trace must still
    hold each of its kernels as many times as the wrapper counted launches
    over the traced calls, or it is taken again over the next ``n`` calls,
    up to PROFILE_TRACES traces."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import kernels as K
    for attempt in range(1, PROFILE_TRACES + 1):
        before = dict(K.LAUNCHES)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _spins(torch)
            t0 = time.monotonic()
            for _ in range(n):
                step()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            _spins(torch)
        groups, names, counts, launches = {}, {}, {}, 0
        other, other_n = {}, {}
        kernels = sorted((e for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and "spin_kernel" not in e.name),
                         key=lambda e: e.time_range.start)
        prev = "other"
        for e in kernels:
            g = _kernel_group(e.name)
            if g == "col_sum":
                # the second kernel of RMSNorm's or LayerNorm's
                # backward, launched right after the rows' kernel
                g = prev
            prev = g
            ms = e.time_range.elapsed_us() / 1e3
            groups[g] = groups.get(g, 0.0) + ms
            key = e.name[:80]
            names[key] = names.get(key, 0.0) + ms
            counts[key] = counts.get(key, 0) + 1
            launches += 1
            if g == "other":      # PyTorch's kernels: named by functor
                key = _other_name(e.name)
                other[key] = other.get(key, 0.0) + ms
                other_n[key] = other_n.get(key, 0) + 1
        checked = checked or {}
        launched = {keys: sum(K.LAUNCHES[k] - before[k] for k in keys)
                    for keys in checked}
        traced = {keys: sum(c for k, c in counts.items() if hit(k))
                  for keys, hit in checked.items()}
        if traced == launched:
            break
        lost = {"+".join(keys): f"{traced[keys]} of {launched[keys]}"
                for keys in checked if traced[keys] != launched[keys]}
        print(f"  profiler trace {attempt}: it holds {lost} counted "
              f"launches; the tracer dropped records (it holds "
              f"{len(kernels)} kernel records, {len(counts)} names)",
              flush=True)
    else:
        raise AssertionError(f"the profiler dropped kernel records in "
                             f"{PROFILE_TRACES} traces running")
    busy = sum(groups.values())
    top = sorted(names.items(), key=lambda kv: -kv[1])[:20]
    top_other = sorted(other.items(), key=lambda kv: -kv[1])[:12]
    plans = sum(c for k, c in counts.items()
                if "ragged_attention_plan_kernel" in k)
    return prof, dict(wall_ms=1e3 * wall / n, device_ms=busy / n,
                      idle_share=1 - busy / (1e3 * wall) if wall else None,
                      device_launches=launches / n,
                      ragged_plans_a_step=plans / n, traces=attempt,
                      by_group_ms={k: v / n for k, v in sorted(
                          groups.items(), key=lambda kv: -kv[1])},
                      top_kernels_ms={k: v / n for k, v in top},
                      top_kernels_launches={k: counts[k] / n for k, _ in top},
                      other_top_ms={k: v / n for k, v in top_other},
                      other_top_launches={k: other_n[k] / n
                                          for k, _ in top_other})


def _save_trace(prof, path):
    """A profiler's chrome trace, gzip-compressed, as ``path`` + ".gz" (the
    traces of a whole run would exceed the output directory's budget
    uncompressed; chrome://tracing and Perfetto read .json.gz). Level 1:
    level 9 took seconds a trace, over the whole run tens of seconds of
    the phases' budget, for 20% smaller files."""
    import gzip
    import shutil
    prof.export_chrome_trace(path)
    with open(path, "rb") as src, gzip.open(path + ".gz", "wb",
                                            compresslevel=1) as dst:
        shutil.copyfileobj(src, dst)
    os.remove(path)


def _dir_bytes(root):
    """Bytes of every file under ``root``."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)


def _other_name(name):
    """A PyTorch kernel's name shortened to what tells its op apart: the
    kernel template and the functor (``vectorized_elementwise_kernel<4,
    ...MulFunctor<float>``), without the argument lists."""
    for cut in (", std::array", ">(int", "(at::", "(float", "(long"):
        i = name.find(cut)
        if i > 0:
            name = name[:i]
    name = name.replace("void ", "").replace("at::native::", "") \
        .replace("(anonymous namespace)::", "")
    return name[:150]


def _print_other(m, tag):
    """The by-op split of a profiled step's "other" group: the 12 kernels
    with the most device ms a step."""
    print(f"  {tag}: the \"other\" group ({m['by_group_ms'].get('other', 0):.3f}"
          f" ms a step) by kernel, top 12:", flush=True)
    for name, ms in m["other_top_ms"].items():
        print(f"    {ms:9.3f} ms {m['other_top_launches'][name]:5.0f}x  "
              f"{name}", flush=True)


def _profile_steps(torch, eng, vocab, seed, tag):
    """Where a step's time goes: a profiler trace of two prefill steps
    (8 prompts of 512 tokens, 256 tokens a step) and of four decode steps
    of the same 8 sequences, kept as their summaries (``_profile``; the
    chrome traces of the serving phases' 26 profiles cost the smoke tens
    of seconds to write). The ragged attention must plan once a step, in
    traces that hold every counted launch."""
    import numpy as np
    rng = np.random.default_rng(seed + 1)
    reqs = [eng.submit(rng.integers(1, vocab, (512,)).tolist(),
                       max_new_tokens=16) for _ in range(8)]
    out = {}
    _, out["prefill"] = _profile(torch, eng.step, 2,
                                 checked=_STEP_TRACE_CHECKED)
    sched = eng.sched
    while sched.waiting or any(r.pos < len(r.seq) - 1 for r in sched.running):
        eng.step()
    _, out["decode"] = _profile(torch, eng.step, 4,
                                checked=_STEP_TRACE_CHECKED)
    eng.run_until_idle()
    if not all(len(r.result(timeout=0)) == 16 for r in reqs):
        raise AssertionError("a profiled request did not finish")
    for kind, m in out.items():
        print(f"  {tag} {kind} step breakdown: wall {m['wall_ms']:.3f} ms, "
              f"device {m['device_ms']:.3f} ms (idle share "
              f"{m['idle_share']:.3f}), {m['device_launches']:.0f} kernels, "
              f"{m['ragged_plans_a_step']:g} ragged plans; by group (ms): "
              + ", ".join(f"{k} {v:.3f}" for k, v in m["by_group_ms"].items()),
              flush=True)
        if m["ragged_plans_a_step"] != 1:
            raise AssertionError(f"{tag} {kind}: the ragged attention "
                                 f"planned {m['ragged_plans_a_step']} times "
                                 f"a step, not once")
    return out


def _step_agreement(torch, model, cfg, ecfg, seed, quant=None):
    """One mixed ragged step (7 decode tokens, contexts up to 2000 or the
    model's positions, and a 64-token prefill chunk) through the kernels
    and through the plain versions, in bf16 and in float32 (the same
    bf16-valued weights and pools, upcast; quantized leaves as they are).
    The weight-only GEMM takes bf16 activations only, so both float32
    runs of a quantized step read the leaves through its plain version:
    there the float32 pair holds the other kernels, and the bf16 pair all
    of them. float32: the two paths differ only in summation order, so
    they must agree to 1e-3 of the largest logit. bf16: both paths round
    at the same places, so the kernel path must be no further from the
    float32 step than the plain bf16 path is, within a factor 2."""
    from paddle_tpu_torch import generation as G
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.quantization._kernels import quant_matmul_arrays
    from paddle_tpu_torch.serving import engine as E
    dev = torch.device("cuda")
    heads = cfg.num_attention_heads
    top = min(2000, cfg.max_position_embeddings - 64)
    contexts = [60, 300, 700, 1100, 1500, 1800, 2000, 700]
    contexts = [min(c, top) for c in contexts]
    t_args, _, _, _ = _ragged_case(
        torch, dev, kvh=heads, heads=heads, d=cfg.hidden_size // heads,
        contexts=contexts, chunk=64, budget=ecfg.token_budget, seed=seed)
    _, kp0, vp0, tables, slot, pos, valid = t_args
    layers = cfg.num_hidden_layers
    # the engine's pools carry a spare page past the real ones, where the
    # padding rows write
    kp0 = torch.cat([kp0, torch.zeros_like(kp0[:1])])
    vp0 = torch.cat([vp0, torch.zeros_like(vp0[:1])])
    kp = kp0[None].expand(layers, *kp0.shape).contiguous()
    vp = vp0[None].expand(layers, *vp0.shape).contiguous()
    del t_args, kp0, vp0
    tokens = torch.randint(1, cfg.vocab_size, (ecfg.token_budget,),
                           generator=torch.Generator().manual_seed(seed)) \
        .to(dev)
    dec = G._decoder_for(model)
    w16 = G._quant_weights_cached(dec, model, quant) if quant \
        else dec.weights(model)

    def run(w, dtype, plain):
        kpc, vpc = kp.to(dtype), vp.to(dtype)
        before = dict(K.LAUNCHES)
        with ExitStack() as stack, torch.inference_mode():
            if plain:
                _plain_patches(stack)
            elif quant and dtype == torch.float32:
                stack.enter_context(mock.patch.object(
                    G, "_qmm", quant_matmul_arrays))
            logits = E._engine_step_impl(dec, w, tokens, slot, pos, valid,
                                         tables, kpc, vpc)
            torch.cuda.synchronize()
        if plain and K.kernel_launches() != {
                n: c for n, c in before.items() if n not in K.ROUTED}:
            raise AssertionError("the plain step launched a kernel")
        return logits[valid].float()

    kb = run(w16, torch.bfloat16, False)
    pb = run(w16, torch.bfloat16, True)
    w32 = {k: v if "::" in k else v.float() for k, v in w16.items()}
    kf = run(w32, torch.float32, False)
    pf = run(w32, torch.float32, True)
    del w32
    torch.cuda.empty_cache()
    scale = float(pf.abs().max())
    err32 = float((kf - pf).abs().max())
    err_k = float((kb - pf).abs().max())
    err_p = float((pb - pf).abs().max())
    err16 = float((kb - pb).abs().max())
    agree32 = float((kf.argmax(-1) == pf.argmax(-1)).float().mean())
    agree16 = float((kb.argmax(-1) == pb.argmax(-1)).float().mean())
    finite = all(bool(torch.isfinite(x).all()) for x in (kb, pb, kf, pf))
    print(f"  step_ragged kernels vs plain, float32: max_abs_err={err32:.4g} "
          f"tol={1e-3 * scale:.4g} (max |logit| {scale:.4g}), argmax "
          f"agreement {agree32:.4f}", flush=True)
    print(f"  step_ragged bf16 vs the float32 step: kernels {err_k:.4g}, "
          f"plain {err_p:.4g} (tol: kernels <= 2 x plain); kernels vs plain "
          f"bf16 {err16:.4g}, argmax agreement {agree16:.4f}; "
          f"finite={finite}", flush=True)
    if not (finite and err32 <= 1e-3 * scale and err_k <= 2 * err_p):
        raise AssertionError("the kernel step disagrees with the plain step")
    return dict(step_logits_err_f32=err32, step_logits_err_bf16=err16,
                step_bf16_err_vs_f32_kernels=err_k,
                step_bf16_err_vs_f32_plain=err_p,
                step_argmax_agreement_f32=agree32,
                step_argmax_agreement_bf16=agree16)


# -- phase 3 (training kernels) ------------------------------------------------------

def _flash_bytes_flops(b, h, sq, sk, d, causal, esize, backward, pairs=None,
                       bounds_bytes=0):
    """Bytes the function must move (each input read once, each output
    written once) and the matmul flops of the visible (query, key) pairs:
    ``pairs`` over all b * h heads where a mask sets them (FlashMask, whose
    bounds add ``bounds_bytes``), else those of causal or no masking."""
    if pairs is None:
        pairs = b * h * (sum(min(sk, i + 1 + sk - sq) for i in range(sq))
                         if causal else sq * sk)
    qo = b * h * sq * d * esize
    kv = b * h * sk * d * esize
    rows = b * h * sq * 4
    if not backward:
        return 2 * qo + 2 * kv + rows + bounds_bytes, 4 * pairs * d
    # q, k, v, out, dO and lse in; dq, dk, dv out
    return (3 * qo + 2 * kv + rows + qo + 2 * kv + bounds_bytes,
            10 * pairs * d)


def _flash_case(torch, dev, b, h, sq, sk, d, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, dout = (torch.randn(b, h, sq, d, device=dev, generator=g).to(dtype)
               for _ in range(2))
    k, v = (torch.randn(b, h, sk, d, device=dev, generator=g).to(dtype)
            for _ in range(2))
    return q, k, v, dout


def _tflops(flops, ms):
    return flops / (ms * 1e-3) / 1e12


def phase_train_kernels(torch, results):
    """Flash attention forward and backward against their plain versions:
    bf16 at the Llama training shape [8, 16, 2048, 128] causal and the
    GPT-MoE one [8, 12, 1024, 64] causal (both timed beside their bound
    and SDPA), at ragged lengths (d 64 and 128), causal with sq < sk and
    non-causal; float32 at a ragged and an sq < sk case. AdamW over one
    decoder layer's tensors and the embedding of the 1.1B model, with
    per-tensor rates and decays in one launch."""
    import torch.nn.functional as F
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels import flash_attention as FA
    from paddle_tpu_torch.kernels.optimizer import (adamw_plain,
                                                    multi_tensor_adamw)
    dev = torch.device("cuda")
    bf, f32 = torch.bfloat16, torch.float32
    print("phase 3: training kernels against their plain versions (flash "
          "bf16: each row of out, dq, dk and dv within 2 bf16 ulps of the "
          "row's largest plain value, since the output's own rounding may "
          "differ by one ulp and P, rounded to bf16 at another running max, "
          "adds less; and no further from the float32 reference than the "
          "plain bf16 version, within 1.1x; float32: 2e-5 and 1e-4 of "
          "max(1, |ref|); lse 1e-3)", flush=True)
    timed = {"bf16_causal": "", "bf16_gpt_moe": "_gpt_moe"}
    for case, (b, h, sq, sk, d, causal, dtype) in {
            "bf16_causal": (8, 16, 2048, 2048, 128, True, bf),
            "bf16_gpt_moe": (8, 12, 1024, 1024, 64, True, bf),
            "bf16_ragged_d128": (2, 4, 333, 333, 128, True, bf),
            "bf16_ragged_d64": (2, 4, 200, 200, 64, True, bf),
            "bf16_causal_sq_lt_sk": (2, 4, 500, 700, 64, True, bf),
            "bf16_noncausal": (2, 4, 300, 450, 128, False, bf),
            "f32_causal_sq_lt_sk": (2, 4, 500, 700, 64, True, f32),
            "f32_ragged": (1, 4, 333, 333, 128, False, f32)}.items():
        q, k, v, dout = _flash_case(torch, dev, b, h, sq, sk, d, dtype, 30)
        bf16 = dtype == bf
        out, lse = FA.flash_forward(q, k, v, causal)
        torch.cuda.synchronize()
        wout, wlse = FA.flash_forward_plain(q, k, v, causal)
        err_l = _check(f"flash_fwd[{case}] lse", lse, wlse, 1e-3)
        if bf16:
            f32s = [x.float() for x in (q, k, v, dout)]
            out32, lse32 = FA.flash_forward_plain(*f32s[:3], causal)
            err_f = max(err_l, _check_rows(f"flash_fwd[{case}]", out, wout,
                                           2))
            dist = {"out": _check_vs_f32(f"flash_fwd[{case}]", out, wout,
                                         out32)}
        else:
            err_f = max(err_l, _check(
                f"flash_fwd[{case}]", out, wout,
                2e-5 * max(1.0, float(wout.abs().max()))))
        del wout, wlse
        grads = FA.flash_backward(q, k, v, out, lse, dout, causal)
        torch.cuda.synchronize()
        want = FA.flash_backward_plain(q, k, v, out, lse, dout, causal)
        if bf16:
            ref32 = FA.flash_backward_plain(*f32s[:3], out32, lse32, f32s[3],
                                            causal)
            del f32s, out32, lse32
        err_b = 0.0
        for i, (name, got, ref) in enumerate(zip(("dq", "dk", "dv"), grads,
                                                 want)):
            if bf16:
                err_b = max(err_b, _check_rows(f"flash_bwd[{case}] {name}",
                                               got, ref, 2))
                dist[name] = _check_vs_f32(f"flash_bwd[{case}] {name}", got,
                                           ref, ref32[i])
            else:
                err_b = max(err_b, _check(
                    f"flash_bwd[{case}] {name}", got, ref,
                    1e-4 * max(1.0, float(ref.abs().max()))))
        del grads, want
        if bf16:
            del ref32
        torch.cuda.empty_cache()
        results[f"flash_fwd[{case}]"] = dict(
            max_abs_err=err_f, shape=[b, h, sq, sk, d], causal=causal,
            l2_from_f32=dist.get("out") if bf16 else None)
        results[f"flash_bwd[{case}]"] = dict(
            max_abs_err=err_b, shape=[b, h, sq, sk, d], causal=causal,
            l2_from_f32={n: dist[n] for n in ("dq", "dk", "dv")}
            if bf16 else None)
        if case not in timed:
            del q, k, v, dout, out, lse
            continue
        nb, nf_fwd = _flash_bytes_flops(b, h, sq, sk, d, causal, 2, False)
        fwd_bound = _bound(nb, nf_fwd, BF16_FLOPS)
        nb, nf_bwd = _flash_bytes_flops(b, h, sq, sk, d, causal, 2, True)
        bwd_bound = _bound(nb, nf_bwd, BF16_FLOPS)
        fwd_ms = _graph_ms(lambda: FA.flash_forward(q, k, v, causal), iters=5,
                           reps=3)
        bwd_ms = _graph_ms(lambda: FA.flash_backward(q, k, v, out, lse, dout,
                                                     causal), iters=3, reps=3)
        fwd_plain = _time_ms(lambda: FA.flash_forward_plain(q, k, v, causal),
                             2, warmup=1)
        bwd_plain = _time_ms(lambda: FA.flash_backward_plain(
            q, k, v, out, lse, dout, causal), 2, warmup=1)
        torch.cuda.empty_cache()
        lib_fwd = _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), 10)
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

        def lib_train():
            F.scaled_dot_product_attention(qg, kg, vg, is_causal=True) \
                .backward(dout)
        lib_both = _time_ms(lib_train, 10)
        key = timed[case]
        results["flash_fwd" + key] = dict(
            results[f"flash_fwd[{case}]"], ms=fwd_ms, plain_ms=fwd_plain,
            bound_ms=fwd_bound[0], bound_by=fwd_bound[1], library_ms=lib_fwd,
            tflops=_tflops(nf_fwd, fwd_ms))
        # no single library call is the backward alone: its time is the
        # library's forward+backward less its forward
        results["flash_bwd" + key] = dict(
            results[f"flash_bwd[{case}]"], ms=bwd_ms, plain_ms=bwd_plain,
            bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
            library_ms=lib_both - lib_fwd, library_fwd_bwd_ms=lib_both,
            tflops=_tflops(nf_bwd, bwd_ms))
        print(f"  flash {[b, h, sq, d]} bf16 causal: forward ms={fwd_ms:.4f} "
              f"({_tflops(nf_fwd, fwd_ms):.1f} TFLOP/s) plain_ms="
              f"{fwd_plain:.4f} bound_ms={fwd_bound[0]:.4f} ({fwd_bound[1]}) "
              f"sdpa_ms={lib_fwd:.4f}; backward (dq with delta, dk/dv) ms="
              f"{bwd_ms:.4f} ({_tflops(nf_bwd, bwd_ms):.1f} TFLOP/s of the "
              f"5 products' flops) plain_ms={bwd_plain:.4f} bound_ms="
              f"{bwd_bound[0]:.4f} ({bwd_bound[1]}) sdpa fwd+bwd ms="
              f"{lib_both:.4f} [{_card_line()}]", flush=True)
        del q, k, v, dout, out, lse, qg, kg, vg
        torch.cuda.empty_cache()

    # AdamW over one decoder layer of the 1.1B model and its embedding, as
    # phase 12's recipe gives them: the embedding at half the rate, no
    # decay on the two norms
    g = torch.Generator(device=dev).manual_seed(31)
    hid, inter, vocab = 2048, 5632, 32000
    shapes = [(hid, hid)] * 4 + [(hid, inter)] * 2 + [(inter, hid)] \
        + [(hid,)] * 2 + [(vocab, hid)]
    ps = [(0.02 * torch.randn(s, device=dev, generator=g)).bfloat16()
          for s in shapes]
    gs = [(1e-3 * torch.randn(s, device=dev, generator=g)).bfloat16()
          for s in shapes]
    ms = [1e-4 * torch.randn(s, device=dev, generator=g) for s in shapes]
    vs = [1e-8 * torch.rand(s, device=dev, generator=g) for s in shapes]
    wds = [0.01] * 7 + [0.0] * 2 + [0.01]
    mults = [1.0] * 9 + [0.5]
    hp = dict(lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8)
    want = [adamw_plain(p, gg, m, v, hp["lr"], hp["beta1"], hp["beta2"],
                        hp["eps"], wd, 3.0, True, mu)
            for p, gg, m, v, wd, mu in zip(ps, gs, ms, vs, wds, mults)]
    # elements whose bf16 value the update changes: a kernel that did not
    # write p would differ from the plain version there
    changed = sum(int((wp != p).sum()) for (wp, _, _), p in zip(want, ps))
    before = K.LAUNCHES["adamw"]
    multi_tensor_adamw(ps, gs, ms, vs, wds=wds, step=3.0, lr_mults=mults,
                       **hp)
    if K.LAUNCHES["adamw"] != before + 1:
        raise AssertionError("the AdamW check is not one launch")
    torch.cuda.synchronize()
    print(f"  adamw: the update changes {changed} bf16 parameter values",
          flush=True)
    if not changed:
        raise AssertionError("the AdamW check changes no parameter value")
    err = 0.0
    for i, ((wp, wm, wv), p, m, v) in enumerate(zip(want, ps, ms, vs)):
        # the same correctly rounded fp32 operations in the same order
        # (every one an explicitly rounded intrinsic in the kernel): equal
        err = max(err, _check(f"adamw[{i}] p", p, wp, 0.0),
                  _check(f"adamw[{i}] m", m, wm, 0.0),
                  _check(f"adamw[{i}] v", v, wv, 0.0))
    del want
    n = sum(p.numel() for p in ps)
    # as the trainer calls it: the rate and step from device tensors (the
    # scalars' few tiny kernels run before the launch), replayed from a
    # CUDA graph so the host's launches of those are not in the number
    lr_t = torch.full((), hp["lr"], device=dev)
    step_t = torch.full((), 3.0, device=dev)
    ms_k = _graph_ms(lambda: multi_tensor_adamw(
        ps, gs, ms, vs, wds=wds, step=step_t, lr_mults=mults, lr=lr_t,
        **{k: v for k, v in hp.items() if k != "lr"}), iters=10, reps=3)
    ms_plain = _time_ms(lambda: [adamw_plain(p, gg, m, v, hp["lr"],
                                             hp["beta1"], hp["beta2"],
                                             hp["eps"], wd, 3.0, True, mu)
                                 for p, gg, m, v, wd, mu in zip(
                                     ps, gs, ms, vs, wds, mults)], 3)
    del ps, gs, ms, vs
    torch.cuda.empty_cache()
    fp = [torch.nn.Parameter(torch.zeros(s, device=dev)) for s in shapes]
    for p in fp:
        p.grad = torch.randn_like(p) * 1e-3
    lib = torch.optim.AdamW(fp, lr=1e-4, weight_decay=0.01, fused=True)
    lib_ms = _time_ms(lib.step, 10)
    del fp, lib
    torch.cuda.empty_cache()
    bound_ms, bound_by = _bound(22 * n, 15 * n, FP32_FLOPS)
    results["adamw"] = dict(max_abs_err=err, ms=ms_k, plain_ms=ms_plain,
                            bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=lib_ms, elements=n,
                            library_bytes=28 * n)
    print(f"  adamw over {n} elements (bf16 p, g; fp32 m, v; 22 bytes an "
          f"element; rate multipliers 0.5 on the embedding, wd 0 on the "
          f"norms; rate and step read from the device, CUDA-graph "
          f"replay): ms={ms_k:.4f} ({bound_ms / ms_k:.3f} of the bound; "
          f"PR 12, with both as launch arguments, events around eager "
          f"calls: 0.9275 ms) plain_ms={ms_plain:.4f} "
          f"bound_ms={bound_ms:.4f} "
          f"({bound_by}); torch.optim.AdamW(fused=True) over fp32 tensors "
          f"of the same count (28 bytes an element) {lib_ms:.4f} ms "
          f"[{_card_line()}]", flush=True)
    _norm_rope_at_training_shapes(torch, dev)
    _rope_training_case(torch, results, dev)
    _fused_passes(torch, results, dev)


# the 1.1B Llama's training step (phase 5): q [8, 2048, 32, 64], k [8,
# 2048, 4, 64] bf16; 66 RoPE launches a step (a forward, its recompute
# under remat and a backward a layer, 22 layers)
ROPE_TRAIN = dict(shape_q=(8, 2048, 32, 64), shape_k=(8, 2048, 4, 64),
                  launches_a_step=66)


def _rope_training_case(torch, results, dev):
    """RoPE (``fused.fused_rope``; its backward is the same kernel with
    -sin) at the Llama training step's shape in bf16 with the model's
    bf16-rounded tables: forward and backward each row within one bf16 ulp
    of its largest plain value, timed by graph replay beside its bound
    (q, k and the gradients read once and written once, the tables read
    once), the plain version by events; into ``results["rope[llama
    training]"]`` / ``["rope_bwd[llama training]"]``."""
    from paddle_tpu_torch.kernels import fused
    from paddle_tpu_torch.models import build_rope_cache
    g = torch.Generator(device=dev).manual_seed(33)
    bf = torch.bfloat16
    sq, sk = ROPE_TRAIN["shape_q"], ROPE_TRAIN["shape_k"]
    cos, sin = (t.to(bf).float() for t in build_rope_cache(
        sq[1], sq[3], device=dev))
    q, gq = (torch.randn(*sq, device=dev, generator=g).to(bf)
             for _ in range(2))
    k, gk = (torch.randn(*sk, device=dev, generator=g).to(bf)
             for _ in range(2))
    card = _card_line()
    nbytes = 2 * 2 * (q.numel() + k.numel()) + 2 * 4 * cos.numel()
    bound_ms, bound_by = _bound(nbytes, 6 * (q.numel() + k.numel()),
                                FP32_FLOPS)
    for key, s_ in (("rope", sin), ("rope_bwd", -sin)):
        xq, xk = (q, k) if key == "rope" else (gq, gk)
        got = fused.rope_op(xq, xk, cos, s_)
        want = fused.fused_rope_plain(xq, xk, cos, s_)
        err = max(_check_rows(f"rope {key} {list(sq)} / {list(sk)} {n}", a, b,
                              1) for n, a, b in zip("qk", got, want))
        ms = _graph_ms(lambda: fused.rope_op(xq, xk, cos, s_), iters=20,
                       reps=3)
        plain = _time_ms(lambda: fused.fused_rope_plain(xq, xk, cos, s_), 5)
        results[f"{key}[llama training]"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None, share_of_bound=bound_ms / ms,
            shape_q=list(sq), shape_k=list(sk),
            launches_a_step=ROPE_TRAIN["launches_a_step"] // 3 * (
                2 if key == "rope" else 1))
        print(f"  {key} at the Llama training shape q {list(sq)}, k "
              f"{list(sk)} bf16: {ms:.4f} ms ({bound_ms / ms:.3f} of the "
              f"bound {bound_ms:.4f} ms, {bound_by}); plain {plain:.4f} ms; "
              f"{results[f'{key}[llama training]']['launches_a_step']} "
              f"launches a step [{card}]", flush=True)
    del q, k, gq, gk
    torch.cuda.empty_cache()


def _norm_rope_at_training_shapes(torch, dev):
    """RMSNorm and RoPE through their autograd functions, forward and
    backward, at the shapes the training step gives them (bf16): x [8,
    2048, 2048]; q, k [8, 2048, 16, 128] with the model's bf16-rounded
    rope tables. Forward and the RoPE backward (the kernel with -sin): each
    row within one bf16 ulp of its largest plain value (both round one
    fp32 result). The RMSNorm backward is its own kernel
    (``_fused_passes`` holds it to the plain version and times it)."""
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels import fused
    from paddle_tpu_torch.models import build_rope_cache
    g = torch.Generator(device=dev).manual_seed(32)
    bf = torch.bfloat16
    x = torch.randn(8, 2048, 2048, device=dev, generator=g).to(bf)
    w = (1 + 0.1 * torch.randn(2048, device=dev, generator=g)).to(bf)
    dy = torch.randn(8, 2048, 2048, device=dev, generator=g).to(bf)
    before = dict(K.LAUNCHES)
    xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
    yk = fused.rms_norm(xk, wk, 1e-6)
    yk.backward(dy)
    xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
    yp = fused.rms_norm_plain(xp, wp, 1e-6)
    yp.backward(dy)
    torch.cuda.synchronize()
    _check_rows("rms_norm [8, 2048, 2048] forward", yk, yp, 1)
    _check_rows("rms_norm [8, 2048, 2048] dx", xk.grad, xp.grad, 1)
    del x, w, dy, xk, wk, yk, xp, wp, yp
    cos, sin = (t.to(bf).float() for t in build_rope_cache(2048, 128,
                                                            device=dev))
    q, k, gq, gk = (torch.randn(8, 2048, 16, 128, device=dev,
                                generator=g).to(bf) for _ in range(4))
    qk, kk = q.clone().requires_grad_(), k.clone().requires_grad_()
    rq, rk = fused.fused_rope(qk, kk, cos, sin)
    torch.autograd.backward((rq, rk), (gq, gk))
    qp, kp = q.clone().requires_grad_(), k.clone().requires_grad_()
    pq, pk = fused.fused_rope_plain(qp, kp, cos, sin)
    torch.autograd.backward((pq, pk), (gq, gk))
    torch.cuda.synchronize()
    for name, got, want in (("q", rq, pq), ("k", rk, pk),
                            ("dq", qk.grad, qp.grad), ("dk", kk.grad, kp.grad)):
        _check_rows(f"rope [8, 2048, 16, 128] {name}", got, want, 1)
    used = {n: K.LAUNCHES[n] - before[n]
            for n in ("rms_norm", "rope", "rms_norm_bwd")}
    print(f"  launches of these checks: {used}", flush=True)
    if used != {"rms_norm": 1, "rope": 2, "rms_norm_bwd": 1}:
        raise AssertionError(f"the checks did not go through the kernels: "
                             f"{used}")
    del q, k, gq, gk, qk, kk, rq, rk, qp, kp, pq, pk
    torch.cuda.empty_cache()


def _fused_passes(torch, results, dev):
    """The elementwise passes XLA fuses into the JAX training step, as the
    port's Triton kernels, at the Llama step's shapes in bf16: RMSNorm's
    backward over x [16384, 2048] (45 calls a step) and SwiGLU over gate,
    up [16384, 5632] (forward 44 calls a step with the recompute, backward
    22). Each against its plain version: every row within one bf16 ulp of
    its largest plain value (dgate two: silu's backward cancels near
    gate = -1.28, where Triton's exp and PyTorch's differ in the last fp32
    bits), dw within one ulp of its largest value; and no further from the
    float32 result than the plain bf16 version (1.1x). Timed by CUDA-graph
    replay (the plain versions by events around eager calls), beside the
    bound (each input read once, each output written once) and, for
    RMSNorm, the autograd of ``F.rms_norm`` (SwiGLU has no single PyTorch
    call)."""
    import torch.nn.functional as F
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels import fused
    g = torch.Generator(device=dev).manual_seed(33)
    bf = torch.bfloat16
    rows, hid, inter = 16384, 2048, 5632
    card = _card_line()
    x = torch.randn(rows, hid, device=dev, generator=g).to(bf)
    w = (1 + 0.1 * torch.randn(hid, device=dev, generator=g)).to(bf)
    dy = torch.randn(rows, hid, device=dev, generator=g).to(bf)
    before = K.LAUNCHES["rms_norm_bwd"]
    dx, dw = fused.rms_norm_backward(x, w, dy, 1e-5)
    if K.LAUNCHES["rms_norm_bwd"] != before + 1:
        raise AssertionError("rms_norm_backward did not launch its kernel")
    pdx, pdw = fused.rms_norm_backward_plain(x, w, dy, 1e-5)
    rdx, rdw = fused.rms_norm_backward_plain(x.float(), w.float(),
                                             dy.float(), 1e-5)
    torch.cuda.synchronize()
    err = max(_check_rows("rms_norm_bwd dx", dx, pdx, 1),
              _check("rms_norm_bwd dw", dw, pdw,
                     ULP_BF16 * float(pdw.float().abs().max())))
    _check_vs_f32("rms_norm_bwd dx", dx, pdx, rdx)
    _check_vs_f32("rms_norm_bwd dw", dw, pdw, rdw)
    del dx, dw, pdx, pdw, rdx, rdw
    ms = _graph_ms(lambda: fused.rms_norm_backward(x, w, dy, 1e-5))
    plain_ms = _time_ms(lambda: fused.rms_norm_backward_plain(x, w, dy, 1e-5),
                        5)
    xl = x.clone().requires_grad_()
    wl = w.clone().requires_grad_()
    yl = F.rms_norm(xl, (hid,), wl, 1e-5)
    lib_ms = _time_ms(lambda: torch.autograd.grad(yl, (xl, wl), dy,
                                                  retain_graph=True), 5)
    del xl, wl, yl
    n = rows * hid
    bound_ms, bound_by = _bound(3 * 2 * n + 2 * 2 * hid, 12 * n, FP32_FLOPS)
    results["rms_norm_bwd"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   bound_ms=bound_ms, bound_by=bound_by,
                                   library_ms=lib_ms, launches_a_step=45)
    print(f"  rms_norm_bwd [{rows}, {hid}] bf16: ms={ms:.4f} "
          f"({bound_ms / ms:.3f} of the bound) plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}); autograd of F.rms_norm "
          f"{lib_ms:.4f} ms [{card}]", flush=True)
    del x, w, dy
    gate = (3 * torch.randn(rows, inter, device=dev, generator=g)).to(bf)
    up = torch.randn(rows, inter, device=dev, generator=g).to(bf)
    dy = torch.randn(rows, inter, device=dev, generator=g).to(bf)
    before = dict(K.LAUNCHES)
    y = fused.swiglu_op(gate, up)
    dg, du = fused.swiglu_backward(gate, up, dy)
    if (K.LAUNCHES["swiglu_fwd"] - before["swiglu_fwd"],
            K.LAUNCHES["swiglu_bwd"] - before["swiglu_bwd"]) != (1, 1):
        raise AssertionError("swiglu did not launch its kernels")
    py = fused.swiglu_plain(gate, up)
    pdg, pdu = fused.swiglu_backward_plain(gate, up, dy)
    ry = fused.swiglu_plain(gate.float(), up.float())
    rdg, rdu = fused.swiglu_backward_plain(gate.float(), up.float(),
                                           dy.float())
    torch.cuda.synchronize()
    err_f = _check_rows("swiglu_fwd y", y, py, 1)
    err_b = max(_check_rows("swiglu_bwd dgate", dg, pdg, 2),
                _check_rows("swiglu_bwd dup", du, pdu, 1))
    _check_vs_f32("swiglu_fwd y", y, py, ry)
    _check_vs_f32("swiglu_bwd dgate", dg, pdg, rdg)
    _check_vs_f32("swiglu_bwd dup", du, pdu, rdu)
    del y, dg, du, py, pdg, pdu, ry, rdg, rdu
    n = rows * inter
    for name, fn, plain, nbytes, flops, per_step, e in (
            ("swiglu_fwd", lambda: fused.swiglu_op(gate, up),
             lambda: fused.swiglu_plain(gate, up), 3 * 2 * n, 6 * n, 44,
             err_f),
            ("swiglu_bwd", lambda: fused.swiglu_backward(gate, up, dy),
             lambda: fused.swiglu_backward_plain(gate, up, dy), 5 * 2 * n,
             14 * n, 22, err_b)):
        ms = _graph_ms(fn)
        plain_ms = _time_ms(plain, 5)
        bound_ms, bound_by = _bound(nbytes, flops, FP32_FLOPS)
        results[name] = dict(max_abs_err=e, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=None, launches_a_step=per_step)
        print(f"  {name} [{rows}, {inter}] bf16: ms={ms:.4f} "
              f"({bound_ms / ms:.3f} of the bound) plain_ms={plain_ms:.4f} "
              f"bound_ms={bound_ms:.4f} ({bound_by}); no single PyTorch "
              f"call [{card}]", flush=True)
    del gate, up, dy
    torch.cuda.empty_cache()


def phase_tiny_training(torch, packed=False):
    """A tiny float32 Llama (head_dim 64) trained 3 steps on the card
    through every training kernel against the port's CPU trainer (plain
    versions); ``packed``: on packed documents of 20-90 tokens, through the
    FlashMask kernels. Tolerances: losses 1e-5 relative; weights within
    1e-5 for 99.9% of the elements and 3 lr for all (Adam turns the sign of
    a near-zero gradient element's rounding difference into up to lr)."""
    import numpy as np
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         load_numpy_state)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import SpmdTrainer
    cfg = LlamaConfig.tiny(vocab_size=256, hidden_size=256, layers=2,
                           heads=4, kv_heads=2, seq=200)
    cpu = LlamaForCausalLM(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(8))
    gpu = LlamaForCausalLM(cfg, device="cuda")
    load_numpy_state(gpu, {n: p.detach().numpy()
                           for n, p in cpu.named_parameters()})
    ids = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (2, 200)))
    batch = (ids, ids)
    if packed:
        labels, se, _ = _packed_batch(torch, ids, 8, lo=20, hi=90)
        batch = (ids, labels, se)
    lr = 1e-3

    def run(model, xs):
        tr = SpmdTrainer(model, AdamW(learning_rate=lr,
                                      parameters=model.parameters()),
                         lambda m, i, l, e=None: m.forward_loss(
                             i, l, loss_chunk_size=64,
                             attn_startend_row_indices=e),
                         remat_layers=list(model.model.layers))
        return [float(tr.train_step(*xs)) for _ in range(3)]

    want = run(cpu, batch)
    before = dict(K.LAUNCHES)
    got = run(gpu, [x.cuda() for x in batch])
    used = {n: K.LAUNCHES[n] - before[n] for n in K.LAUNCHES}
    close = total = 0
    worst = 0.0
    for (n, p), q in zip(cpu.named_parameters(), gpu.parameters()):
        d = (q.detach().cpu() - p.detach()).abs()
        worst = max(worst, float(d.max()))
        close += int((d <= 1e-5).sum())
        total += d.numel()
    loss_err = max(abs(a / b - 1) for a, b in zip(got, want))
    attn = ("flashmask_fwd", "flashmask_bwd_dq", "flashmask_bwd_dkv",
            "flashmask_summary") if packed else ("flash_fwd", "flash_bwd_dq",
                                                 "flash_bwd_dkv")
    print(f"  tiny f32 Llama{' on packed documents' if packed else ''} "
          f"trained 3 steps on the card vs the CPU "
          f"trainer: losses {got} vs {want} (max rel err {loss_err:.3g}, "
          f"tol 1e-5); weights within 1e-5: {close}/{total}, worst "
          f"{worst:.3g} (tol {3 * lr}); launches {used}", flush=True)
    if not (loss_err <= 1e-5 and close >= 0.999 * total and worst <= 3 * lr
            and all(used[n] > 0 for n in attn + ("adamw", "rms_norm",
                                                 "rope"))
            and (not packed or used["flash_fwd"] == 0)):
        raise AssertionError("training on the card disagrees with the CPU")


# -- phase 3 (MoE kernels) --------------------------------------------------------

def _gmm_bytes_flops(t, k, n, sizes, esize, transposed):
    """Bytes the function must move and the flops its data needs: the rows
    of the groups (each read once), the weights of the groups that have
    rows, every output row written once (rows past the groups as zeros),
    the sizes and offsets; 2 flops a multiply-add of a grouped row. For
    tgmm (``transposed``): the groups' rows of both inputs and the fp32
    [e, k, n] output."""
    total = sum(sizes)
    flops = 2 * total * k * n
    meta = 4 * (2 * len(sizes) + 1)
    if transposed:
        return total * (k + n) * esize + len(sizes) * k * n * 4 + meta, flops
    busy = sum(1 for s in sizes if s)
    return (total * k * esize + busy * k * n * esize + t * n * esize + meta,
            flops)


def _library_gmm(torch, a, b, sizes, kind):
    """(ms, what) of a library call for the same grouped product, timed as
    a yardstick only: ``torch._grouped_mm`` for bf16 where this PyTorch has
    it and takes the layout (for float32 it copies between host and device,
    which a CUDA graph cannot capture), else a loop of one ``torch.matmul`` per group (not one call). ``kind``: "gmm" (a [t, k], b [e, k, n]), "gmm_t" (b [e, n,
    k], read transposed) or "tgmm" (a [t, k], b [t, n] -> [e, k, n])."""
    ends = torch.tensor(sizes, dtype=torch.int32, device=a.device).cumsum(
        0, dtype=torch.int32)
    grouped = getattr(torch, "_grouped_mm", None)
    if grouped is not None and a.dtype == torch.bfloat16:
        if kind == "gmm":
            tries = [(a, b), (a, b.transpose(1, 2).contiguous()
                                 .transpose(1, 2))]
        elif kind == "gmm_t":
            tries = [(a, b.transpose(1, 2))]
        else:
            tries = [(a.T, b), (a.T.contiguous(), b)]
        for ma, mb in tries:
            try:
                grouped(ma, mb, offs=ends)
                torch.cuda.synchronize()
            except (RuntimeError, TypeError, ValueError):
                continue
            return (_graph_ms(lambda: grouped(ma, mb, offs=ends), iters=5,
                              reps=3), "torch._grouped_mm")
    bounds = [0] + torch.tensor(sizes).cumsum(0).tolist()
    spans = [(s, e_) for s, e_ in zip(bounds, bounds[1:])]
    if kind == "tgmm":
        def loop():
            return [a[s:e_].T @ b[s:e_] for s, e_ in spans]
    else:
        bw = b.transpose(1, 2) if kind == "gmm_t" else b

        def loop():
            return [a[s:e_] @ bw[g] for g, (s, e_) in enumerate(spans)]
    return _time_ms(loop, 5), "loop of torch.matmul per group"


def _gmm_slice_inputs(torch, dev, seed, tokens=8192, d=768, h=3072, e=8):
    """The MoE slice's grouped products with the routing the model gives:
    8 x 1024 tokens routed top-2 by a gate of the model's initial
    distribution (Xavier-uniform [768, 8]) over unit-variance hidden
    states, the slots sorted by expert as the layer sorts them; expert
    banks of the model's distribution; random upstream gradients."""
    from paddle_tpu_torch.kernels.gmm import route_sorted, topk_route
    from paddle_tpu_torch.nn.initializer import xavier_uniform_
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    x = torch.randn(tokens, d, device=dev, generator=g).to(bf)
    gate = xavier_uniform_(torch.empty(d, e, device=dev), g).to(bf)
    _, _, topi = topk_route(x @ gate, 2)
    order, _, gs = route_sorted(topi, e)
    xs = x[torch.div(order, 2, rounding_mode="floor")]
    w1 = xavier_uniform_(torch.empty(e, d, h, device=dev), g, d, h).to(bf)
    w2 = xavier_uniform_(torch.empty(e, h, d, device=dev), g, h, d).to(bf)
    hs = torch.randn(2 * tokens, h, device=dev, generator=g).to(bf)
    dy1 = (0.01 * torch.randn(2 * tokens, h, device=dev, generator=g)).to(bf)
    dy2 = (0.01 * torch.randn(2 * tokens, d, device=dev, generator=g)).to(bf)
    return xs, w1, w2, hs, dy1, dy2, gs


def _hold_gmm(torch, name, got, plain, ref32, dtype):
    """bf16: rows within 2 ulps of their largest plain value, and the
    relative L2 distance from the float32 reference within 1.1x the plain
    bf16 version's. float32: 1e-5 of the largest plain value."""
    if dtype == torch.float32:
        return _check(name, got, plain, 1e-5 * float(plain.abs().max()))
    err = _check_rows(name, got, plain, 2)
    _check_vs_f32(name, got, plain, ref32)
    return err


def _gmm_case_run(torch, results, name, kind, a, b, gs, dtype):
    """Check one grouped product against its plain version and time it,
    its plain version and a library call; records ``results[name]``."""
    from paddle_tpu_torch.kernels import gmm as PG
    sizes = gs.tolist()
    if kind == "tgmm":
        run = lambda: PG.tgmm(a, b, gs)
        plain = lambda: PG.tgmm_plain(a, b, gs)
        t, k = a.shape
        n = b.shape[1]
        # dw reaches the parameters rounded to the weights' dtype
        got = run().to(dtype)
        torch.cuda.synchronize()
        ref32 = plain()
        want = ref32.to(dtype)
    else:
        trans = kind == "gmm_t"
        run = lambda: PG.gmm(a, b, gs, trans_w=trans)
        plain = lambda: PG.gmm_plain(a, b, gs, trans_w=trans)
        t, k = a.shape
        n = b.shape[1] if trans else b.shape[2]
        got = run()
        torch.cuda.synchronize()
        want = plain()
        ref32 = PG.gmm_plain(a.float(), b.float(), gs, trans_w=trans) \
            if dtype == torch.bfloat16 else want
        total = sum(sizes)
        if got[total:].any():
            raise AssertionError(f"{name}: rows past the groups are not 0")
    if kind == "tgmm" and any(bool(got[i].any())
                              for i, s in enumerate(sizes) if s == 0):
        raise AssertionError(f"{name}: an empty group's dw is not 0")
    err = _hold_gmm(torch, name, got, want, ref32, dtype)
    del got, want, ref32
    esize = 2 if dtype == torch.bfloat16 else 4
    nb, nf = _gmm_bytes_flops(t, k, n, sizes, esize, kind == "tgmm")
    bound_ms, bound_by = _bound(nb, nf, BF16_FLOPS if esize == 2
                                else FP32_FLOPS)
    ms = _graph_ms(run, iters=5, reps=3)
    plain_ms = _time_ms(plain, 2, warmup=1)
    lib_ms, lib_what = _library_gmm(torch, a, b, sizes, kind)
    torch.cuda.empty_cache()
    results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=lib_ms, library_call=lib_what,
                         tflops=_tflops(nf, ms), shape=[t, k, n],
                         groups=len(sizes), rows_grouped=sum(sizes))
    print(f"  {name} [{t}, {k}] -> {n}, {len(sizes)} groups, "
          f"{str(dtype)[6:]}: ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms="
          f"{bound_ms:.4f} ({bound_by}) {_tflops(nf, ms):.1f} TFLOP/s "
          f"library_ms={lib_ms:.4f} ({lib_what})", flush=True)


def phase_gmm_kernels(torch, results):
    """gmm (forward, and dx with trans_w) and tgmm against their plain
    versions: at the MoE slice's shapes with the model's routing, at
    bench.py's gmm_probe shapes (4096 tokens, 1024 -> 4096, 8 and 64 equal
    groups), and at a skewed routing (an empty expert, one expert with
    half the rows, one-row groups inside one tile, rows past the groups)
    in bf16 and float32."""
    dev = torch.device("cuda")
    print("phase 3: MoE kernels against their plain versions (bf16: each "
          "row within 2 bf16 ulps of the row's largest plain value and the "
          "relative L2 distance from float32 within 1.1x the plain bf16 "
          "version's; tgmm's fp32 dw held after its cast to the weights' "
          "dtype; float32: 1e-5 of the largest plain value)", flush=True)
    xs, w1, w2, hs, dy1, dy2, gs = _gmm_slice_inputs(torch, dev, 40)
    print(f"  slice routing: group sizes {gs.tolist()} of {xs.shape[0]} "
          f"rows", flush=True)
    bf = torch.bfloat16
    for name, kind, a, b in (("gmm[fwd_w1]", "gmm", xs, w1),
                             ("gmm[fwd_w2]", "gmm", hs, w2),
                             ("gmm[dx_w1]", "gmm_t", dy1, w1),
                             ("gmm[dx_w2]", "gmm_t", dy2, w2),
                             ("tgmm[dw_w1]", "tgmm", xs, dy1),
                             ("tgmm[dw_w2]", "tgmm", hs, dy2)):
        _gmm_case_run(torch, results, name, kind, a, b, gs, bf)
    del xs, w1, w2, hs, dy1, dy2
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(41)
    for ne in (8, 64):       # bench.py gmm_probe
        x = torch.randn(4096, 1024, device=dev, generator=g).to(bf)
        w = torch.randn(ne, 1024, 4096, device=dev, generator=g).to(bf)
        sizes = torch.full((ne,), 4096 // ne, dtype=torch.int32, device=dev)
        _gmm_case_run(torch, results, f"gmm[probe_e{ne}]", "gmm", x, w,
                      sizes, bf)
        del x, w
    skew = [1, 1, 1, 1, 0, 2048, 3, 1945]     # 4000 of 4096 rows
    gs = torch.tensor(skew, dtype=torch.int32, device=dev)
    for dtype in (bf, torch.float32):
        tag = "bf16" if dtype == bf else "f32"
        x = torch.randn(4096, 768, device=dev, generator=g).to(dtype)
        w = (0.03 * torch.randn(8, 768, 3072, device=dev,
                                generator=g)).to(dtype)
        dy = torch.randn(4096, 3072, device=dev, generator=g).to(dtype)
        _gmm_case_run(torch, results, f"gmm[skew_fwd_{tag}]", "gmm", x, w,
                      gs, dtype)
        _gmm_case_run(torch, results, f"gmm[skew_dx_{tag}]", "gmm_t", dy, w,
                      gs, dtype)
        _gmm_case_run(torch, results, f"tgmm[skew_dw_{tag}]", "tgmm", x, dy,
                      gs, dtype)
        del x, w, dy
    torch.cuda.empty_cache()
    results["gmm"] = dict(results["gmm[fwd_w1]"])
    results["tgmm"] = dict(results["tgmm[dw_w1]"])
    _moe_layer_without_sync(torch, dev)


def _moe_layer_without_sync(torch, dev):
    """One dropless MoE layer at the slice's widths (bf16, 8 x 1024 tokens,
    768 -> 3072, 8 experts, top-2), forward and backward, under
    ``torch.cuda.set_sync_debug_mode("error")``: any operation that waits
    for the device (a read of the group sizes on the host, a nonzero, a
    bincount) raises."""
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    layer = MoELayer(768, 3072, num_expert=8, top_k=2, dropless=True,
                     device=dev, dtype=torch.bfloat16,
                     generator=torch.Generator(device=dev).manual_seed(42))
    x = torch.randn(8, 1024, 768, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(43)) \
        .to(torch.bfloat16).requires_grad_()

    def step():
        out = layer(x)
        (out.float().square().mean() + layer.l_aux).backward()

    step()                        # loads the library, warms the allocator
    torch.cuda.synchronize()
    before = dict(K.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    used = {n: K.LAUNCHES[n] - before[n] for n in ("gmm", "tgmm")}
    finite = all(bool(torch.isfinite(p.grad).all())
                 for p in layer.parameters())
    print(f"  MoE layer [8 x 1024, 768 -> 3072, 8 experts] forward and "
          f"backward under set_sync_debug_mode('error'): no sync; launches "
          f"{used}; gradients finite: {finite}", flush=True)
    if used != {"gmm": 4, "tgmm": 4} or not finite:
        raise AssertionError("the MoE layer did not run through its kernels")
    del layer, x
    torch.cuda.empty_cache()


def _dropless(model):
    for block in model.transformer.h:
        if block.is_moe:
            block.mlp.dropless = True
    return model


def phase_tiny_gpt_training(torch):
    """A tiny float32 GPT-MoE (head_dim 64, 4 experts in every block,
    dropless) trained 3 steps on the card through the flash, gmm, tgmm and
    AdamW kernels against the port's CPU trainer (plain versions), held as
    the tiny Llama is: losses 1e-5 relative; weights within 1e-5 for 99.9%
    of the elements and 3 lr for all."""
    import numpy as np
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         load_numpy_state)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import SpmdTrainer
    cfg = GPTConfig.tiny(vocab_size=256, hidden_size=256, layers=2, heads=4,
                         seq=200, num_experts=4, moe_every=1)
    cpu = _dropless(GPTForCausalLM(cfg, device="cpu",
                                   generator=torch.Generator().manual_seed(9)))
    gpu = _dropless(GPTForCausalLM(cfg, device="cuda"))
    load_numpy_state(gpu, {n: p.detach().numpy()
                           for n, p in cpu.named_parameters()})
    ids = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (2, 200)))
    lr = 1e-3

    def run(model, x):
        tr = SpmdTrainer(model, AdamW(learning_rate=lr,
                                      parameters=model.parameters()),
                         lambda m, i, l: m.compute_loss(m(i), l))
        return [float(tr.train_step(x, x)) for _ in range(3)]

    want = run(cpu, ids)
    before = dict(K.LAUNCHES)
    got = run(gpu, ids.cuda())
    used = {n: K.LAUNCHES[n] - before[n] for n in K.LAUNCHES}
    close = total = 0
    worst = 0.0
    for (n, p), q in zip(cpu.named_parameters(), gpu.parameters()):
        d = (q.detach().cpu() - p.detach()).abs()
        worst = max(worst, float(d.max()))
        close += int((d <= 1e-5).sum())
        total += d.numel()
    loss_err = max(abs(a / b - 1) for a, b in zip(got, want))
    print(f"  tiny f32 GPT-MoE trained 3 steps on the card vs the CPU "
          f"trainer: losses {got} vs {want} (max rel err {loss_err:.3g}, "
          f"tol 1e-5); weights within 1e-5: {close}/{total}, worst "
          f"{worst:.3g} (tol {3 * lr}); launches {used}", flush=True)
    if not (loss_err <= 1e-5 and close >= 0.999 * total and worst <= 3 * lr
            and all(used[n] > 0 for n in ("flash_fwd", "flash_bwd_dq",
                                          "flash_bwd_dkv", "adamw", "gmm",
                                          "tgmm"))):
        raise AssertionError("GPT-MoE training on the card disagrees with "
                             "the CPU")


# -- phase 3 (FlashMask kernels) and packed documents ------------------------------

def _doc_ends(rng, seq, lo, hi):
    """End of each position's document: lengths uniform in [lo, hi] from
    ``rng``, packed to ``seq``, the last one cut."""
    ends, start = [], 0
    while start < seq:
        end = min(seq, start + int(rng.integers(lo, hi + 1)))
        ends += [end] * (end - start)
        start = end
    return ends


def _packed_batch(torch, ids, seed, lo=64, hi=1024):
    """(labels, startend [b, 1, s, 1] int32, ends [b, s] numpy) for ids
    [b, s]: each row packs documents of lengths uniform in [lo, hi] from
    ``numpy.random.default_rng(seed)``; LTS[j] = the end of column j's
    document; the labels are the ids with each document's first position
    (but 0) at -100, so no token is trained across a boundary."""
    import numpy as np
    b, s = ids.shape
    rng = np.random.default_rng(seed)
    ends = np.asarray([_doc_ends(rng, s, lo, hi) for _ in range(b)],
                      np.int32)
    first = np.zeros((b, s), bool)
    first[:, 1:] = ends[:, 1:] != ends[:, :-1]
    labels = ids.clone()
    labels[torch.from_numpy(first).to(ids.device)] = -100
    se = torch.from_numpy(ends[:, None, :, None].copy()).to(ids.device)
    return labels, se, ends


def _causal_doc_pairs(ends):
    """Visible (query, key) pairs of causal attention inside the documents
    whose per-position ends are ``ends`` [b, s]."""
    import numpy as np
    b, s = ends.shape
    i = np.arange(s)
    first = np.ones((b, s), bool)
    first[:, 1:] = ends[:, 1:] != ends[:, :-1]
    start = np.maximum.accumulate(np.where(first, i, 0), axis=1)
    return int((i - start + 1).sum())


def _tile_stats(torch, kinds, vis, h, tile):
    """The masked forward's own tile kinds (``kinds [b * h, nt, nt]`` int8
    over ``tile`` x ``tile`` tiles as it wrote them: 0 skipped, 1 partial,
    2 full, -1 outside its loops) held against the dense visibility
    ``vis [b, hb, s, s]``: every skipped
    tile holds no visible entry, every full tile only visible ones, and
    the heads that share bounds were classified alike. Returns the counts
    over every (b, bounds head): tiles visited, skipped, full, partial, and
    the visited tiles with no visible entry (what an exact test would
    skip)."""
    b, hb, s, _ = vis.shape
    nt = kinds.shape[-1]
    vis = torch.nn.functional.pad(vis, (0, nt * tile - s, 0, nt * tile - s))
    vis = vis.reshape(b, hb, nt, tile, nt, tile)
    seen, whole = vis.any(5).any(3), vis.all(5).all(3)
    kinds = kinds.view(b, hb, h // hb, nt, nt)
    if not bool((kinds == kinds[:, :, :1]).all()):
        raise AssertionError("heads that share bounds got other tile kinds")
    kinds = kinds[:, :, 0]
    if seen[kinds == 0].any() or not bool(whole[kinds == 2].all()):
        raise AssertionError("the kernel skipped a tile with a visible "
                             "entry or ran a tile with a masked entry as "
                             "full")
    visited = kinds >= 0
    return dict(visited=int(visited.sum()), skip=int((kinds == 0).sum()),
                full=int((kinds == 2).sum()),
                partial=int((kinds == 1).sum()),
                no_visible_entry=int((~seen & visited).sum()))


def _flashmask_case(torch, results, name, b, h, s, d, dtype, bounds, causal,
                    window, seed):
    """One FlashMask case: forward (out, lse) and backward (dq, dk, dv)
    against the plain versions (bf16: rows within 2 ulps and no further
    from float32 than plain bf16, 1.1x; float32 2e-5 forward, 1e-4 of
    max(1, |ref|) backward; lse 1e-3), rows that see no key exactly 0 with
    lse -1e30 and dq 0, the tile summary equal to its plain version, the
    forward's own tile kinds held against the mask (``_tile_stats``); then
    the times of the kernels, the plain versions and
    F.scaled_dot_product_attention with the dense boolean mask, and the
    bound from the visible pairs. Records ``results``."""
    import torch.nn.functional as TF
    from paddle_tpu_torch.kernels import flash_attention as FA
    dev = bounds.device
    bf16 = dtype == torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout = (torch.randn(b, h, s, d, device=dev, generator=g)
                     .to(dtype) for _ in range(4))
    vis = FA.flashmask_visible(bounds, s, s, causal, window)
    seen = vis.any(-1).expand(b, h, s)
    pairs = int(vis.sum()) * (h // bounds.shape[1])
    summary = FA.flashmask_summary(bounds)
    if not torch.equal(summary, FA.flashmask_summary_plain(bounds)):
        raise AssertionError(f"flashmask_summary[{name}] differs from its "
                             f"plain version")
    mask = dict(bounds=bounds, window=window, summary=summary)
    tile = FA.KIND_TILE[dtype]
    nt = -(-s // tile)
    kinds = torch.full((b * h, nt, nt), -1, dtype=torch.int8, device=dev)
    out, lse = FA.flash_forward(q, k, v, causal, tile_kinds=kinds, **mask)
    torch.cuda.synchronize()
    tiles = _tile_stats(torch, kinds, vis, h, tile)
    del kinds
    wout, wlse = FA.flash_forward_plain(q, k, v, causal, bounds=bounds,
                                        window=window)
    err_f = _check(f"flashmask_fwd[{name}] lse", lse, wlse, 1e-3)
    dist = {}
    if bf16:
        f32 = [x.float() for x in (q, k, v, dout)]
        out32, lse32 = FA.flash_forward_plain(*f32[:3], causal, bounds=bounds,
                                              window=window)
        err_f = max(err_f, _check_rows(f"flashmask_fwd[{name}]", out, wout,
                                       2))
        dist["out"] = _check_vs_f32(f"flashmask_fwd[{name}]", out, wout,
                                    out32)
    else:
        err_f = max(err_f, _check(f"flashmask_fwd[{name}]", out, wout,
                                  2e-5 * max(1.0, float(wout.abs().max()))))
    empty = int((~seen).sum())
    if out[~seen].any() or not bool((lse[~seen] == FA.NEG_INF).all()):
        raise AssertionError(f"flashmask_fwd[{name}]: a row that sees no "
                             f"key is not 0 with lse -1e30")
    del wout, wlse
    grads = FA.flash_backward(q, k, v, out, lse, dout, causal, **mask)
    torch.cuda.synchronize()
    want = FA.flash_backward_plain(q, k, v, out, lse, dout, causal,
                                   bounds=bounds, window=window)
    if grads[0][~seen].any():
        raise AssertionError(f"flashmask_bwd[{name}]: dq of a row that sees "
                             f"no key is not 0")
    ref32 = FA.flash_backward_plain(*f32[:3], out32, lse32, f32[3], causal,
                                    bounds=bounds, window=window) \
        if bf16 else None
    err_b = 0.0
    for i, (gname, got, ref) in enumerate(zip(("dq", "dk", "dv"), grads,
                                              want)):
        if bf16:
            err_b = max(err_b, _check_rows(f"flashmask_bwd[{name}] {gname}",
                                           got, ref, 2))
            dist[gname] = _check_vs_f32(f"flashmask_bwd[{name}] {gname}",
                                        got, ref, ref32[i])
        else:
            err_b = max(err_b, _check(
                f"flashmask_bwd[{name}] {gname}", got, ref,
                1e-4 * max(1.0, float(ref.abs().max()))))
    del grads, want, ref32
    if bf16:
        del f32, out32, lse32
    torch.cuda.empty_cache()
    esize = 2 if bf16 else 4
    peak = BF16_FLOPS if bf16 else FP32_FLOPS
    nb, nf_fwd = _flash_bytes_flops(b, h, s, s, d, causal, esize, False,
                                    pairs, bounds.numel() * 4)
    fwd_bound = _bound(nb, nf_fwd, peak)
    nb, nf_bwd = _flash_bytes_flops(b, h, s, s, d, causal, esize, True, pairs,
                                    bounds.numel() * 4)
    bwd_bound = _bound(nb, nf_bwd, peak)
    # the kernels' times leave out the pre-pass (timed on its own): the
    # model summarises the bounds once for all the calls of a step
    fwd_ms = _graph_ms(lambda: FA.flash_forward(q, k, v, causal, **mask),
                       iters=5, reps=3)
    bwd_ms = _graph_ms(lambda: FA.flash_backward(q, k, v, out, lse, dout,
                                                 causal, **mask),
                       iters=3, reps=3)
    fwd_plain = _time_ms(lambda: FA.flash_forward_plain(
        q, k, v, causal, bounds=bounds, window=window), 2, warmup=1)
    bwd_plain = _time_ms(lambda: FA.flash_backward_plain(
        q, k, v, out, lse, dout, causal, bounds=bounds, window=window), 2,
        warmup=1)
    torch.cuda.empty_cache()
    lib_fwd = _time_ms(lambda: TF.scaled_dot_product_attention(
        q, k, v, attn_mask=vis), 10)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

    def lib_train():
        TF.scaled_dot_product_attention(qg, kg, vg, attn_mask=vis) \
            .backward(dout)
    lib_both = _time_ms(lib_train, 10)
    frac = pairs / (b * h * s * s)
    causal_frac = pairs / (b * h * s * (s + 1) / 2)
    common = dict(shape=[b, h, s, d], dtype=str(dtype)[6:], causal=causal,
                  window=window, bound_heads=bounds.shape[1],
                  visible_pairs=pairs, visible_of_all=frac,
                  visible_of_causal=causal_frac, tile=tile, tiles=tiles,
                  rows_without_key=empty)
    results[f"flashmask_fwd[{name}]"] = dict(
        max_abs_err=err_f, ms=fwd_ms, plain_ms=fwd_plain,
        bound_ms=fwd_bound[0], bound_by=fwd_bound[1], library_ms=lib_fwd,
        tflops=_tflops(nf_fwd, fwd_ms), l2_from_f32=dist.get("out"),
        **common)
    # no single library call is the backward alone: its time is the
    # library's forward+backward less its forward
    results[f"flashmask_bwd[{name}]"] = dict(
        max_abs_err=err_b, ms=bwd_ms, plain_ms=bwd_plain,
        bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
        library_ms=lib_both - lib_fwd, library_fwd_bwd_ms=lib_both,
        tflops=_tflops(nf_bwd, bwd_ms),
        l2_from_f32={n: dist.get(n) for n in ("dq", "dk", "dv")}, **common)
    print(f"  flashmask[{name}] {[b, h, s, d]} {str(dtype)[6:]} "
          f"{'causal' if causal else 'non-causal'} window {window}, bounds "
          f"heads {bounds.shape[1]}: visible pairs {frac:.4f} of all, "
          f"{causal_frac:.4f} of the causal; rows without a key {empty}; "
          f"{tile} x {tile} tiles visited {tiles['visited']}: skipped "
          f"{tiles['skip']} "
          f"({tiles['skip'] / max(tiles['visited'], 1):.4f}), full "
          f"{tiles['full']}, partial {tiles['partial']} (with no visible "
          f"entry: {tiles['no_visible_entry']}); forward ms={fwd_ms:.4f} "
          f"({_tflops(nf_fwd, fwd_ms):.1f} TFLOP/s of the visible pairs) "
          f"plain_ms={fwd_plain:.4f} bound_ms={fwd_bound[0]:.4f} "
          f"({fwd_bound[1]}) sdpa_mask_ms={lib_fwd:.4f}; backward ms="
          f"{bwd_ms:.4f} ({_tflops(nf_bwd, bwd_ms):.1f} TFLOP/s) plain_ms="
          f"{bwd_plain:.4f} bound_ms="
          f"{bwd_bound[0]:.4f} ({bwd_bound[1]}) sdpa_mask fwd+bwd ms="
          f"{lib_both:.4f}", flush=True)
    del q, k, v, dout, out, lse, qg, kg, vg, vis, summary, mask
    torch.cuda.empty_cache()


def phase_flashmask_kernels(torch, results, seed):
    """The FlashMask kernels (tile-summary pre-pass, forward, dq and dk/dv)
    against their plain versions: bench.py's flashmask_probe shape
    ([4, 16, 2048, 64] bf16, causal documents of 256), the packed slice's
    ([8, 16, 2048, 128] bf16 with phase 7's bounds, and with bounds that
    mask nothing beyond causal, against the dense kernel's time), float32
    cases (non-causal 4-column random bands at a ragged length, causal
    2-column bands with a window of 100, bounds per head, rows that see no
    key) and bf16 ones (the random bands at a ragged length, documents at
    a ragged length with d 128, rows that see no key)."""
    import numpy as np
    from paddle_tpu_torch.kernels import flash_attention as FA
    from paddle_tpu_torch.nn.functional import _canonical_startend
    dev = torch.device("cuda")
    card = _card_line()
    print(f"phase 3: FlashMask kernels against their plain versions (as "
          f"flash: bf16 each row within 2 bf16 ulps of the row's largest "
          f"plain value and no further from float32 than the plain bf16 "
          f"version, within 1.1x; float32 2e-5, backward 1e-4 of max(1, "
          f"|ref|); lse 1e-3; a row that sees no key exactly 0 with lse "
          f"-1e30) [{card}]", flush=True)
    rng = np.random.default_rng(seed + 5)
    j = np.arange(2048)
    probe = np.broadcast_to(((j // 256 + 1) * 256).astype(np.int32)
                            [None, None, :, None], (4, 1, 2048, 1))
    _, slice_se, _ = _packed_batch(torch, torch.zeros(8, 2048,
                                                      dtype=torch.long), seed)
    # bounds that mask nothing: the masked kernels' own cost against the
    # dense kernels' at the slice's shape (phase 3 times both)
    no_mask = np.full((8, 1, 2048, 1), 2048, np.int32)
    s = 333
    lts, uts = rng.integers(1, s, (1, 2, s, 1)), rng.integers(0, s,
                                                              (1, 2, s, 1))
    bands4 = np.concatenate([lts, np.minimum(lts + rng.integers(
        0, 64, (1, 2, s, 1)), s), uts, np.minimum(uts + rng.integers(
            0, 64, (1, 2, s, 1)), s)], -1)
    lts = rng.integers(1, 512, (1, 2, 512, 1))
    bands2 = np.concatenate([lts, np.minimum(lts + rng.integers(
        0, 512, (1, 2, 512, 1)), 512)], -1)
    per_head = np.asarray([[_doc_ends(rng, 384, 30, 150) for _ in range(4)]
                           for _ in range(2)])[..., None]
    empty = np.broadcast_to(np.asarray([90, 150, 90, 150]), (1, 1, 256, 4))
    docs600 = np.asarray([[_doc_ends(rng, 600, 30, 150)]
                          for _ in range(2)])[..., None]
    f32, bf = torch.float32, torch.bfloat16
    cases = [  # name, b, h, s, d, dtype, startend, causal, window
        ("probe", 4, 16, 2048, 64, bf, probe, True, None),
        ("slice", 8, 16, 2048, 128, bf, slice_se.numpy(), True, None),
        ("slice_no_mask", 8, 16, 2048, 128, bf, no_mask, True, None),
        ("f32_noncausal_4", 1, 2, 333, 64, f32, bands4, False, None),
        ("f32_causal_2_window", 1, 2, 512, 128, f32, bands2, True,
         (100, None)),
        ("f32_per_head", 2, 4, 384, 64, f32, per_head, True, None),
        ("f32_empty_rows", 1, 2, 256, 64, f32, empty, False, (-1, None)),
        # bf16 at ragged lengths (d 64 and 128), non-causal, rows without
        # a key (the masked kernels take sq == sk only)
        ("bf16_noncausal_4_ragged", 1, 2, 333, 64, bf, bands4, False, None),
        ("bf16_docs_ragged", 2, 4, 600, 128, bf, docs600, True, None),
        ("bf16_empty_rows", 1, 2, 256, 64, bf, empty, False, (-1, None)),
    ]
    for i, (name, b, h, s, d, dtype, se, causal, window) in enumerate(cases):
        bounds = _canonical_startend(
            torch.from_numpy(np.ascontiguousarray(se, np.int32)), s,
            causal).to(dev)
        _flashmask_case(torch, results, name, b, h, s, d, dtype, bounds,
                        causal, window, seed + 50 + i)
        if name == "slice":
            summ_plain = _time_ms(lambda: FA.flashmask_summary_plain(bounds),
                                  5)
            nk = -(-s // FA.TILE)
            # one PyTorch call for the same function (s divides into
            # TILE-column tiles here): the min and max of each bound over
            # each tile, in another order of the 8 values
            tiles_of = bounds.view(b, bounds.shape[1], nk, FA.TILE, 4)
            lo, hi = torch.aminmax(tiles_of, dim=3)
            want = FA.flashmask_summary_plain(bounds).view(*lo.shape, 2)
            if not (torch.equal(lo, want[..., 0])
                    and torch.equal(hi, want[..., 1])):
                raise AssertionError("torch.aminmax is not the pre-pass's "
                                     "function")
            results["flashmask_summary"] = dict(
                max_abs_err=0.0,
                ms=_graph_ms(lambda: FA.flashmask_summary(bounds)),
                plain_ms=summ_plain,
                # the bounds read once, the summary written once; a min and
                # a max an element (int32, counted at the fp32 rate)
                **dict(zip(("bound_ms", "bound_by"), _bound(
                    bounds.numel() * 4 + b * nk * 32, 2 * bounds.numel(),
                    FP32_FLOPS))),
                library_ms=_graph_ms(lambda: torch.aminmax(tiles_of, dim=3)),
                library_call=f"torch.aminmax over [b, hb, nk, {FA.TILE}, 4], "
                             f"dim 3")
    for name in ("f32_empty_rows", "bf16_empty_rows"):
        if not results[f"flashmask_fwd[{name}]"]["rows_without_key"]:
            raise AssertionError(f"{name} has no row without a key")
    for name in ("fwd", "bwd"):
        results[f"flashmask_{name}"] = dict(results[f"flashmask_{name}[slice]"])
    m = results["flashmask_summary"]
    print(f"  flashmask_summary [8, 1, 2048, 4]: ms={m['ms']:.4f} plain_ms="
          f"{m['plain_ms']:.4f} bound_ms={m['bound_ms']:.4f} "
          f"({m['bound_by']}) library_ms={m['library_ms']:.4f} "
          f"({m['library_call']})", flush=True)


# -- phase 5: full-width training -------------------------------------------------

def _llama_1b(layers=22):
    from paddle_tpu_torch.models import LlamaConfig
    return LlamaConfig(vocab_size=32000, hidden_size=2048,
                       intermediate_size=5632, num_hidden_layers=layers,
                       num_attention_heads=16, num_key_value_heads=16,
                       max_position_embeddings=2048)


def _trainer_for(torch, model, lr=1e-4):
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import SpmdTrainer
    return SpmdTrainer(
        model, AdamW(learning_rate=lr, parameters=model.parameters(),
                     weight_decay=0.01),
        lambda m, ids, labels, se=None: m.forward_loss(
            ids, labels, loss_chunk_size=256, attn_startend_row_indices=se),
        remat_layers=list(model.model.layers), remat_policy="full")


def _llama_train_per_step(n_l, packed=False):
    """The kernel launches of one Llama training step with every layer
    remat'd (full, dots or dots_no_batch: all three recompute the norms,
    RoPE, the flash forward and SwiGLU): each layer's two norms, RoPE,
    flash forward and SwiGLU in the forward and again in the recompute,
    the final norm once, the backward of each norm, RoPE, flash and SwiGLU
    once, one AdamW launch."""
    from paddle_tpu_torch import kernels as K
    per_step = {n: 0 for n in K.LAUNCHES}
    per_step.update(rms_norm=2 * n_l + 1 + 2 * n_l, rope=3 * n_l, adamw=1,
                    rms_norm_bwd=2 * n_l + 1, swiglu_fwd=2 * n_l,
                    swiglu_bwd=n_l)
    if packed:       # the pre-pass runs once, in the model's forward
        per_step.update(flashmask_fwd=2 * n_l, flashmask_bwd_dq=n_l,
                        flashmask_bwd_dkv=n_l, flashmask_summary=1)
    else:
        per_step.update(flash_fwd=2 * n_l, flash_bwd_dq=n_l,
                        flash_bwd_dkv=n_l)
    return per_step


def phase_training(torch, args, launches_out, packed=False):
    """The llama-1.1b-b8 recipe of bench.py at full width: bf16 weights
    (model.bfloat16()), fp32 moments, AdamW lr 1e-4 wd 0.01, full remat of
    every layer, chunked cross entropy of 256, batch 8 x 2048 random ids as
    input and label; 2 warm-up and 5 timed steps. ``packed`` (phase 7):
    each row packs documents of lengths uniform in [64, 1024]
    (``_packed_batch``), attention stays inside each document through the
    FlashMask kernels, and labels are cut at the boundaries."""
    import numpy as np
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models import LlamaForCausalLM
    card = _card_line()
    cfg = _llama_1b()
    batch, seq = 8, 2048
    print(f"phase {7 if packed else 5}: llama-1.1b-b8 training"
          f"{' on packed documents' if packed else ''} (hidden "
          f"{cfg.hidden_size}, {cfg.num_hidden_layers} layers, "
          f"{cfg.num_attention_heads} heads, vocab {cfg.vocab_size}, batch "
          f"{batch} x {seq}) bf16 weights, fp32 moments, seed {args.seed} "
          f"[{card}]", flush=True)
    torch.cuda.reset_peak_memory_stats()
    model = LlamaForCausalLM(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(args.seed))
    model.bfloat16()
    n_params = model.num_params()
    trainer = _trainer_for(torch, model)
    ids = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (batch, seq))).cuda()
    batch_ = (ids, ids)
    visible = None
    if packed:
        labels, se, ends = _packed_batch(torch, ids, args.seed)
        batch_ = (ids, labels, se)
        pairs = _causal_doc_pairs(ends)
        visible = dict(pairs=pairs, of_causal=pairs / (batch * seq * (seq + 1)
                                                       / 2),
                       documents=int(sum(len(np.unique(e)) for e in ends)),
                       labels_cut=int((labels == -100).sum()))
        print(f"  packed documents: {visible['documents']} over {batch} "
              f"rows; visible (query, key) pairs {pairs} = "
              f"{visible['of_causal']:.4f} of the causal pairs", flush=True)
    losses = []
    for _ in range(2):      # the first call runs the step, then captures it
        losses.append(float(trainer.train_step(*batch_)))
    trainer.block()
    K.reset_launches()
    t0 = time.monotonic()
    timed = [trainer.train_step(*batch_) for _ in range(5)]
    trainer.block()
    secs = time.monotonic() - t0
    launches = dict(K.LAUNCHES)
    losses += [float(x) for x in timed]
    graph = _graph_line(trainer, "phase 7" if packed else "phase 5", card)
    n_l = cfg.num_hidden_layers
    per_step = _llama_train_per_step(n_l, packed)
    expect = {k: 5 * v for k, v in per_step.items()}
    print(f"  launches over 5 steps: {launches} (expected {expect}: per step "
          f"{per_step})", flush=True)
    _nothing_routed(launches, f"phase {7 if packed else 5}")
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    launches_out.update(launches)
    step_ms = 1e3 * secs / 5
    tok_s = batch * seq / (secs / 5)
    mfu = model.flops_per_token(seq) * tok_s / BF16_FLOPS
    if packed:
        # the same count with the attention products over the visible
        # pairs only (4 * hidden flops a pair a layer forward, x3 with the
        # backward), in place of the dense-causal s / 2 a row
        attn = 6.0 * n_l * cfg.hidden_size * seq * batch * seq
        done = model.flops_per_token(seq) * batch * seq - attn \
            + 12.0 * n_l * cfg.hidden_size * visible["pairs"]
        visible["mfu_vs_989_tflops"] = done / (secs / 5) / BF16_FLOPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  losses {losses}", flush=True)
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    # MFU with the model's dense-causal flops_per_token in both phases, so
    # the two compare; packed documents do fewer attention flops
    training = dict(params=n_params, batch=batch, seq=seq, step_ms=step_ms,
                    tokens_per_s=tok_s,
                    mfu_vs_989_tflops=mfu, peak_memory_gb=peak_gb,
                    losses=losses, card=card, visible=visible, graph=graph)
    print("  training: " + json.dumps(training), flush=True)
    if packed:
        print(f"  MFU {mfu:.4f} with the dense-causal attention count (as "
              f"phase 5), {visible['mfu_vs_989_tflops']:.4f} with the "
              f"attention over the visible pairs", flush=True)
    prof, training["breakdown"] = _profile(
        torch, lambda: trainer.train_step(*batch_), 1)
    _save_trace(prof, os.path.join(
        args.out, f"{'packed_' if packed else ''}train_step_trace.json"))
    m = training["breakdown"]
    training["idle_share_untraced"] = 1 - m["device_ms"] / step_ms
    print(f"  train step breakdown: wall {m['wall_ms']:.3f} ms, device "
          f"{m['device_ms']:.3f} ms (idle share {m['idle_share']:.3f}), "
          f"{m['device_launches']:.0f} kernels; by group (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in m["by_group_ms"].items()),
          flush=True)
    for name, ms in m["top_kernels_ms"].items():
        print(f"    {ms:9.3f} ms {m['top_kernels_launches'][name]:5.0f}x  "
              f"{name}", flush=True)
    tag = "phase 7" if packed else "phase 5"
    _print_other(m, f"{tag} captured step")
    del prof
    training["eager"] = _captured_against_eager(torch, trainer, batch_, tag,
                                                card, step_ms, m)
    if not packed:
        training["tf32_head"] = _tf32_run(torch, trainer, batch_, card)
    del trainer, model, ids, timed, batch_
    _free(torch)
    training.update(_train_step_agreement(torch, args.seed, packed))
    return training


def _graph_line(trainer, tag, card):
    """The trainer's one captured graph: its memory pool, capture seconds
    (the eager step and the capture) and the launches a replay adds."""
    if len(trainer._graphs) != 1:
        raise AssertionError(f"{tag}: {len(trainer._graphs)} graphs, not "
                             f"one for the one batch signature")
    (cap,) = trainer._graphs.values()
    graph = dict(pool_gb=cap.pool_bytes / 1e9, capture_s=cap.seconds,
                 tally={k: v for k, v in cap.tally.items() if v})
    print(f"  {tag}: one captured graph, its pool {graph['pool_gb']:.3f} GB,"
          f" the first call (eager step and capture) {cap.seconds:.2f} s; a "
          f"replay adds {graph['tally']} to the launch counts [{card}]",
          flush=True)
    return graph


def _state_snapshot(torch, trainer):
    """The trainer's parameters, buffers, optimizer state and step count,
    copied on the card."""
    model = trainer.model
    return ({n: p.detach().clone() for n, p in model.named_parameters()},
            {n: b.detach().clone() for n, b in model.named_buffers()},
            trainer.opt.state_dict(), trainer.opt._global_step)


def _state_restore(torch, trainer, snap):
    params, buffers, opt_state, step = snap
    with torch.no_grad():
        for n, p in trainer.model.named_parameters():
            p.copy_(params[n])
        for n, b in trainer.model.named_buffers():
            b.copy_(buffers[n])
    trainer.opt.set_state_dict(opt_state)
    trainer.opt._global_step = step


def _captured_against_eager(torch, trainer, batch, tag, card, step_ms,
                            captured, n=3, checked=None):
    """From one snapshot of the trainer's weights, buffers and optimizer
    state, ``n`` steps replayed from its graph, then (the graph and its
    pool dropped, the snapshot loaded back in place, the random state
    restored) ``n`` steps of the same trainer op by op (``_step_eager``):
    each loss, every parameter, moment and buffer (BatchNorm's running
    statistics) after the last, bit-equal. One model and no twin: a
    full-width model's activations (the UNet's) fit once, not twice. Returns the eager
    step ms (mean of steps 2..n, host clock), a profile of one eager step
    and its idle share (``checked``: as ``_profile``'s)."""
    from paddle_tpu_torch.framework import random as R
    snap = _state_snapshot(torch, trainer)
    rng = R.get_rng_state()
    got = [trainer.train_step(*batch) for _ in range(n)]
    trainer.block()
    after = _state_snapshot(torch, trainer)
    _state_restore(torch, trainer, snap)
    del snap
    R.set_rng_state(rng)
    trainer._drop_graphs()
    _free(torch)
    want, secs = [], []
    for _ in range(n):
        t = time.monotonic()
        want.append(trainer._step_eager(*batch))
        trainer.block()
        secs.append(time.monotonic() - t)
    params, buffers, opt_state, _ = after
    same_loss = [bool(torch.equal(a, c)) for a, c in zip(got, want)]
    differ = [k for k, p in trainer.model.named_parameters()
              if not torch.equal(p, params[k])]
    bdiffer = [k for k, b in trainer.model.named_buffers()
               if not torch.equal(b, buffers[k])]
    mine = trainer.opt.state_dict()["accumulators"]
    sdiffer = [k for k, acc in opt_state["accumulators"].items()
               if not all(torch.equal(v, mine[k][s]) for s, v in acc.items()
                          if torch.is_tensor(v))]
    print(f"  {tag}: {n} replayed steps against {n} eager ones from one "
          f"snapshot: losses {[float(x) for x in got]} vs "
          f"{[float(x) for x in want]} (bit-equal {same_loss}); parameters "
          f"differing {len(differ)} of {len(params)}, optimizer states "
          f"differing {len(sdiffer)}, buffers differing {len(bdiffer)} of "
          f"{len(buffers)}", flush=True)
    if not all(same_loss) or differ or sdiffer or bdiffer:
        raise AssertionError(f"{tag}: the captured step is not the eager "
                             f"step bit for bit ({differ[:3]}, {sdiffer[:3]}"
                             f", {bdiffer[:3]})")
    n_buffers = len(buffers)
    del after, params, buffers, opt_state
    eager_ms = 1e3 * sum(secs[1:]) / (n - 1)
    _, m = _profile(torch, lambda: trainer._step_eager(*batch), 1, checked)
    out = dict(step_ms=eager_ms, bit_equal=True, breakdown=m,
               idle_share_untraced=1 - m["device_ms"] / eager_ms,
               buffers_compared=n_buffers)
    print(f"  {tag}: step ms captured {step_ms:.3f}, eager {eager_ms:.3f}; "
          f"idle share against the untraced step: captured "
          f"{1 - captured['device_ms'] / step_ms:.4f}, eager "
          f"{out['idle_share_untraced']:.4f}; device ms captured "
          f"{captured['device_ms']:.3f} ({captured['device_launches']:.0f} "
          f"kernels), eager {m['device_ms']:.3f} "
          f"({m['device_launches']:.0f}) [{card}]", flush=True)
    return out


def _tf32_run(torch, trainer, batch, card):
    """The fp32 head (the chunked loss's logits and their gradients)
    under TF32: the step captured anew with
    ``torch.backends.cuda.matmul.allow_tf32`` set (cuBLAS picks its
    kernels at capture), 2 warm-up and 5 timed steps, then the setting
    reset and the graph dropped. A measurement only: the port has no
    such option."""
    trainer._drop_graphs()
    _free(torch)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for _ in range(2):
            trainer.train_step(*batch)
        trainer.block()
        t0 = time.monotonic()
        for _ in range(5):
            trainer.train_step(*batch)
        trainer.block()
        ms = 1e3 * (time.monotonic() - t0) / 5
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        trainer._drop_graphs()
        _free(torch)
    print(f"  phase 5 under TF32 matmuls (the fp32 head): step ms {ms:.3f}"
          f" captured [{card}]", flush=True)
    return dict(step_ms=ms)


def _plain_fusion_patches(stack):
    """Dropout, LayerNorm (with its dropout and residual), the dense
    attention's middle and GroupNorm (with its SiLU) through their plain
    versions: the same masks (the plain Philox is the kernels')."""
    from paddle_tpu_torch.kernels import dropout as D
    from paddle_tpu_torch.kernels import fused

    def dropout_plain(x, key, p, mode="upscale_in_train", mask_shape=None):
        return D.dropout_plain(x, p, key, mode, mask_shape)
    stack.enter_context(mock.patch.object(D, "dropout", dropout_plain))
    stack.enter_context(mock.patch.object(
        fused, "dropout_add_layer_norm", fused.dropout_add_layer_norm_plain))
    from paddle_tpu_torch.kernels import dense_attention as DA

    def dense_plain(scores, mask=None, causal=False, scale=1.0, p=0.0,
                    key=None):
        return DA.dense_softmax_plain(scores, mask, causal, scale,
                                      p if key is not None else 0.0, key)[1]
    stack.enter_context(mock.patch.object(DA, "dense_softmax", dense_plain))
    from paddle_tpu_torch.kernels import group_norm as GN
    stack.enter_context(mock.patch.object(GN, "group_norm",
                                          GN.group_norm_plain))


def _plain_train_patches(stack):
    """Route the training step through the plain versions (the wrappers
    would launch the kernels on CUDA tensors)."""
    from paddle_tpu_torch.kernels import flash_attention as FA
    from paddle_tpu_torch.kernels import fused
    stack.enter_context(mock.patch.object(fused, "rms_norm",
                                          fused.rms_norm_plain))
    stack.enter_context(mock.patch.object(fused, "fused_rope",
                                          fused.fused_rope_plain))
    stack.enter_context(mock.patch.object(fused, "swiglu",
                                          fused.swiglu_plain))
    stack.enter_context(mock.patch.object(fused, "rms_norm_backward",
                                          fused.rms_norm_backward_plain))
    _plain_fusion_patches(stack)

    def plain(fn):      # the summary is the kernels' alone
        return lambda *a, summary=None, **kw: fn(*a, **kw)
    stack.enter_context(mock.patch.object(FA, "flash_forward",
                                          plain(FA.flash_forward_plain)))
    stack.enter_context(mock.patch.object(FA, "flash_backward",
                                          plain(FA.flash_backward_plain)))
    stack.enter_context(mock.patch.object(FA, "flashmask_summary",
                                          FA.flashmask_summary_plain))


def _sq_dists(a, b):
    """({name: squared L2 distance}, {name: squared L2 norm of b}) of two
    {name: gradient} maps, b the reference."""
    return ({n: float((a[n] - b[n]).norm()) ** 2 for n in b},
            {n: float(b[n].norm()) ** 2 for n in b})


def _rel_dist(a, b):
    """(relative L2 distance over all, {name: relative L2 distance}) of
    two {name: gradient} maps, b the reference."""
    sq, ref = _sq_dists(a, b)
    return (math.sqrt(sum(sq.values()) / sum(ref.values())),
            {n: math.sqrt(sq[n] / ref[n]) for n in b})


SMALL_LEAF = 16      # a parameter of fewer elements: a handful of roundings


def _leaf_ratios(leaf_k, leaf_p, sizes, err_p, skip_exact=False):
    """({name: the kernel path's distance from float32 over the plain
    path's}, {name: (elements, kernel distance, plain distance)} of the
    parameters of fewer than SMALL_LEAF elements). Such a parameter (ERNIE's
    2-way ``nsp_head.bias``, whose two gradients are one value and its
    negative; the UNet's 4-channel ``conv_out.bias``) carries one rounding
    or a few, and the ratio of two paths' roundings of one value swings
    either way by seed (PERF.md, Findings): its ratio is over the larger of
    its own plain distance and the plain path's over all (``err_p``), and
    its readings are printed. ``skip_exact``: leave out a parameter the
    plain path gives exactly."""
    ratio, small = {}, {}
    for n, p in leaf_p.items():
        if skip_exact and p == 0:
            continue
        if sizes[n] < SMALL_LEAF:
            small[n] = (sizes[n], leaf_k[n], p)
            p = max(p, err_p)
        ratio[n] = leaf_k[n] / p
    return ratio, small


def _small_leaves_line(small):
    return "; ".join(f"{n} ({e} elements) kernels {k:.4g} plain {p:.4g}"
                     for n, (e, k, p) in small.items()) or "none"


def _worst_leaves(leaf_k, leaf_p, sizes, n=4):
    """The ``n`` parameters of the largest ratio of their own distances
    (kernels over plain), with their sizes (read over seeds by
    ``paddle_tpu_torch/tools/agreement_seeds.py``)."""
    own = {k: leaf_k[k] / leaf_p[k] for k in leaf_p if leaf_p[k] > 0}
    return "; ".join(f"{k} ({sizes[k]}) {own[k]:.4g}" for k in sorted(
        own, key=own.get, reverse=True)[:n])


def _train_step_agreement(torch, seed, packed=False):
    """One forward + backward of the 1.1B widths at 2 layers (batch 1 x
    2048) through the kernels and through the plain versions, in bf16 and
    in float32 (the same bf16-valued weights, upcast); ``packed``: on
    packed documents (FlashMask bounds, labels cut at the boundaries).
    float32: the paths differ only in summation order, so the loss agrees
    to 1e-5 relative and the gradients to 1e-3 relative (L2 over all of
    them). bf16: both paths round at the same places, so the kernel path's
    gradients must be no further from the float32 step than the plain bf16
    path's: within 1.1x over all of them, and within 1.25x for each
    parameter."""
    import numpy as np
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models import LlamaForCausalLM, load_numpy_state
    cfg = _llama_1b(layers=2)
    ids = torch.from_numpy(np.random.default_rng(seed + 2).integers(
        0, cfg.vocab_size, (1, 2048))).cuda()
    labels, se = ids, None
    if packed:
        labels, se, _ = _packed_batch(torch, ids, seed + 2)
    attn = "flashmask_fwd" if packed else "flash_fwd"
    base = LlamaForCausalLM(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(seed + 2))
    base.bfloat16()
    state = {n: p.detach() for n, p in base.named_parameters()}

    def run(dtype, plain):
        model = LlamaForCausalLM(cfg, device="cuda")
        if dtype == torch.bfloat16:
            model.bfloat16()
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(state[n].to(dtype))
        before = dict(K.LAUNCHES)
        with ExitStack() as stack:
            if plain:
                _plain_train_patches(stack)
            loss = model.forward_loss(ids, labels, loss_chunk_size=256,
                                      attn_startend_row_indices=se).float()
            loss.backward()
            torch.cuda.synchronize()
        if plain and K.LAUNCHES != before:
            raise AssertionError("the plain step launched a kernel")
        for name in (attn, "rms_norm_bwd", "swiglu_fwd", "swiglu_bwd"):
            if not plain and K.LAUNCHES[name] == before[name]:
                raise AssertionError(f"the kernel step launched no {name}")
        grads = {n: p.grad.float() for n, p in model.named_parameters()}
        return float(loss.detach()), grads

    lk32, gk32 = run(torch.float32, False)
    lp32, gp32 = run(torch.float32, True)
    err32, _ = _rel_dist(gk32, gp32)
    del gk32
    lk16, gk16 = run(torch.bfloat16, False)
    err_k, leaf_k = _rel_dist(gk16, gp32)
    del gk16
    lp16, gp16 = run(torch.bfloat16, True)
    err_p, leaf_p = _rel_dist(gp16, gp32)
    del gp16
    tf32 = None
    if not packed:
        # the kernels' bf16 step with the fp32 head's products in TF32: a
        # measurement for the TF32 question (no gate; the port has no such
        # option)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            lt, gt = run(torch.bfloat16, False)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        err_t, leaf_t = _rel_dist(gt, gp32)
        worst_t = max(leaf_t, key=lambda n: leaf_t[n] / leaf_p[n])
        tf32 = dict(loss=lt, grad_err=err_t, grad_err_plain=err_p,
                    worst_param=worst_t,
                    worst_param_ratio=leaf_t[worst_t] / leaf_p[worst_t])
        print(f"  2-layer bf16 step with TF32 matmuls: loss {lt:.6f}, the "
              f"gradients' relative L2 distance from the float32 step "
              f"{err_t:.5g} (kernels without TF32 {err_k:.5g}, plain "
              f"{err_p:.5g}); per parameter the largest ratio to plain "
              f"{tf32['worst_param_ratio']:.4g} at {worst_t} (recorded, "
              f"not gated)", flush=True)
        del gt
    del gp32
    torch.cuda.empty_cache()
    ratio = {n: leaf_k[n] / leaf_p[n] for n in leaf_p}
    worst = max(ratio, key=ratio.get)
    loss32 = abs(lk32 / lp32 - 1)
    print(f"  {'packed ' if packed else ''}train step kernels vs plain "
          f"(1.1B widths, 2 layers, 1 x 2048): "
          f"float32 loss {lk32:.6f} vs {lp32:.6f} (rel err {loss32:.3g}, tol "
          f"1e-5), grads rel L2 err {err32:.3g} (tol 1e-3); bf16 loss "
          f"kernels {lk16:.6f} plain {lp16:.6f}, grads' rel L2 distance from "
          f"the float32 step: kernels {err_k:.5g}, plain {err_p:.5g} (tol: "
          f"kernels <= 1.1 x plain); per parameter, the largest ratio "
          f"kernels / plain {ratio[worst]:.4g} at {worst} (tol 1.25)",
          flush=True)
    for n in leaf_p:
        print(f"    {n}: kernels {leaf_k[n]:.5g} plain {leaf_p[n]:.5g}",
              flush=True)
    if not (loss32 <= 1e-5 and err32 <= 1e-3 and err_k <= 1.1 * err_p
            and max(ratio.values()) <= 1.25
            and all(math.isfinite(x) for x in (lk16, lp16, err_k, err_p))):
        raise AssertionError(f"the kernel {'packed ' if packed else ''}"
                             f"train step disagrees with the plain step")
    return dict(train_step_loss_rel_err_f32=loss32,
                train_step_grad_rel_err_f32=err32,
                train_step_bf16_grad_err_kernels=err_k,
                train_step_bf16_grad_err_plain=err_p,
                train_step_bf16_grad_err_ratio_worst_param=ratio[worst],
                train_step_tf32=tf32)


# -- phase 6: GPT-MoE training at full width ------------------------------------

def _gpt_trainer_for(model, lr=1e-4):
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import SpmdTrainer
    return SpmdTrainer(
        model, AdamW(learning_rate=lr, parameters=model.parameters(),
                     weight_decay=0.01),
        lambda m, ids, labels: m.compute_loss(m(ids), labels))


def phase_gpt_moe_training(torch, args, launches_out):
    """GPTConfig.gpt_moe(8) at full width (GPT-2-small widths, 8 experts
    top-2 in every second block, dropless): bf16 weights
    (model.bfloat16()), fp32 moments, AdamW lr 1e-4 wd 0.01, no remat,
    batch 8 x 1024 random ids as input and label, random weights from the
    seed; 2 warm-up and 5 timed steps."""
    import numpy as np
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    card = _card_line()
    cfg = GPTConfig.gpt_moe(8)
    batch, seq = 8, cfg.max_position_embeddings
    print(f"phase 6: GPT-MoE training (hidden {cfg.hidden_size}, "
          f"{cfg.num_hidden_layers} layers, {cfg.num_attention_heads} heads, "
          f"vocab {cfg.vocab_size}, {cfg.num_experts} experts top-"
          f"{cfg.moe_top_k} every {cfg.moe_every} blocks, dropless; batch "
          f"{batch} x {seq}) bf16 weights, fp32 moments, seed {args.seed} "
          f"[{card}]", flush=True)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()   # left by earlier phases
    model = _dropless(GPTForCausalLM(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(args.seed)))
    model.bfloat16()
    n_params = model.num_params()
    trainer = _gpt_trainer_for(model)
    ids = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (batch, seq))).cuda()
    losses = []
    for _ in range(2):      # the first call runs the step, then captures it
        losses.append(float(trainer.train_step(ids, ids)))
    trainer.block()
    K.reset_launches()
    t0 = time.monotonic()
    timed = [trainer.train_step(ids, ids) for _ in range(5)]
    trainer.block()
    secs = time.monotonic() - t0
    launches = dict(K.LAUNCHES)
    losses += [float(x) for x in timed]
    graph = _graph_line(trainer, "phase 6", card)
    n_l = cfg.num_hidden_layers
    n_moe = sum(b.is_moe for b in model.transformer.h)
    per_step = {n: 0 for n in K.LAUNCHES}
    # LayerNorm: two a block and the final one, forward and backward
    per_step.update(flash_fwd=n_l, flash_bwd_dq=n_l, flash_bwd_dkv=n_l,
                    adamw=1, gmm=4 * n_moe, tgmm=4 * n_moe,
                    dropout_add_ln=2 * n_l + 1, dropout_add_ln_bwd=2 * n_l + 1,
                    dropout_add_ln_bwd_warp=2 * n_l + 1)
    expect = {k: 5 * v for k, v in per_step.items()}
    print(f"  launches over 5 steps: {launches} (expected {expect}: per step "
          f"{per_step})", flush=True)
    _nothing_routed(launches, "phase 6")
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    launches_out.update(launches)
    step_ms = 1e3 * secs / 5
    tok_s = batch * seq / (secs / 5)
    mfu = model.flops_per_token(seq) * tok_s / BF16_FLOPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  losses {losses}", flush=True)
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    training = dict(params=n_params, batch=batch, seq=seq, step_ms=step_ms,
                    tokens_per_s=tok_s,
                    flops_per_token=model.flops_per_token(seq),
                    mfu_vs_989_tflops=mfu, peak_memory_gb=peak_gb,
                    peak_memory_of_phase_gb=peak_gb - held / 1e9,
                    losses=losses, card=card, graph=graph)
    print("  gpt_moe training: " + json.dumps(training), flush=True)
    prof, training["breakdown"] = _profile(
        torch, lambda: trainer.train_step(ids, ids), 1)
    _save_trace(prof, os.path.join(args.out,
                                          "gpt_moe_train_step_trace.json"))
    m = training["breakdown"]
    # the profiler's own host cost per launch stretches the traced step's
    # wall time; the untraced step's wall time against the traced device
    # time gives the idle share without it
    training["idle_share_untraced"] = 1 - m["device_ms"] / step_ms
    groups = m["by_group_ms"]
    training["gmm_device_ms"] = groups.get("gmm", 0.0)
    training["tgmm_device_ms"] = groups.get("tgmm", 0.0)
    print(f"  GPT-MoE step {step_ms:.3f} ms untraced: device "
          f"{m['device_ms']:.3f} ms, of it gmm {training['gmm_device_ms']:.3f}"
          f" and tgmm {training['tgmm_device_ms']:.3f} ms [{card}]",
          flush=True)
    print(f"  GPT-MoE train step breakdown: wall {m['wall_ms']:.3f} ms, "
          f"device {m['device_ms']:.3f} ms (idle share "
          f"{m['idle_share']:.3f} traced, "
          f"{training['idle_share_untraced']:.3f} against the untraced "
          f"step), {m['device_launches']:.0f} kernels; by group (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in m["by_group_ms"].items()),
          flush=True)
    for name, ms in m["top_kernels_ms"].items():
        print(f"    {ms:9.3f} ms {m['top_kernels_launches'][name]:5.0f}x  "
              f"{name}", flush=True)
    _print_other(m, "phase 6 captured step")
    del prof
    training["eager"] = _captured_against_eager(
        torch, trainer, (ids, ids), "phase 6", card, step_ms, m)
    del trainer, model, ids, timed
    _free(torch)
    training.update(_gpt_train_step_agreement(torch, args.seed))
    return training


def _plain_gmm_patches(stack):
    from paddle_tpu_torch.kernels import gmm as PG
    stack.enter_context(mock.patch.object(PG, "gmm", PG.gmm_plain))
    stack.enter_context(mock.patch.object(PG, "tgmm", PG.tgmm_plain))


def _gpt_train_step_agreement(torch, seed, seeds=8):
    """One forward + backward of the GPT-MoE widths at 2 layers (one dense,
    one MoE) at batch 1 x 1024 through the kernels and through the plain
    versions, in float32 and in bf16 (the same bf16-valued weights,
    upcast), for each of ``seeds`` seeds (weights and ids). float32: the
    paths differ only in summation order, so on each seed the loss agrees
    to 1e-5 relative and the gradients to 1e-5 relative L2 over all of
    them. bf16: both paths round at the same places, so the kernel path's
    gradients must be no further from the float32 step than the plain bf16
    path's: within 1.1x over all, 1.25x for each parameter, as relative L2
    distances pooled over the seeds. One seed alone does not decide it:
    in bf16 a few tokens' top-2 experts flip between the two paths and the
    float32 step, which moves the router's and the experts' gradients by
    chance (on one seed the plain path itself is further from float32 than
    the other bf16 path by up to 2.3x on a parameter)."""
    import numpy as np
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    cfg = GPTConfig.gpt_moe(8, num_hidden_layers=2)

    def run(state, ids, dtype, plain):
        model = _dropless(GPTForCausalLM(cfg, device="cuda"))
        if dtype == torch.bfloat16:
            model.bfloat16()
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(state[n].to(dtype))
        before = dict(K.LAUNCHES)
        with ExitStack() as stack:
            if plain:
                _plain_train_patches(stack)
                _plain_gmm_patches(stack)
            loss = model.compute_loss(model(ids), ids).float()
            loss.backward()
            torch.cuda.synchronize()
        used = {n: K.LAUNCHES[n] - before[n] for n in K.LAUNCHES}
        if plain and any(used.values()):
            raise AssertionError("the plain step launched a kernel")
        if not plain and (used["gmm"], used["tgmm"]) != (4, 4):
            raise AssertionError(f"the kernel step's launches: {used}")
        grads = {n: p.grad.float() for n, p in model.named_parameters()}
        return float(loss.detach()), grads

    loss32 = err32 = 0.0
    sq_k, sq_p, ref, losses16 = {}, {}, {}, []
    for sd in range(seed, seed + seeds):
        ids = torch.from_numpy(np.random.default_rng(sd + 3).integers(
            0, cfg.vocab_size, (1, 1024))).cuda()
        base = GPTForCausalLM(
            cfg, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(sd + 3))
        base.bfloat16()
        state = {n: p.detach() for n, p in base.named_parameters()}
        del base
        lk32, gk32 = run(state, ids, torch.float32, False)
        lp32, gp32 = run(state, ids, torch.float32, True)
        loss32 = max(loss32, abs(lk32 / lp32 - 1))
        err32 = max(err32, _rel_dist(gk32, gp32)[0])
        del gk32
        lk16, gk16 = run(state, ids, torch.bfloat16, False)
        dk, r = _sq_dists(gk16, gp32)
        del gk16
        lp16, gp16 = run(state, ids, torch.bfloat16, True)
        dp, _ = _sq_dists(gp16, gp32)
        del gp16, gp32, state
        torch.cuda.empty_cache()
        for n in r:
            sq_k[n] = sq_k.get(n, 0.0) + dk[n]
            sq_p[n] = sq_p.get(n, 0.0) + dp[n]
            ref[n] = ref.get(n, 0.0) + r[n]
        losses16 += [lk16, lp16]
    total = sum(ref.values())
    err_k = math.sqrt(sum(sq_k.values()) / total)
    err_p = math.sqrt(sum(sq_p.values()) / total)
    leaf_k = {n: math.sqrt(sq_k[n] / ref[n]) for n in ref}
    leaf_p = {n: math.sqrt(sq_p[n] / ref[n]) for n in ref}
    ratio = {n: leaf_k[n] / leaf_p[n] for n in ref}
    worst = max(ratio, key=ratio.get)
    print(f"  GPT-MoE train step kernels vs plain (full widths, 2 layers, 1 "
          f"x 1024, {seeds} seeds): float32 worst loss rel err {loss32:.3g} "
          f"(tol 1e-5), worst grads rel L2 err {err32:.3g} (tol 1e-5); bf16 "
          f"grads' rel L2 distance from the float32 step pooled over the "
          f"seeds: kernels {err_k:.5g}, plain {err_p:.5g} (tol: kernels <= "
          f"1.1 x plain); per parameter, the largest ratio kernels / plain "
          f"{ratio[worst]:.4g} at {worst} (tol 1.25)", flush=True)
    for n in ref:
        print(f"    {n}: kernels {leaf_k[n]:.5g} plain {leaf_p[n]:.5g}",
              flush=True)
    if not (loss32 <= 1e-5 and err32 <= 1e-5 and err_k <= 1.1 * err_p
            and max(ratio.values()) <= 1.25
            and all(math.isfinite(x) for x in losses16 + [err_k, err_p])):
        raise AssertionError("the GPT-MoE kernel train step disagrees with "
                             "the plain step")
    return dict(train_step_loss_rel_err_f32=loss32,
                train_step_grad_rel_err_f32=err32,
                train_step_bf16_grad_err_kernels=err_k,
                train_step_bf16_grad_err_plain=err_p,
                train_step_bf16_grad_err_ratio_worst_param=ratio[worst],
                train_step_agreement_seeds=seeds)


# -- phase 8: GPT and GPT-MoE serving at full width ------------------------------

GPT_CAPACITY = 8192       # >= every forward's tokens: eval routing no-drop


def _gpt_serving_model(torch, cfg, seed, dtype):
    """GPT weights on the card from a seeded generator. A GShard gate drops
    tokens at its eval capacity; the capacity override at ``GPT_CAPACITY``
    (above the engine's 256-token step and generate()'s 8 x 544) makes its
    routing no-drop, which the decoders require (as in the JAX package)."""
    from paddle_tpu_torch.models import GPTForCausalLM
    model = GPTForCausalLM(
        cfg, device="cuda", dtype=dtype,
        generator=torch.Generator(device="cuda").manual_seed(seed))
    for blk in model.transformer.h:
        if blk.is_moe:
            blk.mlp._capacity_override = GPT_CAPACITY
    return model


def _gpt_f32_pair(cfg):
    import dataclasses
    small = dataclasses.replace(cfg, num_hidden_layers=2)

    def make(torch, seed):
        return _gpt_serving_model(torch, small, seed, torch.float32)
    return make


def _ln_agreement(torch, model, cfg, seed):
    """The decoders' LayerNorm (``generation._ln``: the kernel on the bf16
    hidden state) bit-equal to the kernel run in fp32 and rounded after,
    over [4096, hidden] rows of the model's first LayerNorm."""
    from paddle_tpu_torch import generation
    from paddle_tpu_torch.kernels import fused
    ln = model.transformer.h[0].ln_1
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (4 * torch.randn(4096, cfg.hidden_size, device="cuda", generator=g)
         ).to(ln.weight.dtype)
    eps = cfg.layer_norm_epsilon
    got = generation._ln(x, ln.weight, ln.bias, eps)
    want = fused.dropout_add_layer_norm(x.float(), ln.weight.float(),
                                        ln.bias.float(), eps).to(x.dtype)
    if not torch.equal(got, want):
        raise AssertionError("the LayerNorm on the bf16 state differs from "
                             "the fp32 one rounded after")
    print("  LayerNorm on the bf16 state = fp32 rounded after: bit-equal "
          f"over [4096, {cfg.hidden_size}]", flush=True)
    return True


def phase_gpt_serving(torch, args, launches_out):
    """GPTConfig.gpt2_small() and GPTConfig.gpt_moe(8) in bf16, each served
    by two engines in turn (eager, then captured; max_seqs 8, budget 256,
    block 16, max_model_len 1024) over 12 requests of 16-700 prompt tokens
    and 32 new tokens, with phase 4's checks: exact launch counts (one
    ragged attention a layer, at head_dim 64), tokens equal, every step's
    logits bit-equal, pages equal, a profile; generate() captured against
    eager; one ragged step through the kernels against the plain versions;
    the LayerNorm on the bf16 state bit-equal to the fp32 form rounded
    after; a 2-layer float32 pair."""
    import numpy as np
    from paddle_tpu_torch.models import GPTConfig
    from paddle_tpu_torch.serving import EngineConfig
    card = _card_line()
    out = {}
    for name, cfg in (("gpt2_small", GPTConfig.gpt2_small()),
                      ("gpt_moe_8", GPTConfig.gpt_moe(8))):
        tag = f"phase 8 {name}"
        model = _gpt_serving_model(torch, cfg, args.seed, torch.bfloat16)
        print(f"phase 8: {name} (hidden {cfg.hidden_size}, "
              f"{cfg.num_hidden_layers} layers, {cfg.num_attention_heads} "
              f"heads of {cfg.hidden_size // cfg.num_attention_heads}, vocab "
              f"{cfg.vocab_size}, experts {cfg.num_experts}) bf16, "
              f"{model.num_params()} params, random weights seed "
              f"{args.seed} [{card}]", flush=True)
        ecfg = dict(max_seqs=8, token_budget=256, block_size=16,
                    max_model_len=1024)
        rng = np.random.default_rng(args.seed + 8)
        lens = np.linspace(16, 700, 12).astype(int)
        rng.shuffle(lens)
        prompts = [rng.integers(1, cfg.vocab_size, (n,)).tolist()
                   for n in lens]
        # a forward: a ragged attention and two LayerNorms a layer, the
        # final LayerNorm
        n_ln = 2 * cfg.num_hidden_layers + 1
        stats, _ = _serve_pair(
            torch, model, EngineConfig(**ecfg), prompts, 32,
            {"ragged_attention": cfg.num_hidden_layers,
             "dropout_add_ln": n_ln}, tag, args, launches_out)
        stats["generate"] = _generate_checks(torch, model, cfg, args,
                                             launches_out,
                                             {"dropout_add_ln": n_ln},
                                             tag=tag, full=False)
        stats.update(_step_agreement(torch, model, cfg,
                                     EngineConfig(**ecfg), args.seed))
        stats["ln_bf16_equals_f32"] = _ln_agreement(torch, model, cfg,
                                                    args.seed)
        del model
        torch.cuda.empty_cache()
        stats["captured_step_f32"] = _captured_step_f32(
            torch, _gpt_f32_pair(cfg), args.seed)
        out[name] = stats
    return out


# -- phase 9: quantized serving of Llama-2-7B -----------------------------------------

def phase_quant_serving(torch, args, launches_out, bf16_outputs):
    """Phase 4's model, engine and requests with weight-only int8, int4 and
    fp8 weights, one engine at a time: captured against eager (tokens
    equal, logits bit-equal, exact launch counts with one weight-only GEMM
    a quantized matrix), step ms, tokens/s, idle share, a profile, the
    quantized bytes, the greedy-token agreement with the bf16 engine
    (printed, not gated) and one ragged step through the kernels against
    the plain versions; then generate(quant="weight_only_int8")."""
    from paddle_tpu_torch import generation as G
    from paddle_tpu_torch.serving import EngineConfig
    card = _card_line()
    cfg, model, ecfg, prompts, max_new = _llama_serving_setup(torch, args)
    n_l = cfg.num_hidden_layers
    dec = G._decoder_for(model)
    names, _ = dec.quant_plan()
    params = dict(model.named_parameters())
    bf16_bytes = sum(params[n].numel() * 2 for n in names)
    out = {}
    for algo in QUANT_ALGOS:
        tag = f"phase 9 {algo}"
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        w = G._quant_weights_cached(dec, model, algo)
        torch.cuda.synchronize()
        q_secs = time.monotonic() - t0
        q_bytes = sum(v.numel() * v.element_size() for k, v in w.items()
                      if "::" in k)
        del w
        print(f"phase 9: Llama-2-7B width, {algo}: {len(names)} matrices "
              f"quantized in {q_secs:.2f}s, {q_bytes} bytes with their "
              f"scales against {bf16_bytes} in bf16 [{card}]", flush=True)
        stats, outs = _serve_pair(
            torch, model, EngineConfig(quant=algo, **ecfg), prompts, max_new,
            _llama_per_step(n_l, quant=True), tag, args, launches_out,
            keep_pages=False)
        same_req = sum(a == b for a, b in zip(outs, bf16_outputs))
        same_tok = sum(x == y for a, b in zip(outs, bf16_outputs)
                       for x, y in zip(a, b))
        total = sum(len(a) for a in outs)
        print(f"  {tag}: greedy tokens equal to the bf16 engine's: "
              f"{same_tok}/{total} tokens, {same_req}/{len(outs)} requests "
              f"whole (not gated: random weights, narrower matrices)",
              flush=True)
        stats.update(quantize_seconds=q_secs, quant_bytes=q_bytes,
                     bf16_bytes=bf16_bytes,
                     tokens_equal_to_bf16=same_tok / total,
                     requests_equal_to_bf16=same_req,
                     peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        stats.update(_step_agreement(torch, model, cfg, EngineConfig(**ecfg),
                                     args.seed, quant=algo))
        if algo == "weight_only_int8":
            stats["generate"] = _generate_checks(
                torch, model, cfg, args, launches_out,
                dict(rms_norm=n_l + 1, rms_norm_residual=n_l, rope=n_l,
                     weight_only_gemm=7 * n_l + 1), tag=tag, quant=algo,
                full=False)
        model.__dict__["_quant_weights_cache"].pop(algo)
        torch.cuda.empty_cache()
        out[algo] = stats
    del model, dec
    torch.cuda.empty_cache()
    return out


# -- phase 10: speculative decoding on Llama-2-7B ------------------------------------

def _spec_run(torch, model, ecfg, prompts, max_new):
    """Serve ``prompts`` on a captured engine of ``ecfg``, keeping the
    logits row that scored each output position: {(request, index): fp32
    row} (the last row written for a position is the one whose context was
    accepted). Returns (outputs, rows, stats, launches)."""
    from paddle_tpu_torch.serving import ServingEngine
    eng = ServingEngine(model, ecfg)
    eng.generate_batch([list(range(1, 17))], max_new_tokens=2)   # warm-up
    orig = eng.sched.schedule
    plans = []

    def schedule():
        plan = orig()
        idx, rows = 0, []
        for e in plan.entries:
            n, k = e.n, len(e.draft)
            if e.samples:
                base = len(e.req.output)
                rows += [(e.req.rid, base + j, idx + n - 1 + j)
                         for j in range(k + 1)]
            idx += n + k
        plans.append(rows)
        return plan
    eng.sched.schedule = schedule
    s0 = dict(eng.spec_stats())
    h0 = dict(eng.host_seconds)
    stats, outs, launches, logits = _serve_requests(torch, eng, prompts,
                                                    max_new,
                                                    keep_logits=True)
    index = {r: i for i, r in enumerate(stats.pop("rids"))}
    rows = {}
    for step_rows, lg in zip(plans[-len(logits):], logits):
        for r, oi, row in step_rows:
            if oi < max_new:
                rows[(index[r], oi)] = lg[row].float()
    del logits
    spec = {k: eng.spec_stats()[k] - s0[k] for k in ("proposed", "accepted",
                                                     "rollback_pages")}
    host = {k: 1e3 * (eng.host_seconds[k] - h0[k]) / stats["steps"]
            for k in h0}
    wall = stats["seconds"]
    stats.update(spec, host_ms_a_step=host,
                 step_ms=1e3 * wall / stats["steps"],
                 tokens_per_s=stats["tokens_generated"] / wall)
    del eng
    torch.cuda.empty_cache()
    return outs, rows, stats, launches


SPEC_NOISE_ULPS = 32    # the verify-row vs decode-row noise's bound


def _bf16_ulp(x):
    """One bf16 ulp at magnitude ``x`` (> 0)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _spec_compare(name, base, spec, max_new,
                  names=("non-spec", "speculative")):
    """Spec outputs against non-spec ones (or any two greedy runs of one
    model, ``names`` naming the base run and the other): the fraction of
    requests identical, and the noise: the two runs' largest logit
    difference at every position before a request's first differing
    token (their contexts are equal there; the spec run scored many of
    them from verify rows, the other from decode rows, which take other
    ragged-kernel tiles). Every such difference must lie within
    SPEC_NOISE_ULPS bf16 ulps of its row's largest logit, and at each
    first differing token both tokens must be their own run's argmax with
    the base run's top-2 margin at most twice the largest noise: a near
    tie that rounding noise flips. Any other difference fails. Returns
    the summary."""
    import torch
    outs_b, rows_b = base
    outs_s, rows_s = spec
    same = sum(a == b for a, b in zip(outs_b, outs_s))
    noise, flips, worst_ulps = [], [], 0.0
    for r, (a, b) in enumerate(zip(outs_b, outs_s)):
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        for i in range(max_new if j is None else j):
            d = float((rows_b[(r, i)] - rows_s[(r, i)]).abs().max())
            noise.append(d)
            worst_ulps = max(worst_ulps, d / _bf16_ulp(
                float(rows_b[(r, i)].abs().max())))
        if j is not None:
            flips.append((r, j))
    noise.sort()
    noise_max = noise[-1] if noise else 0.0
    checked = []
    for r, j in flips:
        lb, ls = rows_b[(r, j)], rows_s[(r, j)]
        top = torch.topk(lb, 2).values
        margin = float(top[0] - top[1])
        ok = int(lb.argmax()) == outs_b[r][j] \
            and int(ls.argmax()) == outs_s[r][j] and margin <= 2 * noise_max
        checked.append(dict(request=r, index=j, margin=margin,
                            diff=float((lb - ls).abs().max()), ok=ok))
    noise_ok = worst_ulps <= SPEC_NOISE_ULPS
    summary = dict(requests_identical=same, requests=len(outs_b),
                   noise_positions=len(noise),
                   noise_median=noise[len(noise) // 2] if noise else 0.0,
                   noise_max=noise_max, noise_max_ulps=worst_ulps,
                   flips=checked)
    print(f"  {name}: requests identical to {names[0]} "
          f"{same}/{len(outs_b)}; "
          f"noise (logit difference of the two runs before each first "
          f"difference) over {len(noise)} positions: median "
          f"{summary['noise_median']:.4g}, max {noise_max:.4g}, at most "
          f"{worst_ulps:.3g} bf16 ulps of its row's largest logit (bound "
          f"{SPEC_NOISE_ULPS}) {'ok' if noise_ok else 'FAIL'}; first "
          f"differences "
          + (", ".join(f"req {f['request']} @ {f['index']}: margin "
                       f"{f['margin']:.4g} vs 2 x noise {2 * noise_max:.4g} "
                       f"(difference there {f['diff']:.4g}) "
                       f"{'ok' if f['ok'] else 'FAIL'}" for f in checked)
             or "none"), flush=True)
    if not noise_ok:
        raise AssertionError(f"{name}: the {names[1]} run's logits differ "
                             f"from the {names[0]} run's beyond "
                             f"{SPEC_NOISE_ULPS} bf16 ulps where their "
                             f"contexts are equal")
    if not all(f["ok"] for f in checked):
        raise AssertionError(f"{name}: a {names[1]} token differs from the "
                             f"{names[0]} one beyond a near tie")
    return summary


def _spec_f32(torch, cfg, seed):
    """float32 at full width with 2 layers: speculative tokens (n-gram, and
    the model drafting for itself) identical to non-speculative ones."""
    import numpy as np
    from paddle_tpu_torch.serving import EngineConfig, ServingEngine
    model = _llama_f32_pair(cfg)(torch, seed)
    rng = np.random.default_rng(seed + 4)
    pattern = rng.integers(1, cfg.vocab_size, (7,)).tolist()
    prompts = [rng.integers(1, cfg.vocab_size, (n,)).tolist()
               for n in (40, 200, 7, 130)] + [(pattern * 30)[:150]]
    base = dict(max_seqs=4, token_budget=128, block_size=16,
                max_model_len=1024)
    want = ServingEngine(model, EngineConfig(**base)).generate_batch(
        prompts, max_new_tokens=16)
    out = {}
    for name, kw in (("ngram", dict(spec_method="ngram")),
                     ("draft_self", dict(spec_method="draft_model",
                                         draft_model=model))):
        eng = ServingEngine(model, EngineConfig(num_draft_tokens=4, **kw,
                                                **base))
        got = eng.generate_batch(prompts, max_new_tokens=16)
        ok = got == want
        print(f"  float32 (2 layers at full width) {name}: tokens identical "
              f"to non-speculative {sum(a == b for a, b in zip(got, want))}/"
              f"{len(prompts)} requests, {eng.spec_stats()} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"float32 {name}: speculative tokens differ "
                                 f"from non-speculative ones")
        out[name] = eng.spec_stats()
        del eng
    del model
    torch.cuda.empty_cache()
    return out


SELF_DRAFT_WIDTH = 1100    # > the longest context: 1000 prompt + 32 new


def phase_spec_serving(torch, args, launches_out):
    """Phase 4's model, engine and requests with speculative decoding,
    k = 4: the n-gram drafter, the 1.1B Llama of phase 5 as the draft
    model (64-token window), and the target drafting for itself through a
    window that holds every context. For each: proposed and
    accepted tokens, rollback pages, steps, step ms, tokens/s and the
    host's share; the bf16 comparison with the non-speculative run
    (``_spec_compare``); the draft model's draft_greedy_batch ms; then
    float32 with 2 layers, where speculative tokens must be identical."""
    from paddle_tpu_torch import generation as G
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import EngineConfig
    card = _card_line()
    cfg, model, ecfg, prompts, max_new = _llama_serving_setup(torch, args)
    n_l = cfg.num_hidden_layers
    print(f"phase 10: speculative decoding on Llama-2-7B width, k = 4, "
          f"{len(prompts)} requests [{card}]", flush=True)
    draft = LlamaForCausalLM(
        _llama_1b(), device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(args.seed + 10))
    base_outs, base_rows, base_stats, _ = _spec_run(
        torch, model, EngineConfig(**ecfg), prompts, max_new)
    print(f"  non-speculative: {base_stats['steps']} steps, "
          f"{base_stats['step_ms']:.3f} ms a step, "
          f"{base_stats['tokens_per_s']:.1f} tokens/s [{card}]", flush=True)
    out = dict(non_speculative={k: v for k, v in base_stats.items()})
    for name, kw in (("ngram", dict(spec_method="ngram")),
                     ("draft_1.1b", dict(spec_method="draft_model",
                                         draft_model=draft)),
                     # a window that holds every request's whole context:
                     # the drafts are the target's own greedy tokens
                     ("draft_self", dict(spec_method="draft_model",
                                         draft_model=model,
                                         spec_options={"context_width":
                                                       SELF_DRAFT_WIDTH}))):
        outs, rows, stats, launches = _spec_run(
            torch, model, EngineConfig(num_draft_tokens=4, **kw, **ecfg),
            prompts, max_new)
        _nothing_routed(launches, f"phase 10 {name}")
        if launches["ragged_attention"] != n_l * stats["steps"]:
            raise AssertionError(f"phase 10 {name}: ragged launches "
                                 f"{launches['ragged_attention']} != "
                                 f"{n_l} x {stats['steps']} steps")
        if any(len(o) != max_new for o in outs):
            raise AssertionError(f"phase 10 {name}: a request did not return "
                                 f"all of its tokens")
        for n, c in launches.items():
            launches_out[n] = launches_out.get(n, 0) + c
        stats["vs_non_speculative"] = _spec_compare(
            f"phase 10 {name}", (base_outs, base_rows), (outs, rows), max_new)
        rate = stats["accepted"] / max(stats["proposed"], 1)
        print(f"  phase 10 {name}: proposed {stats['proposed']}, accepted "
              f"{stats['accepted']} ({rate:.3f}), rollback pages "
              f"{stats['rollback_pages']}, {stats['steps']} steps (non-spec "
              f"{base_stats['steps']}), {stats['step_ms']:.3f} ms a step, "
              f"{stats['tokens_per_s']:.1f} tokens/s (non-spec "
              f"{base_stats['tokens_per_s']:.1f}); host ms a step "
              f"schedule (with the drafter's propose) / pack / device / emit "
              f"{_fmt_host(stats['host_ms_a_step'])}; launches {launches} "
              f"[{card}]", flush=True)
        del rows
        out[name] = stats
    # the draft model's batched greedy draft alone: 8 contexts in a
    # 64-token window, 4 tokens (its captured loop is warm)
    seqs = [p[:300] for p in prompts[:8]]
    G.draft_greedy_batch(draft, seqs, 4, width=64)
    t0 = time.monotonic()
    for _ in range(5):
        G.draft_greedy_batch(draft, seqs, 4, width=64)
    torch.cuda.synchronize()
    out["draft_1.1b_greedy_batch_ms"] = 1e3 * (time.monotonic() - t0) / 5
    print(f"  phase 10 draft_greedy_batch of the 1.1B draft model (8 "
          f"contexts, window 64, k 4): "
          f"{out['draft_1.1b_greedy_batch_ms']:.3f} ms a call [{card}]",
          flush=True)
    del model, draft, base_rows
    torch.cuda.empty_cache()
    out["float32"] = _spec_f32(torch, cfg, args.seed)
    return out


# -- FlashMask routing, beams, the artifact, the server -----------------------

def _flashmask_routed_on_card(torch):
    """FlashMask calls the kernels do not take (causal q_len > kv_len,
    q_len < kv_len, head_dim 32) run the plain versions on the card, each
    counted in sdpa_plain and no kernel, and equal the CPU's plain result
    within 2e-5 (float32 sums in another order)."""
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.nn import functional as F
    out = {}
    for name, (sq, sk, d) in {"causal_q_longer": (300, 200, 64),
                              "causal_q_shorter": (200, 300, 128),
                              "d32": (256, 256, 32)}.items():
        g = torch.Generator().manual_seed(sq + sk + d)
        q = torch.randn(2, sq, 8, d, generator=g)
        k = torch.randn(2, sk, 4, d, generator=g)
        v = torch.randn(2, sk, 4, d, generator=g)
        se = torch.randint(sq // 2, sq + 1, (2, 1, sk, 1), generator=g,
                           dtype=torch.int32)
        want = F.flashmask_attention(q, k, v, se, causal=True)
        K.reset_launches()
        got = F.flashmask_attention(q.cuda(), k.cuda(), v.cuda(), se.cuda(),
                                    causal=True)
        torch.cuda.synchronize()
        routed, kernels = K.LAUNCHES["sdpa_plain"], sum(
            K.kernel_launches().values())
        err = float((got.cpu() - want).abs().max())
        ok = routed == 1 and kernels == 0 and err <= 2e-5
        print(f"  F5 FlashMask [{2}, {sq}, 8, {d}] over {sk} keys, causal "
              f"(kv heads 4): routed to the plain path {routed}, kernels "
              f"{kernels}, max_abs_err vs the CPU {err:.3g} (tol 2e-05) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"F5 {name}: routing or result is wrong")
        out[name] = dict(sq=sq, sk=sk, d=d, sdpa_plain=routed,
                         max_abs_err=err)
    return out


def _attend_f32_copies(q, k, v, score_mask, rep):
    """generate()'s dense attention in the form that copies K and V to
    fp32 every step, on the heads-major cache: kept here only to time a
    decode step with it beside the current one (which reads the bf16
    cache in place)."""
    import torch
    b, s, h, d = q.shape
    g = h // rep
    t = k.shape[2]
    qg = q.reshape(b, s, g, rep, d).permute(0, 2, 3, 1, 4).float() \
        .reshape(b, g, rep * s, d)
    scores = (qg @ k.float().transpose(-1, -2)) / math.sqrt(d)
    scores = torch.where(score_mask[:, None],
                         scores.reshape(b, g, rep, s, t), -1e30)
    p = torch.softmax(scores, dim=-1).reshape(b, g, rep * s, t)
    out = (p @ v.float()).reshape(b, g, rep, s, d)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


def _step_ms_f32_copy_attention(torch, dec, w, sig, ids_d, mask_d, max_new):
    """The greedy decode step's ms (a captured loop) with the fp32-copy
    attention patched in, beside which the current step is timed; its
    tokens, and the logits each token was picked from (``_greedy_rows``)."""
    from paddle_tpu_torch import generation as G
    with mock.patch.object(G, "_attend_gqa", _attend_f32_copies):
        loop = G._new_loop(dec, w, *sig)
        loop.capture()
        toks, _, step = _timed_loop(torch, loop, ids_d, mask_d, max_new)
        rows = _greedy_rows(torch, loop, ids_d, mask_d, max_new)
    del loop
    torch.cuda.empty_cache()
    return toks, step, rows


def _greedy_rows(torch, loop, ids_d, mask_d, max_new):
    """A greedy run of ``loop``: {(row, step): the fp32 logits on the CPU
    that step's token was picked from}."""
    loop.start(ids_d, mask_d, 1.0, 0, 1.0, None)
    rows = {}
    for i in range(max_new):
        lg = loop.last_logits.float().cpu()
        rows.update(((r, i), lg[r]) for r in range(lg.shape[0]))
        loop.step()
    return rows


def _left_padded_batch(torch, cfg, seed, b=8, width=512):
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = np.linspace(16, width, b).astype(int)
    rng.shuffle(lens)
    ids = np.zeros((b, width), np.int64)
    mask = np.zeros((b, width), np.int64)
    for i, n in enumerate(lens):
        ids[i, width - n:] = rng.integers(1, cfg.vocab_size, (n,))
        mask[i, width - n:] = 1
    return ids, mask, sorted(lens.tolist())


def _beam_checks(torch, model, cfg, args, launches_out, per_call):
    """generate(num_beams=4) at full width: batch 8, prompts left-padded to
    512, 32 new tokens, and as eos the second token of row 0's best beam
    in a run without eos (so that eos can finish beams). The
    captured beam loop (one CUDA graph a step) against the same loop run
    op by op: tokens, finished flags, beam scores and the beams' tokens
    equal; exact launch counts (the prefill of 32 rows, then each replay);
    prefill ms, decode step ms and the ms of the cache reorder alone (all
    of kcs and vcs gathered through a scratch buffer and copied back, as
    the JAX loop gathers them)."""
    from paddle_tpu_torch import generation as G
    from paddle_tpu_torch import kernels as K
    card = _card_line()
    dev = torch.device("cuda")
    b, k, max_new = 8, 4, 32
    ids, mask, lens = _left_padded_batch(torch, cfg, args.seed + 5)
    width = ids.shape[1]
    ids_d, mask_d = (torch.from_numpy(a).to(dev) for a in (ids, mask))
    dec = G._decoder_for(model)
    w = dec.weights(model)
    free = G._new_loop(dec, w, b, width, max_new, False, False, 0, 1.0,
                       False, k)
    free.start(ids_d, mask_d, 1.0, 0, 1.0, None)
    for _ in range(max_new):
        free.step()
    eos = int(free.result()[0][0, 1])
    del free
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    got, fin = G.generate(model, ids, attention_mask=mask,
                          max_new_tokens=max_new, num_beams=k,
                          eos_token_id=eos)
    first_s = time.monotonic() - t0
    sig = (b, width, max_new, False, True, 0, 1.0, False, k)
    loop = G._loop_for(dec, w, *sig)
    K.reset_launches()
    t0 = time.monotonic()
    loop.start(ids_d, mask_d, 1.0, eos, 1.0, None)
    torch.cuda.synchronize()
    t1 = time.monotonic()
    for _ in range(max_new):
        loop.step()
    torch.cuda.synchronize()
    t2 = time.monotonic()
    launches = dict(K.LAUNCHES)
    pre_g, step_g = 1e3 * (t1 - t0), 1e3 * (t2 - t1) / max_new
    toks_g, fin_g = loop.result()
    expect = {n: per_call.get(n, 0) * (1 + max_new) for n in K.LAUNCHES}
    _nothing_routed(launches, "phase 4 beams")
    if launches != expect:
        raise AssertionError(f"beams: launch counts {launches} != {expect}")
    for n, c in launches.items():
        launches_out[n] = launches_out.get(n, 0) + c
    eager = G._new_loop(dec, w, *sig)
    t0 = time.monotonic()
    eager.start(ids_d, mask_d, 1.0, eos, 1.0, None)
    torch.cuda.synchronize()
    t1 = time.monotonic()
    for _ in range(max_new):
        eager.step()
    torch.cuda.synchronize()
    step_e = 1e3 * (time.monotonic() - t1) / max_new
    toks_e, fin_e = eager.result()
    same = (torch.equal(toks_g, toks_e) and torch.equal(fin_g, fin_e)
            and torch.equal(loop.scores, eager.scores)
            and torch.equal(loop.out, eager.out)
            and torch.equal(got, toks_g) and torch.equal(fin, fin_g))
    in_vocab = 0 <= int(got.min()) and int(got.max()) < cfg.vocab_size
    del eager
    torch.cuda.empty_cache()
    rows = torch.arange(b * k, device=dev)
    reorder_ms = _graph_ms(lambda: loop._reorder(rows), iters=5, reps=3)
    cache_bytes = 2 * loop.kcs.numel() * loop.kcs.element_size()
    print(f"  phase 4 generate(num_beams={k}): batch {b}, prompts {lens} "
          f"left-padded to {width}, {max_new} new tokens, eos {eos}; first "
          f"call {first_s:.2f}s (capture included); graph = eager (tokens, "
          f"finished, scores, beams) {same}; finished {int(fin.sum())}/{b}; "
          f"launches {launches} (expected {expect}) "
          f"{'ok' if same and in_vocab else 'FAIL'}", flush=True)
    if not (same and in_vocab):
        raise AssertionError("beams: the captured loop disagrees with the "
                             "eager loop")
    print(f"  phase 4 beams: prefill ({b * k} rows) {pre_g:.1f} ms; decode "
          f"step eager -> graph {step_e:.3f} -> {step_g:.3f} ms "
          f"({b * k / (step_g / 1e3):.1f} beam tokens/s); the cache "
          f"reorder alone {reorder_ms:.3f} ms a step (kcs + vcs "
          f"{cache_bytes / 1e9:.2f} GB, gathered and copied back: "
          f"{4 * cache_bytes / 1e9:.2f} GB moved, bound "
          f"{4 * cache_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms) [{card}]",
          flush=True)
    dec.loops.clear()
    del loop
    torch.cuda.empty_cache()
    return dict(batch=b, num_beams=k, width=width, max_new_tokens=max_new,
                eos=eos, first_call_s=first_s, graph_prefill_ms=pre_g,
                graph_step_ms=step_g, eager_step_ms=step_e,
                reorder_ms=reorder_ms, cache_bytes=cache_bytes,
                finished=int(fin.sum()), tokens=got.tolist(), card=card)


def _beams_f32_pair(torch, make_model, seed):
    """float32 at full width with 2 layers: generate(num_beams=4) on the
    card (captured) against the same weights on the CPU, batch 2, prompts
    left-padded to 48, 8 new tokens, with eos: tokens and finished flags
    equal."""
    import numpy as np
    from paddle_tpu_torch import generation as G
    from paddle_tpu_torch.models import LlamaForCausalLM
    gpu = make_model(torch, seed)
    cpu = LlamaForCausalLM(gpu.config, device="cpu", dtype=torch.float32)
    cpu.load_state_dict({n: p.cpu() for n, p in gpu.state_dict().items()})
    rng = np.random.default_rng(seed + 7)
    ids = np.zeros((2, 48), np.int64)
    mask = np.zeros((2, 48), np.int64)
    for i, n in enumerate((48, 21)):
        ids[i, 48 - n:] = rng.integers(1, gpu.config.vocab_size, (n,))
        mask[i, 48 - n:] = 1
    free, _ = G.generate(cpu, ids, attention_mask=mask, max_new_tokens=8,
                         num_beams=4, device="cpu")
    kw = dict(attention_mask=mask, max_new_tokens=8, num_beams=4,
              eos_token_id=int(free[0, 2]))
    want = G.generate(cpu, ids, device="cpu", **kw)
    got = G.generate(gpu, ids, **kw)
    ok = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    print(f"  float32 (2 layers at full width) beams: card = CPU (tokens, "
          f"finished) {ok} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("float32 beams: the card disagrees with the CPU")
    del gpu, cpu
    torch.cuda.empty_cache()
    return dict(tokens_equal=True)


def _server_delegation(torch, model, ecfg, prompts, max_new, want):
    """BatchingServer over an EnginePredictor on phase 4's engine
    configuration: 4 client threads submit the 12 requests (in turn, so
    the engine admits them in generate_batch's order; the worker starts
    stepping once all are in), the worker thread replays the engine's
    captured step, and every request gets generate_batch's tokens."""
    import threading
    import numpy as np
    from paddle_tpu_torch.inference import BatchingServer
    from paddle_tpu_torch.serving import (EngineConfig, EnginePredictor,
                                          ServingEngine)
    eng = ServingEngine(model, EngineConfig(**ecfg))
    pred = EnginePredictor(eng, max_new_tokens=max_new)
    gate = threading.Event()
    real_step = eng.step

    def gated_step():
        gate.wait()
        return real_step()

    eng.step = gated_step
    server = BatchingServer(pred)
    futs = [None] * len(prompts)
    turn = threading.Condition()
    nxt = [0]

    def client(c):
        for j in range(c, len(prompts), 4):
            with turn:
                turn.wait_for(lambda: nxt[0] == j)
                futs[j] = server.submit([np.asarray(prompts[j])])
                nxt[0] += 1
                turn.notify_all()

    t0 = time.monotonic()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    gate.set()
    try:
        got = [f.result(timeout=300)[0].tolist() for f in futs]
    finally:
        server.close()
    secs = time.monotonic() - t0
    ok = got == want
    print(f"  BatchingServer (delegation, 4 client threads, the worker "
          f"thread replaying the engine's graph): {len(prompts)} requests in "
          f"{secs:.2f}s, {server.batches_run} steps, tokens equal to "
          f"generate_batch {ok} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("BatchingServer disagrees with generate_batch")
    del server, pred, eng
    torch.cuda.empty_cache()
    return dict(requests=len(prompts), seconds=secs, tokens_equal=True)


ARTIFACT_LAYERS = 11      # of the 1.1B Llama's 22: a depth cut for time


def phase_artifact(torch, args, launches_out):
    """The artifact path at full width on the 1.1B Llama (hidden 2048, 11
    of its 22 layers, bf16, seeded random weights): jit.save with
    InputSpec([None, None], "int64") into a gitignored directory,
    create_predictor on the card, a batch of 4 x 512; its logits equal the
    live model's forward bit for bit, with exact kernel launches (flash
    forward, RMSNorm, RoPE) and nothing routed to a plain path. Then the
    same model saved on the CPU and loaded on the card: the kernels launch
    and the logits equal again. Save, load and run seconds; the artifacts
    are deleted."""
    import shutil
    import numpy as np
    from paddle_tpu_torch import jit
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.models import LlamaForCausalLM
    card = _card_line()
    cfg = _llama_1b(layers=ARTIFACT_LAYERS)
    n_l = cfg.num_hidden_layers
    model = LlamaForCausalLM(
        cfg, device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(args.seed))
    ids = np.random.default_rng(args.seed + 9).integers(
        0, cfg.vocab_size, (4, 512)).astype(np.int64)
    with torch.no_grad():
        live = model(torch.from_numpy(ids).cuda())
    torch.cuda.synchronize()
    root = os.path.join(args.out, "artifact")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    spec = [jit.InputSpec([None, None], "int64")]
    expect = {n: 0 for n in K.LAUNCHES}
    expect.update(flash_fwd=n_l, rms_norm=2 * n_l + 1, rope=n_l,
                  swiglu_fwd=n_l)
    out = {}
    try:
        for where in ("cuda", "cpu"):
            path = os.path.join(root, f"llama_1b_{where}")
            t0 = time.monotonic()
            if where == "cpu":
                model.to("cpu")
            jit.save(model, path, input_spec=spec)
            save_s = time.monotonic() - t0
            if where == "cpu":
                model.to("cuda")
            size = sum(os.path.getsize(path + s)
                       for s in (".pdmodel", ".pdiparams", ".meta.json"))
            t0 = time.monotonic()
            pred = create_predictor(Config(path))
            torch.cuda.synchronize()
            load_s = time.monotonic() - t0
            pred.run([ids])                       # the first run (Triton)
            K.reset_launches()
            t0 = time.monotonic()
            (logits,) = pred.run([ids])
            torch.cuda.synchronize()
            run_s = time.monotonic() - t0
            launches = dict(K.LAUNCHES)
            for n, c in launches.items():
                launches_out[n] = launches_out.get(n, 0) + c
            got = pred._outputs[0]
            same = torch.equal(got, live)
            _nothing_routed(launches, f"phase 11 artifact saved on {where}")
            ok = same and launches == expect and logits.shape == (4, 512,
                                                                  32000)
            print(f"  phase 11 artifact saved on the {where}: jit.save "
                  f"{save_s:.2f}s ({size / 1e9:.3f} GB: .pdmodel "
                  f"{os.path.getsize(path + '.pdmodel') / 1e6:.2f} MB), "
                  f"create_predictor on the card {load_s:.2f}s, run of "
                  f"[4, 512] {run_s:.3f}s; logits = the live forward's bit "
                  f"for bit {same}; launches {launches} (expected {expect}) "
                  f"{'ok' if ok else 'FAIL'} [{card}]", flush=True)
            if not ok:
                raise AssertionError(f"the artifact saved on {where} "
                                     f"disagrees with the live model")
            out[where] = dict(save_s=save_s, load_s=load_s, run_s=run_s,
                              bytes=size, logits_bit_equal=True,
                              launches=launches)
            del pred, got, logits
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del model, live
    torch.cuda.empty_cache()
    return out


# -- phase 12: the training surface ------------------------------------------------

def _recipe(model):
    """The usual recipe: (scheduler, AdamW) with warmup then cosine, weight
    decay 0.1 on every parameter whose name lacks "norm", global-norm
    clipping at 1.0."""
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm, lr
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(3e-4, T_max=10), 2, 0.0,
                            3e-4)
    return sched, AdamW(learning_rate=sched, parameters=model.parameters(),
                        weight_decay=0.1,
                        apply_decay_param_fun=lambda n: "norm" not in n,
                        grad_clip=ClipGradByGlobalNorm(1.0))


def _recipe_model(torch, cfg, seed, dtype):
    """The Llama of ``cfg`` on the card from ``seed``, in ``dtype``, with
    the recipe's attributes: the norms named, the embedding at half the
    rate."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.nn.initializer import ParamAttr, set_param_attr
    model = LlamaForCausalLM(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(seed))
    model.to(dtype)
    for n, p in model.named_parameters():
        if "norm" in n:
            set_param_attr(p, ParamAttr(name=n))
    set_param_attr(model.model.embed_tokens.weight,
                   ParamAttr(learning_rate=0.5))
    return model


def _recipe_trainer(model, opt, policy="full", cast=False):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.parallel import SpmdTrainer

    def loss(m, ids, labels):
        if not cast:
            return m.forward_loss(ids, labels, loss_chunk_size=256)
        with amp.auto_cast():
            return m.forward_loss(ids, labels, loss_chunk_size=256)
    return SpmdTrainer(model, opt, loss, remat_layers=list(model.model.layers),
                       remat_policy=policy)


def _recipe_steps(torch, trainer, sched, batch, n):
    """``n`` steps, the scheduler stepped after each: (losses, each
    step's seconds, the rate each step's update read: the trainer's rate
    tensor, which its captured graph reads at each replay)."""
    losses, secs, rates = [], [], []
    for _ in range(n):
        t = time.monotonic()
        losses.append(float(trainer.train_step(*batch)))
        trainer.block()
        secs.append(time.monotonic() - t)
        rates.append(float(trainer._lr))
        sched.step()
    return losses, secs, rates


def _free(torch):
    """Give back the memory of the models just dropped: a remat'd layer
    and its wrapped forward refer to each other, so only the cycle
    collector frees them."""
    gc.collect()
    torch.cuda.empty_cache()


def _recipe_run(torch, cfg, seed, batch, n, policy="full"):
    """A fresh recipe model and trainer (bf16), ``n`` steps with the
    launch counts zeroed just before and read just after, then one
    profiled step: (losses, seconds, rates, launches, peak GB, {name:
    parameter on the CPU after the n steps}, the profiled step's
    breakdown)."""
    from paddle_tpu_torch import kernels as K
    model = _recipe_model(torch, cfg, seed, torch.bfloat16)
    sched, opt = _recipe(model)
    trainer = _recipe_trainer(model, opt, policy)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    losses, secs, rates = _recipe_steps(torch, trainer, sched, batch, n)
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    params = {k: p.detach().cpu() for k, p in model.named_parameters()}
    _, breakdown = _profile(torch, lambda: trainer.train_step(*batch), 1)
    breakdown["graph"] = _graph_line(trainer, f"phase 12 {policy}",
                                     _card_line())
    _drop_trainer(torch, trainer)
    del model, opt, trainer
    _free(torch)
    return losses, secs, rates, launches, peak, params, breakdown


def _drop_trainer(torch, trainer):
    """Free a trainer's captured graphs and their pools before the next
    full-width trainer is built (each pins its pool while it lives)."""
    held = torch.cuda.memory_reserved()
    trainer._drop_graphs()
    _free(torch)
    back = (held - torch.cuda.memory_reserved()) / 1e9
    print(f"  the trainer's graphs dropped: {back:.3f} GB given back",
          flush=True)


def _breakdown_line(m):
    return (f"device {m['device_ms']:.2f} ms of a {m['wall_ms']:.2f} ms "
            f"traced step (idle share {m['idle_share']:.3f}), "
            f"{m['device_launches']:.0f} kernels; by group (ms): "
            + ", ".join(f"{k} {v:.2f}" for k, v in m["by_group_ms"].items()))


def _hold_launches(tag, launches, per_step, n):
    expect = {k: n * v for k, v in per_step.items()}
    print(f"  {tag}: launches over {n} steps {launches} (expected "
          f"{expect})", flush=True)
    _nothing_routed(launches, tag)
    if launches != expect:
        raise AssertionError(f"{tag}: launch counts {launches} != {expect}")


def _same_params(torch, tag, a, b):
    diff = [k for k in b if not torch.equal(a[k], b[k])]
    print(f"  {tag}: {len(b) - len(diff)} of {len(b)} parameters bit-equal",
          flush=True)
    if diff:
        raise AssertionError(f"{tag}: parameters differ ({diff[:4]})")


def _adamw_plain_all(params, grads, ms, vs, *, lr, beta1, beta2, eps, wds,
                     step, decoupled=True, lr_mults=None):
    """``multi_tensor_adamw`` through ``adamw_plain`` tensor by tensor (what
    its CPU path runs), on any device."""
    from paddle_tpu_torch.kernels.optimizer import adamw_plain
    for p, g, m, v, wd, mult in zip(params, grads, ms, vs, wds,
                                    lr_mults or [1.0] * len(params)):
        pn, mn, vn = adamw_plain(p, g, m, v, lr, beta1, beta2, eps, wd, step,
                                 decoupled, mult)
        p.copy_(pn)
        m.copy_(mn)
        v.copy_(vn)


def _recipe_agreement(torch, seed, cast):
    """3 recipe steps at the 1.1B widths with 2 layers (batch 1 x 2048)
    through the kernels and through the plain versions (the CPU's code,
    here on the card), and a float32 reference through the plain
    versions. bf16 (``cast`` False): bf16 weights; ``cast``: float32
    weights under auto_cast O1 (the reference without it). Each run's
    parameter change (final less initial) must be no further from the
    reference's than the plain run's: within 1.1x over all parameters
    and 1.25x for each."""
    import numpy as np
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch import optimizer as O
    cfg = _llama_1b(layers=2)
    ids = torch.from_numpy(np.random.default_rng(seed + 3).integers(
        0, cfg.vocab_size, (1, 2048))).cuda()
    base = _recipe_model(torch, cfg, seed + 3, torch.bfloat16)
    init = {n: p.detach().float() for n, p in base.named_parameters()}
    del base

    def run(dtype, plain, with_cast):
        model = _recipe_model(torch, cfg, seed + 3, dtype)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(init[n].to(dtype))
        sched, opt = _recipe(model)
        trainer = _recipe_trainer(model, opt, cast=with_cast)
        before = dict(K.LAUNCHES)
        with ExitStack() as stack:
            if plain:
                _plain_train_patches(stack)
                stack.enter_context(mock.patch.object(
                    O, "multi_tensor_adamw", _adamw_plain_all))
            losses, _, _ = _recipe_steps(torch, trainer, sched, (ids, ids), 3)
        if plain and K.LAUNCHES != before:
            raise AssertionError("the plain recipe launched a kernel")
        if not plain and K.LAUNCHES["flash_fwd"] == before["flash_fwd"]:
            raise AssertionError("the kernel recipe launched no flash_fwd")
        delta = {n: p.detach().float() - init[n]
                 for n, p in model.named_parameters()}
        del model, opt, trainer
        _free(torch)
        return losses, delta

    low = torch.float32 if cast else torch.bfloat16
    l32, d32 = run(torch.float32, True, False)
    lk, dk = run(low, False, cast)
    lp, dp = run(low, True, cast)
    err_k, leaf_k = _rel_dist(dk, d32)
    err_p, leaf_p = _rel_dist(dp, d32)
    ratio = {n: leaf_k[n] / leaf_p[n] for n in leaf_p}
    worst = max(ratio, key=ratio.get)
    tag = "auto_cast O1 over float32" if cast else "bf16"
    print(f"  2-layer recipe, {tag}: losses kernels {lk} plain {lp} float32 "
          f"{l32}; the parameters' change, relative L2 distance from the "
          f"float32 run's: kernels {err_k:.5g}, plain {err_p:.5g} (tol: "
          f"kernels <= 1.1 x plain); per parameter the largest ratio "
          f"{ratio[worst]:.4g} at {worst} (tol 1.25)", flush=True)
    if not (err_k <= 1.1 * err_p and max(ratio.values()) <= 1.25
            and all(math.isfinite(x) for x in lk + lp)):
        raise AssertionError(f"the 2-layer recipe ({tag}) through the "
                             f"kernels disagrees with the plain versions")
    return dict(kernels=err_k, plain=err_p, worst_param_ratio=ratio[worst])


def _grad_scaler_on_card(torch, seed):
    """GradScaler under auto_cast on a 2-layer float32 model: an inf
    planted in one gradient skips the step and halves the scale; the next,
    clean step updates and keeps the scale."""
    import numpy as np
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import AdamW
    cfg = _llama_1b(layers=2)
    model = _recipe_model(torch, cfg, seed + 4, torch.float32)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    ids = torch.from_numpy(np.random.default_rng(seed + 4).integers(
        0, cfg.vocab_size, (1, 512))).cuda()
    seen = []
    for plant in (True, False):
        before = model.model.norm.weight.detach().clone()
        with amp.auto_cast():
            loss = model.forward_loss(ids, ids, loss_chunk_size=256)
        scaler.scale(loss).backward()
        if plant:
            model.model.layers[1].mlp.up_proj.weight.grad[3, 5] = math.inf
        scaler.step(opt)
        opt.clear_grad()
        seen.append((scaler._scale, opt._global_step,
                     torch.equal(before, model.model.norm.weight.detach())))
    print(f"  GradScaler: (scale, optimizer steps, norm weight unchanged) "
          f"after a step with an inf, then a clean one: {seen}", flush=True)
    if seen != [(2.0 ** 14, 0, True), (2.0 ** 14, 1, False)]:
        raise AssertionError(f"GradScaler on the card: {seen}")
    del model, opt
    _free(torch)
    return seen


CARD_RULES = {
    "SGD": lambda o, ps: o.SGD(learning_rate=0.05, parameters=ps,
                               weight_decay=0.1),
    "Momentum": lambda o, ps: o.Momentum(learning_rate=0.05, parameters=ps,
                                         use_nesterov=True),
    "Adam": lambda o, ps: o.Adam(learning_rate=1e-3, parameters=ps,
                                 weight_decay=0.01),
    "AdamW": lambda o, ps: o.AdamW(learning_rate=1e-3, parameters=ps),
    "Adagrad": lambda o, ps: o.Adagrad(learning_rate=0.01, parameters=ps),
    "Adadelta": lambda o, ps: o.Adadelta(learning_rate=1.0, parameters=ps),
    "Adamax": lambda o, ps: o.Adamax(learning_rate=2e-3, parameters=ps),
    "RMSProp": lambda o, ps: o.RMSProp(learning_rate=1e-3, parameters=ps,
                                       momentum=0.5, centered=True),
    "Lamb": lambda o, ps: o.Lamb(learning_rate=1e-2, parameters=ps),
    "NAdam": lambda o, ps: o.NAdam(learning_rate=2e-3, parameters=ps),
    "RAdam": lambda o, ps: o.RAdam(learning_rate=2e-3, parameters=ps),
    "Rprop": lambda o, ps: o.Rprop(learning_rate=1e-3, parameters=ps),
    "ASGD": lambda o, ps: o.ASGD(learning_rate=0.05, batch_num=2,
                                 parameters=ps),
}


def _rules_on_card(torch):
    """Every rule, 3 eager steps of the tiny float32 Llama of phase 3 on
    the card and on the CPU, the CPU's gradients carried to the card each
    step (so the rules, not the models' summation orders, are compared):
    the parameters within rtol 1e-5 (atol 1e-7); LBFGS (with and without
    strong Wolfe) on a least-squares fit within 1e-4."""
    import numpy as np
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         load_numpy_state)
    cfg = LlamaConfig.tiny(vocab_size=256, hidden_size=256, layers=2,
                           heads=4, kv_heads=2, seq=200)
    ids = torch.from_numpy(np.random.default_rng(12).integers(0, 256,
                                                              (2, 200)))
    out = {}
    for name, build in CARD_RULES.items():
        cpu = LlamaForCausalLM(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(12))
        gpu = LlamaForCausalLM(cfg, device="cuda")
        load_numpy_state(gpu, {n: p.detach().numpy()
                               for n, p in cpu.named_parameters()})
        oc, og = build(O, cpu.parameters()), build(O, gpu.parameters())
        for _ in range(3):
            cpu.forward_loss(ids, ids, loss_chunk_size=64).backward()
            gpu.forward_loss(ids.cuda(), ids.cuda(),
                             loss_chunk_size=64).backward()
            for p, q in zip(cpu.parameters(), gpu.parameters()):
                q.grad = p.grad.cuda()
            oc.step()
            og.step()
            oc.clear_grad()
            og.clear_grad()
        worst = 0.0
        for p, q in zip(cpu.parameters(), gpu.parameters()):
            a, b = q.detach().cpu(), p.detach()
            worst = max(worst, float(((a - b).abs() / (b.abs() + 1e-2))
                                     .max()))
            if not torch.allclose(a, b, rtol=1e-5, atol=1e-7):
                raise AssertionError(f"{name} on the card disagrees with "
                                     f"the CPU")
        out[name] = worst
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((64, 6)).astype(np.float32))
    y = x @ torch.from_numpy(rng.standard_normal((6, 1)).astype(np.float32))
    for search in (None, "strong_wolfe"):
        got = []
        for dev in ("cpu", "cuda"):
            w = torch.nn.Parameter(torch.zeros(6, 1, device=dev))
            xd, yd = x.to(dev), y.to(dev)
            lb = O.LBFGS(max_iter=8, history_size=5, line_search_fn=search,
                         parameters=[w])

            def closure():
                lb.clear_grad()
                loss = ((xd @ w - yd) ** 2).mean()
                loss.backward()
                return loss
            lb.step(closure)
            got.append(w.detach().cpu())
        err = float((got[1] - got[0]).abs().max())
        out[f"LBFGS {search}"] = err
        if not torch.allclose(got[1], got[0], rtol=1e-4, atol=1e-5):
            raise AssertionError(f"LBFGS ({search}) on the card disagrees "
                                 f"with the CPU")
    print("  the rules on the card vs the CPU, 3 steps of the tiny float32 "
          "Llama (largest |card - cpu| / (|cpu| + 0.01); tol rtol 1e-5): "
          + ", ".join(f"{k} {v:.3g}" for k, v in out.items()), flush=True)
    return out


def phase_training_surface(torch, args, launches_out, phase5_step_ms):
    """The llama-1.1b-b8 widths of phase 5 (bf16 weights, fp32 moments,
    batch 8 x 2048) at 6 of its 22 layers (depth cut for the smoke's
    time limit) trained the usual way: (a) the recipe
    (``_recipe``: warmup then cosine, decay off on the named norms, the
    embedding at half the rate, global-norm clipping) for 5 steps under
    full remat; (b) 3 steps, the model's, optimizer's and scheduler's
    state saved with framework.io, then loaded in place into the trainer
    that captured its step (b1) and into a fresh model and trainer whose
    first call captures (b2), each 2 steps more, bit-equal to (a); (c)
    the same 5 steps under remat "dots", bit-equal to (a); (d) 3 steps of
    float32 weights under auto_cast O1 (flash through the bf16 kernel);
    then the 2-layer agreements, the GradScaler and every optimizer rule
    against the CPU."""
    import numpy as np
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.amp import debugging
    from paddle_tpu_torch.framework import io
    from paddle_tpu_torch.optimizer import lr
    card = _card_line()
    cfg = _llama_1b(6)
    n_l = cfg.num_hidden_layers
    batch = (torch.from_numpy(np.random.default_rng(args.seed + 5).integers(
        0, cfg.vocab_size, (8, 2048))).cuda(),) * 2
    _free(torch)
    print(f"phase 12: the training surface on llama-1.1b-b8 (hidden "
          f"{cfg.hidden_size}, {n_l} layers, batch 8 x 2048), bf16 weights, "
          f"fp32 moments, seed {args.seed} [{card}]", flush=True)
    per_step = _llama_train_per_step(n_l)
    out = {"card": card}

    # (a) the recipe, full remat
    la, sa, ra, launches, peak_a, pa, prof_a = _recipe_run(
        torch, cfg, args.seed, batch, 5)
    want = lr.LinearWarmup(lr.CosineAnnealingDecay(3e-4, T_max=10), 2, 0.0,
                           3e-4)
    want_rates = []
    for _ in range(5):
        want_rates.append(float(np.float32(want())))
        want.step()
    print(f"  (a) recipe, captured: losses {la}; rates the replays read "
          f"{ra} (the scheduler's, in float32, {want_rates}); step s "
          f"{[round(x, 4) for x in sa]} (the first runs the step and "
          f"captures it); peak {peak_a:.2f} GB", flush=True)
    if ra != want_rates:
        raise AssertionError("the rates the updates used are not the "
                             "scheduler's")
    _hold_launches("phase 12 (a)", launches, per_step, 5)
    if not all(math.isfinite(x) for x in la):
        raise AssertionError(f"recipe losses not finite: {la}")
    total = dict(launches)
    step_ms = 1e3 * sum(sa[1:]) / 4
    out["recipe"] = dict(losses=la, rates=ra, step_ms=step_ms,
                         step_seconds=sa, peak_memory_gb=peak_a,
                         phase5_step_ms=phase5_step_ms, breakdown=prof_a)
    print(f"  (a) step ms (mean of steps 2-5) {step_ms:.2f}, phase 5's "
          f"(22 layers) {phase5_step_ms:.2f} in this call; a profiled step: "
          f"{_breakdown_line(prof_a)} [{card}]", flush=True)

    # (c) remat "dots"
    lc, sc, _, launches, peak_c, pc, prof_c = _recipe_run(
        torch, cfg, args.seed, batch, 5, policy="dots")
    _hold_launches("phase 12 (c) dots", launches, per_step, 5)
    for k, v in launches.items():
        total[k] += v
    dots_ms = 1e3 * sum(sc[1:]) / 4
    print(f"  (c) remat dots: losses {lc}; step ms {dots_ms:.2f} (full "
          f"{step_ms:.2f}); peak {peak_c:.2f} GB (full {peak_a:.2f}); a "
          f"profiled step: {_breakdown_line(prof_c)} [{card}]", flush=True)
    if lc != la:
        raise AssertionError(f"dots losses {lc} != full {la}")
    _same_params(torch, "phase 12 (c) dots against full", pc, pa)
    del pc
    out["dots"] = dict(losses=lc, step_ms=dots_ms, step_seconds=sc,
                       peak_memory_gb=peak_c, breakdown=prof_c)

    # (b) resume: the saved state loaded (b1) in place into the trainer
    # that captured its step, and (b2) into a fresh model, optimizer,
    # scheduler and trainer whose first call runs eagerly and captures
    path = os.path.join(args.out, "resume.pdparams")
    model = _recipe_model(torch, cfg, args.seed, torch.bfloat16)
    sched, opt = _recipe(model)
    trainer = _recipe_trainer(model, opt)
    lb, _, _ = _recipe_steps(torch, trainer, sched, batch, 3)
    t = time.monotonic()
    io.save({"model": model.state_dict(), "opt": opt.state_dict(),
             "sched": sched.state_dict()}, path)
    save_s = time.monotonic() - t
    nbytes = os.path.getsize(path)
    lost, _, _ = _recipe_steps(torch, trainer, sched, batch, 1)
    # (b1) into the live parameters and state, which the trainer's graph,
    # captured at the first step, reads and writes
    t = time.monotonic()
    state = io.load(path)
    model.load_state_dict(state["model"])
    opt.set_state_dict(state["opt"])
    sched.set_state_dict(state["sched"])
    torch.cuda.synchronize()
    load_s = time.monotonic() - t
    del state
    K.reset_launches()
    lb1, _, _ = _recipe_steps(torch, trainer, sched, batch, 2)
    launches = dict(K.LAUNCHES)
    _hold_launches("phase 12 (b1) resumed in place", launches, per_step, 2)
    for k, v in launches.items():
        total[k] += v
    if len(trainer._graphs) != 1:
        raise AssertionError("the resumed steps did not replay the graph "
                             "captured before the load")
    pb1 = {k: p.detach().cpu() for k, p in model.named_parameters()}
    _drop_trainer(torch, trainer)
    del model, opt, sched, trainer
    _free(torch)
    # (b2) into a fresh model (other weights, so the load must replace
    # them), optimizer, scheduler and trainer
    t = time.monotonic()
    state = io.load(path)
    model = _recipe_model(torch, cfg, args.seed + 99, torch.bfloat16)
    sched, opt = _recipe(model)
    model.load_state_dict(state["model"])
    opt.set_state_dict(state["opt"])
    sched.set_state_dict(state["sched"])
    trainer = _recipe_trainer(model, opt)
    torch.cuda.synchronize()
    load2_s = time.monotonic() - t
    del state
    os.remove(path)
    K.reset_launches()
    lb2, _, _ = _recipe_steps(torch, trainer, sched, batch, 2)
    launches = dict(K.LAUNCHES)
    _hold_launches("phase 12 (b2) resumed into a fresh trainer", launches,
                   per_step, 2)
    for k, v in launches.items():
        total[k] += v
    if len(trainer._graphs) != 1:
        raise AssertionError("the fresh trainer did not capture its step")
    pb2 = {k: p.detach().cpu() for k, p in model.named_parameters()}
    _drop_trainer(torch, trainer)
    del model, opt, sched, trainer
    _free(torch)
    print(f"  (b) resume: losses {lb} saved, then (b1) in place into the "
          f"captured trainer {lb1} (a step {lost} taken and undone by the "
          f"load), (b2) into a fresh model and trainer {lb2}; saved "
          f"{nbytes / 1e9:.3f} GB in {save_s:.2f} s, loaded in place in "
          f"{load_s:.2f} s, into the fresh model in {load2_s:.2f} s "
          f"[{card}]", flush=True)
    for name, got, pb in (("b1", lb1, pb1), ("b2", lb2, pb2)):
        if lb + got != la:
            raise AssertionError(f"({name}) resumed losses {lb + got} != "
                                 f"{la}")
        _same_params(torch, f"phase 12 ({name}) resumed against "
                     f"uninterrupted", pb, pa)
    del pa, pb1, pb2
    out["resume"] = dict(losses=lb + lb1, fresh_losses=lb + lb2,
                         save_s=save_s, load_s=load_s, fresh_load_s=load2_s,
                         bytes=nbytes)

    # (d) auto_cast O1 over float32 weights
    model = _recipe_model(torch, cfg, args.seed, torch.float32)
    sched, opt = _recipe(model)
    trainer = _recipe_trainer(model, opt, cast=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    ld, sd, _ = _recipe_steps(torch, trainer, sched, batch, 3)
    launches = dict(K.LAUNCHES)
    peak_d = torch.cuda.max_memory_allocated() / 1e9
    _hold_launches("phase 12 (d) auto_cast", launches, per_step, 3)
    for k, v in launches.items():
        total[k] += v
    # which flash kernel the attention took: the ops of one forward,
    # counted by name and input dtype (amp.debugging), which the kernels
    # still run
    K.reset_launches()
    debugging.enable_operator_stats_collection()
    try:
        with torch.no_grad():
            trainer.loss_fn(model, *batch)
    finally:
        stats = debugging.disable_operator_stats_collection()
    observed = dict(K.LAUNCHES)
    graph_d = _graph_line(trainer, "phase 12 (d) auto_cast", card)
    _drop_trainer(torch, trainer)
    del model, opt, sched, trainer
    _free(torch)
    cast_ms = 1e3 * sum(sd[1:]) / 2
    print(f"  (d) auto_cast O1 over float32 weights: losses {ld}; step ms "
          f"{cast_ms:.2f}; peak {peak_d:.2f} GB [{card}]", flush=True)
    out["auto_cast"] = dict(losses=ld, step_ms=cast_ms, peak_memory_gb=peak_d,
                            flash_ops=stats.get("flash_attention(bfloat16)"),
                            graph=graph_d)
    if not all(math.isfinite(x) for x in ld) \
            or stats.get("flash_attention(bfloat16)") != n_l \
            or "flash_attention(float32)" in stats:
        raise AssertionError(f"auto_cast: losses {ld}, attention ops "
                             f"{stats}")
    def ops(name):
        return sum(v for k, v in stats.items() if k.split("(")[0] == name)
    if ops("silu") != n_l or ops("multiply") < n_l \
            or observed["swiglu_fwd"] != n_l or observed["flash_fwd"] != n_l:
        raise AssertionError(f"(d) a forward under operator stats: ops "
                             f"{stats}, launches {observed} (the SwiGLU and "
                             f"flash kernels once a layer)")
    out["recipe_2_layers"] = _recipe_agreement(torch, args.seed, False)
    out["auto_cast_2_layers"] = _recipe_agreement(torch, args.seed, True)
    out["grad_scaler"] = _grad_scaler_on_card(torch, args.seed)
    out["rules"] = _rules_on_card(torch)
    launches_out.update(total)
    print("  training surface: " + json.dumps(out, default=str), flush=True)
    return out


# -- phase 3 (dropout and LayerNorm kernels) and phase 13: ERNIE pretraining ----------

ERNIE_STEP = 26        # LayerNorms a step: embeddings, 2 a layer, MLM head


def _philox_ops(n):
    """Integer operations of n elements' Philox words: 10 rounds of 2
    multiply-highs, 2 multiply-lows, 4 xors and 2 key adds a block of 4
    words (25 an element), and the compare and select (2)."""
    return 27 * n


def _rk(base, site):
    from paddle_tpu_torch.framework.random import RandomKey
    return RandomKey(base, site)


def _dropout_case(torch, results, dev, name, shape, dtype, p, seed):
    """The dropout kernel over ``shape`` against its plain version (bit
    for bit) and torch's own ``F.dropout`` (its own stream: the library
    yardstick), with the keep fraction within 5 sigma of 1 - p."""
    import torch.nn.functional as TF
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels import dropout as D
    card = _card_line()
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(*shape, device=dev, generator=g).to(dtype)
    key = _rk(torch.tensor([seed, 77], device=dev), 5)
    before = K.LAUNCHES["dropout"]
    with torch.no_grad():
        y = D.dropout(x, key, p)
    if K.LAUNCHES["dropout"] != before + 1:
        raise AssertionError(f"{name}: the dropout kernel did not launch")
    want = D.dropout_plain(x, p, key)
    torch.cuda.synchronize()
    same = bool(torch.equal(y, want))
    n = x.numel()
    frac = float((want != 0).float().mean()) if dtype == torch.float32 \
        else float(D.keep_mask_plain(shape, p, key, dev).float().mean())
    sigma = (p * (1 - p) / n) ** 0.5
    err = float((y.float() - want.float()).abs().max())
    print(f"  {name} {list(shape)} {str(dtype)[6:]} p={p}: bit-equal to the "
          f"plain version {same}; keep fraction {frac:.6f} (1 - p = {1 - p},"
          f" {abs(frac - (1 - p)) / sigma:.2f} sigma)", flush=True)
    if not same or abs(frac - (1 - p)) > 5 * sigma:
        raise AssertionError(f"{name}: the dropout kernel disagrees with "
                             f"its plain version or its rate")
    del y, want
    with torch.no_grad():
        ms = _graph_ms(lambda: D.dropout(x, key, p), iters=10, reps=3)
        plain_ms = _time_ms(lambda: D.dropout_plain(x, p, key), 2, warmup=1)
        lib_ms = _time_ms(lambda: TF.dropout(x, p), 10)
    esize = x.element_size()
    bound_ms, bound_by = _bound(2 * esize * n, _philox_ops(n), FP32_FLOPS)
    results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=lib_ms, shape=list(shape),
                         dtype=str(dtype)[6:], keep_fraction=frac)
    print(f"  {name}: ms={ms:.4f} ({bound_ms / ms:.3f} of the bound) "
          f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}); "
          f"F.dropout {lib_ms:.4f} ms [{card}]", flush=True)
    del x
    torch.cuda.empty_cache()


def _dropout_replay(torch, dev):
    """One dropout call captured in a CUDA graph under a key tensor: each
    replay after the tensor was rewritten equals an eager call with the
    new key's words (a host key), bit for bit."""
    from paddle_tpu_torch.kernels import dropout as D
    x = torch.randn(16384, 768, device=dev).to(torch.bfloat16)
    keyt = torch.tensor([1, 2], device=dev)
    with torch.no_grad():
        D.dropout(x, _rk(keyt, 3), 0.1)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = D.dropout(x, _rk(keyt, 3), 0.1)
        same = []
        for words in ((7, 8), (2 ** 32 - 1, 12345), (0, 0)):
            keyt.copy_(torch.tensor(words))
            graph.replay()
            same.append(bool(torch.equal(out, D.dropout(x, _rk(words, 3),
                                                        0.1))))
    print(f"  dropout replayed from a CUDA graph with three new keys: equal "
          f"to the eager calls {same}", flush=True)
    if not all(same):
        raise AssertionError("a replayed dropout disagrees with the eager "
                             "call for its key")
    del graph


def _dln_triton(torch, h, w, dy, eps, p=0.0, key=None):
    """The Triton LayerNorm backward (the plan's other route) on the
    inputs of a CUDA-kernel call: (dx, dh, dweight, dnorm_bias, dbias) as
    ``dropout_add_layer_norm_backward`` returns them."""
    from paddle_tpu_torch.kernels import fused, sm_count
    n = h.shape[-1]
    dh = torch.empty_like(h)
    dx = torch.empty_like(h) if p else dh
    sums = torch.empty(3 * n, dtype=torch.float32, device=h.device)
    fused._triton_backward(h, w, dy, dh, dx, sums, eps, p, key,
                           "upscale_in_train", fused._triton_plan(
                               h.numel() // n, n, sm_count(h.device)))
    return dx, dh, sums[:n], sums[n:2 * n], sums[2 * n:]


def _dln_case(torch, results, dev, p, seed=41):
    """LayerNorm(residual + dropout(x + bias)) over [16384, 768] bf16 (the
    ERNIE step's Add&LN; ``p`` = 0 with no residual and no bias: its plain
    LayerNorms), forward and backward, against the plain ops: the norm's
    input bit-equal to the ops one by one (the dropout kernel's mask), y
    and every gradient each row within one bf16 ulp of its largest plain
    value (vectors: of the largest), and no further from float32 than the
    plain bf16 ops (1.1x); timed beside F.layer_norm and its autograd."""
    import torch.nn.functional as TF
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels import dropout as D
    from paddle_tpu_torch.kernels import fused
    card = _card_line()
    rows, n, bf, eps = 16384, 768, torch.bfloat16, 1e-12
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(rows, n, device=dev, generator=g).to(bf)
    r = torch.randn(rows, n, device=dev, generator=g).to(bf) if p else None
    b = (0.1 * torch.randn(n, device=dev, generator=g)).to(bf) if p else None
    w = (1 + 0.1 * torch.randn(n, device=dev, generator=g)).to(bf)
    nb = (0.1 * torch.randn(n, device=dev, generator=g)).to(bf)
    dy = torch.randn(rows, n, device=dev, generator=g).to(bf)
    key = _rk(torch.tensor([seed, 5], device=dev), 2) if p else None
    tag = "dropout_add_ln" + ("" if p else " (LayerNorm, p 0)")
    before = dict(K.LAUNCHES)
    y, h = fused.dropout_add_layer_norm_forward(x, w, nb, eps, r, b, p, key)
    dx, dh, dw, dnb, db = fused.dropout_add_layer_norm_backward(
        h, w, dy, eps, p, key)
    used = tuple(K.LAUNCHES[k] - before[k] for k in (
        "dropout_add_ln", "dropout_add_ln_bwd", "dropout_add_ln_bwd_warp"))
    if used != (1, 1, 1):
        raise AssertionError(f"{tag}: kernel launches {used} (the backward "
                             f"on the CUDA kernel expected)")
    # the Triton route (the plan's other kernel) on the same inputs: the same
    # tolerances, and timed beside the CUDA kernel
    tri = _dln_triton(torch, h, w, dy, eps, p, key)
    with torch.no_grad():
        want_h = x if b is None else x + b
        if p:
            want_h = D.dropout(want_h, key, p)
        if r is not None:
            want_h = want_h + r
    same_h = bool(torch.equal(h, want_h))

    def plain(dtype, plain_ops):
        leaves = [t.detach().to(dtype).clone().requires_grad_()
                  if t is not None else None for t in (x, r, b, w, nb)]
        lx, lr, lb, lw, lnb = leaves
        with ExitStack() as stack:
            if plain_ops:
                _plain_train_patches(stack)
            out = fused.dropout_add_layer_norm(lx, lw, lnb, eps, lr, lb, p,
                                               key)
            out.backward(dy.to(dtype))
        grads = {"dx": lx.grad, "dw": lw.grad, "dnb": lnb.grad}
        if lr is not None:
            grads.update(dres=lr.grad, dbias=lb.grad)
        return out.detach(), grads
    py, pg = plain(bf, True)
    ry, rg = plain(torch.float32, True)
    torch.cuda.synchronize()
    got = {"dx": dx, "dw": dw.to(bf), "dnb": dnb.to(bf)}
    tgot = {"dx": tri[0], "dw": tri[2].to(bf), "dnb": tri[3].to(bf)}
    if r is not None:
        got.update(dres=dh, dbias=db.to(bf))
        tgot.update(dres=tri[1], dbias=tri[4].to(bf))
    print(f"  {tag}: the norm's input bit-equal to the ops one by one "
          f"{same_h}", flush=True)
    if not same_h:
        raise AssertionError(f"{tag}: h differs from dropout, add, add")
    err_f = _check_rows(f"{tag} y", y, py, 1)
    _check_vs_f32(f"{tag} y", y, py, ry)
    err_b = err_t = 0.0
    for k in got:
        if got[k].dim() > 1:
            err_b = max(err_b, _check_rows(f"{tag} {k}", got[k], pg[k], 1))
            err_t = max(err_t, _check_rows(f"{tag} {k} (Triton)", tgot[k],
                                           pg[k], 1))
        else:
            tol = ULP_BF16 * float(pg[k].float().abs().max())
            err_b = max(err_b, _check(f"{tag} {k}", got[k], pg[k], tol))
            err_t = max(err_t, _check(f"{tag} {k} (Triton)", tgot[k], pg[k],
                                      tol))
        _check_vs_f32(f"{tag} {k}", got[k], pg[k], rg[k])
        _check_vs_f32(f"{tag} {k} (Triton)", tgot[k], pg[k], rg[k])
    del py, pg, ry, rg, got, tgot, tri, dx, dh, y
    fwd = lambda: fused.dropout_add_layer_norm_forward(x, w, nb, eps, r, b,
                                                       p, key)
    bwd = lambda: fused.dropout_add_layer_norm_backward(h, w, dy, eps, p,
                                                        key)
    with torch.no_grad():
        ms_f = _graph_ms(fwd)
        ms_b = _graph_ms(bwd)
        ms_t = _graph_ms(lambda: _dln_triton(torch, h, w, dy, eps, p, key))
        plain_f = _time_ms(lambda: fused.dropout_add_layer_norm_plain(
            x, w, nb, eps, r, b, p, key), 5)
    lib_f = _time_ms(lambda: TF.layer_norm(h, (n,), w, nb, eps), 10)
    hl, wl, nbl = (t.clone().requires_grad_() for t in (h, w, nb))
    yl = TF.layer_norm(hl, (n,), wl, nbl, eps)
    lib_b = _time_ms(lambda: torch.autograd.grad(yl, (hl, wl, nbl), dy,
                                                 retain_graph=True), 10)

    def plain_bwd():
        leaves = [t.detach().clone().requires_grad_() if t is not None
                  else None for t in (x, r, b, w, nb)]
        with ExitStack() as stack:
            _plain_train_patches(stack)
            out = fused.dropout_add_layer_norm(leaves[0], leaves[3],
                                               leaves[4], eps, leaves[1],
                                               leaves[2], p, key)
        return lambda: torch.autograd.grad(
            out, [t for t in leaves if t is not None], dy, retain_graph=True)
    plain_b = _time_ms(plain_bwd(), 5)
    del hl, wl, nbl, yl
    nel = rows * n
    extra = 2 if p else 0            # the residual and the written h
    fb, fo = _bound(2 * nel * (2 + extra) + 2 * 3 * n,
                    8 * nel + (_philox_ops(nel) if p else 0), FP32_FLOPS)
    bb, bo = _bound(2 * nel * (3 + (1 if p else 0)) + 2 * 4 * n,
                    14 * nel + (_philox_ops(nel) if p else 0), FP32_FLOPS)
    suffix = "" if p else "[ln]"
    results["dropout_add_ln" + suffix] = dict(
        max_abs_err=err_f, ms=ms_f, plain_ms=plain_f, bound_ms=fb,
        bound_by=fo, library_ms=lib_f, shape=[rows, n], p=p)
    # the CUDA kernel (the plan's route) and the Triton kernel
    results["dropout_add_ln_bwd_warp" + suffix] = dict(
        max_abs_err=err_b, ms=ms_b, plain_ms=plain_b, bound_ms=bb,
        bound_by=bo, library_ms=lib_b, shape=[rows, n], p=p)
    results["dropout_add_ln_bwd" + suffix] = dict(
        max_abs_err=err_t, ms=ms_t, plain_ms=plain_b, bound_ms=bb,
        bound_by=bo, library_ms=lib_b, shape=[rows, n], p=p)
    print(f"  {tag} [{rows}, {n}] bf16: forward ms={ms_f:.4f} ({fb / ms_f:.3f}"
          f" of the bound) plain_ms={plain_f:.4f} bound_ms={fb:.4f} ({fo}), "
          f"F.layer_norm {lib_f:.4f}; backward (CUDA, a warp a row) ms="
          f"{ms_b:.4f} ({bb / ms_b:.3f}), Triton ms={ms_t:.4f} "
          f"({bb / ms_t:.3f}) plain_ms={plain_b:.4f} bound_ms={bb:.4f} "
          f"({bo}), autograd of F.layer_norm {lib_b:.4f} [{card}]",
          flush=True)
    del x, r, b, w, nb, dy, h
    torch.cuda.empty_cache()


def phase_dropout_kernels(torch, results):
    """The dropout kernel over the ERNIE step's hidden states ([16384,
    768] bf16) and attention probabilities ([32, 12, 512, 512] fp32) at p
    0.1, and LayerNorm(residual + dropout(x + bias)) forward and backward
    over [16384, 768] bf16 with the dropout and as a plain LayerNorm, each
    against its plain version, timed (graph replay) beside its bound, its
    plain version and a PyTorch call; then a captured dropout replayed
    with new keys."""
    dev = torch.device("cuda")
    print("phase 3: dropout and LayerNorm kernels against their plain "
          "versions (dropout bit-equal; LayerNorm's input bit-equal, its "
          "output and gradients each row within one bf16 ulp of its largest "
          "plain value, and no further from float32 than plain bf16, 1.1x)",
          flush=True)
    _dropout_case(torch, results, dev, "dropout", (32, 12, 512, 512),
                  torch.float32, 0.1, 51)
    _dropout_case(torch, results, dev, "dropout[hidden]", (16384, 768),
                  torch.bfloat16, 0.1, 52)
    _dropout_replay(torch, dev)
    _dln_case(torch, results, dev, 0.1)
    _dln_case(torch, results, dev, 0.0)
    for tag, rows, n in LN_ROW_CASES:
        _ln_row_case(torch, results, dev, tag, rows, n)


# (tag, rows, n): plain LayerNorms of the main paths in the dtype their
# steps give them, fp32 (the black list under O1 and O2): the UNet's
# 64 x 64 transformer blocks at batch 4 and Transformer-base's 64 x 64
# tokens
LN_ROW_CASES = (("unet [16384, 320] fp32", 16384, 320),
                ("transformer_base [4096, 512] fp32", 4096, 512))


def _ln_row_case(torch, results, dev, tag, rows, n, seed=43):
    """A plain LayerNorm's backward in fp32 on the CUDA kernel (the plan's
    route) and on the Triton kernel, each against the plain autograd
    (2e-5 of the largest value), timed by graph replay beside the bound,
    the plain version and the autograd of F.layer_norm."""
    import torch.nn.functional as TF
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels import fused
    card = _card_line()
    eps = 1e-5
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(rows, n, device=dev, generator=g)
    w = 1 + 0.1 * torch.randn(n, device=dev, generator=g)
    nb = 0.1 * torch.randn(n, device=dev, generator=g)
    dy = torch.randn(rows, n, device=dev, generator=g)
    before = K.LAUNCHES["dropout_add_ln_bwd_warp"]
    got = fused.dropout_add_layer_norm_backward(h, w, dy, eps)
    if K.LAUNCHES["dropout_add_ln_bwd_warp"] - before != 1:
        raise AssertionError(f"layer_norm_bwd {tag}: not on the CUDA kernel")
    tri = _dln_triton(torch, h, w, dy, eps)
    leaves = [t.clone().requires_grad_() for t in (h, w, nb)]
    fused.layer_norm_plain(leaves[0], leaves[1], leaves[2], eps).backward(dy)
    errs = []
    for route, (dx, _, dw, dnb, _) in (("CUDA", got), ("Triton", tri)):
        err = 0.0
        for k, a, c in (("dx", dx, leaves[0].grad), ("dw", dw, leaves[1].grad),
                        ("dnb", dnb, leaves[2].grad)):
            err = max(err, _check(f"layer_norm_bwd {tag} {k} ({route})", a,
                                  c, 2e-5 * max(1.0, float(c.abs().max()))))
        errs.append(err)
    with torch.no_grad():
        ms = _graph_ms(lambda: fused.dropout_add_layer_norm_backward(
            h, w, dy, eps))
        ms_t = _graph_ms(lambda: _dln_triton(torch, h, w, dy, eps))
    pl = [t.clone().requires_grad_() for t in (h, w, nb)]
    py = fused.layer_norm_plain(pl[0], pl[1], pl[2], eps)
    plain = _time_ms(lambda: torch.autograd.grad(py, pl, dy,
                                                 retain_graph=True), 5)
    hl = h.clone().requires_grad_()
    yl = TF.layer_norm(hl, (n,), w, nb, eps)
    lib = _time_ms(lambda: torch.autograd.grad(yl, hl, dy,
                                               retain_graph=True), 10)
    bound, by = _bound(4 * (3 * rows * n + 4 * n), 14 * rows * n, FP32_FLOPS)
    for key, err, t in (("dropout_add_ln_bwd_warp", errs[0], ms),
                        ("dropout_add_ln_bwd", errs[1], ms_t)):
        results[f"{key}[{tag}]"] = dict(
            max_abs_err=err, ms=t, plain_ms=plain, bound_ms=bound,
            bound_by=by, library_ms=lib, shape=[rows, n], p=0.0)
    print(f"  layer_norm_bwd {tag}: CUDA ms={ms:.4f} ({bound / ms:.3f} of "
          f"the bound) Triton ms={ms_t:.4f} ({bound / ms_t:.3f}) plain_ms="
          f"{plain:.4f} bound_ms={bound:.4f} ({by}), autograd of "
          f"F.layer_norm {lib:.4f} [{card}]", flush=True)
    del h, w, nb, dy, got, tri, leaves, pl, py, hl, yl
    torch.cuda.empty_cache()


def _ernie_batch(torch, cfg, seed, b=32, s=512):
    """A pretraining batch from ``seed``: random ids, two segments a row
    (token types 0 then 1, the cut uniform in [s / 8, 7 s / 8]), 15% of the
    positions labelled with their ids (the rest -100), NSP labels 0/1."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (b, s))
    tt = np.zeros((b, s), np.int64)
    for i, cut in enumerate(rng.integers(s // 8, s - s // 8 + 1, b)):
        tt[i, cut:] = 1
    labels = np.where(rng.random((b, s)) < 0.15, ids, -100)
    nsp = rng.integers(0, 2, b)
    return tuple(torch.from_numpy(a).cuda() for a in (ids, tt, labels, nsp))


def _ernie_loss(m, ids, tt, labels, nsp):
    from paddle_tpu_torch.models import ernie_pretrain_step
    return ernie_pretrain_step(m, {"input_ids": ids, "token_type_ids": tt,
                                   "mlm_labels": labels, "nsp_labels": nsp})


def _ernie_model(torch, cfg, seed, dtype=None, device="cuda"):
    from paddle_tpu_torch.models import ErnieForPretraining
    gen = torch.Generator(device=device).manual_seed(seed) if seed \
        is not None else None
    model = ErnieForPretraining(cfg, device=device, generator=gen)
    if dtype == torch.bfloat16:
        model.bfloat16()
    return model


def _ernie_trainer(model, lr=1e-4):
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import SpmdTrainer
    return SpmdTrainer(model, AdamW(learning_rate=lr, weight_decay=0.01,
                                    parameters=model.parameters()),
                       _ernie_loss)


def _ernie_per_step(cfg, dropout):
    from paddle_tpu_torch import kernels as K
    n_l = cfg.num_hidden_layers
    per_step = {n: 0 for n in K.LAUNCHES}
    per_step.update(adamw=1, dropout_add_ln=2 * n_l + 2,
                    dropout_add_ln_bwd=2 * n_l + 2,
                    dropout_add_ln_bwd_warp=2 * n_l + 2)
    if dropout:
        # forward and backward: the embeddings' dropout (the attention
        # probabilities' is inside X2, the dense attention's middle)
        per_step.update(dropout=2, sdpa_dense=n_l, dense_softmax=n_l,
                        dense_softmax_bwd=n_l,
                        dense_softmax_cuda=0)   # 512 keys: Triton
    else:
        per_step.update(flash_fwd=n_l, flash_bwd_dq=n_l, flash_bwd_dkv=n_l)
    return per_step


def _ernie_run(torch, cfg, args, tag, launches_out, dropout):
    """ERNIE-base pretraining, captured: 2 warm-up and 5 timed steps with
    exact launch counts, finite and falling losses, step ms, tokens/s,
    MFU, peak memory, the graph's pool, a profile of one step by kernel
    group. Returns (stats, trainer, batch, the profile's breakdown)."""
    from paddle_tpu_torch import kernels as K
    card = _card_line()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    model = _ernie_model(torch, cfg, args.seed, torch.bfloat16)
    trainer = _ernie_trainer(model)
    batch = _ernie_batch(torch, cfg, args.seed)
    b, s = batch[0].shape
    losses = []
    for _ in range(2):      # the first call runs the step, then captures it
        losses.append(float(trainer.train_step(*batch)))
    trainer.block()
    K.reset_launches()
    t0 = time.monotonic()
    timed = [trainer.train_step(*batch) for _ in range(5)]
    trainer.block()
    secs = time.monotonic() - t0
    launches = dict(K.LAUNCHES)
    losses += [float(x) for x in timed]
    graph = _graph_line(trainer, tag, card)
    per_step = _ernie_per_step(cfg, dropout)
    expect = {k: 5 * v for k, v in per_step.items()}
    print(f"  {tag} launches over 5 steps: {launches} (expected {expect}: "
          f"per step {per_step})", flush=True)
    if launches != expect:
        raise AssertionError(f"{tag}: launch counts {launches} != {expect}")
    for k, v in launches.items():
        launches_out[k] = launches_out.get(k, 0) + v
    step_ms = 1e3 * secs / 5
    tok_s = b * s / (secs / 5)
    fpt = model.flops_per_token(s)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  {tag} losses {losses} [{card}]", flush=True)
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"{tag}: losses not finite and falling: "
                             f"{losses}")
    stats = dict(params=model.num_params(), batch=b, seq=s, step_ms=step_ms,
                 tokens_per_s=tok_s, flops_per_token=fpt,
                 mfu_vs_989_tflops=fpt * tok_s / BF16_FLOPS,
                 peak_memory_gb=peak_gb,
                 peak_memory_of_phase_gb=peak_gb - held / 1e9, losses=losses,
                 card=card, graph=graph, launches_a_step=per_step)
    prof, m = _profile(torch, lambda: trainer.train_step(*batch), 1)
    _save_trace(prof, os.path.join(
        args.out, f"ernie_train_step_trace{'' if dropout else '_p0'}.json"))
    del prof
    stats["breakdown"] = m
    stats["idle_share_untraced"] = 1 - m["device_ms"] / step_ms
    print(f"  {tag}: step {step_ms:.3f} ms, {tok_s:.0f} tokens/s, MFU "
          f"{stats['mfu_vs_989_tflops']:.4f} (flops/token {fpt:.4g}), peak "
          f"{peak_gb:.2f} GB; {_breakdown_line(m)}; idle share against the "
          f"untraced step {stats['idle_share_untraced']:.4f} [{card}]",
          flush=True)
    print(f"  {tag} by group (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in m["by_group_ms"].items()), flush=True)
    _print_other(m, tag)
    return stats, trainer, batch, m


def _same_seed_same_step(torch, trainer, batch, seed):
    """From one snapshot of weights and optimizer state (loaded back in
    place each time), one captured step under ``seed``, again under
    ``seed``, then under ``seed + 1``: the first two bit-equal (loss and
    every parameter), the third's loss different (new masks)."""
    import paddle_tpu_torch as ptt
    params = [p.detach().clone() for p in trainer.model.parameters()]
    state = trainer.opt.state_dict()
    step0 = trainer.opt._global_step
    out = []
    for sd in (seed, seed, seed + 1):
        with torch.no_grad():
            for p, q in zip(trainer.model.parameters(), params):
                p.copy_(q)
        trainer.opt.set_state_dict(state)
        trainer.opt._global_step = step0
        ptt.seed(sd)
        loss = trainer.train_step(*batch)
        trainer.block()
        out.append((loss, [p.detach().clone() for p in
                           trainer.model.parameters()]))
    same = bool(torch.equal(out[0][0], out[1][0])) and all(
        torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    other = not bool(torch.equal(out[0][0], out[2][0]))
    print(f"  phase 13 (a): one step from one snapshot under seed {seed} "
          f"twice: bit-equal {same} (loss {float(out[0][0]):.6f}); under "
          f"seed {seed + 1}: loss {float(out[2][0]):.6f}, different {other} "
          f"[{_card_line()}]", flush=True)
    if not (same and other):
        raise AssertionError("phase 13: a seed does not fix the step's "
                             "masks")
    return dict(same_seed_bit_equal=same, other_seed_differs=other)


def _ernie_agreement(torch, seed):
    """One forward + backward of ERNIE-base widths at 2 layers (batch 8 x
    512, dropout 0.1) through the kernels and through the plain versions,
    in bf16 and in float32 (the same bf16-valued weights, upcast), every
    run under one fixed key (so every path draws the same masks: the
    kernels' and the plain versions' bits are equal). float32: loss 1e-5
    relative, gradients 1e-3 relative L2; bf16: the kernels' gradients no
    further from the float32 step than the plain bf16 path's, 1.1x over
    all and 1.25x each (the phase 5 gate; a parameter of fewer than
    SMALL_LEAF elements as ``_leaf_ratios`` says)."""
    import dataclasses
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.framework.random import key_context
    from paddle_tpu_torch.models import ErnieConfig
    cfg = dataclasses.replace(ErnieConfig.ernie_base(), num_hidden_layers=2)
    batch = _ernie_batch(torch, cfg, seed + 13, b=8)
    base = _ernie_model(torch, cfg, seed + 13, torch.bfloat16)
    state = {n: p.detach() for n, p in base.named_parameters()}
    del base

    def run(dtype, plain):
        model = _ernie_model(torch, cfg, None, dtype)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(state[n].to(dtype))
        before = dict(K.LAUNCHES)
        with ExitStack() as stack, key_context((seed + 13, 99)):
            if plain:
                _plain_train_patches(stack)
            loss = _ernie_loss(model, *batch).float()
            loss.backward()
            torch.cuda.synchronize()
        used = {n: K.LAUNCHES[n] - before[n] for n in K.kernel_launches()}
        if plain and any(used.values()):
            raise AssertionError(f"the plain ERNIE step launched {used}")
        if not plain and not all(used[n] for n in (
                "dropout", "dropout_add_ln", "dropout_add_ln_bwd",
                "dense_softmax", "dense_softmax_bwd")):
            raise AssertionError(f"the kernel ERNIE step launched {used}")
        return float(loss.detach()), {n: p.grad.float() for n, p in
                                      model.named_parameters()}

    lk32, gk32 = run(torch.float32, False)
    lp32, gp32 = run(torch.float32, True)
    err32, _ = _rel_dist(gk32, gp32)
    sizes = {n: g.numel() for n, g in gp32.items()}
    del gk32
    lk16, gk16 = run(torch.bfloat16, False)
    err_k, leaf_k = _rel_dist(gk16, gp32)
    del gk16
    lp16, gp16 = run(torch.bfloat16, True)
    err_p, leaf_p = _rel_dist(gp16, gp32)
    del gp16, gp32
    torch.cuda.empty_cache()
    ratio, small = _leaf_ratios(leaf_k, leaf_p, sizes, err_p)
    worst = max(ratio, key=ratio.get)
    loss32 = abs(lk32 / lp32 - 1)
    print(f"  phase 13 (c) ERNIE step kernels vs plain (ERNIE-base widths, 2"
          f" layers, 8 x 512, dropout 0.1, the same masks, seed {seed}): "
          f"float32 loss {lk32:.6f} vs {lp32:.6f} (rel err {loss32:.3g}, tol "
          f"1e-5), grads rel L2 err {err32:.3g} (tol 1e-3); bf16 loss "
          f"kernels {lk16:.6f} plain {lp16:.6f}, grads' rel L2 distance from "
          f"the float32 step: kernels {err_k:.5g}, plain {err_p:.5g} (tol "
          f"1.1x); per parameter the largest ratio kernels / plain "
          f"{ratio[worst]:.4g} at {worst} (tol 1.25; below {SMALL_LEAF} "
          f"elements over the larger of its plain distance and the plain "
          f"one over all: {_small_leaves_line(small)}); the largest ratios "
          f"of own distances: {_worst_leaves(leaf_k, leaf_p, sizes)} "
          f"[{_card_line()}]", flush=True)
    if not (loss32 <= 1e-5 and err32 <= 1e-3 and err_k <= 1.1 * err_p
            and max(ratio.values()) <= 1.25
            and all(math.isfinite(x) for x in (lk16, lp16, err_k, err_p))):
        raise AssertionError("the ERNIE kernel step disagrees with the "
                             "plain step")
    return dict(loss_rel_err_f32=loss32, grad_rel_err_f32=err32,
                bf16_grad_err_kernels=err_k, bf16_grad_err_plain=err_p,
                bf16_grad_err_ratio_worst_param=ratio[worst],
                worst_param=worst, small_params=small)


def _ernie_tiny_on_card(torch):
    """A tiny float32 ERNIE (hidden 256, 4 heads of 64, 2 layers, 128
    positions) at dropout 0.1 trained 3 steps on the card against the
    port's CPU trainer from the same seed (the same masks, bit for bit):
    losses within 1e-5 relative, weights within 1e-5 for 99.9% of the
    elements and 3 lr for all."""
    import dataclasses
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models import ErnieConfig, load_numpy_state
    cfg = dataclasses.replace(
        ErnieConfig.tiny(vocab_size=512, hidden_size=256, layers=2, heads=4,
                         seq=128),
        hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    cpu = _ernie_model(torch, cfg, 9, device="cpu")
    gpu = _ernie_model(torch, cfg, None)
    load_numpy_state(gpu, {n: p.detach().numpy()
                           for n, p in cpu.named_parameters()})
    batch = tuple(t.cpu() for t in _ernie_batch(torch, cfg, 9, b=4, s=128))
    lr = 1e-3
    losses = []
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        ptt.seed(17)
        tr = _ernie_trainer(model, lr)
        K.reset_launches()
        losses.append([float(tr.train_step(*(t.to(dev) for t in batch)))
                       for _ in range(3)])
    used = dict(K.LAUNCHES)
    close = total = 0
    worst = 0.0
    for (n, p), q in zip(cpu.named_parameters(), gpu.parameters()):
        d = (q.detach().cpu() - p.detach()).abs()
        worst = max(worst, float(d.max()))
        close += int((d <= 1e-5).sum())
        total += d.numel()
    want, got = losses
    loss_err = max(abs(a / b - 1) for a, b in zip(got, want))
    print(f"  phase 13 (d) tiny f32 ERNIE at dropout 0.1, 3 steps on the "
          f"card vs the CPU trainer: losses {got} vs {want} (max rel err "
          f"{loss_err:.3g}, tol 1e-5); weights within 1e-5: {close}/{total},"
          f" worst {worst:.3g} (tol {3 * lr}); launches {used} "
          f"[{_card_line()}]", flush=True)
    if not (loss_err <= 1e-5 and close >= 0.999 * total and worst <= 3 * lr
            and used["dropout"] > 0 and used["dropout_add_ln"] > 0):
        raise AssertionError("ERNIE training on the card disagrees with the "
                             "CPU")
    return dict(loss_rel_err=loss_err, weights_close=close / total,
                worst=worst)


def _ernie_classifier(torch, args, card):
    """ErnieForSequenceClassification (3 classes) in eval at [32, 512]
    bf16: without a mask through flash (12 forwards, nothing dense), with a
    padding mask through the dense route (12 ``sdpa_dense``, 12 X2
    forwards, no flash);
    each path's logits no further from the float32 plain forward than the
    plain bf16 path's, within 2x (the serving gate), with ms."""
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models import (ErnieConfig,
                                         ErnieForSequenceClassification)
    cfg = ErnieConfig.ernie_base()
    model = ErnieForSequenceClassification(
        cfg, num_classes=3, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(args.seed + 5))
    model.bfloat16()
    model.eval()
    ids, tt = _ernie_batch(torch, cfg, args.seed + 5)[:2]
    mask = torch.ones(32, 1, 1, 512, dtype=torch.bool, device="cuda")
    for i in range(1, 32):          # row i's last 8 i keys are padding
        mask[i, ..., 512 - 8 * i:] = False
    out = {}
    n_l = cfg.num_hidden_layers
    for kind, m, route in (("no mask", None, {"flash_fwd": n_l}),
                           ("padding mask", mask, {
                               "sdpa_dense": n_l, "dense_softmax": n_l,
                               "dense_softmax_cuda": 0}
                            )):
        with torch.no_grad():
            K.reset_launches()
            logits = model(ids, tt, m)
            torch.cuda.synchronize()
            used = {k: v for k, v in K.LAUNCHES.items()
                    if v and k not in ("dropout_add_ln",)}
            route = {k: v for k, v in route.items() if v}
            ms = _time_ms(lambda: model(ids, tt, m), 5)
            with ExitStack() as stack:
                _plain_train_patches(stack)
                plain = model(ids, tt, m)
            model.float()
            with ExitStack() as stack:
                _plain_train_patches(stack)
                ref = model(ids, tt, m)
            model.bfloat16()
        if used != route:
            raise AssertionError(f"phase 13 (e) {kind}: launches {used}, "
                                 f"not {route}")
        d_k = float((logits.float() - ref).abs().max())
        d_p = float((plain.float() - ref).abs().max())
        diff = float((logits.float() - plain.float()).abs().max())
        ok = bool(torch.isfinite(logits).all()) and d_k <= 2 * d_p
        print(f"  phase 13 (e) classifier eval [32, 512] bf16, {kind}: "
              f"launches {used}, {ms:.3f} ms a forward; logits vs plain bf16 "
              f"{diff:.4g}, from the float32 forward: kernels {d_k:.4g}, "
              f"plain {d_p:.4g} (tol 2x) {'ok' if ok else 'FAIL'} [{card}]",
              flush=True)
        if not ok:
            raise AssertionError(f"phase 13 (e) {kind}: the kernels' logits "
                                 f"disagree with the plain path")
        out[kind] = dict(ms=ms, launches=used, err_vs_plain=diff,
                         err_f32_kernels=d_k, err_f32_plain=d_p)
    del model
    _free(torch)
    return out


def phase_ernie_training(torch, args, launches_out):
    """ERNIE-base pretraining (BASELINE configuration 3) at its published
    widths, uncut: vocab 18000, hidden 768, 12 layers, 12 heads, FFN 3072,
    512 positions, 4 token types, eps 1e-12, dropout 0.1 / 0.1; bf16
    weights, fp32 moments, AdamW lr 1e-4 wd 0.01, no remat, batch 32 x 512
    from the seed. (a) the captured step at dropout 0.1 (2 warm-up and 5
    timed steps, exact launch counts, then 3 captured steps against 3
    eager ones from one snapshot and random state, bit-equal, and one
    step from one snapshot under one seed twice and another once); (b)
    the same at dropout 0 (flash 12 + 12 a step); (c) the 2-layer
    agreement through kernels and plain versions; (d) a tiny float32
    ERNIE at dropout 0.1 on the card against the CPU trainer; (e)
    ErnieForSequenceClassification in eval with and without a mask."""
    import dataclasses
    from paddle_tpu_torch.models import ErnieConfig
    card = _card_line()
    cfg = ErnieConfig.ernie_base()
    print(f"phase 13: ERNIE-base pretraining (vocab {cfg.vocab_size}, hidden "
          f"{cfg.hidden_size}, {cfg.num_hidden_layers} layers, "
          f"{cfg.num_attention_heads} heads, FFN {cfg.intermediate_size}, "
          f"dropout {cfg.hidden_dropout_prob} / "
          f"{cfg.attention_probs_dropout_prob}; batch 32 x 512) bf16 "
          f"weights, fp32 moments, seed {args.seed} [{card}]", flush=True)
    out = {}
    stats, trainer, batch, m = _ernie_run(torch, cfg, args,
                                          "phase 13 (a)", launches_out, True)
    stats["eager"] = _captured_against_eager(
        torch, trainer, batch, "phase 13 (a)", card, stats["step_ms"], m)
    stats.update(_same_seed_same_step(torch, trainer, batch, args.seed + 1))
    out["dropout_0.1"] = stats
    _drop_trainer(torch, trainer)
    stats["dense_middle"] = _dense_middle_line(
        torch, "phase 13 (a)", lambda: _ernie_loss(trainer.model, *batch),
        card)
    del trainer, batch
    _free(torch)
    cfg0 = dataclasses.replace(cfg, hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)
    stats0, trainer, batch, _ = _ernie_run(torch, cfg0, args, "phase 13 (b)",
                                           launches_out, False)
    out["dropout_0"] = stats0
    print(f"  phase 13: step ms at dropout 0.1 {stats['step_ms']:.3f} "
          f"(dense attention) vs at dropout 0 {stats0['step_ms']:.3f} "
          f"(flash): the dense route costs "
          f"{stats['step_ms'] - stats0['step_ms']:.3f} ms a step [{card}]",
          flush=True)
    _drop_trainer(torch, trainer)
    del trainer, batch
    _free(torch)
    out["agreement"] = _ernie_agreement(torch, args.seed)
    out["tiny_f32_vs_cpu"] = _ernie_tiny_on_card(torch)
    out["classifier"] = _ernie_classifier(torch, args, card)
    return out


# -- phase 3: GroupNorm; phases 14-15: the convolutional models ---------------------

GN_CASES = (   # (tag, shape, layout, dtype): the UNet's level 0 and 3 in bf16,
    # an fp32 and an NHWC case
    ("[4, 320, 64, 64] bf16", (4, 320, 64, 64), "NCHW", "bfloat16"),
    ("[4, 960, 64, 64] bf16", (4, 960, 64, 64), "NCHW", "bfloat16"),
    ("[4, 1280, 8, 8] bf16", (4, 1280, 8, 8), "NCHW", "bfloat16"),
    ("[4, 320, 64, 64] fp32", (4, 320, 64, 64), "NCHW", "float32"),
    ("[4, 64, 64, 320] bf16 NHWC", (4, 64, 64, 320), "NHWC", "bfloat16"))
GN_MAIN = "[4, 960, 64, 64] bf16"      # the case of the kernels line
GN_GROUPS = 32


def _gn_bytes_ops(n_el, esize, backward, silu):
    """(bytes, operations) of a GroupNorm call: x read and y written once
    (backward: x and dy read, dx written); about 10 operations an element
    forward and 20 backward, 12 more for the SiLU (exp, division) or its
    derivative."""
    nbytes = (3 if backward else 2) * n_el * esize
    ops = (20 if backward else 10) * n_el + (12 * n_el if silu else 0)
    return nbytes, ops


def _ulps_apart(a, b):
    """The largest distance between a and b in bf16 ulps of each value,
    and how many elements differ."""
    import torch
    a, b = a.detach().float(), b.detach().float()
    ulp = ULP_BF16 * torch.maximum(a.abs(), b.abs()).clamp(min=2.0 ** -126)
    return float(((a - b).abs() / ulp).max()), int((a != b).sum())


def _gn_o2_composition(torch, x, w, b, dy, tag):
    """Under ``amp.auto_cast(level="O2")`` the fused call (``then="silu"``)
    against the separate ops (the black-listed norm in fp32, then the SiLU
    on its cast) and the norm written for a convolution (``then=
    "conv2d"``) against the norm's fp32 output cast: forward and every
    gradient. The norm's rounding is bit-equal; the fused SiLU and its
    backward within one bf16 ulp of each value (the counts of elements
    that differ are printed)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import functional as F
    fused_in = [t.clone().requires_grad_() for t in (x, w, b)]
    sep_in = [t.clone().requires_grad_() for t in (x, w, b)]
    with amp.auto_cast(level="O2"):
        y = F.group_norm(fused_in[0], GN_GROUPS, 1e-5, fused_in[1],
                         fused_in[2], then="silu")
        norm = F.group_norm(sep_in[0], GN_GROUPS, 1e-5, sep_in[1], sep_in[2])
        want = F.silu(norm)
        for_conv = F.group_norm(x, GN_GROUPS, 1e-5, w, b, then="conv2d")
    same_norm = bool(torch.equal(for_conv, norm.to(torch.bfloat16)))
    y.backward(dy)
    want.backward(dy)
    torch.cuda.synchronize()
    out = {"norm_bit_equal": same_norm}
    worst = 0.0
    for name, a, c in (("y", y, want), ("dx", fused_in[0].grad,
                                         sep_in[0].grad),
                       ("dw", fused_in[1].grad, sep_in[1].grad),
                       ("db", fused_in[2].grad, sep_in[2].grad)):
        ulps, differ = _ulps_apart(a, c)
        out[name] = dict(ulps=ulps, differing=differ, of=a.numel())
        worst = max(worst, ulps)
    print(f"  group_norm {tag}: under auto_cast O2, the norm for a conv "
          f"bit-equal to the fp32 norm cast {same_norm}; the fused SiLU vs "
          f"the separate ops: " + ", ".join(
              f"{k} {v['differing']} of {v['of']} differ (at most "
              f"{v['ulps']:.3g} ulps)" for k, v in out.items()
              if k != "norm_bit_equal")
          + f" (tol 1 ulp) {'ok' if same_norm and worst <= 1 else 'FAIL'}",
          flush=True)
    if not same_norm or worst > 1:
        raise AssertionError(f"group_norm {tag}: the fused call is not the "
                             f"O2 composition")
    return out


def _gn_case(torch, results, dev, tag, shape, layout, dtype_name, seed):
    """One GroupNorm shape: the kernels (forward with and without the
    SiLU, backward with it) against the plain version (fp32 2e-5 of the
    largest value; bf16 each row within one ulp of its largest plain value
    without the SiLU, two with it, and two for the gradients), two calls
    and a graph replay bit-equal; bf16 NCHW: the O2 composition; ms by
    graph replay beside the bound, the plain version and F.group_norm
    (+ F.silu) and its autograd; the forward and the backward on the
    plans' routes (the cluster kernels at bf16 NCHW) and on the Triton
    kernels, in the same call."""
    import torch.nn.functional as TF
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels import group_norm as GN
    card = _card_line()
    dtype = getattr(torch, dtype_name)
    last = layout == "NHWC"
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (3 + 2 * torch.randn(*shape, device=dev, generator=g)).to(dtype)
    c = shape[-1] if last else shape[1]
    w = (1 + 0.2 * torch.randn(c, device=dev, generator=g)).to(dtype)
    b = (0.2 * torch.randn(c, device=dev, generator=g)).to(dtype)
    dy = torch.randn(*shape, device=dev, generator=g).to(dtype)
    before = dict(K.LAUNCHES)
    errs = {}
    for silu in (False, True):
        y, stats = GN.group_norm_forward(x, w, b, GN_GROUPS, 1e-5, last,
                                         silu)
        y2, _ = GN.group_norm_forward(x, w, b, GN_GROUPS, 1e-5, last, silu)
        want = GN.group_norm_plain(x, GN_GROUPS, w, b, 1e-5, last, silu)
        if not torch.equal(y, y2):
            raise AssertionError(f"group_norm {tag}: two calls differ")
        name = f"group_norm {tag}{' +SiLU' if silu else ''}"
        if dtype == torch.float32:
            errs[silu] = _check(name, y, want, 2e-5 * max(
                1.0, float(want.abs().max())))
        else:
            errs[silu] = _check_rows(name, y, want, 2 if silu else 1)
    dx, dw, db = GN.group_norm_backward(x, w, b, stats, dy, GN_GROUPS, last,
                                        True)
    dx2, dw2, db2 = GN.group_norm_backward(x, w, b, stats, dy, GN_GROUPS,
                                           last, True)
    if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)
            and torch.equal(db, db2)):
        raise AssertionError(f"group_norm {tag}: two backward calls differ")
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    GN.group_norm_plain(leaves[0], GN_GROUPS, leaves[1], leaves[2], 1e-5,
                        last, True).backward(dy)
    err_b = 0.0
    for name, got, want in (("dx", dx, leaves[0].grad),
                            ("dw", dw.to(dtype), leaves[1].grad),
                            ("db", db.to(dtype), leaves[2].grad)):
        if dtype == torch.float32 or got.dim() == 1:
            tol = (2e-5 if dtype == torch.float32 else 2 * ULP_BF16) * max(
                1.0, float(want.float().abs().max()))
            err_b = max(err_b, _check(f"group_norm_bwd {tag} {name}", got,
                                      want, tol))
        else:
            err_b = max(err_b, _check_rows(f"group_norm_bwd {tag} {name}",
                                           got, want, 2))
    used = (K.LAUNCHES["group_norm"] - before["group_norm"],
            K.LAUNCHES["group_norm_bwd"] - before["group_norm_bwd"])
    if used != (4, 2):
        raise AssertionError(f"group_norm {tag}: launches {used}")
    cluster = (K.LAUNCHES["group_norm_cluster"] - before["group_norm_cluster"],
               K.LAUNCHES["group_norm_bwd_cluster"]
               - before["group_norm_bwd_cluster"])
    on_cluster = dtype != torch.float32 and not last
    if cluster != ((4, 2) if on_cluster else (0, 0)):
        raise AssertionError(f"group_norm {tag}: {cluster} forward and "
                             f"backward calls on the cluster kernels")
    # the forward's Triton route on the same inputs (what the cluster kernel
    # replaces): the same tolerances, and timed beside the plan's route
    err_tf = {}
    for silu in (False, True):
        ty = _gn_triton_forward(torch, x, w, b, last, silu)
        want = GN.group_norm_plain(x, GN_GROUPS, w, b, 1e-5, last, silu)
        name = f"group_norm {tag}{' +SiLU' if silu else ''} (Triton)"
        if dtype == torch.float32:
            err_tf[silu] = _check(name, ty, want, 2e-5 * max(
                1.0, float(want.abs().max())))
        else:
            err_tf[silu] = _check_rows(name, ty, want, 2 if silu else 1)
        del ty, want
    # the Triton route (the plan's other kernels) on the same inputs: the same
    # tolerances, and timed beside the plan's route
    tri = _gn_triton(torch, x, w, b, stats, dy, last)
    err_t = 0.0
    for name, got, want in (("dx", tri[0], leaves[0].grad),
                            ("dw", tri[1].to(dtype), leaves[1].grad),
                            ("db", tri[2].to(dtype), leaves[2].grad)):
        if dtype == torch.float32 or got.dim() == 1:
            tol = (2e-5 if dtype == torch.float32 else 2 * ULP_BF16) * max(
                1.0, float(want.float().abs().max()))
            err_t = max(err_t, _check(f"group_norm_bwd {tag} {name} "
                                      f"(Triton)", got, want, tol))
        else:
            err_t = max(err_t, _check_rows(f"group_norm_bwd {tag} {name} "
                                           f"(Triton)", got, want, 2))
    del tri
    o2 = None
    if dtype == torch.bfloat16 and not last:
        o2 = _gn_o2_composition(torch, x, w, b, dy, tag)
    replay_equal = _gn_replay(torch, x, w, b, dy, last)

    def fwd(silu):
        return lambda: GN.group_norm_forward(x, w, b, GN_GROUPS, 1e-5, last,
                                             silu)
    with torch.no_grad():
        ms = {silu: _graph_ms(fwd(silu), iters=10, reps=3)
              for silu in (False, True)}
        ms_tf = {silu: _graph_ms(lambda s=silu: _gn_triton_forward(
            torch, x, w, b, last, s), iters=10, reps=3)
            for silu in (False, True)}
        ms_b = _graph_ms(lambda: GN.group_norm_backward(
            x, w, b, stats, dy, GN_GROUPS, last, True), iters=10, reps=3)
        ms_t = _graph_ms(lambda: _gn_triton(torch, x, w, b, stats, dy, last),
                         iters=10, reps=3)
        plain = {silu: _time_ms(lambda s=silu: GN.group_norm_plain(
            x, GN_GROUPS, w, b, 1e-5, last, s), 3, warmup=1)
            for silu in (False, True)}
    pl = [t.clone().requires_grad_() for t in (x, w, b)]
    py = GN.group_norm_plain(pl[0], GN_GROUPS, pl[1], pl[2], 1e-5, last,
                             True)
    plain_b = _time_ms(lambda: torch.autograd.grad(py, pl, dy,
                                                   retain_graph=True), 3,
                       warmup=1)
    del py, pl
    xl = x.permute(0, 3, 1, 2) if last else x

    def lib(silu):
        def run():
            out = TF.group_norm(xl, GN_GROUPS, w, b, 1e-5)
            return TF.silu(out) if silu else out
        return run
    # the library's few kernels by graph replay too: launched one by one
    # from Python they measure the host at these sizes; its backward is
    # its forward and backward captured together, less the forward
    with torch.no_grad():
        lib_ms = {silu: _graph_ms(lib(silu), iters=10, reps=3)
                  for silu in (False, True)}
    ll = [t.clone().requires_grad_() for t in (xl, w, b)]
    dyl = dy.permute(0, 3, 1, 2) if last else dy
    lib_fb = _graph_ms(lambda: torch.autograd.grad(
        TF.silu(TF.group_norm(ll[0], GN_GROUPS, ll[1], ll[2], 1e-5)), ll,
        dyl), iters=10, reps=3)
    lib_b = lib_fb - lib_ms[True]
    del ll
    n_el, es = x.numel(), x.element_size()
    rec, rec_tf = {}, {}
    for silu in (False, True):
        bound, by = _bound(*_gn_bytes_ops(n_el, es, False, silu), FP32_FLOPS)
        rec[silu] = dict(max_abs_err=errs[silu], ms=ms[silu],
                         plain_ms=plain[silu], bound_ms=bound, bound_by=by,
                         library_ms=lib_ms[silu], shape=list(shape),
                         layout=layout, dtype=dtype_name, silu=silu,
                         route="cluster" if on_cluster else "triton")
        rec_tf[silu] = dict(rec[silu], max_abs_err=err_tf[silu],
                            ms=ms_tf[silu], route="triton")
    bound_b, by_b = _bound(*_gn_bytes_ops(n_el, es, True, True), FP32_FLOPS)
    rec_b = dict(max_abs_err=err_b, ms=ms_b, plain_ms=plain_b,
                 bound_ms=bound_b, bound_by=by_b, library_ms=lib_b,
                 shape=list(shape), layout=layout, dtype=dtype_name,
                 silu=True, replay_bit_equal=replay_equal, o2=o2)
    rec_t = dict(rec_b, max_abs_err=err_t, ms=ms_t, replay_bit_equal=None,
                 o2=None, route="triton")
    rec_b["route"] = "cluster" if on_cluster else "triton"
    results[f"group_norm[{tag}]"] = rec[False]
    results[f"group_norm[{tag} +SiLU]"] = rec[True]
    results[f"group_norm_triton[{tag}]"] = rec_tf[False]
    results[f"group_norm_triton[{tag} +SiLU]"] = rec_tf[True]
    results[f"group_norm_bwd[{tag} +SiLU]"] = rec_b
    results[f"group_norm_bwd_triton[{tag} +SiLU]"] = rec_t
    if tag == GN_MAIN:
        results["group_norm"] = rec_tf[True]
        results["group_norm_cluster"] = rec[True]
        results["group_norm_bwd"] = rec_t
        results["group_norm_bwd_cluster"] = rec_b
    for silu in (False, True):
        r = rec[silu]
        print(f"  group_norm {tag}{' +SiLU' if silu else ''} ({r['route']}): "
              f"ms={r['ms']:.4f} ({r['bound_ms'] / r['ms']:.3f} of the bound)"
              f", Triton ms={ms_tf[silu]:.4f} "
              f"({r['bound_ms'] / ms_tf[silu]:.3f}) "
              f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
              f"({r['bound_by']}); F.group_norm{' + F.silu' if silu else ''}"
              f" {r['library_ms']:.4f} [{card}]", flush=True)
    print(f"  group_norm_bwd {tag} +SiLU ({rec_b['route']}): ms={ms_b:.4f} "
          f"({bound_b / ms_b:.3f} of the bound), Triton ms={ms_t:.4f} "
          f"({bound_b / ms_t:.3f}) plain_ms={plain_b:.4f} bound_ms="
          f"{bound_b:.4f} "
          f"({by_b}); autograd of F.group_norm + F.silu {lib_b:.4f}; a graph "
          f"replay bit-equal to the eager call {replay_equal} [{card}]",
          flush=True)
    del x, w, b, dy, y, y2, dx, dx2
    torch.cuda.empty_cache()


def _gn_triton_forward(torch, x, w, b, last, silu):
    """The Triton GroupNorm forward (the plan's other route): y."""
    from paddle_tpu_torch.kernels import group_norm as GN
    y = torch.empty_like(x)
    stats = torch.empty(x.shape[0] * GN_GROUPS, 2, device=x.device)
    GN._triton_forward(x, w, b, y, stats, GN_GROUPS, 1e-5, last, silu)
    return y


def _gn_triton(torch, x, w, b, stats, dy, last):
    """The Triton GroupNorm backward with the SiLU (the plan's other
    route): (dx, dweight, dbias) as ``group_norm_backward`` returns
    them."""
    from paddle_tpu_torch.kernels import group_norm as GN
    c = x.shape[-1] if last else x.shape[1]
    dx = torch.empty_like(x)
    sums = torch.zeros(2 * c, dtype=torch.float32, device=x.device)
    GN._triton_backward(x, w, b, stats, dy, GN_GROUPS, last, True, dx, sums)
    return dx, sums[:c], sums[c:]


def _gn_replay(torch, x, w, b, dy, last):
    """Forward (with the SiLU) and backward captured in one CUDA graph: a
    replay after the input is rewritten equals an eager call bit for
    bit."""
    from paddle_tpu_torch.kernels import group_norm as GN
    xs = x.clone()

    def step():
        y, stats = GN.group_norm_forward(xs, w, b, GN_GROUPS, 1e-5, last,
                                         True)
        return (y,) + GN.group_norm_backward(xs, w, b, stats, dy, GN_GROUPS,
                                             last, True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cap = step()
    xs.copy_(x.flip(0))
    graph.replay()
    eager = step()
    torch.cuda.synchronize()
    same = all(bool(torch.equal(a, c)) for a, c in zip(cap, eager))
    del graph, cap, eager, xs
    if not same:
        raise AssertionError("a replayed GroupNorm differs from the eager "
                             "call")
    return same


def phase_group_norm_kernels(torch, results):
    """GroupNorm (with and without the SiLU) forward and backward at the
    UNet's shapes (level 0's 320 and 960 channels, level 3's 1280 at 8 x
    8), one fp32 and one NHWC case, against the plain version, replayed,
    against the O2 composition, timed beside the bound and F.group_norm."""
    dev = torch.device("cuda")
    print(f"phase 3: GroupNorm kernels (G {GN_GROUPS}, eps 1e-5) against "
          f"their plain version (fp32 2e-5 of the largest value; bf16 each "
          f"row within 1 ulp of its largest plain value, 2 with the SiLU "
          f"and for the gradients)", flush=True)
    _gn_warm(torch)
    for i, (tag, shape, layout, dtype_name) in enumerate(GN_CASES):
        _gn_case(torch, results, dev, tag, shape, layout, dtype_name, 70 + i)


def _gn_warm_one(torch, shape, last, dtype):
    """Launch, once each, the GroupNorm kernels a ``GN_CASES`` case
    launches (forward with and without the SiLU on both routes, backward
    with it), so that Triton compiles each of them here."""
    from paddle_tpu_torch.kernels import group_norm as GN
    c = shape[-1] if last else shape[1]
    x = torch.zeros(shape, dtype=dtype, device="cuda")
    w, b = torch.ones(c, dtype=dtype, device="cuda"), torch.zeros(
        c, dtype=dtype, device="cuda")
    for silu in (False, True):
        _, stats = GN.group_norm_forward(x, w, b, GN_GROUPS, 1e-5, last, silu)
        _gn_triton_forward(torch, x, w, b, last, silu)
    GN.group_norm_backward(x, w, b, stats, x, GN_GROUPS, last, True)
    torch.cuda.synchronize()


def _gn_warm(torch):
    """Compile the GroupNorm kernels of phase 3's cases in as many threads
    at once, as ``_bn_warm`` does BatchNorm's. Nothing is measured or
    counted from these launches: each case takes the counts' difference
    around its own calls."""
    from concurrent.futures import ThreadPoolExecutor
    from paddle_tpu_torch.kernels import group_norm as GN
    GN._jit()          # the kernels wrapped once, before the threads
    t = time.monotonic()
    with ThreadPoolExecutor(len(GN_CASES)) as ex:
        list(ex.map(lambda case: _gn_warm_one(
            torch, case[1], case[2] == "NHWC", getattr(torch, case[3])),
            GN_CASES))
    torch.cuda.empty_cache()
    print(f"  GroupNorm kernels compiled for {len(GN_CASES)} cases in "
          f"{len(GN_CASES)} threads: {time.monotonic() - t:.1f}s", flush=True)


# -- phase 3: the BatchNorm kernels ------------------------------------------------

# (tag, shape, layout, x dtype, form): ResNet-50's stem, a layer1 block's
# last BatchNorm and layer4's, in bf16 under O1's dtypes (fp32 weights,
# residual and output), a downsample's (no ReLU), a layer3 block's last
# and a layer2 block's inner one, one fp32 and one NHWC
BN_CASES = (
    ("[128, 64, 112, 112] bf16 +ReLU", (128, 64, 112, 112), "NCHW",
     "bfloat16", "relu"),
    ("[128, 256, 56, 56] bf16 +residual +ReLU", (128, 256, 56, 56), "NCHW",
     "bfloat16", "residual_relu"),
    ("[128, 2048, 7, 7] bf16 +residual +ReLU", (128, 2048, 7, 7), "NCHW",
     "bfloat16", "residual_relu"),
    ("[128, 2048, 7, 7] bf16", (128, 2048, 7, 7), "NCHW", "bfloat16",
     "plain"),
    ("[128, 1024, 14, 14] bf16 +residual +ReLU", (128, 1024, 14, 14), "NCHW",
     "bfloat16", "residual_relu"),
    ("[128, 512, 28, 28] bf16 +ReLU", (128, 512, 28, 28), "NCHW", "bfloat16",
     "relu"),
    ("[32, 256, 56, 56] fp32 +ReLU", (32, 256, 56, 56), "NCHW", "float32",
     "relu"),
    ("[32, 56, 56, 256] bf16 NHWC +residual +ReLU", (32, 56, 56, 256),
     "NHWC", "bfloat16", "residual_relu"),
)
# the kernels line's cases: the forward's Triton row (the stem, which its
# plan keeps there), the backward's two-pass row, both cluster rows
BN_TRITON_MAIN = "[128, 64, 112, 112] bf16 +ReLU"
BN_MAIN = "[128, 256, 56, 56] bf16 +residual +ReLU"
BN_CLUSTER_MAIN = "[128, 2048, 7, 7] bf16 +residual +ReLU"


def _bn_bytes_ops(n_el, esize, backward, res, relu):
    """(bytes, operations) of a BatchNorm call under O1's dtypes: forward x
    read, the fp32 residual read and the fp32 output written once;
    backward x, dy (fp32) and, under the ReLU, the output read, dx and the
    fp32 residual's gradient written once; about 10 operations an element
    forward and 20 backward."""
    if backward:
        nbytes = n_el * (2 * esize + 4 + (4 if relu else 0)
                         + (4 if res else 0))
    else:
        nbytes = n_el * (esize + 4 + (4 if res else 0))
    return nbytes, (20 if backward else 10) * n_el


def _bn_abs_sums(torch, x, y, dy, relu, last):
    """Per channel, sum |g| and sum |g * x-hat| (g: dy under the ReLU's
    mask): the scale of the rounding of the two gradient sums."""
    ch = x.dim() - 1 if last else 1
    axes = tuple(i for i in range(x.dim()) if i != ch)
    shape = [1] * x.dim()
    shape[ch] = -1
    x32 = x.float()
    var, mean = torch.var_mean(x32, dim=axes, unbiased=False)
    xh = (x32 - mean.reshape(shape)) * (var + 1e-5).rsqrt().reshape(shape)
    g = torch.where(y <= 0, 0.0, dy) if relu else dy
    return (g * xh).abs().sum(dim=axes), g.abs().sum(dim=axes)


def _bn_o1_composition(torch, x, w, b, r, stats, dy, tag, fmt):
    """Under ``amp.auto_cast(level="O1")`` the fused calls (``then=
    "relu"``, with the residual where the case has one) against the
    kernel's unfused output followed by PyTorch's add and ReLU: output,
    dx, dresidual, dweight, dbias and the running statistics bit-equal."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import functional as F
    runs = []
    for fused in (True, False):
        xi, wi, bi = (t.clone().requires_grad_() for t in (x, w, b))
        ri = None if r is None else r.clone().requires_grad_()
        rm, rv = (t.clone() for t in stats)
        with amp.auto_cast(level="O1"):
            if fused:
                y = F.batch_norm(xi, rm, rv, wi, bi, training=True,
                                 data_format=fmt, residual=ri, then="relu")
            else:
                z = F.batch_norm(xi, rm, rv, wi, bi, training=True,
                                 data_format=fmt)
                y = F.relu(z if ri is None else z + ri)
        y.backward(dy)
        runs.append([y, xi.grad, wi.grad, bi.grad, rm, rv]
                    + ([] if ri is None else [ri.grad]))
    torch.cuda.synchronize()
    same = all(a.dtype == c.dtype and bool(torch.equal(a, c))
               for a, c in zip(*runs))
    print(f"  batch_norm {tag}: under auto_cast O1 the fused call against "
          f"the unfused kernel, PyTorch's add and ReLU: output, every "
          f"gradient and the running statistics bit-equal {same} "
          f"{'ok' if same else 'FAIL'}", flush=True)
    if not same:
        raise AssertionError(f"batch_norm {tag}: the fused call is not the "
                             f"composition")
    del runs
    return same


def _bn_replay(torch, x, w, b, r, stats, dy, relu, last):
    """Forward and backward captured in one CUDA graph with the running
    statistics: a replay after the input is rewritten equals an eager
    call, statistics included, bit for bit."""
    from paddle_tpu_torch.kernels import batch_norm as BN
    xs = x.clone()
    cap_stats = [t.clone() for t in stats]
    eager_stats = [t.clone() for t in stats]

    def step(st):
        y, saved = BN.batch_norm_forward(xs, w, b, st[0], st[1], True, 0.9,
                                         1e-5, last, r, relu, False,
                                         torch.float32)
        return (y,) + BN.batch_norm_backward(
            xs, w, saved, dy, y, True, last, relu, False,
            None if r is None else r.dtype)[::2]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step([t.clone() for t in stats])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cap = step(cap_stats)
    for t, src in zip(cap_stats, stats):
        t.copy_(src)
    xs.copy_(x.flip(0))
    graph.replay()
    eager = step(eager_stats)
    torch.cuda.synchronize()
    same = all(bool(torch.equal(a, c)) for a, c in zip(
        list(cap) + cap_stats, list(eager) + eager_stats))
    del graph, cap, eager, xs
    if not same:
        raise AssertionError("a replayed BatchNorm differs from the eager "
                             "call")
    return same


def _bn_case(torch, results, dev, tag, shape, layout, dtype_name, form,
             seed):
    """One BatchNorm shape: the kernels (forward in training and eval,
    backward) against the plain version (the fp32 output within 2e-5 of
    its largest value; dx in bf16 each row within two ulps of its largest
    plain value, fp32 2e-5 of dx's scale; the weight's and bias's
    gradients within 1e-5 of each channel's sum of the terms' magnitudes;
    the running statistics within 2e-5), two calls and a graph replay
    bit-equal, bf16: the O1 composition bit-equal; ms by graph replay
    beside the bound, the plain version and F.batch_norm (cuDNN) with
    PyTorch's add and ReLU and its autograd."""
    import torch.nn.functional as TF
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels import batch_norm as BN
    card = _card_line()
    dtype = getattr(torch, dtype_name)
    last = layout == "NHWC"
    relu = form != "plain"
    c = shape[-1] if last else shape[1]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    s_ = math.prod(shape) // (shape[0] * c)
    fplan = BN.batch_norm_forward_plan(shape[0], c, s_, last, dtype, True,
                                       sms)
    plan = BN.batch_norm_backward_plan(shape[0], c, s_, last, dtype, True,
                                       sms)
    print(f"  batch_norm {tag}: forward route {fplan}; batch_norm_bwd "
          f"route {plan}", flush=True)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (3 + 2 * torch.randn(*shape, device=dev, generator=g)).to(dtype)
    w = 1 + 0.2 * torch.randn(c, device=dev, generator=g)
    b = 0.2 * torch.randn(c, device=dev, generator=g)
    r = torch.randn(*shape, device=dev, generator=g) \
        if form == "residual_relu" else None
    dy = torch.randn(*shape, device=dev, generator=g)
    stats = (0.1 * torch.randn(c, device=dev, generator=g),
             1 + 0.1 * torch.rand(c, device=dev, generator=g))
    args = (True, 0.9, 1e-5, last, r, relu, False, torch.float32)
    before = dict(K.LAUNCHES)
    st1, st2, stp = ([t.clone() for t in stats] for _ in range(3))
    y, saved = BN.batch_norm_forward(x, w, b, *st1, *args)
    y2, _ = BN.batch_norm_forward(x, w, b, *st2, *args)
    want = BN.batch_norm_plain(x, *stp, w, b, *args)
    if not (torch.equal(y, y2) and torch.equal(st1[0], st2[0])
            and torch.equal(st1[1], st2[1])):
        raise AssertionError(f"batch_norm {tag}: two calls differ")
    err = _check(f"batch_norm {tag}", y, want,
                 2e-5 * max(1.0, float(want.abs().max())))
    for name, a, e in (("running mean", st1[0], stp[0]),
                       ("running variance", st1[1], stp[1])):
        _check(f"batch_norm {tag} {name}", a, e,
               2e-5 * max(1.0, float(e.abs().max())))
    ye, _ = BN.batch_norm_forward(x, w, b, *stats, False, *args[1:])
    we = BN.batch_norm_plain(x, *stats, w, b, False, *args[1:])
    err = max(err, _check(f"batch_norm {tag} eval", ye, we,
                          2e-5 * max(1.0, float(we.abs().max()))))
    rdt = None if r is None else r.dtype
    bwd = (x, w, saved, dy, y, True, last, relu, False, rdt)
    dx, dres, dw, db = BN.batch_norm_backward(*bwd)
    dx2, dres2, dw2, db2 = BN.batch_norm_backward(*bwd)
    if not all(torch.equal(p, q) for p, q in
               ((dx, dx2), (dw, dw2), (db, db2))
               + (((dres, dres2),) if r is not None else ())):
        raise AssertionError(f"batch_norm {tag}: two backward calls differ")
    # the plain norm's autograd from the gradient the kernel's own output
    # lets through the ReLU (a value within rounding of 0 may take the
    # other side in the plain forward), which is the residual's gradient
    gk = torch.where(y <= 0, 0.0, dy) if relu else dy
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    BN.batch_norm_plain(leaves[0], *[t.clone() for t in stats], leaves[1],
                        leaves[2], True, 0.9, 1e-5, last, None, False, False,
                        torch.float32).backward(gk)
    abs_dw, abs_db = _bn_abs_sums(torch, x, y, dy, relu, last)
    err_b = 0.0
    if dtype == torch.float32:
        ch = x.dim() - 1 if last else 1
        axes = tuple(i for i in range(x.dim()) if i != ch)
        var = x.float().var(dim=axes, unbiased=False)
        scale = float((var + 1e-5).rsqrt().max()) * float(
            dy.abs().max() * w.abs().max())
        err_b = _check(f"batch_norm_bwd {tag} dx", dx, leaves[0].grad,
                       2e-5 * max(1.0, scale))
    else:
        err_b = _check_rows(f"batch_norm_bwd {tag} dx", dx, leaves[0].grad,
                            2)
    for name, got, ref, mag in (("dw", dw, leaves[1].grad, abs_dw),
                                ("db", db, leaves[2].grad, abs_db)):
        d = (got - ref).abs()
        ok = bool((d <= 1e-5 * mag + 1e-6).all())
        print(f"  batch_norm_bwd {tag} {name}: max_abs_err="
              f"{float(d.max()):.6g}, worst channel at "
              f"{float((d / (1e-5 * mag + 1e-6)).max()):.3g} of its "
              f"tolerance (1e-5 of its terms' magnitudes) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"batch_norm_bwd {tag} {name}: kernel "
                                 f"disagrees with its plain version")
        err_b = max(err_b, float(d.max()))
    if r is not None:
        err_b = max(err_b, _check(f"batch_norm_bwd {tag} dresidual", dres,
                                  gk, 0.0))
    used = tuple(K.LAUNCHES[k] - before[k] for k in (
        "batch_norm", "batch_norm_cluster", "batch_norm_bwd",
        "batch_norm_bwd_cluster"))
    if used != (3, 2 if fplan[0] == "cluster" else 0, 2,
                2 if plan[0] == "cluster" else 0):
        raise AssertionError(f"batch_norm {tag}: launches {used} (forward, "
                             f"on its cluster kernel, backward, on its "
                             f"cluster kernel)")
    composition = None
    if dtype == torch.bfloat16 and relu:
        composition = _bn_o1_composition(torch, x, w, b, r, stats, dy, tag,
                                         layout)
    replay_equal = _bn_replay(torch, x, w, b, r, stats, dy, relu, last)
    del leaves, gk, want, we, ye, dx2, dres2, y2
    torch.cuda.empty_cache()
    stk = [t.clone() for t in stats]
    with torch.no_grad():
        ms = _graph_ms(lambda: BN.batch_norm_forward(x, w, b, *stk, *args),
                       iters=10, reps=3)
        ms_b = _graph_ms(lambda: BN.batch_norm_backward(*bwd), iters=10,
                         reps=3)
        plain = _time_ms(lambda: BN.batch_norm_plain(
            x, *[t.clone() for t in stats], w, b, *args), 3, warmup=1)
    pl = [t.clone().requires_grad_() for t in (x, w, b)]
    py = BN.batch_norm_plain(pl[0], *[t.clone() for t in stats], pl[1],
                             pl[2], *args)
    plain_b = _time_ms(lambda: torch.autograd.grad(py, pl, dy,
                                                   retain_graph=True), 3,
                       warmup=1)
    del py, pl
    xl = x.permute(0, 3, 1, 2) if last else x
    rl = None if r is None else (r.permute(0, 3, 1, 2) if last else r)
    lib_stats = [t.clone() for t in stats]

    def lib(xin, win, bin_):
        out = TF.batch_norm(xin, *lib_stats, win, bin_, training=True,
                            momentum=0.1, eps=1e-5)
        if rl is not None:
            out = out + rl
        return TF.relu(out) if relu else out
    # cuDNN's few kernels by graph replay too; its backward is its forward
    # and backward captured together, less the forward
    with torch.no_grad():
        lib_ms = _graph_ms(lambda: lib(xl, w, b), iters=10, reps=3)
    ll = [t.clone().requires_grad_() for t in (xl, w, b)]
    dyl = dy.permute(0, 3, 1, 2) if last else dy
    lib_fb = _graph_ms(lambda: torch.autograd.grad(
        lib(*ll), ll, dyl.to(x.dtype) if r is None else dyl), iters=10,
        reps=3)
    lib_b = lib_fb - lib_ms
    del ll
    n_el, es = x.numel(), x.element_size()
    bound, by = _bound(*_bn_bytes_ops(n_el, es, False, r is not None, relu),
                       FP32_FLOPS)
    bound_b, by_b = _bound(*_bn_bytes_ops(n_el, es, True, r is not None,
                                          relu), FP32_FLOPS)
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
               bound_by=by, library_ms=lib_ms, shape=list(shape),
               layout=layout, dtype=dtype_name, form=form,
               o1_composition_bit_equal=composition,
               replay_bit_equal=replay_equal, route=list(fplan))
    rec_b = dict(max_abs_err=err_b, ms=ms_b, plain_ms=plain_b,
                 bound_ms=bound_b, bound_by=by_b, library_ms=lib_b,
                 shape=list(shape), layout=layout, dtype=dtype_name,
                 form=form, replay_bit_equal=replay_equal, route=list(plan))
    results[f"batch_norm[{tag}]"] = rec
    results[f"batch_norm_bwd[{tag}]"] = rec_b
    if tag == BN_TRITON_MAIN:
        results["batch_norm"] = rec
    if tag == BN_MAIN:
        results["batch_norm_bwd"] = rec_b
    lib_name = "F.batch_norm" + (" + add" if r is not None else "") + \
        (" + F.relu" if relu else "")
    print(f"  batch_norm {tag} ({fplan[0]}): ms={ms:.4f} ({bound / ms:.3f} "
          f"of the bound) plain_ms={plain:.4f} bound_ms={bound:.4f} ({by}); "
          f"{lib_name} (cuDNN) {lib_ms:.4f} [{card}]", flush=True)
    print(f"  batch_norm_bwd {tag} ({plan[0]}): ms={ms_b:.4f} "
          f"({bound_b / ms_b:.3f} of the bound) plain_ms={plain_b:.4f} "
          f"bound_ms={bound_b:.4f} ({by_b}); autograd of {lib_name}, less "
          f"its forward {lib_b:.4f}; a graph replay bit-equal to the eager "
          f"call {replay_equal} [{card}]", flush=True)
    del x, w, b, r, dy, y, dx, dres, saved, stats, stk, lib_stats
    torch.cuda.empty_cache()


def _instance_norm_case(torch, dev):
    """``InstanceNorm2D`` on the card: the GroupNorm kernels with one
    channel a group, forward and backward against the plain version (bf16
    each row within one ulp of its largest plain value, two for dx; the
    weight's and bias's gradients within two ulps of their largest)."""
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels import group_norm as GN
    from paddle_tpu_torch.nn import InstanceNorm2D
    g = torch.Generator(device=dev).manual_seed(75)
    layer = InstanceNorm2D(64, device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        layer.weight.normal_(1.0, 0.2, generator=g)
        layer.bias.normal_(0.0, 0.2, generator=g)
    x = (3 + 2 * torch.randn(16, 64, 56, 56, device=dev, generator=g)) \
        .to(torch.bfloat16).requires_grad_()
    dy = torch.randn(16, 64, 56, 56, device=dev, generator=g) \
        .to(torch.bfloat16)
    before = (K.LAUNCHES["group_norm"], K.LAUNCHES["group_norm_bwd"])
    y = layer(x)
    y.backward(dy)
    torch.cuda.synchronize()
    used = (K.LAUNCHES["group_norm"] - before[0],
            K.LAUNCHES["group_norm_bwd"] - before[1])
    leaves = [t.detach().clone().requires_grad_()
              for t in (x, layer.weight, layer.bias)]
    want = GN.group_norm_plain(leaves[0], 64, leaves[1], leaves[2])
    want.backward(dy)
    err = _check_rows("InstanceNorm2D [16, 64, 56, 56] bf16 (GroupNorm "
                      "kernel, 64 groups)", y, want, 1)
    err = max(err, _check_rows("InstanceNorm2D dx", x.grad, leaves[0].grad,
                               2))
    for name, got, ref in (("dweight", layer.weight.grad, leaves[1].grad),
                           ("dbias", layer.bias.grad, leaves[2].grad)):
        err = max(err, _check(f"InstanceNorm2D {name}", got, ref,
                              2 * ULP_BF16 * float(ref.float().abs().max())))
    if used != (1, 1):
        raise AssertionError(f"InstanceNorm2D: GroupNorm launches {used}")
    print(f"  InstanceNorm2D through the GroupNorm kernel: launches "
          f"{used} [{_card_line()}]", flush=True)
    return dict(max_abs_err=err, launches=used)


def _resnet50_bn_calls(batch=128):
    """ResNet-50's BatchNorm calls at [batch, 3, 224, 224], one of each
    kind, as (x shape, with the residual, with the ReLU): the stem's; in
    each stage the first block's (stride on its 3 x 3, a downsample) and
    the next blocks'."""
    calls = {((batch, 64, 112, 112), False, True)}
    hw = 56
    for planes, stride in ((64, 1), (128, 2), (256, 2), (512, 2)):
        out = hw // stride
        for h_in in (hw, out):
            calls.add(((batch, planes, h_in, h_in), False, True))
            calls.add(((batch, planes, out, out), False, True))
            calls.add(((batch, 4 * planes, out, out), True, True))
        calls.add(((batch, 4 * planes, out, out), False, False))
        hw = out
    return sorted(calls)


def _bn_warm_one(torch, shape, last, dtype, res, relu, unfused):
    """Launch, once each, the BatchNorm kernels a shape's calls in phase 3
    or 15 launch: training forward and backward (and the unfused form the
    O1 composition runs) and the eval forward, with the arguments' dtypes
    and flags, so that Triton compiles each of them here."""
    from paddle_tpu_torch.kernels import batch_norm as BN
    c = shape[-1] if last else shape[1]
    z = functools.partial(torch.zeros, device="cuda")
    x, dy = z(shape, dtype=dtype), z(shape)
    w, b = torch.ones(c, device="cuda"), z(c)
    r = z(shape) if res else None
    for ri, rel in [(r, relu)] + ([(None, False)] if unfused else []):
        rm, rv = z(c), torch.ones(c, device="cuda")
        y, st = BN.batch_norm_forward(x, w, b, rm, rv, True, 0.9, 1e-5,
                                      last, ri, rel, False, torch.float32)
        BN.batch_norm_backward(x, w, st, dy, y if rel else None, True, last,
                               rel, False, None if ri is None else ri.dtype)
    BN.batch_norm_forward(x, w, b, rm, rv, False, 0.9, 1e-5, last, r, relu,
                          False, torch.float32)
    torch.cuda.synchronize()


def _bn_warm(torch):
    """Compile the BatchNorm kernels of phase 3's cases and of ResNet-50's
    53 calls (phase 15) in 8 threads at once: Triton compiles a kernel at
    its first launch with each new set of argument dtypes, flags and
    shapes' divisibilities, and much of a compile lets other threads run,
    where the phases would compile them one after the other. Nothing is
    measured or counted from these launches: each phase sets the counts
    to 0, or takes their difference, around its own run."""
    from concurrent.futures import ThreadPoolExecutor
    from paddle_tpu_torch.kernels import batch_norm as BN
    BN._jit()          # the kernels wrapped once, before the threads
    # (shape, channels last, dtype, residual, ReLU) -> the unfused form too
    specs = {(shape, False, torch.bfloat16, res, relu): False
             for shape, res, relu in _resnet50_bn_calls()}
    for _, shape, layout, dt, form in BN_CASES:
        key = (shape, layout == "NHWC", getattr(torch, dt),
               form == "residual_relu", form != "plain")
        specs[key] = dt == "bfloat16" and form != "plain"
    t = time.monotonic()
    with ThreadPoolExecutor(8) as ex:
        list(ex.map(lambda kv: _bn_warm_one(torch, *kv[0], kv[1]), sorted(
            specs.items(), key=lambda kv: -math.prod(kv[0][0]))))
    torch.cuda.empty_cache()
    print(f"  BatchNorm kernels compiled for {len(specs)} shapes and forms "
          f"in 8 threads: {time.monotonic() - t:.1f}s", flush=True)


def phase_batch_norm_kernels(torch, results):
    """BatchNorm (with the ReLU, with the residual add and the ReLU, and
    alone) forward, eval and backward at ResNet-50's shapes in bf16 under
    O1's dtypes, one fp32 and one NHWC case, against the plain version,
    replayed, against the O1 composition, timed beside the bound,
    the plain version and cuDNN's F.batch_norm; then an InstanceNorm2D on
    the GroupNorm kernel."""
    dev = torch.device("cuda")
    print("phase 3: BatchNorm kernels (momentum 0.9, eps 1e-5; bf16 x, fp32 "
          "weights, residual and output, as ResNet-50 under amp O1) against "
          "their plain version", flush=True)
    _bn_warm(torch)
    for i, case in enumerate(BN_CASES):
        _bn_case(torch, results, dev, *case, 80 + i)
    results["instance_norm[InstanceNorm2D]"] = _instance_norm_case(torch,
                                                                   dev)


def _conv_linear_flops(model):
    """Forward hooks that add up the products of every Conv2D and Linear
    (2 x outputs x inputs a output element) and of every CrossAttention's
    two attention products (QK^T and PV: 4 x b x s x sk x inner) of the
    forwards run while installed: (the running count [1], the hooks)."""
    from paddle_tpu_torch.models.unet import CrossAttention
    from paddle_tpu_torch.nn import Conv2D, Linear
    count = [0]

    def conv(m, inp, out):
        count[0] += 2 * out.numel() * m.weight[0].numel()

    def linear(m, inp, out):
        count[0] += 2 * out.numel() * m.weight.shape[0]

    def attention(m, inp, out):
        x = inp[0]
        ctx = inp[1] if len(inp) > 1 and inp[1] is not None else x
        count[0] += 4 * x.shape[0] * x.shape[1] * ctx.shape[1] * \
            m.heads * m.head_dim
    hooks = []
    for mod in model.modules():
        if isinstance(mod, Conv2D):
            hooks.append(mod.register_forward_hook(conv))
        elif isinstance(mod, Linear):
            hooks.append(mod.register_forward_hook(linear))
        elif isinstance(mod, CrossAttention):
            hooks.append(mod.register_forward_hook(attention))
    return count, hooks


def _forward_flops(torch, model, args):
    """The products' FLOPs of one forward of ``model`` on ``args`` (counted
    by hooks on one forward, under no_grad)."""
    count, hooks = _conv_linear_flops(model)
    try:
        with torch.no_grad():
            model(*args)
    finally:
        for h in hooks:
            h.remove()
    return count[0]


def _timed_steps(torch, trainer, batch, n_warm=2, n=5):
    """``n_warm`` warm-up steps (the first runs the step and captures it)
    and ``n`` timed ones: (losses, ms a step, launches of the timed
    steps)."""
    from paddle_tpu_torch import kernels as K
    losses = [float(trainer.train_step(*batch)) for _ in range(n_warm)]
    trainer.block()
    K.reset_launches()
    t0 = time.monotonic()
    timed = [trainer.train_step(*batch) for _ in range(n)]
    trainer.block()
    secs = time.monotonic() - t0
    launches = dict(K.LAUNCHES)
    return losses + [float(x) for x in timed], 1e3 * secs / n, launches


UNET_GROUP_NORMS = 61      # sd15 a forward: 2 a ResNet block (22), 1 a
UNET_GN_SILU = 45          # transformer (16), conv_norm_out; 45 with SiLU
UNET_ATTENTION = 32        # 2 a transformer, all dense (head_dim 40/80/160)
UNET_LAYER_NORMS = 48      # 3 a transformer
# the UNet's self-attentions at 64 x 64 latents see 4096 keys (5), 1024
# (5), 256 (5) and 64 (1), its 16 cross-attentions the context's 77: the
# rows of 256 and 64 keys take X2's CUDA forward, the rest the Triton one
UNET_X2_CUDA = 6


def _unet_forward_launches():
    """A forward's launches: every GroupNorm on the cluster forward, the
    self-attentions' middles that its plan takes on the CUDA forward."""
    from paddle_tpu_torch import kernels as K
    per = {n: 0 for n in K.LAUNCHES}
    per.update(group_norm=UNET_GROUP_NORMS,
               group_norm_cluster=UNET_GROUP_NORMS,
               dropout_add_ln=UNET_LAYER_NORMS,
               sdpa_plain=UNET_ATTENTION, dense_softmax=UNET_ATTENTION,
               dense_softmax_cuda=UNET_X2_CUDA)
    return per


def _unet_inputs(torch, cfg, seed, b, hw=64, ctx_len=77):
    """Latents [b, 4, hw, hw], integer timesteps in [0, 1000) (999 for the
    forward), a context [b, ctx_len, cross dim], noise: from ``seed``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, cfg.in_channels, hw, hw, device="cuda", generator=g)
    t = torch.randint(0, 1000, (b,), device="cuda", generator=g)
    ctx = torch.randn(b, ctx_len, cfg.cross_attention_dim, device="cuda",
                      generator=g)
    noise = torch.randn(b, cfg.out_channels, hw, hw, device="cuda",
                        generator=g)
    return x, t, ctx, noise


def _unet_model(torch, cfg, seed, bf16=True, device="cuda"):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import UNet2DConditionModel
    gen = torch.Generator(device=device).manual_seed(seed) \
        if seed is not None else None
    model = UNet2DConditionModel(cfg, device=device, generator=gen)
    if bf16:
        model = amp.decorate(model, level="O2", dtype="bfloat16")
    return model


def _unet_loss_o2(m, x, t, ctx, noise):
    """The denoising loss under auto_cast O2 (as the JAX package runs the
    UNet in bf16): mean((unet(x, t, ctx) - noise)^2)."""
    from paddle_tpu_torch import amp
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        return ((m(x, t, ctx) - noise) ** 2).mean()


def _unet_trainer(model, lr=1e-4, cast=True):
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import SpmdTrainer
    loss = _unet_loss_o2 if cast else (
        lambda m, x, t, ctx, n: ((m(x, t, ctx) - n) ** 2).mean())
    return SpmdTrainer(model, AdamW(learning_rate=lr,
                                    parameters=model.parameters()), loss)


def _unet_forward(torch, args, card, launches_out):
    """(a): one denoising forward of SD 1.5 at full width, batch 2 (the
    conditioned and unconditioned halves of classifier-free guidance) at
    [2, 4, 64, 64], timesteps 999, a [2, 77, 768] context, eval, no_grad,
    bf16 under O2: exact launch counts, ms (median of 20), a profile,
    peak memory, the products' FLOPs."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models import UNetConfig
    cfg = UNetConfig.sd15()
    torch.cuda.reset_peak_memory_stats()
    model = _unet_model(torch, cfg, args.seed)
    model.eval()
    x, _, ctx, _ = _unet_inputs(torch, cfg, args.seed, 2)
    t = torch.full((2,), 999, dtype=torch.int64, device="cuda")

    def fwd():
        with torch.no_grad(), amp.auto_cast(level="O2", dtype="bfloat16"):
            return model(x, t, ctx)
    out = fwd()             # compiles the Triton kernels
    torch.cuda.synchronize()
    K.reset_launches()
    out = fwd()
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    per = _unet_forward_launches()
    print(f"  phase 14 (a) launches a forward: {launches} (expected "
          f"{per}); of the GroupNorms {UNET_GN_SILU} with the SiLU fused",
          flush=True)
    if launches != per:
        raise AssertionError(f"phase 14 (a): launch counts {launches} != "
                             f"{per}")
    for k, v in launches.items():
        launches_out[k] = launches_out.get(k, 0) + v
    if out.shape != (2, 4, 64, 64) or out.dtype != torch.bfloat16 \
            or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"phase 14 (a): output {out.dtype} "
                             f"{tuple(out.shape)}, not finite bf16 [2, 4, "
                             f"64, 64]")
    secs = []
    for _ in range(20):
        t0 = time.monotonic()
        fwd()
        torch.cuda.synchronize()
        secs.append(time.monotonic() - t0)
    secs.sort()
    ms = 1e3 * secs[len(secs) // 2]
    peak = torch.cuda.max_memory_allocated() / 1e9
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        flops = _forward_flops(torch, model, (x, t, ctx))
    prof, m = _profile(torch, fwd, 1)
    _save_trace(prof, os.path.join(args.out,
                                          "unet_forward_trace.json"))
    del prof
    stats = dict(params=model.num_params(), ms=ms, ms_min=1e3 * secs[0],
                 peak_memory_gb=peak, flops=flops,
                 tflops_per_s=flops / ms / 1e9, launches=launches,
                 breakdown=m, idle_share_untraced=1 - m["device_ms"] / ms,
                 card=card)
    print(f"  phase 14 (a) SD 1.5 UNet forward, batch 2 x [4, 64, 64], "
          f"{stats['params'] / 1e6:.1f}M parameters, bf16 under O2: "
          f"{ms:.3f} ms a forward (median of 20; min {stats['ms_min']:.3f}),"
          f" {flops / 1e12:.4f} TFLOP of products ({stats['tflops_per_s']:.1f}"
          f" TFLOP/s), peak {peak:.2f} GB; {_breakdown_line(m)}; idle share "
          f"against the untraced forward {stats['idle_share_untraced']:.4f} "
          f"[{card}]", flush=True)
    _print_other(m, "phase 14 (a)")
    del model, out, x, ctx
    _free(torch)
    return stats


def _unet_train(torch, args, card, launches_out):
    """(b): the training step, batch 4 x [4, 64, 64], AdamW lr 1e-4,
    captured, no remat: cuDNN free to choose (5 timed steps), then
    ``cudnn.deterministic`` (recaptured; 5 timed steps, exact launches, a
    profile), then replayed against eager from one snapshot."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import UNetConfig
    cfg = UNetConfig.sd15()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    model = _unet_model(torch, cfg, args.seed + 1)
    trainer = _unet_trainer(model)
    batch = _unet_inputs(torch, cfg, args.seed + 1, 4)
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        flops = 3 * _forward_flops(torch, model, batch[:3])
    out = {}
    torch.backends.cudnn.deterministic = False
    losses0, ms0, _ = _timed_steps(torch, trainer, batch)
    print(f"  phase 14 (b) cuDNN's own choice of algorithms: step "
          f"{ms0:.3f} ms captured, losses {losses0} [{card}]", flush=True)
    trainer._drop_graphs()
    _free(torch)
    torch.backends.cudnn.deterministic = True
    losses, step_ms, launches = _timed_steps(torch, trainer, batch)
    graph = _graph_line(trainer, "phase 14 (b)", card)
    per = _unet_forward_launches()
    per.update(group_norm_bwd=UNET_GROUP_NORMS,
               group_norm_bwd_cluster=UNET_GROUP_NORMS,
               dropout_add_ln_bwd=UNET_LAYER_NORMS,
               dropout_add_ln_bwd_warp=UNET_LAYER_NORMS,
               dense_softmax_bwd=UNET_ATTENTION, adamw=1)
    expect = {k: 5 * v for k, v in per.items()}
    print(f"  phase 14 (b) launches over 5 steps: {launches} (expected "
          f"{expect})", flush=True)
    if launches != expect:
        raise AssertionError(f"phase 14 (b): launch counts {launches} != "
                             f"{expect}")
    for k, v in launches.items():
        launches_out[k] = launches_out.get(k, 0) + v
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"phase 14 (b): losses not finite and "
                             f"falling: {losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof, m = _profile(torch, lambda: trainer.train_step(*batch), 1)
    _save_trace(prof, os.path.join(args.out,
                                          "unet_train_step_trace.json"))
    del prof
    img_s = 4 / (step_ms / 1e3)
    out.update(step_ms=step_ms, step_ms_cudnn_free=ms0, images_per_s=img_s,
               flops_per_step=flops,
               mfu_vs_989_tflops=flops / (step_ms / 1e3) / BF16_FLOPS,
               peak_memory_gb=peak, peak_memory_of_phase_gb=peak - held / 1e9,
               losses=losses, graph=graph, breakdown=m,
               idle_share_untraced=1 - m["device_ms"] / step_ms,
               launches_a_step=per, card=card)
    print(f"  phase 14 (b) SD 1.5 UNet training step, batch 4, AdamW, "
          f"captured, cudnn.deterministic: {step_ms:.3f} ms ({ms0:.3f} with "
          f"cuDNN's own choice), {img_s:.2f} images/s, MFU "
          f"{out['mfu_vs_989_tflops']:.4f} ({flops / 1e12:.3f} TFLOP a step),"
          f" peak {peak:.2f} GB; {_breakdown_line(m)}; idle share against "
          f"the untraced step {out['idle_share_untraced']:.4f}; losses "
          f"{losses} [{card}]", flush=True)
    _print_other(m, "phase 14 (b)")
    out["eager"] = _captured_against_eager(torch, trainer, batch,
                                         "phase 14 (b)", card, step_ms, m)
    _drop_trainer(torch, trainer)
    out["dense_middle"] = _dense_middle_line(
        torch, "phase 14 (b)", lambda: _unet_loss_o2(model, *batch), card)
    del trainer, model, batch
    _free(torch)
    return out


def _unet_agreement(torch, seed):
    """(c): one forward + backward of a 2-level UNet at SD 1.5's widths
    (channels 320 / 640, 2 layers a block, 8 heads, 32 groups, cross 768;
    batch 2 x [4, 32, 32], a [2, 77, 768] context) through the kernels and
    through the plain versions, bf16 under O2 and float32 (the same
    bf16-valued weights, upcast): float32 loss 1e-5 relative and
    gradients 1e-3 relative L2; bf16 gradients no further from the
    float32 step than the plain bf16 path's (1.1x over all, 1.25x per
    parameter; one of fewer than SMALL_LEAF elements as ``_leaf_ratios``
    says)."""
    import dataclasses
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models import UNetConfig
    cfg = dataclasses.replace(UNetConfig.sd15(),
                              block_out_channels=(320, 640))
    batch = _unet_inputs(torch, cfg, seed + 13, 2, hw=32)
    base = _unet_model(torch, cfg, seed + 13)
    state = {n: p.detach() for n, p in base.named_parameters()}
    del base

    def run(bf16, plain):
        model = _unet_model(torch, cfg, None, bf16=bf16)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(state[n].to(p.dtype))
        before = dict(K.LAUNCHES)
        with ExitStack() as stack:
            if plain:
                _plain_train_patches(stack)
            loss_fn = _unet_loss_o2 if bf16 else (
                lambda m, x, t, c, n: ((m(x, t, c) - n) ** 2).mean())
            loss = loss_fn(model, *batch).float()
            loss.backward()
            torch.cuda.synchronize()
        used = {n: K.LAUNCHES[n] - before[n] for n in K.kernel_launches()}
        if plain and any(used.values()):
            raise AssertionError(f"the plain UNet step launched {used}")
        if not plain and not all(used[n] for n in (
                "group_norm", "group_norm_bwd", "dropout_add_ln")):
            raise AssertionError(f"the kernel UNet step launched {used}")
        return float(loss.detach()), {n: p.grad.float() for n, p in
                                      model.named_parameters()}

    lk32, gk32 = run(False, False)
    lp32, gp32 = run(False, True)
    err32, _ = _rel_dist(gk32, gp32)
    sizes = {n: g.numel() for n, g in gp32.items()}
    del gk32
    lk16, gk16 = run(True, False)
    err_k, leaf_k = _rel_dist(gk16, gp32)
    del gk16
    lp16, gp16 = run(True, True)
    err_p, leaf_p = _rel_dist(gp16, gp32)
    del gp16, gp32
    torch.cuda.empty_cache()
    ratio, small = _leaf_ratios(leaf_k, leaf_p, sizes, err_p,
                                skip_exact=True)
    worst = max(ratio, key=ratio.get)
    loss32 = abs(lk32 / lp32 - 1)
    print(f"  phase 14 (c) UNet step kernels vs plain (SD 1.5 widths, 2 "
          f"levels, 2 x [4, 32, 32], seed {seed}): float32 loss {lk32:.6f} "
          f"vs {lp32:.6f} (rel err {loss32:.3g}, tol 1e-5), grads rel L2 err "
          f"{err32:.3g} (tol 1e-3); bf16 O2 loss kernels {lk16:.6f} plain "
          f"{lp16:.6f}, grads' rel L2 distance from the float32 step: "
          f"kernels {err_k:.5g}, plain {err_p:.5g} (tol 1.1x); per parameter "
          f"the largest ratio kernels / plain {ratio[worst]:.4g} at {worst} "
          f"(tol 1.25; below {SMALL_LEAF} elements over the larger of its "
          f"plain distance and the plain one over all: "
          f"{_small_leaves_line(small)}); the largest ratios of own "
          f"distances: {_worst_leaves(leaf_k, leaf_p, sizes)} "
          f"[{_card_line()}]", flush=True)
    if not (loss32 <= 1e-5 and err32 <= 1e-3 and err_k <= 1.1 * err_p
            and max(ratio.values()) <= 1.25
            and all(math.isfinite(v) for v in (lk16, lp16, err_k, err_p))):
        raise AssertionError("the UNet kernel step disagrees with the "
                             "plain step")
    return dict(loss_rel_err_f32=loss32, grad_rel_err_f32=err32,
                bf16_grad_err_kernels=err_k, bf16_grad_err_plain=err_p,
                bf16_grad_err_ratio_worst_param=ratio[worst],
                worst_param=worst, small_params=small)


def _tiny_on_card(torch, tag, make, make_opt, loss_fn, batch, lr,
                  seed=None):
    """A tiny float32 model trained 3 steps on the card (captured) against
    the port's CPU trainer from the same weights and buffers: the forward
    and the losses within 1e-5 relative, weights and buffers within 1e-5
    for 99.9% of the elements and 3 lr for all. ``seed``: the random state
    set before each device's forward and trainer (a model with dropout
    draws the same masks on both)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.models import load_numpy_state
    from paddle_tpu_torch.parallel import SpmdTrainer
    cpu = make("cpu")
    gpu = make("cuda")
    load_numpy_state(gpu, {k: v.numpy() for k, v in
                           cpu.state_dict().items()})
    reseed = (lambda: ptt.seed(seed)) if seed is not None else (
        lambda: None)
    with torch.no_grad():
        reseed()
        fc = loss_fn(cpu, *batch)
        reseed()
        fg = loss_fn(gpu, *(t.cuda() for t in batch))
    fwd_err = abs(float(fg) / float(fc) - 1)
    losses = []
    K.reset_launches()
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        reseed()
        tr = SpmdTrainer(model, make_opt(model), loss_fn)
        losses.append([float(tr.train_step(*(t.to(dev) for t in batch)))
                       for _ in range(3)])
    used = {k: v for k, v in K.LAUNCHES.items() if v}
    close = total = 0
    worst = 0.0
    want = cpu.state_dict()
    far = {}
    for k, v in gpu.state_dict().items():
        d = (v.cpu() - want[k]).abs()
        worst = max(worst, float(d.max()))
        close += int((d <= 1e-5).sum())
        total += d.numel()
        far[k] = int((d > 1e-5).sum())
    far = dict(sorted(((k, n) for k, n in far.items() if n),
                      key=lambda kv: -kv[1])[:5])
    want_l, got_l = losses
    loss_err = max(abs(a / b - 1) for a, b in zip(got_l, want_l))
    ok = (fwd_err <= 1e-5 and loss_err <= 1e-5 and close >= 0.999 * total
          and worst <= 3 * lr)
    print(f"  {tag} tiny float32 on the card vs the CPU: first loss rel err "
          f"{fwd_err:.3g}; 3 trainer steps' losses {got_l} vs {want_l} (max "
          f"rel err {loss_err:.3g}, tol 1e-5); weights and buffers within "
          f"1e-5: {close}/{total}, the most beyond it {far}, worst "
          f"{worst:.3g} (tol {3 * lr}); "
          f"launches {used} {'ok' if ok else 'FAIL'} [{_card_line()}]",
          flush=True)
    if not ok:
        raise AssertionError(f"{tag}: training on the card disagrees with "
                             f"the CPU")
    return dict(forward_rel_err=fwd_err, loss_rel_err=loss_err,
                weights_close=close / total, worst=worst, launches=used)


def _unet_tiny_on_card(torch):
    """(d): a tiny float32 UNet (channels 32 / 64, groups 8, cross 32) on
    [2, 4, 16, 16], AdamW lr 1e-4."""
    import numpy as np
    from paddle_tpu_torch.models import UNet2DConditionModel, UNetConfig
    from paddle_tpu_torch.optimizer import AdamW
    cfg = UNetConfig.tiny(ch=(32, 64), cross=32, groups=8)
    rng = np.random.default_rng(61)
    batch = tuple(torch.from_numpy(a) for a in (
        rng.standard_normal((2, 4, 16, 16)).astype(np.float32),
        np.array([3, 900]), rng.standard_normal((2, 7, 32))
        .astype(np.float32),
        rng.standard_normal((2, 4, 16, 16)).astype(np.float32)))
    torch.manual_seed(61)
    return _tiny_on_card(
        torch, "phase 14 (d)", lambda d: UNet2DConditionModel(cfg, device=d),
        lambda m: AdamW(learning_rate=1e-4, parameters=m.parameters()),
        lambda m, x, t, c, n: ((m(x, t, c) - n) ** 2).mean(), batch, 1e-4)


def phase_unet(torch, args, launches_out):
    """The Stable Diffusion UNet (BASELINE configuration 5, SD 1.5 uncut:
    channels 320 / 640 / 1280 / 1280, 2 layers a block, 8 heads, 32
    groups, cross dim 768; random weights from the seed), bf16 under O2:
    (a) one denoising forward at batch 2; (b) the captured training step
    at batch 4, bit-equal to the eager one; (c) the 2-level agreement
    through kernels and plain versions; (d) a tiny float32 UNet on the
    card against the CPU trainer."""
    card = _card_line()
    print(f"phase 14: the SD 1.5 UNet, bf16 under amp O2, seed {args.seed} "
          f"[{card}]", flush=True)
    prev = torch.backends.cudnn.deterministic
    try:
        out = {"forward": _unet_forward(torch, args, card, launches_out)}
        out["train"] = _unet_train(torch, args, card, launches_out)
        torch.backends.cudnn.deterministic = True
        out["agreement"] = _unet_agreement(torch, args.seed)
        out["tiny_f32_vs_cpu"] = _unet_tiny_on_card(torch)
    finally:
        torch.backends.cudnn.deterministic = prev
    return out


def _resnet_loss_o1(m, x, y):
    """Cross entropy of ResNet's logits under auto_cast O1 (convs and
    linears in bf16, BatchNorm in fp32)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import functional as F
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        return F.cross_entropy(m(x), y)


def _resnet_trainer(model, lr=0.1):
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.parallel import SpmdTrainer
    from paddle_tpu_torch.regularizer import L2Decay
    return SpmdTrainer(model, Momentum(learning_rate=lr, momentum=0.9,
                                       parameters=model.parameters(),
                                       weight_decay=L2Decay(1e-4)),
                       _resnet_loss_o1)


def _batch_norm_ops(torch, x, rm, rv, w, b, residual, relu):
    """BatchNorm as ``F.batch_norm`` computed it with PyTorch ops before
    the kernels, under O1 (x cast to fp32, ``var_mean``, per-channel
    factors, one ``addcmul``, the running statistics updated in place),
    then PyTorch's add and ReLU: the yardstick of the kernels on the
    step's calls."""
    x32 = x.float()
    var, mean = torch.var_mean(x32, dim=(0, 2, 3), unbiased=False)
    with torch.no_grad():
        rm.copy_(0.9 * rm + 0.1 * mean)
        rv.copy_(0.9 * rv + 0.1 * var)
    scale = (1.0 / torch.sqrt(var + 1e-5)) * w
    out = torch.addcmul(b.reshape(1, -1, 1, 1), x32 - mean.reshape(
        1, -1, 1, 1), scale.reshape(1, -1, 1, 1))
    if residual is not None:
        out = out + residual
    return torch.relu(out) if relu else out


def _resnet_bn_cluster_calls(torch, model, x):
    """How many BatchNorms of a forward under O1 ``batch_norm_forward_plan``
    and ``batch_norm_backward_plan`` send to their cluster kernels (a hook
    on each, one eager forward without gradients): (forward, backward)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.kernels import batch_norm as BN
    from paddle_tpu_torch.nn import BatchNorm2D
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    routes, froutes = [], []

    def hook(mod, args, out):
        n, c, h, w = args[0].shape
        froutes.append(BN.batch_norm_forward_plan(
            n, c, h * w, False, args[0].dtype, True, sms)[0])
        routes.append(BN.batch_norm_backward_plan(
            n, c, h * w, False, args[0].dtype, True, sms)[0])
    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, BatchNorm2D)]
    try:
        with torch.no_grad(), amp.auto_cast(level="O1", dtype="bfloat16"):
            model(x)
    finally:
        for h in hooks:
            h.remove()
    print(f"  phase 15: forward routes of the {len(froutes)} BatchNorms: "
          f"{froutes.count('cluster')} on the cluster kernel, "
          f"{froutes.count('triton')} on the Triton kernels; backward "
          f"routes: {routes.count('cluster')} on the cluster kernel, "
          f"{routes.count('two_pass')} on the two-pass Triton kernels",
          flush=True)
    return froutes.count("cluster"), routes.count("cluster")


def _batch_norm_ms(torch, model, x):
    """Device ms of every BatchNorm's forward and backward as the step
    makes them (bf16 inputs under O1; the stem's and the blocks' inner
    ones with the ReLU fused, each block's last with the residual add and
    the ReLU), the 53 calls captured in one CUDA graph and replayed:
    through the kernels (``F.batch_norm``), and through the
    composition of PyTorch ops with PyTorch's add and ReLU, in the same
    call. Returns (kernel ms, ops ms, calls, their kinds: (x shape, with
    the residual, with the ReLU))."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import BatchNorm2D
    from paddle_tpu_torch.nn import functional as F
    calls = []

    def hook(mod, args, kwargs, out):
        res = kwargs.get("residual")
        calls.append((mod, tuple(args[0].shape),
                      None if res is None else tuple(res.shape),
                      kwargs.get("then") == "relu"))
    hooks = [m.register_forward_hook(hook, with_kwargs=True)
             for m in model.modules() if isinstance(m, BatchNorm2D)]
    try:
        with torch.no_grad(), amp.auto_cast(level="O1", dtype="bfloat16"):
            model(x)
    finally:
        for h in hooks:
            h.remove()
    g = torch.Generator(device="cuda").manual_seed(7)
    inputs = [(mod, torch.randn(s, device="cuda", generator=g)
               .to(torch.bfloat16).requires_grad_(),
               None if rs is None else torch.randn(
                   rs, device="cuda", generator=g).requires_grad_(), relu)
              for mod, s, rs, relu in calls]
    means = [m._mean.clone() for m, *_ in inputs]
    variances = [m._variance.clone() for m, *_ in inputs]

    def run(kernels):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            for (mod, xi, ri, relu), rm, rv in zip(inputs, means,
                                                    variances):
                if kernels:
                    y = F.batch_norm(xi, rm, rv, mod.weight, mod.bias,
                                     training=True, residual=ri,
                                     then="relu" if relu else None)
                else:
                    # the ops' casts are explicit in _batch_norm_ops
                    amp.amp_state.depth += 1
                    try:
                        y = _batch_norm_ops(torch, xi, rm, rv, mod.weight,
                                            mod.bias, ri, relu)
                    finally:
                        amp.amp_state.depth -= 1
                leaves = (xi, mod.weight, mod.bias) + (
                    () if ri is None else (ri,))
                torch.autograd.grad(y, leaves, torch.ones_like(y))
    ms = {k: _graph_ms(lambda k=k: run(k), iters=1, reps=5)
          for k in (True, False)}
    del inputs, means, variances
    kinds = sorted({(s, rs is not None, relu) for _, s, rs, relu in calls})
    return ms[True], ms[False], len(calls), kinds


def _resnet_tiny_on_card(torch):
    """A tiny float32 ResNet-18 (5 classes) on [8, 3, 64, 64] (layer4's
    BatchNorms over 8 x 2 x 2 values), Momentum 1e-4 with L2Decay (a
    rate at which the loss stays away from 0, where its relative error
    grows)."""
    import numpy as np
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.regularizer import L2Decay
    from paddle_tpu_torch.vision.models import resnet18
    rng = np.random.default_rng(62)
    batch = (torch.from_numpy(rng.standard_normal((8, 3, 64, 64))
                              .astype(np.float32)),
             torch.from_numpy(rng.integers(0, 5, 8)))
    torch.manual_seed(62)
    return _tiny_on_card(
        torch, "phase 15 (d)",
        lambda d: resnet18(num_classes=5, device=d),
        lambda m: Momentum(learning_rate=1e-4, momentum=0.9,
                           parameters=m.parameters(),
                           weight_decay=L2Decay(1e-4)),
        lambda m, x, y: F.cross_entropy(m(x), y), batch, 1e-4)


def phase_resnet(torch, args, launches_out):
    """ResNet-50 (BASELINE configuration 1) at ImageNet shape: 1000
    classes, float32 weights, batch 128 x [3, 224, 224] from the seed,
    under auto_cast O1, Momentum(0.1, 0.9) with L2Decay(1e-4), captured:
    (a) 2 warm-up and 5 timed steps with cuDNN's own choice, then under
    cudnn.deterministic (exact launches: the 53 BatchNorms' kernels, 53
    forward and 53 backward a step, nothing else of the port), images/s,
    MFU, peak, a profile, the BatchNorms' device ms through the kernels
    and through the PyTorch ops they replaced; replayed against eager
    with the 53 BatchNorms' running statistics; (b) an eval forward at
    batch 128 on the running statistics (53 BatchNorm launches); (d) a
    tiny float32 ResNet-18 on the card against the CPU trainer."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.nn import BatchNorm2D
    from paddle_tpu_torch.vision.models import resnet50
    card = _card_line()
    print(f"phase 15: ResNet-50, 1000 classes, batch 128 x [3, 224, 224], "
          f"float32 weights under amp O1, Momentum 0.1 / 0.9, L2Decay 1e-4, "
          f"seed {args.seed} [{card}]", flush=True)
    prev = torch.backends.cudnn.deterministic
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    g = torch.Generator(device="cuda").manual_seed(args.seed + 2)
    model = resnet50(num_classes=1000, device="cuda", generator=g)
    n_bn = sum(1 for m in model.modules() if isinstance(m, BatchNorm2D))
    x = torch.randn(128, 3, 224, 224, device="cuda", generator=g)
    n_fwd_cluster, n_cluster = _resnet_bn_cluster_calls(torch, model, x)
    y = torch.randint(0, 1000, (128,), device="cuda", generator=g)
    trainer = _resnet_trainer(model)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        flops = 3 * _forward_flops(torch, model, (x,))
    out = {}
    try:
        torch.backends.cudnn.deterministic = False
        losses0, ms0, _ = _timed_steps(torch, trainer, (x, y))
        print(f"  phase 15 cuDNN's own choice of algorithms: step "
              f"{ms0:.3f} ms captured, losses {losses0} [{card}]",
              flush=True)
        trainer._drop_graphs()
        _free(torch)
        torch.backends.cudnn.deterministic = True
        losses, step_ms, launches = _timed_steps(torch, trainer, (x, y))
        graph = _graph_line(trainer, "phase 15", card)
        expect = {k: 0 for k in K.LAUNCHES}
        expect.update(batch_norm=5 * n_bn, batch_norm_bwd=5 * n_bn,
                      batch_norm_cluster=5 * n_fwd_cluster,
                      batch_norm_bwd_cluster=5 * n_cluster)
        print(f"  phase 15 launches over 5 steps: {launches} (expected "
              f"{expect}: the BatchNorm kernels, one forward and one "
              f"backward a layer, and no other kernel of the port)",
              flush=True)
        if launches != expect:
            raise AssertionError(f"phase 15: launch counts {launches}")
        for k, v in launches.items():
            launches_out[k] = launches_out.get(k, 0) + v
        # Momentum at 0.1 from a random start without warm-up need not
        # lower the loss within 7 steps; the step's correctness is its
        # bit-equality to eager and the tiny model's agreement with the CPU
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"phase 15: losses not finite: {losses}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        prof, m = _profile(torch, lambda: trainer.train_step(x, y), 1)
        _save_trace(prof, os.path.join(args.out,
                                              "resnet50_step_trace.json"))
        del prof
        bn_ms, bn_ops_ms, bn_calls, bn_kinds = _batch_norm_ms(torch, model,
                                                              x)
        img_s = 128 / (step_ms / 1e3)
        out.update(step_ms=step_ms, step_ms_cudnn_free=ms0,
                   images_per_s=img_s, flops_per_step=flops,
                   mfu_vs_989_tflops=flops / (step_ms / 1e3) / BF16_FLOPS,
                   peak_memory_gb=peak,
                   peak_memory_of_phase_gb=peak - held / 1e9, losses=losses,
                   graph=graph, breakdown=m,
                   idle_share_untraced=1 - m["device_ms"] / step_ms,
                   batch_norm_ms=bn_ms, batch_norm_ops_ms=bn_ops_ms,
                   batch_norms=bn_calls, card=card)
        print(f"  phase 15 ResNet-50 training step, batch 128, captured, "
              f"cudnn.deterministic: {step_ms:.3f} ms ({ms0:.3f} with "
              f"cuDNN's own choice), {img_s:.1f} images/s, MFU "
              f"{out['mfu_vs_989_tflops']:.4f} ({flops / 1e12:.3f} TFLOP a "
              f"step), peak {peak:.2f} GB; {_breakdown_line(m)}; idle share "
              f"against the untraced step {out['idle_share_untraced']:.4f}; "
              f"the {bn_calls} BatchNorms' forward and backward alone "
              f"{bn_ms:.3f} ms through the kernels, {bn_ops_ms:.3f} ms "
              f"through the PyTorch ops they replaced (graph replay, the "
              f"same call) [{card}]", flush=True)
        _print_other(m, "phase 15")
        if bn_calls != n_bn or n_bn != 53:
            raise AssertionError(f"phase 15: {bn_calls} BatchNorm calls of "
                                 f"{n_bn} layers, not 53")
        if bn_kinds != _resnet50_bn_calls():
            raise AssertionError(f"phase 15: the BatchNorm calls' kinds "
                                 f"{bn_kinds} are not those phase 3 "
                                 f"compiled for ({_resnet50_bn_calls()})")
        out["eager"] = _captured_against_eager(torch, trainer, (x, y),
                                             "phase 15", card, step_ms, m)
        _drop_trainer(torch, trainer)
        model.eval()

        def evaluate():
            with torch.no_grad(), amp.auto_cast(level="O1",
                                                dtype="bfloat16"):
                return model(x)
        evaluate()
        K.reset_launches()
        logits = evaluate()
        torch.cuda.synchronize()
        eval_launches = {k: v for k, v in K.LAUNCHES.items() if v}
        eval_ms = _time_ms(evaluate, 5)
        ok = logits.shape == (128, 1000) and bool(
            torch.isfinite(logits).all()) \
            and eval_launches == {"batch_norm": n_bn}
        print(f"  phase 15 (b) eval forward at batch 128 on the running "
              f"statistics: {eval_ms:.3f} ms, logits {logits.dtype} "
              f"{tuple(logits.shape)} finite, launches {eval_launches} "
              f"(expected {{'batch_norm': {n_bn}}}) "
              f"{'ok' if ok else 'FAIL'} [{card}]", flush=True)
        if not ok:
            raise AssertionError("phase 15 (b): eval logits not finite or "
                                 "the BatchNorm launches not 53")
        out["eval_ms"] = eval_ms
        del trainer, model, x, y, logits
        _free(torch)
        torch.backends.cudnn.deterministic = True
        out["tiny_f32_vs_cpu"] = _resnet_tiny_on_card(torch)
    finally:
        torch.backends.cudnn.deterministic = prev
    return out


# -- phases 3 and 16: CTC and RNN-T ----------------------------------------------

# the sequence losses' configurations: DeepSpeech2's English output (Amodei
# et al., 2016: 28 characters and the blank) over 500 frames of a batch of
# 32; an AISHELL-1-sized Mandarin character vocabulary; a
# Conformer-Transducer's joint (Gulati et al., 2020: encoder 512 and
# prediction network 640 wide, joint 640, 1024 word pieces)
CTC_EN = dict(T=500, B=32, C=29, L=200, feat=1024, ilen=(400, 500),
              llen=(100, 200))
CTC_ZH = dict(T=250, B=32, C=4200, L=40, feat=1024, ilen=(200, 250),
              llen=(10, 40))
RNNT_CFG = dict(B=16, T=200, U=60, V=1024, enc=512, pred=640, hidden=640,
                ilen=(150, 200), llen=(30, 60))
SEQ_PLAIN = ("ctc_forward_plain", "ctc_backward_plain", "rnnt_forward_plain",
             "rnnt_backward_plain")


def _lengths(torch, g, n, lo_hi):
    return torch.randint(lo_hi[0], lo_hi[1] + 1, (n,), device="cuda",
                         generator=g, dtype=torch.int32)


def _seq_targets(torch, cfg, vocab, n_labels, seed, empty=False):
    """Labels [B, n_labels] (no blank) and input and label lengths in the
    configuration's ranges (one empty label sequence with ``empty``),
    int32 on the card, from ``seed``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lab = torch.randint(1, vocab, (cfg["B"], n_labels), device="cuda",
                        generator=g, dtype=torch.int32)
    il, ll = _lengths(torch, g, cfg["B"], cfg["ilen"]), \
        _lengths(torch, g, cfg["B"], cfg["llen"])
    if empty:
        ll[0] = 0
    return lab, il, ll


def _ctc_inputs(torch, cfg, seed, dtype=None, empty=False):
    """Logits [T, B, C] (2x standard normals) and ``_seq_targets``."""
    g = torch.Generator(device="cuda").manual_seed(seed + 1000)
    x = (torch.randn(cfg["T"], cfg["B"], cfg["C"], device="cuda",
                     generator=g) * 2).to(dtype or torch.float32)
    return (x,) + _seq_targets(torch, cfg, cfg["C"], cfg["L"], seed, empty)


def _rnnt_inputs(torch, cfg, seed, dtype=None, empty=False):
    """The joint's logits [B, T, U+1, V] and ``_seq_targets``."""
    g = torch.Generator(device="cuda").manual_seed(seed + 1000)
    x = torch.randn(cfg["B"], cfg["T"], cfg["U"] + 1, cfg["V"],
                    device="cuda", generator=g).to(dtype or torch.float32)
    return (x,) + _seq_targets(torch, cfg, cfg["V"], cfg["U"], seed, empty)


def _seq_bytes(kind, x, il, ll):
    """(forward bytes, backward bytes) the loss must move: the rows of x
    its recursion reads (t <= the sample's t_last, and for RNN-T u <= its
    label length) once, and for the backward dx written whole; the
    lengths, labels, nll and upstream gradient are a few KB."""
    esize = x.element_size()
    il, ll = il.cpu().long(), ll.cpu().long()
    if kind == "ctc":
        T, _, C = x.shape
        rows = int(il.clamp(1, T).sum())
        width = C
    else:
        _, T, _, V = x.shape
        rows = int((il.clamp(1, T) * (ll + 1)).sum())
        width = V
    read = rows * width * esize
    return read, read + x.numel() * esize


def _seq_dx_check(torch, dx, x, glp):
    """A kernel's dx against the plain gradient, element by element. The
    plain dx is ``glp - p * sum(glp)`` (``glp`` the plain gradient on the
    log-probabilities, p the softmax of x); each element may differ by
    2e-3 of the size of its two terms, ``|glp| + p * |sum(glp)|`` (the
    adjoints are exps of fp32 sums near -1000, a few 1e-4 of it off),
    plus 1e-12 of the largest such size (values near the denormal
    range), plus in bf16 one ulp of the plain value (both round).
    Returns (ok, the worst error's share of its tolerance, the max abs
    error, the worst row's max error over its largest |plain dx|, and in
    fp32 the shares two wrong gradients read: the softmax term 1% off,
    and the rows (lattice cells) of less than the median size 1% off)."""
    p = torch.softmax(x.float(), -1)
    total = glp.sum(-1, keepdim=True)
    want = glp - p * total
    size = glp.abs() + p * total.abs()
    tol = 2e-3 * size + 1e-12 * float(size.max())
    if dx.dtype != torch.float32:
        want = want.to(dx.dtype).float()
        tol += 2.0 ** -7 * want.abs()
    err = (dx.float() - want).abs()
    share = float((err / tol).max())
    rowmax = want.abs().amax(-1)
    row = float((err.amax(-1) / rowmax.clamp(min=1e-30))[rowmax > 0].max())
    wrong = None
    if dx.dtype == torch.float32:
        rows = size.amax(-1)
        low = (rows > 0) & (rows < rows[rows > 0].median())
        wrong = (float((0.01 * p * total.abs() / tol).max()),
                 float((0.01 * want.abs() / tol)[low].max()) if low.any()
                 else math.inf)
    return share <= 1.0, share, float(err.max()), row, wrong


def _seq_case(torch, results, name, kind, inputs, g, opt):
    """The kernels of ``kind`` ("ctc": opt is norm_by_times; "rnnt":
    fastemit_lambda) forward and backward against their plain versions on
    the same inputs, one launch each, two runs bit-equal; each timed
    (graph replay) beside its bound, the plain version and (CTC)
    ``F.ctc_loss`` on the log-softmaxed fp32 input (forward; forward and
    backward less forward), into ``results[name + "_fwd" / "_bwd"]``."""
    import torch.nn.functional as TF
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels import seq_loss as SL
    card = _card_line()
    x, lab, il, ll = inputs
    if kind == "ctc":
        fwd = lambda: SL.ctc_forward(x, lab, il, ll)               # noqa: E731
        bwd = lambda s: SL.ctc_backward(x, lab, il, ll, *s, g, 0, opt)  # noqa: E731
        pfwd = lambda: SL.ctc_forward_plain(x, lab, il, ll)        # noqa: E731
        pbwd = lambda a: SL.ctc_backward_plain(x, lab, il, ll, a, g, 0,  # noqa: E731
                                               opt)
        pglp = lambda a: SL.ctc_log_prob_grad_plain(  # noqa: E731
            x, lab, il, ll, a, g, 0, opt)
    else:
        fwd = lambda: SL.rnnt_forward(x, lab, il, ll)              # noqa: E731
        bwd = lambda s: SL.rnnt_backward(x, lab, il, ll, *s, g, 0, opt)  # noqa: E731
        pfwd = lambda: SL.rnnt_forward_plain(x, lab, il, ll)       # noqa: E731
        pbwd = lambda a: SL.rnnt_backward_plain(x, lab, il, ll, a, g, 0,  # noqa: E731
                                                opt)
        pglp = lambda a: SL.rnnt_log_prob_grad_plain(  # noqa: E731
            x, lab, il, ll, a, g, 0, opt)
    keys = (f"{kind}_fwd", f"{kind}_bwd")
    before = [K.LAUNCHES[k] for k in keys]
    nll, *saved = fwd()
    dx = bwd(saved)
    torch.cuda.synchronize()
    if [K.LAUNCHES[k] for k in keys] != [b + 1 for b in before]:
        raise AssertionError(f"{name}: not one launch each way")
    nll2, *saved2 = fwd()
    same = bool(torch.equal(nll, nll2) and torch.equal(dx, bwd(saved2)))
    del saved2
    pn, pa = pfwd()
    ok_b, share, err_b, row, wrong = _seq_dx_check(torch, dx, x, pglp(pa))
    del pa
    rel = float(((nll - pn).abs() / pn.abs().clamp(min=1.0)).max())
    err_f = float((nll - pn).abs().max())
    if wrong is not None and min(wrong) <= 1.0:
        raise AssertionError(f"{name}: the dx check passes a wrong "
                             f"gradient (shares {wrong})")
    tol_line = (f"each element's share of its tolerance {share:.3g}, the "
                f"worst row's error {row:.3g} of its largest")
    if wrong is not None:
        tol_line += (f"; a softmax term 1% off reads {wrong[0]:.3g}, the "
                     f"rows below the median size 1% off {wrong[1]:.3g}")
    print(f"  {name} {list(x.shape)} {str(x.dtype)[6:]} "
          f"{'norm_by_times' if kind == 'ctc' else 'fastemit_lambda'}="
          f"{opt}: nll max rel err {rel:.3g} (tol 1e-5), dx max abs err "
          f"{err_b:.3g} ({tol_line}): {'ok' if rel <= 1e-5 and ok_b else 'FAIL'};"
          f" two runs bit-equal {same}", flush=True)
    if rel > 1e-5 or not ok_b or not same:
        raise AssertionError(f"{name}: the {kind} kernels disagree with "
                             f"their plain versions or with themselves")
    nbytes_f, nbytes_b = _seq_bytes(kind, x, il, ll)
    steps = int((il.long().clamp(1, x.shape[0 if kind == "ctc" else 1])
                 + (0 if kind == "ctc" else ll.long())).max())
    ms_f = _graph_ms(fwd, iters=10, reps=3)
    ms_b = _graph_ms(lambda: bwd(saved), iters=10, reps=3)
    plain_f = _time_ms(pfwd, 1, warmup=1)
    pa = pfwd()[1]
    plain_b = _time_ms(lambda: pbwd(pa), 1, warmup=1)
    del pa
    lib_f = lib_b = None
    if kind == "ctc":
        lp = torch.log_softmax(x.float(), -1).detach().requires_grad_()
        args = (lab.long(), il.long(), ll.long())
        lib_f = _time_ms(lambda: TF.ctc_loss(lp, *args, reduction="sum"), 5)
        lib_b = _time_ms(lambda: TF.ctc_loss(lp, *args, reduction="sum")
                         .backward(), 5) - lib_f
        del lp
    out = {}
    for key, ms, plain, nbytes, lib, err in (
            ("fwd", ms_f, plain_f, nbytes_f, lib_f, err_f),
            ("bwd", ms_b, plain_b, nbytes_b, lib_b, err_b)):
        bound_ms, bound_by = _bound(nbytes, 0, FP32_FLOPS)
        results[f"{name}_{key}"] = out[key] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=lib, shape=list(x.shape),
            dtype=str(x.dtype)[6:], dependent_steps=steps)
        print(f"  {name} {key}: ms={ms:.4f} ({bound_ms / ms:.3f} of the "
              f"bound) bound_ms={bound_ms:.4f} ({bound_by}; and {steps} "
              f"dependent steps a sample) plain_ms={plain:.2f} library_ms="
              f"{'none' if lib is None else f'{lib:.4f}'} [{card}]",
              flush=True)


def phase_seq_loss_kernels(torch, results):
    """CTC and RNN-T forward and backward kernels against their plain
    versions at phase 16's shapes: CTC at DeepSpeech2's [500, 32, 29]
    (labels up to 200) in fp32, and in bf16 with an empty label sequence
    and ``norm_by_times``; at the Mandarin [250, 32, 4200] (labels up to
    40); RNN-T at the Conformer-Transducer's joint [16, 200, 61, 1024] in
    fp32 with ``fastemit_lambda`` 0.001, and in bf16 with an empty label
    sequence; ragged input and label lengths throughout. Each timed beside
    its bound, its plain version and (CTC) ``F.ctc_loss``."""
    dev = torch.device("cuda")
    print("phase 3: CTC and RNN-T kernels against their plain versions "
          "(nll within 1e-5 relative; each element of dx within 2e-3 of the "
          "size of its two terms |d/dlogp| + p |sum d/dlogp|, plus 1e-12 of "
          "the largest size, plus in bf16 one ulp)", flush=True)
    g32 = torch.rand(CTC_EN["B"], device=dev,
                     generator=torch.Generator(device=dev).manual_seed(71))
    _seq_case(torch, results, "ctc", "ctc", _ctc_inputs(torch, CTC_EN, 72),
              g32, False)
    _seq_case(torch, results, "ctc[bf16]", "ctc",
              _ctc_inputs(torch, CTC_EN, 73, torch.bfloat16, True), g32,
              True)
    _seq_case(torch, results, "ctc[zh]", "ctc",
              _ctc_inputs(torch, CTC_ZH, 74), g32, False)
    g16 = g32[:RNNT_CFG["B"]]
    _seq_case(torch, results, "rnnt", "rnnt",
              _rnnt_inputs(torch, RNNT_CFG, 75), g16, 0.001)
    _seq_case(torch, results, "rnnt[bf16]", "rnnt",
              _rnnt_inputs(torch, RNNT_CFG, 76, torch.bfloat16, True), g16,
              0.0)
    torch.cuda.empty_cache()


# -- phase 3: the dense attention's middle (X2) --------------------------------

# (tag, [b, h, sq, sk], the mask, causal, p, head_dim): the three main
# paths' shapes (timed), then the cases that reach the kernels' other
# branches (a row longer than one block, unaligned rows, a fully masked
# row, an additive mask with a gradient, flash_attn_unpadded's segments)
DENSE_MAIN = (
    ("unet", (4, 8, 4096, 4096), None, False, 0.0, 40),
    ("ernie", (32, 12, 512, 512), "padding", False, 0.1, 64),
    ("transformer", (64, 8, 64, 64), "causal+padding", False, 0.1, 64),
    ("unet 16x16", (4, 8, 256, 256), None, False, 0.0, 80),
    ("unet 8x8", (4, 8, 64, 64), None, False, 0.0, 160),
)
DENSE_EXTRA = (
    ("causal sq<sk, bool mask, a row without a key", (2, 3, 100, 300),
     "bool", True, 0.1, 64),
    ("additive mask with a gradient", (2, 2, 64, 130), "grad", False, 0.0,
     32),
    ("long unaligned row, causal, [sq, sk] mask", (1, 2, 8, 10001),
     "additive2d", True, 0.1, 64),
    ("long aligned row", (1, 1, 4, 16384), None, False, 0.1, 64),
    ("flash_attn_unpadded segments", (1, 4, 700, 700), "segments", False,
     0.0, 64),
)
DENSE_RTOL = 2e-5     # each element against its size (fp32 sums reordered)
DENSE_KERNEL = "ernie"    # the kernels line's case (the Triton kernels)
DENSE_CUDA_KERNEL = "transformer"   # the CUDA forward's


def _dense_mask(torch, kind, shape, g, dev):
    """The mask of a case: a [b, 1, 1, sk] bool padding mask (each row's
    last 0-40% of keys hidden), the Transformer decoder's additive
    [b, 1, sq, sk] (the square subsequent mask plus padding), a bool
    [b, h, sq, sk] with the first query row of each head hidden, an
    additive [b, 1, sq, sk] that needs a gradient, an additive [sq, sk],
    or the bool [sq, sk] segments of three packed sequences (causal inside
    each)."""
    b, h, sq, sk = shape
    if kind is None:
        return None
    if kind in ("padding", "causal+padding"):
        keep = torch.randint(int(0.6 * sk), sk + 1, (b,), device=dev,
                             generator=g)
        pad = torch.arange(sk, device=dev)[None, :] < keep[:, None]
        if kind == "padding":
            return pad[:, None, None, :]
        sub = torch.triu(torch.full((sq, sk), -1e9, device=dev), 1)
        return sub[None, None] + torch.where(pad, 0.0, -1e9)[:, None, None]
    if kind == "bool":
        m = torch.rand(shape, device=dev, generator=g) < 0.7
        m[:, :, 0] = False
        return m
    if kind == "grad":
        return torch.randn(b, 1, sq, sk, device=dev,
                           generator=g).requires_grad_()
    if kind == "additive2d":
        return torch.randn(sq, sk, device=dev, generator=g)
    cu = torch.tensor([0, 180, 520, 700], device=dev)
    seg = torch.searchsorted(cu, torch.arange(700, device=dev), right=True)
    pos = torch.arange(700, device=dev) - cu[seg - 1]
    return (seg[:, None] == seg[None, :]) & (pos[:, None] >= pos[None, :])


def _dense_rel(name, got, want, size):
    """Each element of ``got`` within DENSE_RTOL of its ``size`` (plus
    1e-30; for ds the size of its terms, ``p |gp| + p sum(p |gp|)``): the
    worst element's share of its tolerance."""
    err = (got.detach() - want.detach()).abs()
    worst = float((err / (DENSE_RTOL * size + 1e-30)).max())
    ok = math.isfinite(worst) and worst <= 1.0
    print(f"  {name}: max_abs_err={float(err.max()):.4g}, the worst element "
          f"at {worst:.3g} of its tolerance ({DENSE_RTOL} of its size) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({worst} of the tolerance)")
    return float(err.max())


def _dense_bytes(shape, mask, p, backward):
    """Bytes a call must move: forward the scores read and the probs (and
    the dropped probs) written; backward g and the probs read, ds written;
    the mask read once at its own size."""
    n = math.prod(shape)
    mb = 0 if mask is None else mask.numel() * mask.element_size()
    return 4 * n * (3 if backward or p > 0 else 2) + mb


def _dense_case(torch, results, tag, shape, mask_kind, causal, p, hd,
                timed, seed):
    """X2 at one shape against its plain version on the card: the probs
    element by element, the dropped probs bit-equal to the kernel's own
    probs under ``keep_mask_plain``'s bits, ds (and the additive mask's
    gradient) against the plain version's autograd, two calls bit-equal;
    where the plan takes the CUDA forward, the Triton forward too (its
    probs and its keep mask); ``timed``: ms by graph replay each way
    beside the bound, the plain version and torch.softmax (the softmax
    alone), the forward on both routes where the plan takes CUDA."""
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels import dense_attention as DA
    from paddle_tpu_torch.kernels import dropout as D
    dev = torch.device("cuda")
    card = _card_line()
    g = torch.Generator(device=dev).manual_seed(seed)
    scores = torch.randn(shape, device=dev, generator=g) * 4.0
    mask = _dense_mask(torch, mask_kind, shape, g, dev)
    scale = 1.0 / math.sqrt(hd)
    key = _rk(torch.tensor([seed, 99], device=dev), 7) if p > 0 else None
    want_dz = mask_kind == "grad"
    mk = None if mask is None else mask.detach()
    cuda = DA.dense_softmax_forward_plan(shape[-1]) == "cuda"
    before = (K.LAUNCHES["dense_softmax"], K.LAUNCHES["dense_softmax_bwd"],
              K.LAUNCHES["dense_softmax_cuda"])
    probs, dropped = DA.dense_softmax_forward(scores, mk, causal, scale, p,
                                              key)
    gy = torch.randn(shape, device=dev, generator=g)
    ds, dz = DA.dense_softmax_backward(gy, probs, mk, causal, scale, p, key,
                                       want_dz)
    if (K.LAUNCHES["dense_softmax"], K.LAUNCHES["dense_softmax_bwd"],
            K.LAUNCHES["dense_softmax_cuda"]) != (
            before[0] + 1, before[1] + 1, before[2] + int(cuda)):
        raise AssertionError(f"dense attention [{tag}]: the kernels did not "
                             f"launch once each (CUDA forward {cuda})")
    sp = scores.clone().requires_grad_()
    leaves = [sp] + ([mask] if want_dz else [])
    pp, dp = DA.dense_softmax_plain(sp, mask, causal, scale, p, key)
    grads = torch.autograd.grad(dp, leaves, gy)
    name = f"dense attention [{tag}] {list(shape)}"
    route = "CUDA" if cuda else "Triton"
    err = _dense_rel(f"{name} probs ({route})", probs, pp, pp.detach().abs())
    outs = [(route, probs, dropped)]
    targs = (*DA._mask_args(mk, scores.shape, dev), causal, scale,
             *DA._drop_args(p, key, scores.device))
    if cuda:
        tp = torch.empty_like(scores)
        td = torch.empty_like(scores) if p > 0 else tp
        DA._triton_forward(scores, *targs, tp, td)
        err_t = _dense_rel(f"{name} probs (Triton)", tp, pp,
                           pp.detach().abs())
        outs.append(("Triton", tp, td))
    else:
        err_t = err
    if p > 0:
        keep = D.keep_mask_plain(shape, p, key, dev)
        for rname, pr, dr in outs:
            want = torch.where(keep, pr * D.scale_of(p, "upscale_in_train"),
                               torch.zeros((), device=dev))
            same = bool(torch.equal(dr, want))
            print(f"  {name} p={p} ({rname}): the dropped probs bit-equal to "
                  f"the kernel's probs under kernels/dropout.py's keep mask "
                  f"{same}; keep fraction {float(keep.float().mean()):.5f}",
                  flush=True)
            if not same:
                raise AssertionError(f"{name} ({rname}): the dropout's bits "
                                     f"differ from kernels/dropout.py's")
    del outs
    gp = gy * (dropped != 0) * (D.scale_of(p, "upscale_in_train")
                                if p > 0 else 1.0)
    # the size of each element's terms: p |gp| and p sum(|gp| p)
    dot = (gp.abs() * probs).sum(-1, keepdim=True)
    size = probs * (gp.abs() + dot) * scale
    _dense_rel(f"{name} ds", ds, grads[0], size)
    if want_dz:
        _dense_rel(f"{name} d(mask)", dz.sum_to_size(mask.shape), grads[1],
                   (size / scale).sum_to_size(mask.shape))
    probs2, dropped2 = DA.dense_softmax_forward(scores, mk, causal, scale, p,
                                                key)
    ds2, _ = DA.dense_softmax_backward(gy, probs, mk, causal, scale, p, key,
                                       want_dz)
    same2 = bool(torch.equal(probs, probs2) and torch.equal(dropped, dropped2)
                 and torch.equal(ds, ds2))
    print(f"  {name}: two calls bit-equal {same2}", flush=True)
    if not same2:
        raise AssertionError(f"{name}: two calls differ")
    del pp, dp, grads, sp, probs2, dropped2, ds2, dz, gp, dot, size
    if not timed:
        torch.cuda.empty_cache()
        return
    n = math.prod(shape)
    z = scores * scale
    # a call of a few microseconds is timed over _graph_ms's 100 replayed
    # calls (over 15 a replay's own cost is within the noise)
    it = {} if n <= 1 << 22 else dict(iters=5, reps=3)
    with torch.no_grad():
        fwd = _graph_ms(lambda: DA.dense_softmax_forward(
            scores, mk, causal, scale, p, key), **it)
        if cuda:
            fwd_t = _graph_ms(lambda: DA._triton_forward(scores, *targs, tp,
                                                         td), **it)
        bwd = _graph_ms(lambda: DA.dense_softmax_backward(
            gy, probs, mk, causal, scale, p, key), **it)
        plain_fwd = _time_ms(lambda: DA.dense_softmax_plain(
            scores, mk, causal, scale, p, key), 3)
        lib_fwd = _graph_ms(lambda: torch.softmax(z, -1), **it)
        lib_bwd = _graph_ms(lambda: torch._softmax_backward_data(
            gy, probs, -1, torch.float32), **it)
    sp = scores.clone().requires_grad_()

    def plain_both():
        torch.autograd.grad(DA.dense_softmax_plain(sp, mk, causal, scale,
                                                   p, key)[1], sp, gy)
    plain_bwd = max(_time_ms(plain_both, 3) - plain_fwd, 0.0)
    ops = 7 * n + (7 * n if p > 0 else 0)
    rows = [("dense_softmax_cuda", fwd, plain_fwd, lib_fwd, False, err),
            ("dense_softmax", fwd_t, plain_fwd, lib_fwd, False, err_t)] \
        if cuda else [("dense_softmax", fwd, plain_fwd, lib_fwd, False, err)]
    for kind, ms, pl, lib, back, e in rows + [
            ("dense_softmax_bwd", bwd, plain_bwd, lib_bwd, True, err)]:
        bound_ms, bound_by = _bound(_dense_bytes(shape, mk, p, back),
                                    ops, FP32_FLOPS)
        results[f"{kind}[{tag}]"] = dict(
            max_abs_err=e, ms=ms, plain_ms=pl, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=lib, shape=list(shape),
            mask=mask_kind, p=p, share_of_bound=bound_ms / ms)
        print(f"  {kind}[{tag}] {list(shape)} mask {mask_kind} p={p}: "
              f"ms={ms:.4f} ({bound_ms / ms:.3f} of the bound) plain_ms="
              f"{pl:.4f} bound_ms={bound_ms:.4f} ({bound_by}); torch.softmax"
              f"{' backward' if back else ''} alone (pre-scaled scores) "
              f"{lib:.4f} ms [{card}]", flush=True)
    del scores, probs, dropped, ds, gy, z, sp
    if cuda:
        del tp, td
    torch.cuda.empty_cache()


def phase_dense_attention_kernels(torch, results):
    """X2, the dense attention's middle (scale, masks, softmax, dropout),
    forward and backward kernels against their plain version on the card
    in fp32 at the UNet's [4, 8, 4096, 4096] (no mask, no dropout),
    ERNIE's [32, 12, 512, 512] (a padding mask, p 0.1) and
    Transformer-base's decoder self-attention [64, 8, 64, 64] (the float
    causal mask plus padding, p 0.1) and the UNet's self-attentions at 16 x
    16 and 8 x 8 ([4, 8, 256, 256], [4, 8, 64, 64]), each timed (the last
    three on the CUDA forward, which ``dense_softmax_forward_plan`` takes
    at short rows, timed beside the Triton one); then causal with sq < sk,
    a bool mask with a row that sees no key, an additive mask with a
    gradient, rows longer than one block (unaligned and aligned) and
    flash_attn_unpadded's segment mask."""
    print(f"phase 3: the dense attention's middle (X2) against its plain "
          f"version (probs and ds each element within {DENSE_RTOL} of its "
          f"size: fp32 sums in another order; the dropout's keep mask "
          f"bit-equal to kernels/dropout.py's; two calls bit-equal)",
          flush=True)
    for i, (tag, shape, mask, causal, p, hd) in enumerate(DENSE_MAIN):
        _dense_case(torch, results, tag, shape, mask, causal, p, hd, True,
                    91 + i)
    for i, (tag, shape, mask, causal, p, hd) in enumerate(DENSE_EXTRA):
        _dense_case(torch, results, tag, shape, mask, causal, p, hd, False,
                    95 + i)


def _layer_cases(torch, F, nn):
    """(name, call(tensors, device), numpy inputs, indices of the inputs
    that carry gradients) for the functionals and layers of this slice."""
    import numpy as np
    rng = np.random.default_rng(81)

    def f32(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    x, y = f32(4, 5), f32(4, 5)
    logp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    lab = rng.integers(0, 5, 4)
    p = rng.uniform(0.05, 0.95, (4, 5)).astype(np.float32)
    bits = rng.integers(0, 2, (4, 5)).astype(np.float32)
    sign = np.where(rng.random(4) < 0.5, -1.0, 1.0).astype(np.float32)
    e1, e2, e3 = f32(5, 4), f32(5, 4), f32(5, 4)
    img = f32(2, 4, 6, 6)
    cases = [
        ("cross_entropy", lambda t, d: F.cross_entropy(
            t[0], t[1], label_smoothing=0.1, reduction="sum"), [x, lab], [0]),
        ("cross_entropy[soft]", lambda t, d: F.cross_entropy(
            t[0], t[1], soft_label=True), [x, p], [0]),
        ("nll_loss", lambda t, d: F.nll_loss(t[0], t[1]), [logp, lab], [0]),
        ("mse_loss", lambda t, d: F.mse_loss(*t), [x, y], [0, 1]),
        ("smooth_l1_loss", lambda t, d: F.smooth_l1_loss(*t), [x, y], [0]),
        ("bce", lambda t, d: F.binary_cross_entropy(*t), [p, bits], [0]),
        ("bce_with_logits", lambda t, d: F.binary_cross_entropy_with_logits(
            t[0], t[1], pos_weight=t[2]), [x, bits, p[0]], [0]),
        ("kl_div", lambda t, d: F.kl_div(*t, reduction="batchmean"),
         [logp, p], [0]),
        ("margin_ranking_loss", lambda t, d: F.margin_ranking_loss(*t),
         [x[:, 0], y[:, 0], sign], [0, 1]),
        ("cosine_embedding_loss", lambda t, d: F.cosine_embedding_loss(*t),
         [e1, e2, np.array([1, -1, 1, 1, -1])], [0, 1]),
        ("triplet_margin_loss", lambda t, d: F.triplet_margin_loss(
            *t, swap=True), [e1, e2, e3], [0, 1, 2]),
        ("sigmoid_focal_loss", lambda t, d: F.sigmoid_focal_loss(*t),
         [x, bits], [0]),
        ("margin_cross_entropy", lambda t, d: F.margin_cross_entropy(
            t[0], t[1]), [np.tanh(x), lab], [0]),
        ("hsigmoid_loss", lambda t, d: F.hsigmoid_loss(
            t[0], t[1], 6, t[2], t[3]), [e1, rng.integers(0, 6, 5),
                                         f32(5, 4), f32(5, 1)], [0, 2, 3]),
        ("dice_loss", lambda t, d: F.dice_loss(torch.softmax(t[0], -1), t[1]),
         [img, rng.integers(0, 6, (2, 4, 6, 1))], [0]),
        ("gaussian_nll_loss", lambda t, d: F.gaussian_nll_loss(*t),
         [x, y, p], [0, 2]),
        ("poisson_nll_loss", lambda t, d: F.poisson_nll_loss(*t, full=True),
         [x, bits * 3], [0]),
        ("multi_margin_loss", lambda t, d: F.multi_margin_loss(*t, p=2),
         [x, lab], [0]),
        ("multi_label_soft_margin_loss", lambda t, d:
         F.multi_label_soft_margin_loss(*t), [x, bits], [0]),
        ("triplet_margin_with_distance_loss", lambda t, d:
         F.triplet_margin_with_distance_loss(*t), [e1, e2, e3], [0, 1, 2]),
        ("npair_loss", lambda t, d: F.npair_loss(*t),
         [e1, e2, np.array([0, 1, 0, 2, 1])], [0, 1]),
        ("adaptive_log_softmax", lambda t, d: nn.AdaptiveLogSoftmaxWithLoss(
            4, 10, [3, 6], head_bias=True, device=d)(t[0], t[1])[1],
         [e1, np.array([0, 2, 5, 7, 9])], [0]),
        ("interpolate[bicubic]", lambda t, d: F.interpolate(
            t[0], size=[4, 9], mode="bicubic"), [img], [0]),
        ("interpolate[area]", lambda t, d: F.interpolate(
            t[0], size=[3, 2], mode="area"), [img], [0]),
        ("interpolate[trilinear]", lambda t, d: F.interpolate(
            t[0][:, :, None], size=[2, 9, 4], mode="trilinear",
            data_format="NCDHW"), [img], [0]),
        ("upsample[corners]", lambda t, d: nn.UpsamplingBilinear2D(
            scale_factor=2, data_format="NHWC")(t[0]), [img], [0]),
        ("pad[reflect]", lambda t, d: nn.Pad2D([1, 2, 2, 1], "reflect")(
            t[0]), [img], [0]),
        ("pad[circular]", lambda t, d: F.pad(t[0], [1, 1, 2, 0], "circular",
                                              data_format="NHWC"), [img], [0]),
        ("fold", lambda t, d: nn.Fold([6, 6], 3, 1, 1)(
            nn.Unfold(3, 1, 1)(t[0])), [img], [0]),
        ("shuffles", lambda t, d: nn.ChannelShuffle(2)(nn.PixelUnshuffle(2)(
            nn.PixelShuffle(2)(t[0]))), [img], [0]),
        ("cosine_similarity", lambda t, d: nn.CosineSimilarity()(*t),
         [e1, e2], [0, 1]),
        ("bilinear", lambda t, d: nn.Bilinear(4, 4, 3, device=d)(*t),
         [e1, e2], [0, 1]),
        ("softmax2d", lambda t, d: nn.Softmax2D()(t[0]), [img], [0]),
        ("spectral_norm", lambda t, d: nn.SpectralNorm([4, 5], device=d)(
            t[0]), [f32(4, 5)], [0]),
        ("dropout2d", lambda t, d: nn.Dropout2D(0.3)(t[0]), [img], [0]),
        ("alpha_dropout", lambda t, d: nn.AlphaDropout(0.2)(t[0]), [img],
         [0]),
        ("feature_alpha_dropout", lambda t, d: nn.FeatureAlphaDropout(0.2)(
            t[0]), [img], [0]),
        ("class_center_sample", lambda t, d: F.class_center_sample(
            t[0], 20, 8)[1], [np.array([3, 7, 3, 12])], []),
    ]
    return cases + _attention_cases(torch, F, nn, rng)


def _sparse_csr(rng, b, h, s, nnz):
    """CSR offsets [b, h, s + 1] and columns [b, h, nnz] (rows of 0-4
    sorted keys, one row empty, the tail padding)."""
    import numpy as np
    offs, cols = [], []
    for _ in range(b * h):
        lens = rng.integers(0, 5, s)
        lens[1] = 0
        offs.append(np.concatenate([[0], np.cumsum(lens)]))
        c = np.concatenate([np.sort(rng.choice(s, n, replace=False))
                            for n in lens] + [np.zeros(0, np.int64)])
        cols.append(np.concatenate([c, np.zeros(nnz - len(c))]))
    return (np.stack(offs).reshape(b, h, s + 1).astype(np.int32),
            np.stack(cols).reshape(b, h, nnz).astype(np.int32))


def _attention_cases(torch, F, nn, rng):
    """The attention functionals, sparse_attention, the
    Transformer layers (weights made on the CPU from one seed and moved,
    so both devices hold the same), the fused functionals and layers, the
    in-place activations."""
    import numpy as np
    from paddle_tpu_torch.incubate import nn as inn
    from paddle_tpu_torch.incubate.nn import functional as IF

    def f32(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def built(make, d):
        torch.manual_seed(5)
        return make().to(d)
    q, k, v = f32(2, 64, 2, 64), f32(2, 64, 2, 64), f32(2, 64, 2, 64)
    packed = f32(64, 3, 2, 64)
    cu = np.array([0, 20, 44, 64], np.int32)
    sq, sk, sv = f32(2, 2, 8, 16), f32(2, 2, 8, 16), f32(2, 2, 8, 16)
    off, cols = _sparse_csr(rng, 2, 2, 8, 40)
    kpm = (rng.random((2, 8)) > 0.2).astype(np.float32)
    am = (rng.random((8, 8)) > 0.2).astype(np.float32)
    x, mem = f32(2, 64, 64), f32(2, 64, 64)
    pad = np.where(rng.random((2, 1, 1, 64)) > 0.3, 0.0, -1e9).astype(
        np.float32)
    sub = np.triu(np.full((64, 64), -1e9, np.float32), 1)
    mmask = rng.random((2, 1, 64, 64)) > 0.3
    w1, w2 = f32(64, 96, scale=0.1), f32(96, 64, scale=0.1)
    qkvw, lw = f32(3, 2, 32, 64, scale=0.1), f32(64, 64, scale=0.1)
    cache = f32(2, 2, 2, 4, 32)
    mha = (lambda: nn.MultiHeadAttention(64, 2, dropout=0.1,
                                         device="cpu"))
    return [
        ("flash_attention", lambda t, d: F.flash_attention(
            *t, causal=True)[0], [q, k, v], [0, 1, 2]),
        ("flash_attention[dropout]", lambda t, d: F.flash_attention(
            *t, dropout=0.1)[0], [q, k, v], [0, 1, 2]),
        ("flash_attn_qkvpacked", lambda t, d: F.flash_attn_qkvpacked(
            t[0].reshape(2, 64, 3, 2, 64))[0],
         [np.stack([q, k, v], 2).reshape(2, 64, 6, 64)], [0]),
        ("flash_attn_unpadded[causal]", lambda t, d: F.flash_attn_unpadded(
            t[0][:, 0], t[0][:, 1], t[0][:, 2], t[1], t[1], 24, 24, 0.125,
            causal=True)[0], [packed, cu], [0]),
        ("flash_attn_varlen_qkvpacked", lambda t, d:
         F.flash_attn_varlen_qkvpacked(t[0], t[1], t[1], 24, 24, 0.2)[0],
         [packed, cu], [0]),
        ("sparse_attention", lambda t, d: F.sparse_attention(*t),
         [sq, sk, sv, off, cols, kpm, am], [0, 1, 2]),
        ("MultiHeadAttention[mask, Cache]", lambda t, d: (lambda m: m(
            t[0], attn_mask=t[1], cache=m.gen_cache(t[0]))[0])(
                built(mha, d)), [x, pad], [0]),
        ("MultiHeadAttention[StaticCache]", lambda t, d: (lambda m: m(
            t[0], t[1], t[1], cache=m.gen_cache(
                t[1], type=nn.MultiHeadAttention.StaticCache))[0])(
                    built(mha, d)), [x, mem], [0, 1]),
        ("TransformerEncoderLayer[pre-norm]", lambda t, d: built(
            lambda: nn.TransformerEncoderLayer(
                64, 2, 96, normalize_before=True, activation="gelu",
                device="cpu"), d)(t[0], t[1]), [x, pad], [0]),
        ("TransformerDecoderLayer", lambda t, d: built(
            lambda: nn.TransformerDecoderLayer(64, 2, 96, device="cpu"), d)(
                t[0], t[1], t[2], t[3]), [x, mem, sub, mmask], [0, 1]),
        ("Transformer", lambda t, d: built(
            lambda: nn.Transformer(64, 2, 1, 1, 96, device="cpu"), d)(
                t[0], t[1], None, t[2]), [mem, x, sub], [0, 1]),
        ("fused_feedforward", lambda t, d: IF.fused_feedforward(
            *t, dropout1_rate=0.1, dropout2_rate=0.1, pre_layer_norm=True),
         [x, w1, w2], [0, 1, 2]),
        ("fused_multi_head_attention[cache_kv]", lambda t, d:
         IF.fused_multi_head_attention(
             t[0], t[1], t[2], attn_mask=None, cache_kv=t[3],
             dropout_rate=0.1, attn_dropout_rate=0.1)[0],
         [x, qkvw, lw, cache], [0, 1, 2]),
        ("FusedTransformerEncoderLayer", lambda t, d: built(
            lambda: inn.FusedTransformerEncoderLayer(64, 2, 96,
                                                     device="cpu"), d)(
                t[0], t[1]), [x, pad], [0]),
        ("FusedBiasDropoutResidualLayerNorm", lambda t, d: built(
            lambda: inn.FusedBiasDropoutResidualLayerNorm(64, 0.1,
                                                          device="cpu"), d)(
                *t), [x, f32(2, 64, 64)], [0, 1]),
        ("elu_ / leaky_relu_ / hardtanh_ / tanh_ / thresholded_relu_",
         lambda t, d: F.thresholded_relu_(F.tanh_(F.hardtanh_(
             F.leaky_relu_(F.elu_(t[0] * 1.0))))), [x], [0]),
    ]


def phase_new_layers_on_card(torch):
    """Each new functional and layer of this slice on CUDA tensors against
    the same call on CPU tensors (the same seed before each, so layers
    draw the same parameters and the random ones the same bits): outputs
    and input gradients within 1e-5 of the largest CPU value (float32 sums
    in another order); the random ones equal."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F
    print("phase 3: the new losses, common functionals and layers, and the "
          "attention functionals, Transformer and fused layers, on the card "
          "against the CPU (within 1e-5 of the largest CPU value)",
          flush=True)
    worst, n = 0.0, 0
    for name, call, arrays, diff in _layer_cases(torch, F, nn):
        got = []
        for dev in ("cpu", "cuda"):
            ts = [torch.from_numpy(a).to(dev).requires_grad_(i in diff)
                  for i, a in enumerate(arrays)]
            ptt.seed(82)
            out = call(ts, dev)
            grads = []
            if diff:
                ct = torch.from_numpy(np.asarray(
                    np.random.default_rng(83).standard_normal(
                        tuple(out.shape)), np.float32)).to(dev)
                grads = torch.autograd.grad((out.float() * ct).sum(),
                                            [ts[i] for i in diff])
            got.append([t.detach().cpu() for t in (out, *grads)])
        for a, b in zip(got[1], got[0]):
            if not a.is_floating_point():
                err = 0.0 if torch.equal(a, b) else float("inf")
            else:
                err = float((a - b).abs().max()) / max(1.0,
                                                       float(b.abs().max()))
            worst = max(worst, err)
            if not err <= 1e-5:
                raise AssertionError(f"{name}: the card's result differs "
                                     f"from the CPU's ({err})")
        n += 1
    print(f"  {n} calls, outputs and gradients: the worst at {worst:.3g} of "
          f"the largest CPU value (tol 1e-5) ok [{_card_line()}]",
          flush=True)
    same = _sparse_twice(torch, F)
    return dict(calls=n, worst_rel=worst, sparse_attention_bit_equal=same)


def _sparse_twice(torch, F):
    """sparse_attention on the card twice at [4, 8, 512, 64] with 32 keys a
    row (both masks): output and the q, k, v gradients bit-equal (its
    reductions run in a fixed order)."""
    import numpy as np
    rng = np.random.default_rng(84)
    b, h, s, d, per = 4, 8, 512, 64, 32
    qkv = [torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(
        np.float32)).cuda() for _ in range(3)]
    cols = np.sort(np.stack([rng.choice(s, per, replace=False)
                             for _ in range(b * h * s)]), axis=-1)
    cols = torch.from_numpy(cols.reshape(b, h, s * per)).cuda()
    off = torch.arange(0, s * per + 1, per).repeat(b, h, 1).cuda()
    kpm = torch.from_numpy((rng.random((b, s)) > 0.1).astype(
        np.float32)).cuda()
    am = torch.from_numpy((rng.random((s, s)) > 0.1).astype(
        np.float32)).cuda()
    gy = torch.randn(b, h, s, d, device="cuda")
    runs = []
    for _ in range(2):
        ts = [t.clone().requires_grad_() for t in qkv]
        out = F.sparse_attention(*ts, off, cols, kpm, am)
        runs.append([out] + list(torch.autograd.grad(out, ts, gy)))
    same = all(torch.equal(a, c) for a, c in zip(*runs))
    print(f"  sparse_attention [4, 8, 512, 64], 32 keys a row, twice on the "
          f"card: output and gradients bit-equal {same}", flush=True)
    if not same:
        raise AssertionError("sparse_attention: two calls on the card differ")
    return same


def _ctc_model(torch, cfg, device, seed):
    """The CTC head: ``Linear(feat, C)`` over features [T, B, feat]."""
    from paddle_tpu_torch.nn import Linear
    g = torch.Generator(device=device).manual_seed(seed)
    return Linear(cfg["feat"], cfg["C"], device=device, generator=g)


def _ctc_loss_fn(m, feats, labels, il, ll):
    from paddle_tpu_torch.nn import CTCLoss
    return CTCLoss()(m(feats), labels, il, ll)


def _joint_model(torch, cfg, device, seed):
    """The transducer's joint: the encoder's [B, T, enc] and the
    prediction network's [B, U+1, pred] outputs each through a Linear to
    ``hidden``, added with broadcasting, tanh, then ``Linear(hidden, V)``:
    logits [B, T, U+1, V]."""
    from paddle_tpu_torch.nn import Layer, Linear
    g = torch.Generator(device=device).manual_seed(seed)

    class Joint(Layer):
        def __init__(self):
            super().__init__()
            self.enc = Linear(cfg["enc"], cfg["hidden"], device=device,
                              generator=g)
            self.pred = Linear(cfg["pred"], cfg["hidden"], device=device,
                               generator=g)
            self.out = Linear(cfg["hidden"], cfg["V"], device=device,
                              generator=g)

        def forward(self, enc, pred):
            h = self.enc(enc)[:, :, None, :] + self.pred(pred)[:, None, :, :]
            return self.out(torch.tanh(h))
    return Joint()


def _rnnt_loss_fn(m, enc, pred, labels, il, ll):
    from paddle_tpu_torch.nn import RNNTLoss
    return RNNTLoss()(m(enc, pred), labels, il, ll)


def _seq_trainer(model, loss_fn, lr=1e-3):
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import SpmdTrainer
    return SpmdTrainer(model, AdamW(learning_rate=lr,
                                    parameters=model.parameters()), loss_fn)


def _seq_train(torch, tag, model, loss_fn, batch, kind, card, launches_out):
    """Phase 16's run of one configuration: the trainer's first step
    (eager, then captured) and two replayed steps with exact launch
    counts (the loss's two kernels and AdamW, one each a step, nothing
    else of the port), finite losses, step ms, a profile of one step (the
    loss kernels' share), then 2 replayed steps against 2 eager ones from
    one snapshot, bit-equal."""
    from paddle_tpu_torch import kernels as K
    trainer = _seq_trainer(model, loss_fn)
    losses, step_ms, launches = _timed_steps(torch, trainer, batch, 1, 2)
    want = {k: 0 for k in K.LAUNCHES}
    want.update({f"{kind}_fwd": 2, f"{kind}_bwd": 2, "adamw": 2})
    got = {k: v for k, v in launches.items() if v}
    ok = launches == want and all(math.isfinite(v) for v in losses)
    print(f"  {tag}: losses {losses}; 2 replayed steps launched {got} "
          f"(want {kind}_fwd 2, {kind}_bwd 2, adamw 2) "
          f"{'ok' if ok else 'FAIL'}; step ms {step_ms:.3f} [{card}]",
          flush=True)
    if not ok:
        raise AssertionError(f"{tag}: launches {got} or losses {losses}")
    for k, v in launches.items():
        launches_out[k] = launches_out.get(k, 0) + v
    # one CUDA kernel of each call is named here; a trace that lost one
    # is taken again (``_profile``)
    checked = {(f"{kind}_fwd",): lambda n: f"{kind}_alpha_kernel" in n,
               (f"{kind}_bwd",): lambda n: f"{kind}_adjoint_kernel" in n,
               ("adamw",): lambda n: "adamw_kernel" in n}
    _, prof = _profile(torch, lambda: trainer.train_step(*batch), 1,
                       checked)
    share = sum(prof["by_group_ms"].get(k, 0.0)
                for k in (f"{kind}_fwd", f"{kind}_bwd")) / prof["device_ms"]
    print(f"  {tag}: {_breakdown_line(prof)}; the loss kernels "
          f"{share:.3f} of the device ms", flush=True)
    eager = _captured_against_eager(torch, trainer, batch, tag, card,
                                    step_ms, prof, n=2, checked=checked)
    _drop_trainer(torch, trainer)
    return dict(losses=losses, step_ms=step_ms, breakdown=prof,
                loss_kernel_share=share, eager=eager, launches=got)


def _seq_tiny_on_card(torch):
    """A tiny float32 CTC head and RNN-T joint trained 3 steps on the card
    against the CPU trainer (``_tiny_on_card``)."""
    import numpy as np
    from paddle_tpu_torch.optimizer import AdamW
    rng = np.random.default_rng(84)
    ctc = dict(T=20, B=3, C=7, L=5, feat=16)
    batch = tuple(torch.from_numpy(a) for a in (
        rng.standard_normal((20, 3, 16)).astype(np.float32),
        rng.integers(1, 7, (3, 5)).astype(np.int32),
        np.array([20, 15, 9], np.int32), np.array([5, 0, 3], np.int32)))
    opt = lambda m: AdamW(learning_rate=1e-3, parameters=m.parameters())  # noqa: E731
    out = {"ctc": _tiny_on_card(
        torch, "phase 16 (ctc)", lambda d: _ctc_model(torch, ctc, d, 85),
        opt, _ctc_loss_fn, batch, 1e-3)}
    joint = dict(B=2, T=8, U=3, V=9, enc=12, pred=10, hidden=16)
    batch = tuple(torch.from_numpy(a) for a in (
        rng.standard_normal((2, 8, 12)).astype(np.float32),
        rng.standard_normal((2, 4, 10)).astype(np.float32),
        rng.integers(1, 9, (2, 3)).astype(np.int32),
        np.array([8, 5], np.int32), np.array([3, 1], np.int32)))
    out["rnnt"] = _tiny_on_card(
        torch, "phase 16 (rnnt)", lambda d: _joint_model(torch, joint, d, 86),
        opt, _rnnt_loss_fn, batch, 1e-3)
    return out


def phase_seq_loss_training(torch, args, launches_out):
    """Sequence-loss training through ``SpmdTrainer`` (captured, AdamW),
    with no plain loop allowed to run (each raises): (a) CTC at
    DeepSpeech2's English output, features [500, 32, 1024] ->
    ``Linear(1024, 29)`` -> ``CTCLoss``, input lengths 400-500, labels
    100-200; (b) CTC over a 4,200-character Mandarin vocabulary, [250, 32,
    1024], labels up to 40; (c) RNN-T at a Conformer-Transducer's joint:
    encoder [16, 200, 512] and prediction [16, 61, 640] each to 640, added,
    tanh, ``Linear(640, 1024)``, ``RNNTLoss`` (fastemit 0.001) on [16, 200,
    61, 1024] fp32, input lengths 150-200, labels 30-60; each as
    ``_seq_train``; (d) a tiny float32 CTC head and joint on the card
    against the CPU trainer."""
    from paddle_tpu_torch.kernels import seq_loss as SL
    card = _card_line()
    print(f"phase 16: sequence-loss training, captured, AdamW, seed "
          f"{args.seed} [{card}]", flush=True)
    out = {}
    with ExitStack() as stack:
        for fn in SEQ_PLAIN:
            stack.enter_context(mock.patch.object(
                SL, fn, side_effect=AssertionError(f"{fn} ran on the card")))
        for tag, cfg in (("ctc_en", CTC_EN), ("ctc_zh", CTC_ZH)):
            g = torch.Generator(device="cuda").manual_seed(args.seed + 90)
            feats = torch.randn(cfg["T"], cfg["B"], cfg["feat"],
                                device="cuda", generator=g)
            lab, il, ll = _seq_targets(torch, cfg, cfg["C"], cfg["L"],
                                       args.seed + 91)
            model = _ctc_model(torch, cfg, "cuda", args.seed + 92)
            out[tag] = _seq_train(torch, f"phase 16 ({tag})", model,
                                  _ctc_loss_fn, (feats, lab, il, ll), "ctc",
                                  card, launches_out)
            del model, feats
            _free(torch)
        cfg = RNNT_CFG
        g = torch.Generator(device="cuda").manual_seed(args.seed + 93)
        enc = torch.randn(cfg["B"], cfg["T"], cfg["enc"], device="cuda",
                          generator=g)
        pred = torch.randn(cfg["B"], cfg["U"] + 1, cfg["pred"],
                           device="cuda", generator=g)
        lab, il, ll = _seq_targets(torch, cfg, cfg["V"], cfg["U"],
                                   args.seed + 94)
        torch.cuda.reset_peak_memory_stats()
        model = _joint_model(torch, cfg, "cuda", args.seed + 95)
        out["rnnt"] = _seq_train(torch, "phase 16 (rnnt)", model,
                                 _rnnt_loss_fn, (enc, pred, lab, il, ll),
                                 "rnnt", card, launches_out)
        out["rnnt"]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"  phase 16 (rnnt): peak {out['rnnt']['peak_gb']:.2f} GB",
              flush=True)
        del model, enc, pred
        _free(torch)
    out["tiny_f32_vs_cpu"] = _seq_tiny_on_card(torch)
    return out


# -- the dense attention's middle a step, through X2 and through the ops ------

def _dense_calls(torch, run):
    """The dense attention calls ``run()`` makes (through
    ``kernels.dense_attention.dense_softmax``): (scores shape, mask, causal,
    scale, p, key with its base on the card) each."""
    from paddle_tpu_torch.framework.random import RandomKey
    from paddle_tpu_torch.kernels import dense_attention as DA
    from paddle_tpu_torch.kernels import dropout as D
    calls = []
    real = DA.dense_softmax

    def record(scores, mask=None, causal=False, scale=1.0, p=0.0, key=None):
        k = None if key is None else RandomKey(
            D.key_tensor(key[0], scores.device).clone(), key[1])
        calls.append((tuple(scores.shape), None if mask is None
                      else mask.detach(), causal, scale, p, k))
        return real(scores, mask, causal, scale, p, k)
    with mock.patch.object(DA, "dense_softmax", record), torch.no_grad():
        run()
    return calls


def _dense_middle_ms(torch, calls):
    """Device ms of a step's dense attention middles, forward and backward
    (the recorded calls on seeded scores and gradients, one CUDA graph
    replayed): through X2's kernels, and through the separate ops'
    composition (the plain version: scale, masks, torch.softmax, the
    dropout kernel), in the same call. Returns (X2 ms, composition
    ms)."""
    from paddle_tpu_torch.kernels import dense_attention as DA
    g = torch.Generator(device="cuda").manual_seed(5)
    n = max(math.prod(c[0]) for c in calls)
    s_buf = torch.randn(n, device="cuda", generator=g)
    g_buf = torch.randn(n, device="cuda", generator=g)
    views = [(s_buf[:math.prod(c[0])].view(c[0]).requires_grad_(),
              g_buf[:math.prod(c[0])].view(c[0])) for c in calls]

    def run(kernels):
        for (s, gy), (_, mask, causal, scale, p, key) in zip(views, calls):
            if kernels:
                y = DA.DenseSoftmaxFunction.apply(s, mask, causal, scale, p,
                                                  key)
            else:
                y = DA.dense_softmax_plain(s, mask, causal, scale, p, key)[1]
            torch.autograd.grad(y, s, gy)
    ms = {k: _graph_ms(lambda k=k: run(k), iters=1, reps=3)
          for k in (True, False)}
    del views, s_buf, g_buf
    torch.cuda.empty_cache()
    return ms[True], ms[False]


def _dense_middle_line(torch, tag, run, card):
    calls = _dense_calls(torch, run)
    x2, ops = _dense_middle_ms(torch, calls)
    print(f"  {tag}: the dense attention's middle a step ({len(calls)} calls"
          f", forward and backward): X2 {x2:.3f} ms, the ops' composition "
          f"(the plain version: scale, masks, torch.softmax, the dropout "
          f"kernel) {ops:.3f} ms, in this call [{card}]", flush=True)
    return dict(calls=len(calls), x2_ms=x2, composition_ms=ops)


# -- phase 17: Transformer-base ------------------------------------------------

TB_VOCAB = 37000      # the shared WMT14 En-De BPE vocabulary
TB_BATCH = 64         # sentence pairs: ~4,096 tokens a side
TB_LEN = 64           # lengths drawn in [16, 64], padded to 64
TB_LAYERS = 6


def _transformer_model(torch, seed, device="cuda", dropout=0.1, d=512,
                       heads=8, layers=TB_LAYERS, ff=2048, vocab=TB_VOCAB,
                       max_len=TB_LEN):
    """Transformer-base as a user builds it on ``nn.Transformer``'s
    defaults (Vaswani et al., 2017, Table 3 "base"): one embedding table
    for source and target (id 0 the padding; N(0, d^-1/2)), scaled by
    sqrt(d), sinusoidal positions, dropout on the sums, the output
    projection tied to the table."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F

    class TransformerBase(nn.Layer):
        def __init__(self):
            super().__init__()
            gen = torch.Generator(device=device).manual_seed(seed)
            self.embedding = nn.Embedding(vocab, d, padding_idx=0,
                                          device=device, generator=gen)
            with torch.no_grad():
                self.embedding.weight.mul_(d ** -0.5)
            torch.manual_seed(seed)
            self.transformer = nn.Transformer(
                d, heads, layers, layers, ff, dropout=dropout, device=device)
            pos = torch.arange(max_len, dtype=torch.float32)[:, None]
            inv = torch.exp(torch.arange(0, d, 2, dtype=torch.float32)
                            * (-math.log(10000.0) / d))
            pe = torch.zeros(max_len, d)
            pe[:, 0::2] = torch.sin(pos * inv)
            pe[:, 1::2] = torch.cos(pos * inv)
            self.register_buffer("pos", pe.to(device), persistable=False)
            self.dropout = nn.Dropout(dropout)

        def embed(self, ids):
            x = self.embedding(ids) * d ** 0.5 + self.pos[:ids.shape[1]]
            return self.dropout(x)

        def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                    memory_mask=None):
            h = self.transformer(self.embed(src), self.embed(tgt), src_mask,
                                 tgt_mask, memory_mask)
            return F.linear(h, self.embedding.weight.t())
    return TransformerBase()


def _transformer_batch(torch, seed, b=TB_BATCH, s=TB_LEN, vocab=TB_VOCAB,
                       lo=16, pad=True):
    """(src, tgt_in, labels, src_mask, tgt_mask) on the card: lengths in
    [lo, s] from ``seed`` (all s without ``pad``), ids in [1, vocab), 0
    past the length; labels the next target token (-100 past the end);
    the key-padding mask additive [b, 1, 1, s] (0 or -1e9), the decoder's
    ``generate_square_subsequent_mask(s)`` plus its padding [b, 1, s, s]."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ls = rng.integers(lo, s + 1, b) if pad else np.full(b, s)
    lt = rng.integers(lo, s + 1, b) if pad else np.full(b, s)
    pos = np.arange(s)[None, :]
    src = np.where(pos < ls[:, None], rng.integers(1, vocab, (b, s)), 0)
    y = np.where(np.arange(s + 1)[None, :] <= lt[:, None],
                 rng.integers(1, vocab, (b, s + 1)), 0)
    tgt_in = np.where(pos < lt[:, None], y[:, :s], 0)
    labels = np.where(pos < lt[:, None], y[:, 1:], -100)
    src_pad = np.where(pos < ls[:, None], 0.0, -1e9).astype(np.float32)
    tgt_pad = np.where(pos < lt[:, None], 0.0, -1e9).astype(np.float32)
    sub = np.triu(np.full((s, s), -1e9, np.float32), 1)
    src_mask = src_pad[:, None, None, :]
    tgt_mask = sub[None, None] + tgt_pad[:, None, None, :]
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda()
                 for a in (src, tgt_in, labels, src_mask, tgt_mask))


def _transformer_loss_o1(m, src, tgt, labels, src_mask, tgt_mask):
    """Label-smoothed (0.1) cross entropy of the tied logits under
    auto_cast O1 (the products in bf16), padding ignored."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import functional as F
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        logits = m(src, tgt, src_mask, tgt_mask, src_mask)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1), label_smoothing=0.1)


def _transformer_loss_f32(m, src, tgt, labels, src_mask, tgt_mask):
    from paddle_tpu_torch.nn import functional as F
    logits = m(src, tgt, src_mask, tgt_mask, src_mask)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1), label_smoothing=0.1)


def _transformer_opt(model, warmup=4000, d=512):
    """Adam(0.9, 0.98, 1e-9) on NoamDecay(d_model, warmup), the paper's."""
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.optimizer.lr import NoamDecay
    return Adam(learning_rate=NoamDecay(d_model=d, warmup_steps=warmup),
                beta1=0.9, beta2=0.98, epsilon=1e-9,
                parameters=model.parameters())


def _transformer_per_step(layers=TB_LAYERS):
    """Launches a training step at dropout 0.1: the dense middle (X2) for
    every attention (encoder self, decoder self and cross: 3 a pair of
    layers) each way, every forward's on the CUDA kernel (64 keys);
    dropout on the two embeddings, 3 an encoder layer and 4 a decoder
    layer, each way; LayerNorm 2 an encoder layer and 3 a decoder layer,
    each way; AdamW once. Nothing routed to flash or the
    plain path."""
    from paddle_tpu_torch import kernels as K
    per = {n: 0 for n in K.LAUNCHES}
    n_attn = 3 * layers
    drops = 2 + 7 * layers
    per.update(dense_softmax=n_attn, dense_softmax_bwd=n_attn,
               dense_softmax_cuda=n_attn,
               sdpa_dense=n_attn, dropout=2 * drops,
               dropout_add_ln=5 * layers, dropout_add_ln_bwd=5 * layers,
               dropout_add_ln_bwd_warp=5 * layers, adamw=1)
    return per


def _transformer_flops(torch, model, batch):
    """The products of one forward: every Linear (2 x out x in an output
    row), both products of each attention (4 x b x sq x sk x d), and the
    tied output projection (2 x tokens x d x vocab), counted by hooks."""
    from paddle_tpu_torch import nn
    count = [0]

    def linear(m, inp, out):
        count[0] += 2 * out.numel() * m.weight.shape[0]

    def attention(m, inp, out):
        q = inp[0]
        k = inp[1] if len(inp) > 1 and inp[1] is not None else q
        count[0] += 4 * q.shape[0] * q.shape[1] * k.shape[1] * m.embed_dim
    hooks = []
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            hooks.append(mod.register_forward_hook(linear))
        elif isinstance(mod, nn.MultiHeadAttention):
            hooks.append(mod.register_forward_hook(attention))
    try:
        with torch.no_grad():
            _transformer_loss_o1(model, *batch)
    finally:
        for h in hooks:
            h.remove()
    b, s = batch[1].shape
    return count[0] + 2 * b * s * model.embedding.weight.numel()


def _transformer_eval_routes(torch, seed, card):
    """One eval forward (under O1) of Transformer-base built with
    ``dropout=0.0`` on a batch without padding: the encoder's self-attention
    and the cross-attention take the flash kernel (no mask, no dropout: 12
    forwards), the decoder's masked self-attention X2 (6, on the CUDA
    forward: 64 keys), as the JAX package routes them."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import kernels as K
    model = _transformer_model(torch, seed, dropout=0.0)
    model.eval()
    src, tgt, _, _, tgt_mask = _transformer_batch(torch, seed, pad=False)
    sub = tgt_mask[:1, :1]
    want = {"flash_fwd": 2 * TB_LAYERS, "dense_softmax": TB_LAYERS,
            "dense_softmax_cuda": TB_LAYERS,
            "sdpa_dense": TB_LAYERS, "dropout_add_ln": 5 * TB_LAYERS}
    want = {k: v for k, v in want.items() if v}
    with torch.no_grad(), amp.auto_cast(level="O1", dtype="bfloat16"):
        K.reset_launches()
        logits = model(src, tgt, None, sub, None)
        torch.cuda.synchronize()
        used = {k: v for k, v in K.LAUNCHES.items() if v}
        ms = _time_ms(lambda: model(src, tgt, None, sub, None), 5)
    ok = used == want and bool(torch.isfinite(logits).all())
    print(f"  phase 17 (c) eval forward at dropout 0, no padding, O1: "
          f"launches {used} (expected {want}), {ms:.3f} ms a forward "
          f"{'ok' if ok else 'FAIL'} [{card}]", flush=True)
    if not ok:
        raise AssertionError(f"phase 17 (c): the eval forward routed "
                             f"{used}, not {want}")
    del model
    _free(torch)
    return dict(launches=used, ms=ms)


def _transformer_tiny_on_card(torch):
    """(d): a tiny float32 Transformer (d 128, 2 heads of 64, 2 + 2 layers,
    FFN 256, vocab 500, dropout 0.1) on [4, 16] pairs with padding,
    Momentum at 1e-3 (so every element within 3e-3, as the other tiny
    models' 3 lr), against the CPU trainer from the same seed. Not Adam:
    it turns the rounding noise of gradients that are 0 or nearly (the
    keys' biases, to which softmax is blind, and ~0.1% of the rest here)
    into whole steps of the rate, which no two summation orders share."""
    from paddle_tpu_torch.optimizer import Momentum
    batch = tuple(t.cpu() for t in _transformer_batch(
        torch, 71, b=4, s=16, vocab=500, lo=6))
    return _tiny_on_card(
        torch, "phase 17 (d)",
        lambda dv: _transformer_model(torch, 71, dv, 0.1, d=128, heads=2,
                                      layers=2, ff=256, vocab=500,
                                      max_len=16),
        lambda m: Momentum(learning_rate=1e-3, momentum=0.9,
                           parameters=m.parameters()),
        _transformer_loss_f32, batch, 1e-3, seed=72)


def phase_transformer_base(torch, args, launches_out):
    """Transformer-base (Vaswani et al., 2017, Table 3 "base") at full
    width on ``nn.Transformer``'s defaults: d_model 512, 8 heads, 6 + 6
    layers, FFN 2048, ReLU, post-norm, dropout 0.1, a shared 37,000-token
    vocabulary tied to the output; label-smoothed (0.1) cross entropy,
    Adam(0.9, 0.98, 1e-9) on NoamDecay(512, 4000), bf16 under amp O1 with
    float32 weights; 64 sentence pairs of 16-64 tokens a side padded to 64
    (one GPU's share of the paper's 25,000-token batch over 8). (a) the
    step captured: 2 warm-up and 3 timed steps with exact launch counts
    (X2 18 + 18, no flash, nothing on the plain path), step ms, tokens/s,
    MFU, peak memory, a profile by kernel group, the dense middles' ms
    through X2 and through the ops' composition; (b) 3 replayed steps
    against 3 eager ones from one snapshot, bit-equal; (c) the eval
    forward's routes at dropout 0; (d) a tiny float32 Transformer on the
    card against the CPU trainer."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.parallel import SpmdTrainer
    card = _card_line()
    print(f"phase 17: Transformer-base (d 512, 8 heads, 6 + 6 layers, FFN "
          f"2048, dropout 0.1, vocab {TB_VOCAB} shared and tied), batch "
          f"{TB_BATCH} pairs padded to {TB_LEN}, bf16 under O1, Adam on "
          f"NoamDecay, seed {args.seed} [{card}]", flush=True)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ptt.seed(args.seed + 170)
    model = _transformer_model(torch, args.seed + 170)
    opt = _transformer_opt(model)
    trainer = SpmdTrainer(model, opt, _transformer_loss_o1)
    batch = _transformer_batch(torch, args.seed + 171)
    tokens = int((batch[0] != 0).sum() + (batch[1] != 0).sum())
    flops = 3 * _transformer_flops(torch, model, batch)
    losses, step_ms, launches = _timed_steps(torch, trainer, batch,
                                             n_warm=2, n=3)
    per = _transformer_per_step()
    expect = {k: 3 * v for k, v in per.items()}
    print(f"  phase 17 (a): launches over 3 steps {launches} (expected "
          f"{expect}; every attention on X2, none on the plain path)",
          flush=True)
    if launches != expect or launches["sdpa_plain"]:
        raise AssertionError(f"phase 17 (a): launch counts {launches} != "
                             f"{expect}")
    for k, v in launches.items():
        launches_out[k] = launches_out.get(k, 0) + v
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"phase 17 (a): losses not finite: {losses}")
    graph = _graph_line(trainer, "phase 17 (a)", card)
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof, m = _profile(torch, lambda: trainer.train_step(*batch), 1)
    _save_trace(prof, os.path.join(args.out,
                                          "transformer_step_trace.json"))
    del prof
    out = dict(step_ms=step_ms, tokens_per_s=tokens / (step_ms / 1e3),
               tokens_a_step=tokens, flops_per_step=flops,
               mfu_vs_989_tflops=flops / (step_ms / 1e3) / BF16_FLOPS,
               peak_memory_gb=peak, peak_memory_of_phase_gb=peak - held / 1e9,
               losses=losses, graph=graph, breakdown=m,
               idle_share_untraced=1 - m["device_ms"] / step_ms,
               launches_a_step=per, card=card)
    print(f"  phase 17 (a): step {step_ms:.3f} ms, {out['tokens_per_s']:.0f} "
          f"tokens/s ({tokens} source and target tokens a step, padding "
          f"excluded), MFU {out['mfu_vs_989_tflops']:.4f} ({flops / 1e12:.3f}"
          f" TFLOP a step), peak {peak:.2f} GB; {_breakdown_line(m)}; idle "
          f"share against the untraced step {out['idle_share_untraced']:.4f}"
          f"; losses {losses} [{card}]", flush=True)
    _print_other(m, "phase 17 (a)")
    out["dense_middle"] = _dense_middle_line(
        torch, "phase 17 (a)", lambda: _transformer_loss_o1(model, *batch),
        card)
    out["eager"] = _captured_against_eager(torch, trainer, batch,
                                           "phase 17 (b)", card, step_ms, m)
    _drop_trainer(torch, trainer)
    del trainer, model, opt, batch
    _free(torch)
    out["eval_routes"] = _transformer_eval_routes(torch, args.seed + 172,
                                                  card)
    out["tiny_f32_vs_cpu"] = _transformer_tiny_on_card(torch)
    return out


# -- phase 3: the recurrence kernels -------------------------------------------

RNN_FWD_TOL = 1e-5    # of the largest |plain value|: fp32 sums reordered
RNN_BWD_TOL = 1e-4    # the gradients: sums over T steps and B rows besides
# (tag, mode, T, B, in, H, reverse, timed): the shapes of the IWSLT'15
# model (a layer and direction, the decoder's first cell at in 1024, a
# beam step over 128 x 10 rows) timed; the rest cover every mode and
# direction at shapes that are no multiple of the kernels' tiles
RNN_CASES = (
    ("lstm layer", "lstm", 50, 128, 512, 512, False, True),
    ("gru layer", "gru", 50, 128, 512, 512, False, True),
    ("rnn_tanh layer", "rnn_tanh", 50, 128, 512, 512, False, True),
    ("lstm decoder cell", "lstm", 1, 128, 1024, 512, False, True),
    ("lstm beam step", "lstm", 1, 1280, 1024, 512, False, True),
    ("lstm reverse", "lstm", 9, 37, 24, 40, True, False),
    ("gru reverse", "gru", 9, 37, 24, 40, True, False),
    ("rnn_tanh reverse", "rnn_tanh", 9, 37, 24, 40, True, False),
    ("rnn_relu", "rnn_relu", 9, 37, 24, 40, False, False),
    ("rnn_relu reverse", "rnn_relu", 9, 37, 24, 40, True, False),
    ("gru cell without b_hc", "gru", 1, 5, 24, 40, False, False),
)
RNN_MAIN = "lstm layer"       # the kernels line's case (persistent)
RNN_STEP_MAIN = "lstm beam step"   # the forward's step kernel's row
RNN_STEP_BWD_MAIN = "lstm beam step"   # the backward's step route's rows
RNN_LIBRARY = {"lstm": "LSTM", "gru": "GRU", "rnn_tanh": "RNN",
               "rnn_relu": "RNN"}


def _rnn_inputs(torch, mode, T, B, n_in, H, seed):
    """x [T, B, in], the weights and biases (uniform in ±1/sqrt(H), the
    layers' init), the given initial states h0 and c0 (N(0, 0.25)), fp32
    on the card from ``seed``."""
    from paddle_tpu_torch.kernels import rnn as R
    g = torch.Generator(device="cuda").manual_seed(seed)
    G = R.GATES[mode]

    def u(*shape):
        return (torch.rand(*shape, device="cuda", generator=g) * 2 - 1) \
            * H ** -0.5
    x = torch.randn(T, B, n_in, device="cuda", generator=g)
    w_ih, w_hh, b_ih, b_hh = u(G * H, n_in), u(G * H, H), u(G * H), u(G * H)
    h0 = torch.randn(B, H, device="cuda", generator=g) * 0.5
    c0 = torch.randn(B, H, device="cuda", generator=g) * 0.5 \
        if mode == "lstm" else None
    return x, w_ih, w_hh, b_ih, b_hh, h0, c0


def _rnn_terms(torch, mode, x, w_ih, b_ih, b_hh, has_b_hc=True):
    """A layer's input term of all steps, ``torch.addmm`` over T x B rows
    as ``nn.LSTM`` / ``GRU`` / ``SimpleRNN`` make it, and the gru
    candidate's hidden bias (None without ``has_b_hc``)."""
    from paddle_tpu_torch.nn.layer.rnn import _fold
    T, B, _ = x.shape
    fold, b_hc = _fold(mode, b_ih, b_hh)
    xw = torch.addmm(fold, x.reshape(T * B, -1), w_ih.t()).view(T, B, -1)
    return xw, (b_hc if has_b_hc else None)


def _rnn_bytes_flops(mode, T, B, H, backward):
    """(bytes, flops) of the steps: the recurrent products (2 B G H H a
    step each way) and, each read once or written once, the input terms,
    W_hh, the states, what the forward saves for the backward (lstm and
    gru 4 H a row, the lstm's c_t) and the outputs."""
    from paddle_tpu_torch.kernels import rnn as R
    G = R.GATES[mode]
    saved = (4 * H if G > 1 else 0) + (H if mode == "lstm" else 0)
    states = (2 if mode == "lstm" else 1) * B * H
    if backward:   # dy, saved, y read; dxw (and the gru's dhc) written
        per_row = H + saved + H + G * H + (H if mode == "gru" else 0)
    else:          # xw read; y and saved written
        per_row = G * H + H + saved
    return 4 * (T * B * per_row + G * H * H + 2 * states), \
        2 * T * B * G * H * H


def _rnn_cudnn(torch, mode, n_in, H, w_ih, w_hh, b_ih, b_hh):
    """cuDNN's layer (``torch.nn.LSTM`` / ``GRU`` / ``RNN``: the library
    yardstick, never on the port's path) on the same weights."""
    kw = dict(nonlinearity=mode[4:]) if mode.startswith("rnn") else {}
    lib = getattr(torch.nn, RNN_LIBRARY[mode])(n_in, H, **kw).cuda()
    with torch.no_grad():
        for name, w in (("weight_ih_l0", w_ih), ("weight_hh_l0", w_hh),
                        ("bias_ih_l0", b_ih), ("bias_hh_l0", b_hh)):
            getattr(lib, name).copy_(w)
    return lib


def _rnn_check(torch, tag, mode, T, B, n_in, H, reverse, seed):
    """The kernels against the plain loop on the same inputs (torch's
    autograd through ``rnn_scan_plain`` on the card): y, h_T, c_T within
    RNN_FWD_TOL of the largest plain value; the gradients of x, W_ih,
    W_hh, b_ih, b_hh, h0, c0 within RNN_BWD_TOL of their largest; the
    forward's launches as its plan says (one on the persistent kernel, one
    a step on the step kernel), one a step backward; two runs bit-equal.
    Returns (inputs, the upstream gradients, {name: max abs err}, the
    outputs' count, the forward's plan)."""
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels import rnn as R
    has_b_hc = not tag.endswith("without b_hc")
    inputs = _rnn_inputs(torch, mode, T, B, n_in, H, seed)
    names = [n for n, t in zip(("x", "w_ih", "w_hh", "b_ih", "b_hh", "h0",
                                "c0"), inputs) if t is not None]
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    ups = [torch.randn(T, B, H, device="cuda", generator=g)] + [
        torch.randn(B, H, device="cuda", generator=g)
        for _ in range(2 if mode == "lstm" else 1)]

    def run(plain):
        ins = {n: t.detach().requires_grad_() for n, t in
               zip(names, [t for t in inputs if t is not None])}
        xw, b_hc = _rnn_terms(torch, mode, ins["x"], ins["w_ih"],
                              ins["b_ih"], ins["b_hh"], has_b_hc)
        scan = R.rnn_scan_plain if plain else R.rnn_scan
        outs = [o for o in scan(mode, xw, ins["h0"], ins.get("c0"),
                                ins["w_hh"], b_hc, reverse=reverse)
                if o is not None]
        loss = sum((o * u).sum() for o, u in zip(outs, ups))
        grads = torch.autograd.grad(loss, list(ins.values()))
        return [t.detach() for t in outs + list(grads)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = R.rnn_forward_plan(mode, T, B, H, sms)
    bplan = R.rnn_backward_plan(mode, T, B, H, sms)
    keys = ("rnn_fwd", "rnn_fwd_step", "rnn_bwd", "rnn_bwd_gates",
            "rnn_bwd_step")
    before = [K.LAUNCHES[k] for k in keys]
    got = run(False)
    torch.cuda.synchronize()
    used = tuple(K.LAUNCHES[k] - b for k, b in zip(keys, before))
    want = (plan.launches, T if plan.route == "step" else 0) + (
        (1, 0, 0) if bplan.route == "persistent" else (0, T, T))
    if used != want:
        raise AssertionError(f"rnn {tag}: launches {used} (forward, on the "
                             f"step kernel; backward persistent, gates, "
                             f"product) against {plan} and {bplan}")
    same = all(torch.equal(a, b) for a, b in zip(got, run(False)))
    replayed = _rnn_replay(torch, mode, inputs, ups, has_b_hc, reverse)
    want = run(True)
    n_out = len(ups)
    keys = ["y", "h_T", "c_T"][:n_out] + [f"d{n}" for n in names]
    errs, worst = {}, 0.0
    for i, (key, a, b) in enumerate(zip(keys, got, want)):
        errs[key] = float((a - b).abs().max())
        tol = RNN_FWD_TOL if i < n_out else RNN_BWD_TOL
        worst = max(worst, errs[key] / (tol * max(1.0, float(b.abs().max()))))
    ok = worst <= 1.0 and same and replayed
    print(f"  rnn {tag} [T {T}, B {B}, in {n_in}, H {H}]"
          f"{' reverse' if reverse else ''}: forward on the {plan.route} "
          f"kernel ({plan.rows} rows a block, {plan.launches} launch(es), "
          f"{plan.smem} bytes of shared memory); backward on the "
          f"{bplan.route} route ({bplan.rows} rows a block, "
          f"{bplan.launches} launch(es), {bplan.smem} bytes of shared "
          f"memory); max abs err "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f"; the worst {worst:.3g} of its tolerance (outputs "
          f"{RNN_FWD_TOL:g}, gradients {RNN_BWD_TOL:g} of the largest plain "
          f"value); two runs bit-equal {same}; graph replays bit-equal "
          f"{replayed} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"rnn {tag}: the kernels disagree with the "
                             f"plain loop or with themselves")
    return inputs, ups, errs, n_out, plan, bplan


def _rnn_case(torch, results, tag, mode, T, B, n_in, H, reverse, timed,
              seed):
    """``_rnn_check``; then, ``timed``, the kernels' ms by graph replay
    (the T steps alone, and the whole layer: its input product, or its
    weight, bias and input gradients' products) beside the bound, the
    plain loop's ms (events; its backward autograd through the loop less
    its forward) and cuDNN's layer on the same weights (by graph replay:
    the forward, and the forward and backward less the training forward),
    into ``results["rnn_fwd[tag]"]`` / ``["rnn_bwd[tag]"]``."""
    from paddle_tpu_torch.kernels import rnn as R
    inputs, ups, errs, n_out, plan, bplan = _rnn_check(
        torch, tag, mode, T, B, n_in, H, reverse, seed)
    if not timed:
        return
    card = _card_line()
    x, w_ih, w_hh, b_ih, b_hh, h0, c0 = inputs
    xw, b_hc = _rnn_terms(torch, mode, x, w_ih, b_ih, b_hh)
    gy, gh, gc_ = (ups + [None])[:3]
    y, _, _, saved, cs = R.rnn_forward(mode, xw, h0, c0, w_hh, b_hc, reverse)
    flat_x = x.reshape(T * B, -1)

    def fwd():
        R.rnn_forward(mode, xw, h0, c0, w_hh, b_hc, reverse)

    def fwd_layer():
        xw_, _ = _rnn_terms(torch, mode, x, w_ih, b_ih, b_hh)
        R.rnn_forward(mode, xw_, h0, c0, w_hh, b_hc, reverse)

    def bwd():
        return R.rnn_backward(mode, gy, gh, gc_, saved, cs, h0, c0, y, w_hh,
                              reverse)

    def bwd_layer():
        dxw, dhc, _, _ = bwd()
        R.weight_grads(dxw, dhc, h0, y, reverse, b_hc is not None)
        d = dxw.reshape(T * B, -1)
        return d.t() @ flat_x, d @ w_ih, d.sum(0)
    iters = 3 if T > 1 else 20
    ms = {k: _graph_ms(f, iters=iters, reps=3) for k, f in (
        ("fwd", fwd), ("fwd_layer", fwd_layer), ("bwd", bwd),
        ("bwd_layer", bwd_layer))}
    with torch.no_grad():
        plain_f = _time_ms(lambda: R.rnn_scan_plain(mode, xw, h0, c0, w_hh,
                                                    b_hc, reverse), 2)
    # the plain backward: autograd through the loop, less its forward
    pl = [None if t is None else t.detach().requires_grad_()
          for t in (xw, h0, c0, w_hh, b_hc)]
    pl_ups = [u for u in (gy, gh, gc_) if u is not None]

    def plain_both():
        outs = [o for o in R.rnn_scan_plain(mode, *pl, reverse=reverse)
                if o is not None]
        torch.autograd.grad(outs, [t for t in pl if t is not None], pl_ups)
    plain_b = max(_time_ms(plain_both, 2) - plain_f, 0.0)
    del pl
    lib = _rnn_cudnn(torch, mode, n_in, H, w_ih, w_hh, b_ih, b_hh)
    state = (h0[None], c0[None]) if c0 is not None else h0[None]
    with torch.no_grad():
        lib_diff = float((lib(x, state)[0] - y).abs().max())
        lib_f = _graph_ms(lambda: lib(x, state), iters=iters, reps=3)
    xl = x.detach().requires_grad_()
    params = [xl] + list(lib.parameters())
    # cuDNN's backward: its training forward and backward captured
    # together, less its training forward captured alone
    lib_ft = _graph_ms(lambda: lib(xl, state), iters=iters, reps=3)
    lib_fb = _graph_ms(lambda: torch.autograd.grad(
        lib(xl, state)[0], params, gy), iters=iters, reps=3)
    lib_b = lib_fb - lib_ft
    del lib, params, xl
    for key, plain, library in (("fwd", plain_f, lib_f),
                                ("bwd", plain_b, lib_b)):
        nbytes, flops = _rnn_bytes_flops(mode, T, B, H, key == "bwd")
        bound_ms, bound_by = _bound(nbytes, flops, FP32_FLOPS)
        err = max(v for i, v in enumerate(errs.values())
                  if (i < n_out) == (key == "fwd"))
        results[f"rnn_{key}[{tag}]"] = dict(
            max_abs_err=err, ms=ms[key], plain_ms=plain, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=library,
            layer_ms=ms[f"{key}_layer"], steps=T, us_a_step=ms[key] / T * 1e3,
            share_of_bound=bound_ms / ms[key], mode=mode,
            shape=dict(T=T, B=B, n_in=n_in, H=H),
            cudnn_forward_max_abs_diff=lib_diff,
            route=(plan if key == "fwd" else bplan).route)
        if key == "bwd":
            results[f"rnn_bwd[{tag}]"].update(
                library_fwd_bwd_ms=lib_fb, library_train_fwd_ms=lib_ft)
        print(f"  rnn {tag} {key} ({(plan if key == 'fwd' else bplan).route}"
              f"): {T} step(s) {ms[key]:.4f} ms "
              f"({ms[key] / T * 1e3:.2f} us a step; {bound_ms / ms[key]:.3f} "
              f"of the bound {bound_ms:.4f} ms, {bound_by}); the whole layer "
              f"{ms[f'{key}_layer']:.4f} ms; plain {plain:.3f} ms; cuDNN's "
              f"{RNN_LIBRARY[mode]}, the whole layer "
              f"{'(graph replay)' if key == 'fwd' else '(graph replay, fwd+bwd less its training fwd)'}"
              f" {library:.4f} ms [{card}]", flush=True)
    print(f"  rnn {tag}: cuDNN's training forward {lib_ft:.4f} ms, forward "
          f"and backward {lib_fb:.4f} ms (graph replay)", flush=True)
    if bplan.route == "step":
        _rnn_step_kernels(torch, results, tag, mode, T, B, H, w_hh, bwd,
                          plain_b, errs, n_out, card)
    print(f"  rnn {tag}: cuDNN's output against the kernel's, max abs diff "
          f"{lib_diff:.3g}", flush=True)


# floats a (row, unit) pair of the backward's gates kernel reads and
# writes: dy, the recurrent dh; lstm dc, i f g o, c_t, c_{t-1} read, dxw's
# 4 and dc written; gru r z n hc, h_{t-1} read, dxw's 3 and dhc written;
# the simple RNN h_t read, dxw written
RNN_GATES_FLOATS = {"lstm": 14, "gru": 11, "rnn_tanh": 4, "rnn_relu": 4}


def _rnn_step_kernels(torch, results, tag, mode, T, B, H, w_hh, bwd, plain_b,
                      errs, n_out, card):
    """The backward's step route kernel by kernel: each one's device ms a
    launch from a profiler trace of ``bwd`` (the gate gradients, then the
    product), beside its own bound (the gates: bytes, ``RNN_GATES_FLOATS``
    a pair; the product: 2 B G H H operations), the plain backward a step
    (for both: the plain loop has no such split) and, for the product,
    one ``torch.mm`` of the same operands (graph replay), into
    ``results["rnn_bwd_gates[tag]"]`` / ``["rnn_bwd_step[tag]"]``."""
    from paddle_tpu_torch.kernels import rnn as R
    G = R.GATES[mode]
    _, m = _profile(torch, bwd, 10, {
        ("rnn_bwd_gates",): lambda n: "rnn_bwd_gates_kernel" in n,
        ("rnn_bwd_step",): lambda n: "rnn_bwd_step_kernel" in n})
    dxw = bwd()[0]
    lib = _graph_ms(lambda: torch.mm(dxw[0], w_hh), iters=20, reps=3)
    err = max(v for i, v in enumerate(errs.values()) if i >= n_out)
    costs = {"gates": (4 * B * H * RNN_GATES_FLOATS[mode], 20 * B * H),
             "step": (4 * (B * (G + 1 + (3 if mode == "gru" else 0)) * H
                           + G * H * H), 2 * B * G * H * H)}
    for key, kname in (("gates", "rnn_bwd_gates_kernel"),
                       ("step", "rnn_bwd_step_kernel")):
        hits = [k for k in m["top_kernels_ms"] if kname in k]
        ms = sum(m["top_kernels_ms"][k] for k in hits) / T
        launches = sum(m["top_kernels_launches"][k] for k in hits)
        bound_ms, bound_by = _bound(*costs[key], FP32_FLOPS)
        library = lib if key == "step" else None
        results[f"rnn_bwd_{key}[{tag}]"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_b / T, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=library,
            share_of_bound=bound_ms / ms, shape=dict(T=T, B=B, H=H),
            mode=mode, route="step", traced_launches_a_call=launches)
        print(f"  rnn {tag} backward's {kname}: {ms:.4f} ms a launch "
              f"({launches:.0f} a call traced; {bound_ms / ms:.3f} of the "
              f"bound {bound_ms:.4f} ms, {bound_by}); "
              + (f"torch.mm of the same operands {library:.4f} ms"
                 if library is not None else "no one PyTorch call")
              + f" [{card}]", flush=True)


def _rnn_replay(torch, mode, inputs, ups, has_b_hc, reverse):
    """The case's forward and backward kernels (``rnn_forward``,
    ``rnn_backward`` on the upstream gradients ``ups``) eager, then
    captured in a CUDA graph and replayed twice: each replay equal to the
    eager call bit for bit."""
    from paddle_tpu_torch.kernels import rnn as R
    x, w_ih, w_hh, b_ih, b_hh, h0, c0 = inputs
    xw, b_hc = _rnn_terms(torch, mode, x, w_ih, b_ih, b_hh, has_b_hc)
    dy, dhT, dcT = (list(ups) + [None])[:3]

    def call():
        y, hT, cT, saved, cs = R.rnn_forward(mode, xw, h0, c0, w_hh, b_hc,
                                             reverse)
        return [t for t in (y, hT, cT) + R.rnn_backward(
            mode, dy, dhT, dcT, saved, cs, h0, c0, y, w_hh, reverse)
            if t is not None]
    eager = [t.clone() for t in call()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = call()
    same = True
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        same = same and all(torch.equal(a, b) for a, b in zip(eager, static))
    del graph
    return same


def phase_rnn_kernels(torch, results):
    """The recurrence kernels (``csrc/rnn_recurrence.cu``) against their
    plain loop on the card, fp32, forward and backward, every mode and
    direction, given initial states, every gradient, as ``RNN_CASES``;
    the IWSLT'15 model's shapes timed beside their bounds, the plain loop
    and cuDNN's layer; each case's forward and backward replayed from a
    CUDA graph bit-equal to the eager call."""
    print(f"phase 3: the recurrence kernels against the plain loop, fp32 "
          f"[{_card_line()}]", flush=True)
    for i, (tag, mode, T, B, n_in, H, reverse, timed) in enumerate(RNN_CASES):
        _rnn_case(torch, results, tag, mode, T, B, n_in, H, reverse, timed,
                  40 + i)
    torch.cuda.empty_cache()


# -- phase 3: the recurrent layers and the decoder on the card ------------------

RNN_LAYER_TOLS = (1e-5, 1e-4)   # outputs, gradients: of the largest CPU value
# a cell under amp O2 computes in bf16: the CPU rounds each of a step's ops,
# the card (the kernels in fp32) only the outputs; two steps differ by up to
# 2 bf16 ulps of 1 in the outputs and 0.01 of the largest in the gradients
RNN_O2_TOLS = (2.0 ** -6, 2.0 ** -5)


def _rnn_layer_cases(torch, F, nn):
    """(name, call(tensors, device), numpy inputs, indices of the inputs
    that carry gradients, tolerances) for the layers and functionals of
    ``nn/layer/rnn.py``, ``nn/decode.py`` and ``ops/special.py``, and the
    three cells under ``auto_cast(level="O2")``."""
    import numpy as np
    from paddle_tpu_torch import amp
    rng = np.random.default_rng(87)

    def f32(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    class ScaledCell(nn.Layer):
        """A GRU cell taking ``scale=`` through ``RNN``'s kwargs."""

        def __init__(self, d):
            super().__init__()
            self.gru = nn.GRUCell(6, 5, device=d)

        def forward(self, x, states, scale=1.0):
            return self.gru(x * scale, states)

    def lstm_cell(t, d):
        h, (h2, c2) = nn.LSTMCell(6, 5, device=d)(t[0], (t[1], t[2]))
        return torch.cat([h, c2], -1)

    def stacked_lstm(t, d):
        m = nn.LSTM(6, 5, num_layers=2, dropout=0.2, device=d)
        y, (h, c) = m(t[0], (t[1], t[2]))
        return torch.cat([y.reshape(-1), h.reshape(-1), c.reshape(-1)])

    def decode(t, d, log_probs=False):
        # the table and the Linear draw from a torch generator (its bits
        # differ by device): made on the CPU from one seed, then moved
        cell = nn.GRUCell(4, 6, device=d)
        g = torch.Generator().manual_seed(90)
        emb = nn.Embedding(9, 4, device="cpu", generator=g).to(d)
        out = nn.Linear(6, 9, device="cpu", generator=g).to(d)
        dec = nn.BeamSearchDecoder(cell, 1, 2, 4, embedding_fn=emb,
                                   output_fn=out)
        seqs, (_, lp, _), lens = nn.dynamic_decode(
            dec, t[0], max_step_num=7, return_length=True)
        if log_probs:
            return lp
        return torch.cat([seqs.reshape(-1), lens.reshape(-1)])

    def o2_cell(cls):
        # two steps in bf16, the second from the first's states
        def call(t, d):
            m = getattr(nn, cls)(6, 5, device=d)
            with amp.auto_cast(level="O2", dtype="bfloat16"):
                return m(t[0], m(t[0])[1])[0]
        return (f"{cls}[amp O2]", call, [x], [0], RNN_O2_TOLS)

    x, x3 = f32(4, 6), f32(4, 7, 6)
    h, c = f32(4, 5, scale=0.5), f32(4, 5, scale=0.5)
    h2, c2 = f32(4, 4, 5, scale=0.5), f32(2, 4, 5, scale=0.5)
    cases = [
        ("SimpleRNNCell[tanh]", lambda t, d: nn.SimpleRNNCell(
            6, 5, device=d)(t[0], t[1])[0], [x, h], [0, 1]),
        ("SimpleRNNCell[relu]", lambda t, d: nn.SimpleRNNCell(
            6, 5, "relu", device=d)(t[0], t[1])[0], [x, h], [0, 1]),
        ("LSTMCell", lstm_cell, [x, h, c], [0, 1, 2]),
        ("GRUCell[no bias]", lambda t, d: nn.GRUCell(
            6, 5, bias_ih_attr=False, device=d)(t[0])[0], [x], [0]),
        ("RNN[LSTMCell, reverse]", lambda t, d: nn.RNN(nn.LSTMCell(
            6, 5, device=d), is_reverse=True)(t[0])[0], [x3], [0]),
        ("RNN[kwargs]", lambda t, d: nn.RNN(ScaledCell(d))(
            t[0], scale=0.5)[0], [x3], [0]),
        ("BiRNN[GRUCell, time_major]", lambda t, d: nn.BiRNN(
            nn.GRUCell(6, 5, device=d), nn.GRUCell(6, 5, device=d),
            time_major=True)(t[0])[0], [x3], [0]),
        ("SimpleRNN[relu, 2 layers, bidirect]", lambda t, d: nn.SimpleRNN(
            6, 5, num_layers=2, direction="bidirect", activation="relu",
            device=d)(t[0], t[1])[0], [x3, h2], [0, 1]),
        ("LSTM[2 layers, dropout 0.2, states]", stacked_lstm,
         [x3, c2, c2 * 0.5], [0, 1, 2]),
        ("GRU[bidirectional, time_major]", lambda t, d: nn.GRU(
            6, 5, direction="bidirectional", time_major=True, device=d)(
            t[0])[0], [x3], [0]),
        ("sequence_mask", lambda t, d: F.sequence_mask(
            t[0], dtype="float32"), [np.array([3, 0, 7, 5])], []),
        ("sequence_mask[maxlen]", lambda t, d: F.sequence_mask(
            t[0], maxlen=9), [np.array([[3, 0], [7, 5]])], []),
        ("gather_tree", lambda t, d: F.gather_tree(t[0], t[1]),
         [rng.integers(0, 9, (5, 3, 4)), rng.integers(0, 4, (5, 3, 4))], []),
        ("dynamic_decode[beam 4]", decode, [f32(3, 6)], []),
        ("dynamic_decode[beam 4, log-probs]", lambda t, d: decode(
            t, d, True), [f32(3, 6)], []),
    ]
    return [case + (RNN_LAYER_TOLS,) for case in cases] + [
        o2_cell(cls) for cls in ("LSTMCell", "GRUCell", "SimpleRNNCell")]


def phase_rnn_layers_on_card(torch):
    """Each layer and functional of ``_rnn_layer_cases`` on CUDA tensors
    against the same call on CPU tensors (the same seed before each, so
    the layers draw the same parameters and the dropout the same bits):
    outputs within 1e-5 and input gradients within 1e-4 of the largest
    CPU value (fp32 sums in another order, over the steps; the cells under
    amp O2 ``RNN_O2_TOLS``, in bf16); the same dtypes; integer outputs
    (the decoder's tokens and lengths) equal."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F
    print(f"phase 3: the recurrent layers, sequence_mask, gather_tree and a "
          f"beam decode on the card against the CPU (outputs "
          f"{RNN_LAYER_TOLS[0]:g}, gradients {RNN_LAYER_TOLS[1]:g} of the "
          f"largest CPU value; the cells under amp O2 {RNN_O2_TOLS[0]:g}, "
          f"{RNN_O2_TOLS[1]:g})", flush=True)
    worst, worst_o2, n = 0.0, 0.0, 0
    for name, call, arrays, diff, tols in _rnn_layer_cases(torch, F, nn):
        got = []
        for dev in ("cpu", "cuda"):
            ts = [torch.from_numpy(a).to(dev).requires_grad_(i in diff)
                  for i, a in enumerate(arrays)]
            ptt.seed(88)
            out = call(ts, dev)
            grads = []
            if diff:
                ct = torch.from_numpy(np.asarray(
                    np.random.default_rng(89).standard_normal(
                        tuple(out.shape)), np.float32)).to(dev)
                grads = torch.autograd.grad((out.float() * ct).sum(),
                                            [ts[i] for i in diff])
            got.append([t.detach().cpu() for t in (out, *grads)])
        for i, (a, b) in enumerate(zip(got[1], got[0])):
            if a.dtype != b.dtype:
                err = float("inf")
            elif not a.is_floating_point() or name.startswith(
                    ("sequence_mask", "gather_tree")):
                err = 0.0 if torch.equal(a, b) else float("inf")
            else:
                err = float((a.float() - b.float()).abs().max()) / max(
                    1.0, float(b.float().abs().max())) / tols[min(i, 1)]
            if tols is RNN_O2_TOLS:
                worst_o2 = max(worst_o2, err)
            else:
                worst = max(worst, err)
            if not err <= 1.0:
                raise AssertionError(f"{name}: the card's result differs "
                                     f"from the CPU's ({err} of the "
                                     f"tolerance; dtypes {a.dtype}, "
                                     f"{b.dtype})")
        n += 1
    print(f"  {n} calls, outputs and gradients: the worst at {worst:.3g} of "
          f"its tolerance (the cells under amp O2 {worst_o2:.3g}) ok "
          f"[{_card_line()}]", flush=True)
    return dict(calls=n, worst_share=worst, worst_share_o2=worst_o2)


# -- phase 18: attention LSTM translation, IWSLT'15 English-Vietnamese --------

S2S_SRC_VOCAB = 17191   # tensorflow/nmt's iwslt15 vocab.en (PaddleNLP's)
S2S_TRG_VOCAB = 7709    # vocab.vi
S2S_D = 512             # embedding and hidden width
S2S_LAYERS = 2
S2S_DROPOUT = 0.2
S2S_BATCH = 128
S2S_LEN = 50            # lengths drawn in [10, 50], padded to 50
S2S_BEAM = 10
PAD, BOS, EOS = 0, 1, 2


def _seq2seq_model(torch, seed, device="cuda", src_vocab=S2S_SRC_VOCAB,
                   trg_vocab=S2S_TRG_VOCAB, d=S2S_D, layers=S2S_LAYERS,
                   dropout=S2S_DROPOUT, init_scale=0.1):
    """The attention-based LSTM translation model of PaddleNLP's
    ``examples/machine_translation/seq2seq`` (tensorflow/nmt's iwslt15
    setting), from the port's layers: the source embedding and
    ``nn.LSTM(d, d, num_layers=layers, dropout=dropout)``; the decoder
    ``nn.RNN`` over a cell of ``layers`` ``nn.LSTMCell``s with input
    feeding (the first takes the embedding and the previous attention
    output, 2 d), dropout after each, and Luong attention (``input_proj``
    and ``output_proj`` without bias, an additive -1e9 padding mask, a
    softmax); the output layer ``Linear(d, trg_vocab)`` without bias.
    Every parameter uniform in ±``init_scale``. Id 0 pads (the tables'
    ``padding_idx``), 1 starts and 2 ends a sentence. The cell takes the
    encoder's output and mask as ``RNN``'s kwargs, or holds them in
    ``memory`` (beam search: ``dynamic_decode`` passes no kwargs)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F

    class Attention(nn.Layer):
        def __init__(self):
            super().__init__()
            self.input_proj = nn.Linear(d, d, bias_attr=False, device=device)
            self.output_proj = nn.Linear(2 * d, d, bias_attr=False,
                                         device=device)

        def forward(self, hidden, encoder_output, padding_mask):
            mem = self.input_proj(encoder_output)
            scores = torch.matmul(hidden.unsqueeze(1), mem.transpose(1, 2))
            probs = F.softmax(scores + padding_mask, axis=-1)
            ctx = torch.matmul(probs, mem).squeeze(1)
            return self.output_proj(torch.cat([ctx, hidden], 1))

    class DecoderCell(nn.Layer):
        def __init__(self):
            super().__init__()
            self.dropout = nn.Dropout(dropout)
            self.lstm_cells = nn.LayerList([
                nn.LSTMCell(2 * d if i == 0 else d, d, device=device)
                for i in range(layers)])
            self.attention_layer = Attention()
            self.memory = None

        def forward(self, step_input, states, encoder_output=None,
                    encoder_padding_mask=None):
            if encoder_output is None:
                encoder_output, encoder_padding_mask = self.memory
            lstm_states, input_feed = states
            step_input = torch.cat([step_input, input_feed], 1)
            new_states = []
            for i, cell in enumerate(self.lstm_cells):
                out, new = cell(step_input, lstm_states[i])
                step_input = self.dropout(out)
                new_states.append(new)
            out = self.attention_layer(step_input, encoder_output,
                                       encoder_padding_mask)
            return out, [new_states, out]

    class Seq2SeqAttn(nn.Layer):
        def __init__(self):
            super().__init__()
            self.src_embedder = nn.Embedding(src_vocab, d, padding_idx=PAD,
                                             device=device)
            self.encoder = nn.LSTM(d, d, num_layers=layers, dropout=dropout,
                                   device=device)
            self.trg_embedder = nn.Embedding(trg_vocab, d, padding_idx=PAD,
                                             device=device)
            self.decoder = nn.RNN(DecoderCell())
            self.output_layer = nn.Linear(d, trg_vocab, bias_attr=False,
                                          device=device)

        def encode(self, src):
            """(the encoder's output, the decoder's initial states, the
            additive padding mask [B, 1, S])."""
            out, (h, c) = self.encoder(self.src_embedder(src))
            states = [[(h[i], c[i]) for i in range(layers)],
                      torch.zeros(src.shape[0], d, device=src.device)]
            mask = ((src != PAD).float() - 1.0) * 1e9
            return out, states, mask.unsqueeze(1)

        def forward(self, src, trg):
            enc, states, mask = self.encode(src)
            dec, _ = self.decoder(self.trg_embedder(trg), states,
                                  encoder_output=enc,
                                  encoder_padding_mask=mask)
            return self.output_layer(dec)
    ptt.seed(seed)
    model = Seq2SeqAttn()
    init = nn.initializer.Uniform(-init_scale, init_scale)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(init(tuple(p.shape), p.dtype, p.device))
    return model


def _seq2seq_batch(torch, seed, b=S2S_BATCH, s=S2S_LEN, src_vocab=S2S_SRC_VOCAB,
                   trg_vocab=S2S_TRG_VOCAB, lo=10, device="cuda"):
    """(src, trg_in, labels, trg_len) on ``device``: lengths in [lo, s]
    from ``seed``, ids in [3, vocab), PAD past the length; the decoder's
    input is BOS then the target's first len - 1 tokens, its labels the
    target's len tokens ending in EOS; trg_len int64."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ls, lt = rng.integers(lo, s + 1, b), rng.integers(lo, s + 1, b)
    pos = np.arange(s)[None, :]
    src = np.where(pos < ls[:, None], rng.integers(3, src_vocab, (b, s)), PAD)
    words = rng.integers(3, trg_vocab, (b, s))
    labels = np.where(pos < lt[:, None] - 1, words,
                      np.where(pos == lt[:, None] - 1, EOS, PAD))
    trg_in = np.where(pos < lt[:, None],
                      np.concatenate([np.full((b, 1), BOS), words[:, :-1]],
                                     1), PAD)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (src, trg_in, labels, lt))


def _seq2seq_loss(m, src, trg, labels, trg_len):
    """PaddleNLP's ``CrossEntropyCriterion``: the token cross entropy
    masked by ``sequence_mask(trg_len, maxlen)`` (maxlen given: no host
    read in the captured step), the batch mean at each position summed
    over time."""
    from paddle_tpu_torch.nn import functional as F
    logits = m(src, trg)
    cost = F.cross_entropy(logits, labels, reduction="none")
    mask = F.sequence_mask(trg_len, maxlen=trg.shape[1], dtype="float32")
    return (cost * mask).mean(0).sum()


def _seq2seq_opt(model, lr=1e-3):
    """Adam(1e-3) with ``ClipGradByGlobalNorm(5.0)``, PaddleNLP's."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import Adam
    return Adam(learning_rate=lr, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(5.0))


def _seq2seq_per_step(s=S2S_LEN, layers=S2S_LAYERS):
    """Launches a training step: the recurrence's forward one persistent
    launch an encoder layer and one step-kernel launch a decoder cell
    call; its backward one persistent launch an encoder layer and a cell
    call; dropout between the encoder's layers and after each decoder
    cell, each way; AdamW once. The attention is matmuls and a softmax:
    nothing dense."""
    from paddle_tpu_torch import kernels as K
    per = {n: 0 for n in K.LAUNCHES}
    cells = layers * s
    drops = (layers - 1) + layers * s
    per.update(rnn_fwd=layers + cells, rnn_fwd_step=cells,
               rnn_bwd=layers + cells, dropout=2 * drops, adamw=1)
    return per


def _seq2seq_flops(torch, model, batch):
    """The products of one forward, counted by hooks: every Linear (2 x
    out x in an output row), every LSTMCell call (2 B (in + H) 4 H), the
    LSTM's layers (2 T B (in + H) 4 H each), both attention products of
    each decoder step (4 B S d)."""
    from paddle_tpu_torch import nn
    count = [0]

    def linear(m, inp, out):
        count[0] += 2 * out.numel() * m.weight.shape[0]

    def cell(m, inp, out):
        count[0] += 2 * inp[0].shape[0] * (m.input_size + m.hidden_size) \
            * m.weight_ih.shape[0]

    def lstm(m, inp, out):
        T, B = inp[0].shape[1], inp[0].shape[0]
        for wi, wh, _, _ in m._weights:
            count[0] += 2 * T * B * (wi.shape[1] + wh.shape[1]) * wh.shape[0]

    def attention(m, inp, out):
        count[0] += 4 * inp[1].shape[0] * inp[1].shape[1] * inp[1].shape[2]
    hooks = []
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            hooks.append(mod.register_forward_hook(linear))
        elif isinstance(mod, nn.LSTMCell):
            hooks.append(mod.register_forward_hook(cell))
        elif isinstance(mod, nn.LSTM):
            hooks.append(mod.register_forward_hook(lstm))
        elif type(mod).__name__ == "Attention":
            hooks.append(mod.register_forward_hook(attention))
    try:
        with torch.no_grad():
            _seq2seq_loss(model, *batch)
    finally:
        for h in hooks:
            h.remove()
    return count[0]


def _seq2seq_decoder(model, beam):
    from paddle_tpu_torch import nn
    return nn.BeamSearchDecoder(model.decoder.cell, BOS, EOS, beam,
                                embedding_fn=model.trg_embedder,
                                output_fn=model.output_layer)


def _seq2seq_decode(torch, model, src, beam, max_steps):
    """Beam search as PaddleNLP's ``Seq2SeqAttnInferModel`` runs it, on the
    port's decoder: encode, tile the encoder's output and mask by
    ``tile_beam_merge_with_batch`` into the cell's ``memory``, then
    ``dynamic_decode``. Returns (sequences [B, beam, T], lengths)."""
    from paddle_tpu_torch import nn
    enc, states, mask = model.encode(src)
    tile = nn.BeamSearchDecoder.tile_beam_merge_with_batch
    model.decoder.cell.memory = (tile(enc, beam), tile(mask, beam))
    try:
        seqs, _, lens = nn.dynamic_decode(_seq2seq_decoder(model, beam),
                                          inits=states, max_step_num=max_steps,
                                          return_length=True)
    finally:
        model.decoder.cell.memory = None
    return seqs, lens


def _seq2seq_greedy(torch, model, src, steps):
    """The greedy chain by hand: each step's argmax fed back, a finished
    sentence held at EOS; [B, steps]."""
    enc, states, mask = model.encode(src)
    cell = model.decoder.cell
    tok = torch.full((src.shape[0],), BOS, dtype=torch.int64,
                     device=src.device)
    done = torch.zeros_like(tok, dtype=torch.bool)
    out = []
    for _ in range(steps):
        h, states = cell(model.trg_embedder(tok), states, enc, mask)
        nxt = model.output_layer(h).argmax(-1)
        tok = torch.where(done, torch.full_like(nxt, EOS), nxt)
        done = done | (tok == EOS)
        out.append(tok)
    return torch.stack(out, 1)


def _seq2seq_tiny(torch, seed, device, dropout=0.2):
    return _seq2seq_model(torch, seed, device, src_vocab=23, trg_vocab=19,
                          d=16, dropout=dropout)


def _seq2seq_tiny_on_card(torch):
    """(c): the model at hidden 16, vocabularies 23 / 19, dropout 0.2, on
    [4, 7] pairs, trained 3 steps on the card against the CPU trainer
    (``_tiny_on_card``; Momentum at 1e-3, as phase 17's: Adam turns the
    rounding noise of a gradient that is nearly 0 into a whole step); (d)
    its beam search at beam 1 equal to the greedy chain by hand, and at
    beam 4 on the card equal to the CPU's."""
    from paddle_tpu_torch.optimizer import Momentum
    batch = tuple(t.cpu() for t in _seq2seq_batch(
        torch, 181, b=4, s=7, src_vocab=23, trg_vocab=19, lo=3,
        device="cpu"))
    out = _tiny_on_card(
        torch, "phase 18 (c)", lambda dv: _seq2seq_tiny(torch, 182, dv),
        lambda m: Momentum(learning_rate=1e-3, momentum=0.9,
                           parameters=m.parameters()),
        _seq2seq_loss, batch, 1e-3, seed=183)
    model = _seq2seq_tiny(torch, 184, "cuda")
    model.eval()
    src = batch[0].cuda()
    with torch.no_grad():
        seqs, _ = _seq2seq_decode(torch, model, src, 1, 7)
        greedy = _seq2seq_greedy(torch, model, src, seqs.shape[-1])
        beams = [_seq2seq_decode(torch, m, src.to(m.output_layer.weight
                                                  .device), 4, 7)
                 for m in (model, _seq2seq_cpu_copy(torch, model))]
    same_greedy = bool(torch.equal(seqs[:, 0].long(), greedy))
    same_beams = all(torch.equal(a.cpu(), b.cpu())
                     for a, b in zip(beams[0], beams[1]))
    print(f"  phase 18 (d) tiny: beam 1 equal to the greedy chain by hand "
          f"{same_greedy} ({tuple(seqs.shape)}); beam 4 on the card equal "
          f"to the CPU's (sequences and lengths) {same_beams}", flush=True)
    if not (same_greedy and same_beams):
        raise AssertionError("phase 18 (d): the beam search disagrees")
    out.update(greedy_equal=same_greedy, beams_card_equal_cpu=same_beams)
    return out


def _seq2seq_cpu_copy(torch, model):
    """The tiny model again on the CPU, with ``model``'s weights."""
    from paddle_tpu_torch.models import load_numpy_state
    cpu = _seq2seq_tiny(torch, 184, "cpu")
    load_numpy_state(cpu, {k: v.cpu().numpy()
                           for k, v in model.state_dict().items()})
    cpu.eval()
    return cpu


def _seq2seq_beam_search(torch, model, src, card):
    """(e): beam search at beam 10 over the batch (eval), at most 50 steps,
    twice: as built, and with the output layer's EOS column at 0 (with
    random weights a finished beam keeps its log-probability while every
    extension loses about ln 7709 a step, so all beams end within a few
    steps; an EOS logit of 0, about the median, keeps all 50 steps). Each
    launches exactly 2 ``rnn_fwd`` a step on the step kernel (the
    decoder's two cells) besides the encoder's 2 (one persistent launch a
    layer) and nothing else of the port, sequences [128, 10, T];
    ms a beam step and for the whole decode (host clock, after a
    warm-up)."""
    from paddle_tpu_torch import kernels as K
    model.eval()
    out = {}
    w = model.output_layer.weight
    held = w[:, EOS].clone()
    with torch.no_grad():
        _seq2seq_decode(torch, model, src, S2S_BEAM, 3)
        for tag in ("as built", "EOS logit 0"):
            if tag != "as built":
                w[:, EOS] = 0.0
            torch.cuda.synchronize()
            K.reset_launches()
            t0 = time.monotonic()
            model.encode(src)
            torch.cuda.synchronize()
            enc_ms = 1e3 * (time.monotonic() - t0)
            enc_fwd = K.LAUNCHES["rnn_fwd"]
            K.reset_launches()
            t0 = time.monotonic()
            seqs, lens = _seq2seq_decode(torch, model, src, S2S_BEAM,
                                         S2S_LEN)
            torch.cuda.synchronize()
            total_ms = 1e3 * (time.monotonic() - t0)
            launches = dict(K.LAUNCHES)
            steps = seqs.shape[-1]
            want = {k: 0 for k in K.LAUNCHES}
            want.update(rnn_fwd=enc_fwd + 2 * steps, rnn_fwd_step=2 * steps)
            ok = (launches == want and enc_fwd == S2S_LAYERS
                  and tuple(seqs.shape[:2]) == (S2S_BATCH, S2S_BEAM))
            step_ms = (total_ms - enc_ms) / steps
            print(f"  phase 18 (e) beam search ({tag}), beam {S2S_BEAM}, "
                  f"batch {S2S_BATCH}: sequences {tuple(seqs.shape)}, lengths "
                  f"{int(lens.min())} to {int(lens.max())}; launches "
                  f"{({k: v for k, v in launches.items() if v})} (want "
                  f"rnn_fwd {enc_fwd} for the encoder + 2 a step over {steps}"
                  f" steps) {'ok' if ok else 'FAIL'}; the decode "
                  f"{total_ms:.1f} ms ({step_ms:.3f} ms a beam step; the "
                  f"encoder {enc_ms:.2f} ms) [{card}]", flush=True)
            if not ok:
                raise AssertionError(f"phase 18 (e): launches {launches} or "
                                     f"shape {tuple(seqs.shape)}")
            out[tag] = dict(shape=list(seqs.shape), steps=steps,
                            total_ms=total_ms, beam_step_ms=step_ms,
                            encoder_ms=enc_ms,
                            launches={k: v for k, v in launches.items()
                                      if v})
        w[:, EOS] = held
    model.train()
    return out


def phase_seq2seq(torch, args, launches_out):
    """Attention-based LSTM translation on IWSLT'15 English-Vietnamese at
    full width, as PaddleNLP's ``examples/machine_translation/seq2seq``
    builds it (``_seq2seq_model``: vocabularies 17,191 / 7,709, width 512,
    2 layers, dropout 0.2, uniform ±0.1), Adam(1e-3) with global-norm
    clipping at 5, fp32; 128 pairs of 10-50 tokens a side padded to 50,
    seeded. (a) the step captured: 2 warm-up and 3 timed steps with exact
    launch counts (rnn_fwd 102; rnn_bwd 102, the encoder's layers and the
    decoder's cells on the persistent kernel; dropout, AdamW; nothing on a
    dense attention), step ms, tokens/s, MFU, peak memory, a profile by
    kernel group; (b) 3 replayed steps against 3 eager ones, bit-equal;
    (c) a tiny float32 model on the card against the CPU trainer; (d) its
    beam 1 against the greedy chain, its beam 4 against the CPU's; (e)
    beam search at beam 10 over the batch."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.parallel import SpmdTrainer
    card = _card_line()
    print(f"phase 18: attention LSTM translation, IWSLT'15 En-Vi (vocab "
          f"{S2S_SRC_VOCAB} / {S2S_TRG_VOCAB}, width {S2S_D}, {S2S_LAYERS} "
          f"layers, dropout {S2S_DROPOUT}), batch {S2S_BATCH} pairs padded "
          f"to {S2S_LEN}, fp32, Adam with global-norm clip 5, seed "
          f"{args.seed} [{card}]", flush=True)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    model = _seq2seq_model(torch, args.seed + 180)
    trainer = SpmdTrainer(model, _seq2seq_opt(model), _seq2seq_loss)
    batch = _seq2seq_batch(torch, args.seed + 181)
    ptt.seed(args.seed + 182)
    tokens = int((batch[0] != PAD).sum() + (batch[1] != PAD).sum())
    flops = 3 * _seq2seq_flops(torch, model, batch)
    losses, step_ms, launches = _timed_steps(torch, trainer, batch,
                                             n_warm=2, n=3)
    per = _seq2seq_per_step()
    expect = {k: 3 * v for k, v in per.items()}
    print(f"  phase 18 (a): launches over 3 steps "
          f"{({k: v for k, v in launches.items() if v})} (expected rnn_fwd "
          f"{3 * per['rnn_fwd']}, rnn_bwd {3 * per['rnn_bwd']}, dropout "
          f"{3 * per['dropout']}, adamw 3; no sdpa call)", flush=True)
    if launches != expect:
        raise AssertionError(f"phase 18 (a): launch counts {launches} != "
                             f"{expect}")
    for k, v in launches.items():
        launches_out[k] = launches_out.get(k, 0) + v
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"phase 18 (a): losses not finite: {losses}")
    graph = _graph_line(trainer, "phase 18 (a)", card)
    peak = torch.cuda.max_memory_allocated() / 1e9
    checked = {("rnn_fwd",): lambda n: _kernel_group(n) == "rnn_fwd",
               ("rnn_bwd",): lambda n: "rnn_bwd_persistent_kernel" in n,
               ("adamw",): lambda n: "adamw_kernel" in n}
    prof, m = _profile(torch, lambda: trainer.train_step(*batch), 1, checked)
    _save_trace(prof, os.path.join(args.out, "seq2seq_step_trace.json"))
    del prof
    out = dict(step_ms=step_ms, tokens_per_s=tokens / (step_ms / 1e3),
               tokens_a_step=tokens, flops_per_step=flops,
               mfu_vs_989_tflops=flops / (step_ms / 1e3) / BF16_FLOPS,
               share_of_fp32_peak=flops / (step_ms / 1e3) / FP32_FLOPS,
               peak_memory_gb=peak, peak_memory_of_phase_gb=peak - held / 1e9,
               losses=losses, graph=graph, breakdown=m,
               idle_share_untraced=1 - m["device_ms"] / step_ms,
               launches_a_step={k: v for k, v in per.items() if v},
               card=card)
    print(f"  phase 18 (a): step {step_ms:.3f} ms, {out['tokens_per_s']:.0f} "
          f"tokens/s ({tokens} source and target tokens a step, padding "
          f"excluded), MFU {out['mfu_vs_989_tflops']:.4f} against the bf16 "
          f"peak ({out['share_of_fp32_peak']:.4f} of the fp32 peak; "
          f"{flops / 1e12:.3f} TFLOP a step), peak {peak:.2f} GB; "
          f"{_breakdown_line(m)}; idle share against the untraced step "
          f"{out['idle_share_untraced']:.4f}; losses {losses} [{card}]",
          flush=True)
    _print_other(m, "phase 18 (a)")
    out["eager"] = _captured_against_eager(torch, trainer, batch,
                                           "phase 18 (b)", card, step_ms, m,
                                           checked=checked)
    _drop_trainer(torch, trainer)
    out["beam_search"] = _seq2seq_beam_search(torch, model, batch[0], card)
    for run in out["beam_search"].values():
        for k, v in run["launches"].items():
            launches_out[k] = launches_out.get(k, 0) + v
    del trainer, model, batch
    _free(torch)
    out["tiny_f32_vs_cpu"] = _seq2seq_tiny_on_card(torch)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, prompts and inputs")
    ap.add_argument("--out", default="smoke_out",
                    help="directory for the JSON record and the traces")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    # fails, before any result, where the checkout is not beside this file
    from paddle_tpu_torch.kernels import _build, fused

    card = _card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    print(f"phase 1: card [{card}] python {sys.version.split()[0]} torch "
          f"{torch.__version__} cuda {torch.version.cuda} triton "
          f"{triton_version} devices {torch.cuda.device_count()}", flush=True)

    t0 = time.monotonic()
    built = _build.build_all()
    nvcc_s = time.monotonic() - t0
    for name, info in built.items():
        print(f"phase 2: built {name} in {info['seconds']:.2f}s -> "
              f"{os.path.relpath(info['path'])}", flush=True)
        for line in info["log"].splitlines():
            if any(w in line for w in ("registers", "spill", "arning",
                                       "Performance")):
                print(f"    {line.strip()}")
    t1 = time.monotonic()
    x = torch.randn(4, 4096, device="cuda", dtype=torch.bfloat16)
    w = torch.ones(4096, device="cuda", dtype=torch.bfloat16)
    fused.rms_norm(x, w)
    fused.add_rms_norm(x, x, w)
    q = torch.randn(1, 4, 32, 128, device="cuda", dtype=torch.bfloat16)
    c = torch.ones(4, 64, device="cuda")
    fused.fused_rope(q, q, c, c)
    torch.cuda.synchronize()
    _build.library("flash_attention")
    _build.library("flash_attention_bf16")
    _build.library("adamw")
    _build.library("gmm")
    _build.library("weight_only_gemm")
    _build.library("ctc_loss")
    _build.library("rnnt_loss")
    _build.library("rnn_recurrence")
    print(f"phase 2: nvcc {nvcc_s:.2f}s, triton compile "
          f"{time.monotonic() - t1:.2f}s", flush=True)
    sass = _wgmma_sass(built)
    sass.update(_gemm_sass(built))
    sass["group_norm_fwd"] = _gn_silu_sass(built)

    os.makedirs(args.out, exist_ok=True)
    results = {}
    seconds = {}

    def timed(name, fn, *a):
        t = time.monotonic()
        out = fn(*a)
        seconds[name] = time.monotonic() - t
        print(f"  [{name}: {seconds[name]:.1f}s]", flush=True)
        return out

    timed("phase 3 serving kernels", phase_kernels, torch, results)
    timed("phase 3 weight-only GEMM", phase_gemm_kernels, torch, results)
    timed("phase 3 training kernels", phase_train_kernels, torch, results)
    timed("phase 3 tiny serving", phase_tiny_reference, torch)
    timed("phase 3 tiny training", phase_tiny_training, torch)
    timed("phase 3 MoE kernels", phase_gmm_kernels, torch, results)
    timed("phase 3 tiny GPT-MoE training", phase_tiny_gpt_training, torch)
    timed("phase 3 FlashMask kernels", phase_flashmask_kernels, torch,
          results, args.seed)
    timed("phase 3 tiny packed training", phase_tiny_training, torch, True)
    routed_f5 = timed("phase 3 F5 FlashMask routing",
                      _flashmask_routed_on_card, torch)
    timed("phase 3 dropout and LayerNorm kernels", phase_dropout_kernels,
          torch, results)
    timed("phase 3 GroupNorm kernels", phase_group_norm_kernels, torch,
          results)
    timed("phase 3 BatchNorm kernels", phase_batch_norm_kernels, torch,
          results)
    timed("phase 3 CTC and RNN-T kernels", phase_seq_loss_kernels, torch,
          results)
    timed("phase 3 dense attention kernels", phase_dense_attention_kernels,
          torch, results)
    new_layers = timed("phase 3 new layers on the card",
                       phase_new_layers_on_card, torch)
    timed("phase 3 recurrence kernels", phase_rnn_kernels, torch, results)
    rnn_layers = timed("phase 3 recurrent layers on the card",
                       phase_rnn_layers_on_card, torch)
    serve_launches, train_launches, gpt_launches = {}, {}, {}
    packed_launches, beam_launches, artifact_launches = {}, {}, {}
    serving = timed("phase 4 serving", phase_serving, torch, args,
                    serve_launches, beam_launches)
    serve13_launches = {}
    serving13 = timed("phase 4b Llama-2-13B serving", phase_llama13b_serving,
                      torch, args, serve13_launches)
    training = timed("phase 5 training", phase_training, torch, args,
                     train_launches)
    gpt_moe = timed("phase 6 GPT-MoE training", phase_gpt_moe_training,
                    torch, args, gpt_launches)
    packed = timed("phase 7 packed-document training", phase_training,
                   torch, args, packed_launches, True)
    gpt_serve_launches, quant_launches, spec_launches = {}, {}, {}
    gpt_serving = timed("phase 8 GPT serving", phase_gpt_serving, torch,
                        args, gpt_serve_launches)
    quant = timed("phase 9 quantized serving", phase_quant_serving, torch,
                  args, quant_launches, serving["outputs"])
    spec = timed("phase 10 speculative decoding", phase_spec_serving, torch,
                 args, spec_launches)
    artifact = timed("phase 11 artifact", phase_artifact, torch, args,
                     artifact_launches)
    surface_launches = {}
    surface = timed("phase 12 training surface", phase_training_surface,
                    torch, args, surface_launches, training["step_ms"])
    ernie_launches = {}
    ernie = timed("phase 13 ERNIE pretraining", phase_ernie_training, torch,
                  args, ernie_launches)
    unet_launches, resnet_launches = {}, {}
    unet = timed("phase 14 UNet", phase_unet, torch, args, unet_launches)
    resnet = timed("phase 15 ResNet-50", phase_resnet, torch, args,
                   resnet_launches)
    seq_launches = {}
    seq = timed("phase 16 sequence-loss training", phase_seq_loss_training,
                torch, args, seq_launches)
    transformer_launches = {}
    transformer = timed("phase 17 Transformer-base",
                        phase_transformer_base, torch, args,
                        transformer_launches)
    seq2seq_launches = {}
    seq2seq = timed("phase 18 seq2seq", phase_seq2seq, torch, args,
                    seq2seq_launches)

    replaces = {
        "ragged_attention": ("cuda",
                             "paddle_tpu_torch/csrc/ragged_attention_bf16.cu",
                             "paddle_tpu/kernels/ragged_pallas.py:134"),
        "rms_norm": ("triton", "paddle_tpu_torch/kernels/fused.py",
                     "paddle_tpu/kernels/fused_pallas.py:156"),
        "rms_norm_residual": ("triton", "paddle_tpu_torch/kernels/fused.py",
                              "paddle_tpu/kernels/fused_pallas.py:143"),
        "rope": ("triton", "paddle_tpu_torch/kernels/fused.py",
                 "paddle_tpu/kernels/fused_pallas.py:89"),
        "flash_fwd": ("cuda", "paddle_tpu_torch/csrc/flash_attention_bf16.cu",
                      "paddle_tpu/kernels/flash_pallas.py:236"),
        "flash_bwd": ("cuda", "paddle_tpu_torch/csrc/flash_attention_bf16.cu",
                      "paddle_tpu/kernels/flash_pallas.py:439"),
        "adamw": ("cuda", "paddle_tpu_torch/csrc/adamw.cu",
                  "paddle_tpu/kernels/optimizer_pallas.py:81"),
        "gmm": ("cuda", "paddle_tpu_torch/csrc/gmm.cu",
                "paddle_tpu/kernels/gmm_pallas.py:108"),
        "tgmm": ("cuda", "paddle_tpu_torch/csrc/gmm.cu",
                 "paddle_tpu/kernels/gmm_pallas.py:156"),
        "flashmask_summary": ("cuda",
                              "paddle_tpu_torch/csrc/flash_attention.cu",
                              "paddle_tpu/kernels/flash_pallas.py:141"),
        "flashmask_fwd": ("cuda",
                          "paddle_tpu_torch/csrc/flash_attention_bf16.cu",
                          "paddle_tpu/kernels/flash_pallas.py:572"),
        "flashmask_bwd": ("cuda",
                          "paddle_tpu_torch/csrc/flash_attention_bf16.cu",
                          "paddle_tpu/kernels/flash_pallas.py:594"),
        # no Pallas kernel: the port of the convert XLA fuses into the dot
        "weight_only_gemm": ("cuda",
                             "paddle_tpu_torch/csrc/weight_only_gemm.cu",
                             "paddle_tpu/quantization/_kernels.py:99"),
        # no Pallas kernel: passes XLA fuses into the compiled training step
        # (the vjp of the RMSNorm oracle; the Llama MLP's silu * up)
        "rms_norm_bwd": ("triton", "paddle_tpu_torch/kernels/fused.py",
                         "paddle_tpu/nn/functional/norm.py:60"),
        "swiglu_fwd": ("triton", "paddle_tpu_torch/kernels/fused.py",
                       "paddle_tpu/models/llama.py:197"),
        "swiglu_bwd": ("triton", "paddle_tpu_torch/kernels/fused.py",
                       "paddle_tpu/models/llama.py:197"),
        # no Pallas kernel: the dropout and the bias, dropout, residual and
        # LayerNorm XLA fuses (forward; the vjp of the same function)
        "dropout": ("triton", "paddle_tpu_torch/kernels/dropout.py",
                    "paddle_tpu/nn/functional/common.py:40"),
        "dropout_add_ln": ("triton", "paddle_tpu_torch/kernels/fused.py",
                           "paddle_tpu/incubate/nn/functional/fused_ops.py"
                           ":636"),
        "dropout_add_ln_bwd": ("triton", "paddle_tpu_torch/kernels/fused.py",
                               "paddle_tpu/incubate/nn/functional/"
                               "fused_ops.py:636"),
        # its backward by layer_norm_backward_plan: a warp a row
        "dropout_add_ln_bwd_warp": ("cuda",
                                    "paddle_tpu_torch/csrc/layer_norm_bwd.cu",
                                    "paddle_tpu/incubate/nn/functional/"
                                    "fused_ops.py:636"),
        # no Pallas kernel: the GroupNorm (and the SiLU after it) XLA fuses
        "group_norm": ("triton", "paddle_tpu_torch/kernels/group_norm.py",
                       "paddle_tpu/nn/functional/norm.py:186"),
        "group_norm_bwd": ("triton",
                           "paddle_tpu_torch/kernels/group_norm.py",
                           "paddle_tpu/nn/functional/norm.py:186"),
        # its forward and backward by their plans: a cluster a group
        "group_norm_cluster": ("cuda",
                               "paddle_tpu_torch/csrc/group_norm_fwd.cu",
                               "paddle_tpu/nn/functional/norm.py:186"),
        "group_norm_bwd_cluster": ("cuda",
                                   "paddle_tpu_torch/csrc/group_norm_bwd.cu",
                                   "paddle_tpu/nn/functional/norm.py:186"),
        # no Pallas kernel: the BatchNorm (and the add and ReLU after it)
        # XLA fuses
        "batch_norm": ("triton", "paddle_tpu_torch/kernels/batch_norm.py",
                       "paddle_tpu/nn/functional/norm.py:95"),
        "batch_norm_bwd": ("triton",
                           "paddle_tpu_torch/kernels/batch_norm.py",
                           "paddle_tpu/nn/functional/norm.py:95"),
        # the forward's and the backward's short runs, by their plans
        "batch_norm_cluster": ("cuda",
                               "paddle_tpu_torch/csrc/batch_norm_fwd.cu",
                               "paddle_tpu/nn/functional/norm.py:95"),
        "batch_norm_bwd_cluster": ("cuda",
                                   "paddle_tpu_torch/csrc/batch_norm_bwd.cu",
                                   "paddle_tpu/nn/functional/norm.py:95"),
        # no Pallas kernel: the scans XLA compiles into loops on the device
        "ctc_fwd": ("cuda", "paddle_tpu_torch/csrc/ctc_loss.cu",
                    "paddle_tpu/nn/functional/loss.py:282"),
        "ctc_bwd": ("cuda", "paddle_tpu_torch/csrc/ctc_loss.cu",
                    "paddle_tpu/nn/functional/loss.py:282"),
        "rnnt_fwd": ("cuda", "paddle_tpu_torch/csrc/rnnt_loss.cu",
                     "paddle_tpu/nn/functional/loss.py:363"),
        "rnnt_bwd": ("cuda", "paddle_tpu_torch/csrc/rnnt_loss.cu",
                     "paddle_tpu/nn/functional/loss.py:363"),
        # no Pallas kernel: the dense attention's scale, masks, softmax and
        # dropout XLA fuses (forward; the vjp of the same function)
        "dense_softmax": ("triton",
                          "paddle_tpu_torch/kernels/dense_attention.py",
                          "paddle_tpu/nn/functional/attention.py:20"),
        "dense_softmax_bwd": ("triton",
                              "paddle_tpu_torch/kernels/dense_attention.py",
                              "paddle_tpu/nn/functional/attention.py:20"),
        # the forward at short rows, by dense_softmax_forward_plan
        "dense_softmax_cuda": ("cuda", "paddle_tpu_torch/csrc/dense_softmax.cu",
                               "paddle_tpu/nn/functional/attention.py:20"),
        # no Pallas kernel: the scan over the RNN step XLA compiles into a
        # loop on the device
        # the forward's two kernels by its plan: persistent (T > 1), step
        "rnn_fwd": ("cuda", "paddle_tpu_torch/csrc/rnn_recurrence.cu",
                    "paddle_tpu/nn/layer/rnn.py:281"),
        "rnn_fwd_step": ("cuda", "paddle_tpu_torch/csrc/rnn_recurrence.cu",
                         "paddle_tpu/nn/layer/rnn.py:281"),
        # the backward's routes by its plan: persistent (where it fits);
        # the step route's two kernels (gate gradients, product)
        "rnn_bwd": ("cuda", "paddle_tpu_torch/csrc/rnn_recurrence.cu",
                    "paddle_tpu/nn/layer/rnn.py:281"),
        "rnn_bwd_gates": ("cuda", "paddle_tpu_torch/csrc/rnn_recurrence.cu",
                          "paddle_tpu/nn/layer/rnn.py:281"),
        "rnn_bwd_step": ("cuda", "paddle_tpu_torch/csrc/rnn_recurrence.cu",
                         "paddle_tpu/nn/layer/rnn.py:281"),
    }
    # launches: the main paths' runs (serving, Llama, GPT-MoE and
    # packed-document training, the training surface's full-width runs),
    # summed; a backward's entry counts its dq
    # launches, each paired with one dk/dv launch (the training runs check
    # both counts exactly)
    runs = (serve_launches, serve13_launches, train_launches, gpt_launches,
            packed_launches,
            gpt_serve_launches, quant_launches, spec_launches, beam_launches,
            artifact_launches, surface_launches, ernie_launches,
            unet_launches, resnet_launches, seq_launches,
            transformer_launches, seq2seq_launches)
    main_runs = {k: sum(r.get(k, 0) for r in runs)
                 for k in set().union(*runs)}
    main_runs["flash_bwd"] = main_runs["flash_bwd_dq"]
    main_runs["flashmask_bwd"] = main_runs["flashmask_bwd_dq"]
    # the routes' counts are subsets of their function's
    main_runs["rnn_fwd"] -= main_runs["rnn_fwd_step"]
    main_runs["batch_norm"] -= main_runs["batch_norm_cluster"]
    main_runs["batch_norm_bwd"] -= main_runs["batch_norm_bwd_cluster"]
    main_runs["dropout_add_ln_bwd"] -= main_runs["dropout_add_ln_bwd_warp"]
    main_runs["group_norm_bwd"] -= main_runs["group_norm_bwd_cluster"]
    main_runs["group_norm"] -= main_runs["group_norm_cluster"]
    main_runs["dense_softmax"] -= main_runs["dense_softmax_cuda"]
    kernels = []
    for name, (route, source, tpu) in replaces.items():
        m = results[{"ragged_attention": "ragged_attention[mixed_mha]",
                     "weight_only_gemm":
                         "weight_only_gemm[llama_qkvo int8 M=256]",
                     "dense_softmax": f"dense_softmax[{DENSE_KERNEL}]",
                     "dense_softmax_bwd":
                         f"dense_softmax_bwd[{DENSE_KERNEL}]",
                     "dense_softmax_cuda":
                         f"dense_softmax_cuda[{DENSE_CUDA_KERNEL}]",
                     "rnn_fwd": f"rnn_fwd[{RNN_MAIN}]",
                     "rnn_fwd_step": f"rnn_fwd[{RNN_STEP_MAIN}]",
                     "batch_norm_cluster": f"batch_norm[{BN_CLUSTER_MAIN}]",
                     "batch_norm_bwd_cluster":
                         f"batch_norm_bwd[{BN_CLUSTER_MAIN}]",
                     "rnn_bwd": f"rnn_bwd[{RNN_MAIN}]",
                     "rnn_bwd_gates": f"rnn_bwd_gates[{RNN_STEP_BWD_MAIN}]",
                     "rnn_bwd_step": f"rnn_bwd_step[{RNN_STEP_BWD_MAIN}]"}
                    .get(name, name)]
        kernels.append(dict(name=name, route=route, source=source,
                            replaces=tpu, launches=main_runs[name],
                            **{k: m[k] for k in JSON_KEYS}))
    print("phase seconds: " + json.dumps(seconds), flush=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": results, "sass": sass,
                   "build_seconds": {n: i["seconds"] for n, i in built.items()},
                   "serving": serving, "serving_llama2_13b": serving13,
                   "training": training, "gpt_moe_training": gpt_moe,
                   "packed_training": packed, "gpt_serving": gpt_serving,
                   "quant_serving": quant, "spec_serving": spec,
                   "artifact": artifact, "flashmask_routed": routed_f5,
                   "training_surface": surface, "ernie_training": ernie,
                   "unet": unet, "resnet50": resnet,
                   "seq_loss_training": seq, "new_layers": new_layers,
                   "transformer_base": transformer,
                   "rnn_layers": rnn_layers, "seq2seq": seq2seq,
                   "seconds": seconds,
                   "launches": {"serving": serve_launches,
                                "serving_llama2_13b": serve13_launches,
                                "training": train_launches,
                                "gpt_moe_training": gpt_launches,
                                "packed_training": packed_launches,
                                "gpt_serving": gpt_serve_launches,
                                "quant_serving": quant_launches,
                                "spec_serving": spec_launches,
                                "beams": beam_launches,
                                "artifact": artifact_launches,
                                "training_surface": surface_launches,
                                "ernie_training": ernie_launches,
                                "unet": unet_launches,
                                "resnet50": resnet_launches,
                                "seq_loss_training": seq_launches,
                                "transformer_base": transformer_launches,
                                "seq2seq": seq2seq_launches}},
                  f,
                  indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(f"output directory {args.out}: {_dir_bytes(args.out) / 2**20:.1f} "
          f"MiB (budget {OUT_BUDGET_MIB} MiB)", flush=True)
    if _dir_bytes(args.out) > OUT_BUDGET_MIB * 2**20:
        raise AssertionError(f"{args.out} holds more than "
                             f"{OUT_BUDGET_MIB} MiB")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
