"""Hand-written GPU kernels of the port, each beside its plain version.

``LAUNCHES`` counts, per kernel, the launches its wrapper made: a wrapper
adds one where it launches the kernel and nowhere else, so a run that
zeroes the counts, drives the engine or a trainer and reads them shows which kernels
the path really went through. A call on a CPU tensor takes the plain
version and counts nothing. Where a kernel is a ``torch.library`` op, the
count sits in the op's CUDA implementation, so a program exported with
``jit.save`` counts its launches too (and a trace counts none).

A CUDA graph's replay runs no Python, so no wrapper counts it: code
that captures a graph takes the launches the capture counted back out
(``uncount_since``) and adds that tally at every replay (the serving
engine's step, generate()'s decode loops, and ``parallel.SpmdTrainer``'s
training step, one graph per batch signature, whose replays each add the
launches of one step).

``rms_norm_bwd`` counts one call of RMSNorm's backward (two Triton
kernels: the rows' pass and the sum of its dw partials); ``swiglu_fwd``
and ``swiglu_bwd`` the Llama MLP's fused ``silu(gate) * up`` and its
backward. They port no TPU kernel: they are passes XLA fuses into the
JAX package's compiled training step.

``dropout`` counts the launches of the dropout kernel (a forward, a
backward, one each); ``dropout_add_ln`` and ``dropout_add_ln_bwd`` the
calls of ``LayerNorm(residual + dropout(x + bias))``'s forward kernel and
of its backward (the rows' pass and the column sums: two kernels), which
every LayerNorm on the card goes through; ``dropout_add_ln_bwd_warp``
counts the backward calls that ``layer_norm_backward_plan`` sends to the
CUDA kernel (``csrc/layer_norm_bwd.cu``, a warp a row), the rest take the
Triton one. They port no TPU kernel either: XLA fuses the JAX package's
dropout and LayerNorm.

``group_norm`` and ``group_norm_bwd`` count the calls of GroupNorm's
forward (one kernel: ``group_norm_forward_plan``'s cluster kernel,
``csrc/group_norm_fwd.cu``, a thread-block cluster a group with the SiLU
where fused; or two Triton kernels: the chunks' statistics, then the
normalisation) and of its backward (two kernels:
``group_norm_backward_plan``'s cluster kernel, ``csrc/group_norm_bwd.cu``,
then the column sums of the weight and bias gradients; or three Triton
kernels: the chunks' partial sums, dx, the column sums), which every
GroupNorm on the card goes through (the convolutional models);
``group_norm_cluster`` and ``group_norm_bwd_cluster`` count the calls of
the cluster kernels. No TPU kernel either: XLA fuses the JAX package's GroupNorm and
SiLU.

``batch_norm`` and ``batch_norm_bwd`` count the calls of BatchNorm's
forward (two Triton kernels in training: the chunks' statistics, then the
normalisation with the residual add and the ReLU where fused; one in
eval; or the one-pass cluster kernel of ``csrc/batch_norm_fwd.cu``, which
``batch_norm_forward_plan`` picks for short channels and
``batch_norm_cluster`` also counts) and of its backward (two: the chunks' partial sums, then dx and the
residual's gradient), which every BatchNorm on the card goes through
(ResNet); ``batch_norm_bwd_cluster`` also counts the backward calls that
``batch_norm_backward_plan`` sends to the one-pass cluster kernel
(``csrc/batch_norm_bwd.cu``) instead. No TPU kernel either: XLA fuses the
JAX package's BatchNorm with the add and the ReLU after it.

``ctc_fwd`` and ``ctc_bwd`` count the calls of CTC's forward and
backward, ``rnnt_fwd`` and ``rnnt_bwd`` those of RNN-T's (two CUDA
kernels a call each: a pass over the rows and the recursion,
``kernels/seq_loss.py``). No TPU kernel either: XLA compiles the JAX
package's scans into loops on the device.

``rnn_fwd`` and ``rnn_bwd`` count the launches of the recurrence's
forward and backward kernels (``kernels/rnn.py``, ``csrc/rnn_recurrence.cu``):
the forward one a layer and direction on the persistent kernel, one a
time step on the step kernel (``rnn_forward_plan``: a cell call, and
shapes the persistent kernel cannot hold), which ``rnn_fwd_step`` also
counts; the backward's persistent kernel one a layer and direction or a
cell call (``rnn_backward_plan``'s persistent route). ``rnn_bwd_gates``
and ``rnn_bwd_step`` count the backward's step route (what the persistent
kernel cannot hold), two kernels a time step (the gate gradients, then
the product), each only its own. Every
SimpleRNN, LSTM, GRU and cell on the card goes through them. No TPU kernel either: XLA compiles the JAX
package's scan over the step into a loop on the device.

``dense_softmax`` and ``dense_softmax_bwd`` count the calls of the dense
attention's middle (the scale, the masks, the fp32 softmax and the
probabilities' dropout: ``kernels/dense_attention.py``, one kernel each
way: the forward ``dense_softmax_forward_plan``'s CUDA kernel,
``csrc/dense_softmax.cu``, at short rows, which ``dense_softmax_cuda``
also counts, else Triton; the backward Triton), which every attention that
takes ``_sdpa_reference`` on the card goes through (the ``sdpa_plain`` and ``sdpa_dense`` routes,
``flash_attn_unpadded``). No TPU kernel either: XLA fuses those passes of
the JAX package's ``_sdpa_reference``.

``weight_only_gemm`` counts every call of the weight-only GEMM on the
card, whichever of its two kernels it launched; ``weight_only_gemm_sm80``
counts those that went to the mma.sync kernel (shapes TMA cannot read).

Three keys count calls instead, on any device: ``sdpa_plain`` the attention
calls that ``nn.functional.scaled_dot_product_attention`` routes to its
plain ``_sdpa_reference`` because the flash kernels do not take their
shapes (``flash_attention.flash_takes``), and ``ragged_plain`` the serving
attention calls that ``serving.ragged.make_attend`` routes to
``ragged_attention_plain`` for the same reason (``ragged_attention.
kernel_takes``). ``sdpa_dense`` counts the attention calls that take
the dense ``_sdpa_reference`` because they have a mask or a dropout
(``scaled_dot_product_attention`` with ``attn_mask`` or ``dropout_p``,
``flashmask_attention`` with a dropout in training, ``flash_attn_unpadded``,
whose segments are a mask). Every routing is the
JAX package's own; a main path that takes one reads above 0 there.
"""
from __future__ import annotations

import functools

LAUNCHES = {"ragged_attention": 0, "rms_norm": 0, "rms_norm_residual": 0,
            "rope": 0, "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "adamw": 0, "gmm": 0, "tgmm": 0, "flashmask_summary": 0,
            "flashmask_fwd": 0, "flashmask_bwd_dq": 0, "flashmask_bwd_dkv": 0,
            "weight_only_gemm": 0, "weight_only_gemm_sm80": 0,
            "rms_norm_bwd": 0, "swiglu_fwd": 0, "swiglu_bwd": 0,
            "dropout": 0, "dropout_add_ln": 0, "dropout_add_ln_bwd": 0,
            "dropout_add_ln_bwd_warp": 0, "group_norm": 0,
            "group_norm_bwd": 0, "group_norm_bwd_cluster": 0,
            "batch_norm": 0,
            "batch_norm_bwd": 0, "batch_norm_bwd_cluster": 0, "ctc_fwd": 0,
            "ctc_bwd": 0, "rnnt_fwd": 0, "rnnt_bwd": 0, "dense_softmax": 0,
            "dense_softmax_bwd": 0, "dense_softmax_cuda": 0,
            "group_norm_cluster": 0, "rnn_fwd": 0, "rnn_fwd_step": 0,
            "rnn_bwd": 0, "rnn_bwd_gates": 0, "rnn_bwd_step": 0,
            "batch_norm_cluster": 0,
            "sdpa_plain": 0,
            "sdpa_dense": 0, "ragged_plain": 0}


# the keys that count calls
ROUTED = ("sdpa_plain", "sdpa_dense", "ragged_plain")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernel_launches() -> dict:
    """The counts of the kernels alone (``LAUNCHES`` less ``ROUTED``)."""
    return {n: c for n, c in LAUNCHES.items() if n not in ROUTED}


def uncount_since(before: dict) -> dict:
    """Take the counts added since ``before`` (a copy of ``LAUNCHES``) back
    out, and return them: what a CUDA graph's capture counted without
    launching, which each replay then adds."""
    tally = {n: LAUNCHES[n] - before[n] for n in LAUNCHES
             if LAUNCHES[n] != before[n]}
    LAUNCHES.update(before)
    return tally


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The SMs of the CUDA device ``device`` (a plan's grid is cut to it)."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


__all__ = ["LAUNCHES", "ROUTED", "reset_launches", "kernel_launches",
           "uncount_since", "sm_count"]
