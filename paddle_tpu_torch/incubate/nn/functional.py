"""``paddle_tpu.incubate.nn.functional``'s
``fused_bias_dropout_residual_layer_norm``
(``paddle_tpu/incubate/nn/functional/fused_ops.py:636``):
``LayerNorm(residual + dropout(x + bias))`` over the last axis, through
``kernels.fused.dropout_add_layer_norm`` (one Triton kernel forward, one
backward, on CUDA tensors; the plain ops on CPU tensors)."""
from __future__ import annotations

from ... import amp
from ...framework.random import next_key
from ...kernels import dropout as D
from ...kernels import fused
from ...nn import functional as F


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias=None, ln_scale=None, ln_bias=None,
        dropout_rate=0.5, ln_epsilon=1e-5, training=True,
        mode="upscale_in_train", name=None):
    """``LayerNorm(residual + dropout(x + bias))``, the JAX composition's
    ops and roundings, the mask drawn under ``next_key()`` when training
    with ``0 < dropout_rate < 1``. Where the composition is not one
    kernel call (eval under "downscale_in_infer", which scales by ``1 -
    p``; a rate of 1; ``amp`` casting or observing its ops, which the JAX
    composition's ``layer_norm`` makes float32) it runs the port's
    functionals one by one, as the JAX function does."""
    if mode not in D.MODES:
        raise ValueError(f"dropout mode must be one of {D.MODES}, got "
                         f"{mode!r}")
    p = float(dropout_rate) if training else 0.0
    plain = (p >= 1.0 or (not training and mode == "downscale_in_infer")
             or (amp._active() and not amp.amp_state.depth))
    if plain:
        h = x if bias is None else x + bias
        h = F.dropout(h, p=dropout_rate, training=training, mode=mode)
        return F.layer_norm(h + residual, h.shape[-1], weight=ln_scale,
                            bias=ln_bias, epsilon=ln_epsilon)
    key = next_key() if p > 0.0 else None
    return fused.dropout_add_layer_norm(x, ln_scale, ln_bias, ln_epsilon,
                                        residual, bias, p, key, mode)


__all__ = ["fused_bias_dropout_residual_layer_norm"]
