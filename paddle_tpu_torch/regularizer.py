"""Weight-decay regularizers: ``L1Decay`` and ``L2Decay``.

Mirrors ``paddle_tpu/regularizer.py``. A regularizer is a coefficient that
the optimizer consumes: ``apply(grad, param)`` returns the gradient plus
the penalty's derivative, computed in the gradient's dtype as the JAX one
is (its Python coefficient is weakly typed, so it takes the gradient's
dtype before the product: for bf16 gradients the coefficient is rounded to
bf16 and every operation rounds to bf16). A regularizer on a parameter
(``param.regularizer``) takes precedence over the optimizer's
``weight_decay``; ``param.regularizer = False`` turns decay off for it.
Which cases ride the update's own weight-decay term instead is the
optimizer's decision (``Optimizer._wd_coeff``).
"""
from __future__ import annotations

import torch

from ._scalars import const


class WeightDecayRegularizer:
    def __init__(self, coeff: float = 0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self) -> float:
        return self._coeff

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self._coeff})"

    def _c(self, grad):
        """The coefficient in the gradient's dtype on its device, made once
        (``_scalars.const``): applying the penalty copies nothing
        from the host, so a captured step can hold it."""
        return const(self._coeff, grad.device, grad.dtype)

    def apply(self, grad, param):
        """The regularized gradient (grad + d penalty / d param)."""
        raise NotImplementedError


class L1Decay(WeightDecayRegularizer):
    """Adds coeff * sign(param) to the gradient."""

    def apply(self, grad, param):
        return grad + self._c(grad) * torch.sign(param.to(grad.dtype))


class L2Decay(WeightDecayRegularizer):
    """Adds coeff * param to the gradient (coupled decay). Under a coupled
    optimizer this rides the update's weight-decay term (the same math);
    under a decoupled one (AdamW) it goes through the gradient and the
    decoupled term is skipped for that parameter."""

    def apply(self, grad, param):
        return grad + self._c(grad) * param.to(grad.dtype)


__all__ = ["WeightDecayRegularizer", "L1Decay", "L2Decay"]
