"""PyTorch/CUDA port of paddle_tpu: Llama serving and training, GPT
(dense and dropless MoE) training, ERNIE pretraining, the Stable
Diffusion UNet and ResNet.

A package of its own beside ``paddle_tpu`` (the JAX reference): it imports
``torch`` and nothing of JAX or of ``paddle_tpu``. Module names mirror the
JAX package so each counterpart is easy to find; the kernels under
``kernels/`` are written by hand for the H100 (CUDA C++ and Triton), each
beside a plain PyTorch version that CPU tensors take.

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the GPU. Raises when the
    GPU is asked for and there is none, rather than running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU with the kernels' plain versions")
    return dev


from .framework.random import get_rng_state, seed, set_rng_state  # noqa: E402

__all__ = ["resolve_device", "seed", "get_rng_state", "set_rng_state"]
