"""Hand-written GPU kernels of the port, each beside its plain version.

``LAUNCHES`` counts, per kernel, the launches its wrapper made: a wrapper
adds one where it launches the kernel and nowhere else, so a run that
zeroes the counts, drives the engine or a trainer and reads them shows which kernels
the path really went through. A call on a CPU tensor takes the plain
version and counts nothing.
"""
from __future__ import annotations

LAUNCHES = {"ragged_attention": 0, "rms_norm": 0, "rms_norm_residual": 0,
            "rope": 0, "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "adamw": 0, "gmm": 0, "tgmm": 0, "flashmask_summary": 0,
            "flashmask_fwd": 0, "flashmask_bwd_dq": 0, "flashmask_bwd_dkv": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


__all__ = ["LAUNCHES", "reset_launches"]
