"""Build the port's CUDA sources into shared libraries and load them.

Each ``paddle_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, loaded
with ``ctypes``. Libraries land in ``build/kernels/`` at the root of the
checkout (listed in ``.gitignore``), named by a hash of the source text,
the shared ``*.cuh`` headers and the flags, so an edited source builds
anew and an unchanged one loads the library already there. Builds run at first use, one ``nvcc``
per source, all started together. Importing this module needs no
``nvcc``: only ``build_all``, ``library`` and ``build_variants`` (the
variant builds that the scripts under ``tools/`` time) call it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME or "
        "/usr/local/cuda): the port's CUDA kernels are built from source "
        "at first use")


def sources() -> Dict[str, Path]:
    """{name: path} of every CUDA source of the port."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # the headers a source may include
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, dict]:
    """Compile every source whose library is missing, in parallel.
    Returns {name: {"path", "seconds", "log"}}, where ``log`` is nvcc's
    output (register and shared-memory use per kernel, from ptxas).
    Raises RuntimeError naming the source if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    result = {}
    for name, src in sources().items():
        out = _target(src)
        if out.exists():
            log = out.with_suffix(".log")
            result[name] = {"path": str(out), "seconds": 0.0,
                            "log": log.read_text() if log.exists() else ""}
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.monotonic())
    failed = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        secs = time.monotonic() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)     # atomic: a concurrent build sees all or nothing
        result[name] = {"path": str(out), "seconds": secs, "log": log}
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return result


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        src = sources().get(name)
        if src is None:
            raise KeyError(f"no CUDA source {name}.cu in {CSRC}")
        out = _target(src)
        if not out.exists():
            build_all()
        lib = ctypes.CDLL(str(out))
        _loaded[name] = lib
    return lib


def build_variants(name: str, variants: Dict[str, list]) -> Dict[str, Path]:
    """Compile variants of ``csrc/<name>.cu``, each the source with some
    text replaced (``{variant: [(old, new), ...]}``), in parallel, into
    ``build/variants/``, printing each one's nvcc exit and ptxas spill,
    error and warning lines. Returns {variant: library path} of those that
    compiled. Raises ValueError if an ``old`` text is not in the source."""
    src = (CSRC / f"{name}.cu").read_text()
    out_dir = BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for var, reps in variants.items():
        text = src
        for old, new in reps:
            if old not in text:
                raise ValueError(f"variant {var}: {old[:60]!r} is not in "
                                 f"{name}.cu")
            text = text.replace(old, new)
        path = out_dir / f"{name}_{var}.cu"
        path.write_text(text)
        cmd = [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o",
               str(path.with_suffix(".so")), str(path)]
        procs[var] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      path.with_suffix(".so"))
    built = {}
    for var, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        print(f"== {var}: nvcc exit {proc.returncode}", flush=True)
        for line in log.splitlines():
            if ("spill" in line and " 0 bytes spill" not in line) \
                    or any(w in line for w in ("error", "arning",
                                               "Performance")):
                print("   ", line.strip()[:200])
        if proc.returncode == 0:
            built[var] = lib
    return built


__all__ = ["build_all", "library", "build_variants", "sources", "BUILD_DIR",
           "NVCC_FLAGS"]
