"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface. :func:`build_library`
compiles one with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``build/srm_tpu_torch/`` at the repository root, named after a hash of
the source, the ``csrc/*.cuh`` headers and the flags, so an edited source or
header builds anew and an unchanged one is reused. :func:`load_library`
loads the result. Nothing is compiled when a module is imported; a machine
without ``nvcc`` fails here, when a kernel is first called on a CUDA
tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "srm_tpu_torch"
# -fmad=false: no multiply-add contraction, so a kernel rounds as its plain
# PyTorch version does, op by op; -Xptxas=-v reports registers and spills.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def build_library(source: str) -> Tuple[Path, str]:
    """Compile ``csrc/<source>`` if needed; returns (library path, compiler
    log — empty when the library was already built)."""
    src = CSRC / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src.read_bytes() + headers
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}_{key}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)               # atomic: a concurrent build sees all or nothing
    return out, proc.stdout + proc.stderr


def load_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``."""
    path, _ = build_library(source)
    return ctypes.CDLL(str(path))
