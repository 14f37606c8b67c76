"""Build the CUDA kernels from ``kernels/csrc`` and load them with ctypes.

The sources compile with ``nvcc`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, at first use, into
``<repo>/build/kernels/<hash>/``, where the hash covers the sources and the
compiler flags. A later call in any process with the same sources loads that
library instead of compiling again. Nothing here falls back: without CUDA or
without ``nvcc`` the build raises ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libgpgpuraytrace_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME or /usr/local/cuda); "
        "the CUDA kernels are built from source at first use"
    )


def build_library() -> tuple[Path, str]:
    """Compile the kernels unless a library for these sources exists.

    Returns (library path, compiler log); the log is empty when nothing was
    compiled and holds ptxas's register and spill report otherwise."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the trace kernel runs only on an NVIDIA "
            "GPU (the plain PyTorch version runs on CPU tensors)"
        )
    sources = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib, ""
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib, proc.stdout + proc.stderr


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    path, _ = build_library()
    return ctypes.CDLL(str(path))

