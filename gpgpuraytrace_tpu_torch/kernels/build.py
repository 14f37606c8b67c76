"""Build the CUDA kernels from ``kernels/csrc`` and load them with ctypes.

Each ``.cu`` source compiles with ``nvcc`` for Hopper (``sm_90a``), all of
them at once in parallel processes, and the objects link into one shared
library with a plain C interface, at first use, into
``<repo>/build/kernels/<hash>/``, where the hash covers every file in
``csrc/`` (headers too) and the compiler flags. A later call in any process
with the same sources loads that library instead of compiling again. Nothing
here falls back: without CUDA or without ``nvcc`` the build raises
``RuntimeError``.
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _sources() -> list[Path]:
    """The translation units: every ``.cu`` file of ``csrc/``."""
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    """``BUILD_ROOT/<hash>``: the hash covers the flags and every file in
    ``csrc/``, so an edited header builds anew too."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(p for p in CSRC.iterdir() if p.is_file()):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16]


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
            "CUDA is not available: the trace kernels run only on an NVIDIA "
            "GPU (their plain PyTorch versions run on CPU tensors)"
        )
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib, ""
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    jobs = []
    for src in _sources():
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((src, obj, cmd, proc))
    logs = []
    failed = []
    for src, _, cmd, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"--- {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
           *(str(obj) for _, obj, _, _ in jobs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    for _, obj, _, _ in jobs:
        obj.unlink()
    return lib, "\n".join(logs)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    path, _ = build_library()
    return ctypes.CDLL(str(path))

