"""Test-only probe of the forward kernel's 2D value noise on the card.

``tests/csrc/noise2_probe.cu`` runs ``kernels/csrc/field.cuh``'s
``noise2_value`` or ``noise2_value_bf16`` one thread per point, so
tests/test_torch_cuda.py and chip_smoke.py can hold the card's arithmetic to
``ops/noise.py``'s. It is built here, apart from the kernel library, into a
directory the caller names:

    lib = load(build(out_dir))  # or start(out_dir), then finish(proc)
    out = noise2_probe(lib, x, z, seed, bf16=True)
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import torch

from gpgpuraytrace_tpu_torch.kernels import build as kbuild

SOURCE = Path(__file__).resolve().parent / "csrc" / "noise2_probe.cu"
LIB_NAME = "libnoise2_probe.so"


def start(out_dir) -> subprocess.Popen:
    """Start nvcc on the probe (one process, run beside other builds)."""
    out = Path(out_dir) / LIB_NAME
    cmd = [kbuild.find_nvcc(), *kbuild.NVCC_FLAGS, "-shared", "-I", str(kbuild.CSRC),
           str(SOURCE), "-o", str(out)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish(proc: subprocess.Popen) -> Path:
    """Wait for ``start``'s nvcc; the library's path, or RuntimeError."""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {SOURCE.name}:\n{log}")
    return Path(proc.args[-1])


def build(out_dir) -> Path:
    return finish(start(out_dir))


def load(path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.noise2_probe_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 2
    lib.noise2_probe_launch.restype = ctypes.c_int
    return lib


def noise2_probe(lib: ctypes.CDLL, x: torch.Tensor, z: torch.Tensor, seed: int,
                 bf16: bool = False) -> torch.Tensor:
    """The kernel's 2D value noise at float32 CUDA points ``x``, ``z``."""
    if x.dtype != torch.float32 or z.shape != x.shape or x.device.type != "cuda" \
            or z.device != x.device:
        raise ValueError("x and z must be float32 CUDA tensors of one shape on one device")
    x, z = x.contiguous(), z.contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.noise2_probe_launch(x.data_ptr(), z.data_ptr(), x.numel(), seed, int(bf16),
                                      out.data_ptr(),
                                      torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"noise2_probe launch failed: CUDA error {err}")
    return out
