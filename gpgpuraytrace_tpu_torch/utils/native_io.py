"""ctypes bindings for the native frame writer, ``native/tpurt_io.cc``
(counterpart of ``gpgpuraytrace_tpu/utils/native_io.py``, same C ABI).

The C++ side has a PNG encoder (zlib, filter 0; raw bytes for a ``.rgb``
path) and an asynchronous frame writer: worker threads encode and write
while the card renders the next batch. The library builds at first use with
``native/build.sh``'s compile line into ``<repo>/build/native/<hash>/``, the
hash covering the source, the flags and the host CPU that ``-march=native``
targets (a tree copied to another machine builds its own), so the JAX
package's own ``native/libtpurt_io.so`` is never touched. Without g++ or
zlib nothing builds: ``available()`` is False, ``write_png_native`` returns
False and ``AsyncFrameWriter`` raises; callers keep the Python encoder of
``utils/image.py``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "tpurt_io.cc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
LIB_NAME = "libtpurt_io.so"
# native/build.sh's compile line, without its input and output.
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
LINK_FLAGS = ("-lz", "-lpthread")
ABI_VERSION = 2  # tpurt_abi_version() in native/tpurt_io.cc


@functools.cache
def _native_target() -> bytes:
    """What ``-march=native`` selects on this host (g++'s target options);
    empty without g++, which then builds nothing anyway."""
    try:
        return subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                              capture_output=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return b""


def build_dir() -> Path:
    """``BUILD_ROOT/<hash>``: the hash covers the flags, the host CPU they
    target and the source."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    digest.update(_native_target())
    digest.update(SOURCE.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16]


def _build() -> Path | None:
    """The library's path, compiled first unless it exists; None when it
    cannot be built (no g++, no zlib, no source)."""
    try:
        lib = build_dir() / LIB_NAME
        if lib.is_file():
            return lib
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
        subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), *LINK_FLAGS, "-o", str(tmp)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
        return lib
    except (OSError, subprocess.SubprocessError):
        return None


@functools.cache
def _load():
    """The loaded library with its signatures set, or None (not buildable,
    or another ABI)."""
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.tpurt_abi_version.restype = ctypes.c_int
    if lib.tpurt_abi_version() != ABI_VERSION:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.tpurt_write_png.argtypes = [ctypes.c_char_p, u8p] + [ctypes.c_int] * 3
    lib.tpurt_write_png.restype = ctypes.c_int
    lib.tpurt_writer_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.tpurt_writer_create.restype = ctypes.c_void_p
    lib.tpurt_writer_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p, u8p,
                                      ctypes.c_int, ctypes.c_int]
    lib.tpurt_writer_push.restype = None
    lib.tpurt_writer_destroy.argtypes = [ctypes.c_void_p]
    lib.tpurt_writer_destroy.restype = ctypes.c_int
    lib.tpurt_writer_written.argtypes = [ctypes.c_void_p]
    lib.tpurt_writer_written.restype = ctypes.c_int
    return lib


def available() -> bool:
    return _load() is not None


def _rgb(rgb: np.ndarray):
    """(contiguous uint8 (H, W, 3) array, its data pointer)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {rgb.shape}")
    return rgb, rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def write_png_native(path: str, rgb: np.ndarray, level: int = 6) -> bool:
    """Write ``rgb`` (uint8 (H, W, 3)) synchronously: a PNG at zlib
    ``level``, raw bytes for a ``.rgb`` path. False if the library is not
    available or the write failed."""
    lib = _load()
    if lib is None:
        return False
    rgb, ptr = _rgb(rgb)
    return lib.tpurt_write_png(path.encode(), ptr, rgb.shape[0], rgb.shape[1], level) == 0


class AsyncFrameWriter:
    """Background frame writer: ``push(path, rgb)`` copies the frame into the
    queue (at most 16 waiting) and returns; ``num_threads`` workers encode
    at zlib ``level`` and write. As a context manager, exit waits for the
    queue to drain and raises if any frame failed. Raises ``RuntimeError``
    when the library is not available."""

    def __init__(self, num_threads: int = 2, level: int = 6):
        lib = _load()
        if lib is None:
            raise RuntimeError("native IO library unavailable (needs g++ and zlib)")
        self._lib = lib
        self._handle = lib.tpurt_writer_create(num_threads, level)

    def push(self, path: str, rgb: np.ndarray) -> None:
        rgb, ptr = _rgb(rgb)
        self._lib.tpurt_writer_push(self._handle, path.encode(), ptr, rgb.shape[0],
                                    rgb.shape[1])

    def written(self) -> int:
        return self._lib.tpurt_writer_written(self._handle)

    def close(self) -> int:
        """Drain the queue, stop the workers; returns the frames that failed."""
        if self._handle is None:
            return 0
        errs = self._lib.tpurt_writer_destroy(self._handle)
        self._handle = None
        return errs

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        errs = self.close()
        if errs and not exc[0]:
            raise RuntimeError(f"{errs} frames failed to write")
