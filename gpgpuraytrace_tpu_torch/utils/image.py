"""Image output: PNG and NPY writers (numpy only).

Copied from ``gpgpuraytrace_tpu/utils/image.py`` so the port does not import
the JAX package; the dependency-free PNG encoder is zlib + struct, and
``write_png`` always uses it. The native C++ writer (``utils/native_io.py``:
a synchronous encoder and the asynchronous ``AsyncFrameWriter``) is what
the flythrough CLI writes frames with; this encoder is its fallback.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_uint8(img) -> np.ndarray:
    """float [0,1] (H,W,3) → uint8, gamma already applied by tonemap."""
    arr = np.asarray(img)
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def encode_png(rgb: np.ndarray, level: int = 6) -> bytes:
    """Encode (H, W, 3) uint8 → PNG bytes (8-bit truecolor, filter 0).

    ``level`` is the zlib effort knob (VERDICT r4 item 6: level 6 made
    1080p flythroughs encode-bound on a 2-core host; 1 is much faster
    deflate at moderately larger files)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    assert c == 3, f"expected RGB, got {rgb.shape}"
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1
    ).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", ihdr)
        + _png_chunk(b"IDAT", zlib.compress(raw, level))
        + _png_chunk(b"IEND", b"")
    )


def write_png(path: str, img, level: int = 6) -> None:
    """Write a float [0,1] or uint8 (H,W,3) image as PNG (or raw RGB bytes
    for a ``.rgb`` path — the encoder-free stream mode)."""
    rgb = img if getattr(img, "dtype", None) == np.uint8 else to_uint8(img)
    rgb = np.ascontiguousarray(rgb, np.uint8)
    with open(path, "wb") as fh:
        if path.endswith(".rgb"):
            fh.write(rgb.tobytes())
        else:
            fh.write(encode_png(rgb, level))


def write_npy(path: str, img) -> None:
    np.save(path, np.asarray(img))
