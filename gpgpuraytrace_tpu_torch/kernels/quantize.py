"""Tonemap and quantize linear RGB to display uint8 in one kernel
(``csrc/quantize.cu``), the step that ends every flythrough frame.

The counterpart of the XLA fusion of ``tonemap -> clip -> x 255 + 0.5 ->
uint8`` inside the JAX package's compiled batch program
(``gpgpuraytrace_tpu/ops/flythrough.py:_make_batch_render``, :51-52).

* ``tonemap_quantize`` is the wrapper: on a CUDA tensor it launches the
  kernel (and raises if the build, the table or the launch fails), on a CPU
  tensor it runs the plain version. ``.launches`` counts kernel launches.
* ``tonemap_quantize_reference`` is the plain version: Reinhard, clamp,
  gamma 1 / 2.2, clamp, x 255 + 0.5, truncate, as eight elementwise torch
  passes. On the card the kernel's output equals it byte for byte for every
  float32 input.
* ``level_table`` is the kernel's table of the 255 level edges, made on each
  device at first use from the chain itself (``make_table``: the scan kernel
  lists every bit pattern where the chain's level changes;
  ``table_from_changes`` and ``pack_table`` turn the list into the table
  that ``csrc/quantize.cu`` describes), and cached per device. It is never
  made on the CPU, whose ``pow`` may round otherwise, nor inside a CUDA graph
  capture: the first call on a device must come before one.
"""

from __future__ import annotations

import bisect
import ctypes
import dataclasses
import functools
import time
from typing import Iterable

import numpy as np
import torch

from gpgpuraytrace_tpu_torch.ops.shade import tonemap

# The table's layout (csrc/quantize.cu): a piece is a bit pattern's top bits
# (bits >> PIECE_SHIFT: the exponent and 6 mantissa bits); patterns below
# FINITE are the finite x >= +0; the words of the header, the edges (e_0 .. e_255
# and sentinels) and the window ends before the pieces' bytes.
PIECE_SHIFT = 17
FINITE = 0x7F800000
HEADER_WORDS, EDGE_WORDS, WINDOW_WORDS = 4, 260, 256
PIECE_WORDS = HEADER_WORDS + EDGE_WORDS + WINDOW_WORDS
LEVELS = 256
# Entries of the scan's change list: 255 edges if the chain is monotone,
# two more per window where it is not.
SCAN_CAPACITY = 1 << 20


def tonemap_quantize_reference(color: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) linear RGB -> (..., H, W, 3) uint8 on its device."""
    return (torch.clamp(tonemap(color), 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def table_from_changes(changes: Iterable[tuple[int, int]]):
    """The level edges and windows from the chain's changes.

    ``changes`` lists (pattern, level) where the level at a finite
    non-negative pattern differs from the one before (level 0 before +0),
    in increasing pattern order. Returns (edges, window_ends, windows):
    edges[k] is e_k, the least pattern whose level is >= k (edges[0] = 0);
    window_ends[k] is w_k, the end of the last window of [e_k, e_k+1) where
    the level is below k (e_k where there is none; the kernel sends [e_k,
    w_k) to the exact chain); windows lists every (start, end) where the
    level is below the running maximum."""
    edges = [0] * LEVELS
    ends = [0] * LEVELS
    windows = []
    top, dip, last = 0, None, -1
    for pattern, level in changes:
        if not last < pattern < FINITE or not 0 <= level < LEVELS:
            raise ValueError(f"change ({pattern:#x}, {level}) out of order or range")
        last = pattern
        if level < top:
            if dip is None:
                dip = pattern
            continue
        if dip is not None:
            windows.append((dip, pattern))
            ends[top] = pattern
            dip = None
        for k in range(top + 1, level + 1):
            edges[k] = ends[k] = pattern
        top = max(top, level)
    if dip is not None:
        windows.append((dip, FINITE))
        ends[top] = FINITE
    if top != LEVELS - 1:
        raise ValueError(f"the chain's levels reach {top}, not {LEVELS - 1}")
    return edges, ends, windows


def pack_table(edges: list[int], window_ends: list[int]) -> np.ndarray:
    """The kernel's table as uint32 words (layout in ``csrc/quantize.cu``):
    for each piece from e_1's to e_255's, the count of edges below its first
    pattern. Raises ``ValueError`` if a piece holds more than one edge (the
    kernel finishes a level with one compare)."""
    base = edges[1] >> PIECE_SHIFT
    pieces = (edges[LEVELS - 1] >> PIECE_SHIFT) - base + 1
    starts = [(base + i) << PIECE_SHIFT for i in range(pieces)]
    below = [bisect.bisect_left(edges, s, 1) - 1 for s in starts]
    per_piece = np.diff(below + [LEVELS - 1])
    if per_piece.max() > 1:
        worst = int(np.argmax(per_piece))
        raise ValueError(f"piece {worst} (patterns from {starts[worst]:#x}) holds "
                         f"{per_piece[worst]} edges; the kernel takes at most one")
    piece_bytes = np.zeros(-(-pieces // 16) * 16, dtype=np.uint8)
    piece_bytes[:pieces] = below
    words = np.zeros(PIECE_WORDS, dtype=np.uint32)
    words[:2] = base, pieces
    words[HEADER_WORDS:HEADER_WORDS + LEVELS] = edges
    words[HEADER_WORDS + LEVELS:HEADER_WORDS + EDGE_WORDS] = 0xFFFFFFFF
    words[HEADER_WORDS + EDGE_WORDS:] = window_ends
    return np.concatenate([words, piece_bytes.view(np.uint32)])


@dataclasses.dataclass(frozen=True)
class LevelTable:
    """A device's table (``words``, int32 on the device) and how it was
    made: the scan's change count, the edges, the window ends, the windows
    where the chain goes back, and the scan's seconds (host clock, launch to
    count)."""

    words: torch.Tensor
    changes: int
    edges: tuple[int, ...]
    window_ends: tuple[int, ...]
    windows: tuple[tuple[int, int], ...]
    seconds: float

    @property
    def exact_patterns(self) -> int:
        """Finite non-negative patterns the kernel sends to the exact chain."""
        return sum(w - e for e, w in zip(self.edges, self.window_ends))


@functools.cache
def _library() -> ctypes.CDLL:
    from gpgpuraytrace_tpu_torch.kernels.build import load_library

    lib = load_library()
    lib.tonemap_quantize_launch.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                                            + [ctypes.c_longlong] * 7 + [ctypes.c_void_p])
    lib.tonemap_quantize_launch.restype = ctypes.c_int
    lib.tonemap_quantize_scan_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_uint,
                                                                         ctypes.c_void_p]
    lib.tonemap_quantize_scan_launch.restype = ctypes.c_int
    lib.trace_error_string.argtypes = [ctypes.c_int]
    lib.trace_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({lib.trace_error_string(err).decode()})")


def make_table(lib, device: torch.device) -> LevelTable:
    """Scan the chain on ``device`` with ``lib``'s scan kernel and build its
    table (synchronises the device)."""
    with torch.cuda.device(device):
        changes = torch.empty(SCAN_CAPACITY, dtype=torch.int64, device=device)
        count = torch.zeros(1, dtype=torch.int32, device=device)
        t0 = time.perf_counter()
        _raise_on(lib, lib.tonemap_quantize_scan_launch(
            changes.data_ptr(), count.data_ptr(), SCAN_CAPACITY,
            torch.cuda.current_stream(device).cuda_stream), "the level scan's launch")
        n = int(count.item())
        seconds = time.perf_counter() - t0
    if n > SCAN_CAPACITY:
        raise RuntimeError(f"the level scan found {n} changes; it keeps {SCAN_CAPACITY}")
    packed = sorted(changes[:n].cpu().tolist())
    edges, ends, windows = table_from_changes((c >> 8, c & 0xFF) for c in packed)
    words = torch.from_numpy(pack_table(edges, ends).view(np.int32)).to(device)
    return LevelTable(words, n, tuple(edges), tuple(ends), tuple(windows), seconds)


_TABLES: dict[int, LevelTable] = {}


def level_table(device) -> LevelTable:
    """The kernel's table on CUDA ``device``, made at the first call there
    (``level_table.made`` counts the tables made); raises inside a CUDA
    graph capture rather than make it there."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    table = _TABLES.get(index)
    if table is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"tonemap_quantize: the level table of cuda:{index} is made at "
                               f"first use, outside a CUDA graph capture; call "
                               f"tonemap_quantize there once before capturing")
        table = _TABLES[index] = make_table(_library(), torch.device("cuda", index))
        level_table.made += 1
    return table


level_table.made = 0


def tonemap_quantize(color: torch.Tensor) -> torch.Tensor:
    """``tonemap_quantize_reference`` of ``color``, (..., H, W, 3) float32
    of any strides, as (..., H, W, 3) uint8 on its device: on a CUDA tensor
    one kernel launch into a contiguous tensor (the leading dimensions must
    merge into one without a copy, as a (B, H, W, 3) view of the trace's
    (B, 3, H, W) planes does; anything else raises ``ValueError``), on a CPU
    tensor the plain version."""
    if color.device.type != "cuda":
        return tonemap_quantize_reference(color)
    if color.dtype != torch.float32 or color.dim() < 3 or color.shape[-1] != 3:
        raise ValueError(f"tonemap_quantize takes (..., H, W, 3) float32, got "
                         f"{tuple(color.shape)} {color.dtype}")
    h, w = color.shape[-3:-1]
    if color.numel() == 0:
        return torch.empty(color.shape, dtype=torch.uint8, device=color.device)
    try:
        x = color.view(-1, h, w, 3)
    except RuntimeError as e:
        raise ValueError(f"tonemap_quantize: the leading dimensions of a "
                         f"{tuple(color.shape)} tensor of strides {color.stride()} do not "
                         f"merge into one") from e
    table = level_table(color.device).words
    out = torch.empty(color.shape, dtype=torch.uint8, device=color.device)
    lib = _library()
    with torch.cuda.device(color.device):
        err = lib.tonemap_quantize_launch(
            x.data_ptr(), out.data_ptr(), table.data_ptr(), table.numel(), *x.shape[:3],
            *x.stride(), torch.cuda.current_stream(color.device).cuda_stream)
    _raise_on(lib, err, "tonemap_quantize kernel launch")
    tonemap_quantize.launches += 1
    return out


tonemap_quantize.launches = 0
