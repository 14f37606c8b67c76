"""Tonemap and quantize linear RGB to display uint8 in one kernel
(``csrc/quantize.cu``), the step that ends every flythrough frame.

The counterpart of the XLA fusion of ``tonemap -> clip -> x 255 + 0.5 ->
uint8`` inside the JAX package's compiled batch program
(``gpgpuraytrace_tpu/ops/flythrough.py:_make_batch_render``, :51-52).

* ``tonemap_quantize`` is the wrapper: on a CUDA tensor it launches the
  kernel (and raises if the build or the launch fails), on a CPU tensor it
  runs the plain version. ``.launches`` counts kernel launches.
* ``tonemap_quantize_reference`` is the plain version: Reinhard, clamp,
  gamma 1 / 2.2, clamp, x 255 + 0.5, truncate, as eight elementwise torch
  passes. The kernel rounds each step as torch's CUDA pass for it does, so
  on the card their outputs are equal byte for byte.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gpgpuraytrace_tpu_torch.ops.shade import tonemap

# The kernel's grid takes the frames on its z and the rows on its y.
MAX_GRID_YZ = 65535


def tonemap_quantize_reference(color: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) linear RGB -> (..., H, W, 3) uint8 on its device."""
    return (torch.clamp(tonemap(color), 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


@functools.cache
def _library() -> ctypes.CDLL:
    from gpgpuraytrace_tpu_torch.kernels.build import load_library

    lib = load_library()
    lib.tonemap_quantize_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 7 + [
        ctypes.c_void_p]
    lib.tonemap_quantize_launch.restype = ctypes.c_int
    lib.trace_error_string.argtypes = [ctypes.c_int]
    lib.trace_error_string.restype = ctypes.c_char_p
    return lib


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
    if x.shape[0] > MAX_GRID_YZ or h > MAX_GRID_YZ:
        raise ValueError(f"tonemap_quantize: {x.shape[0]} frames of {h} rows; at most "
                         f"{MAX_GRID_YZ} of each")
    out = torch.empty(color.shape, dtype=torch.uint8, device=color.device)
    lib = _library()
    with torch.cuda.device(color.device):
        err = lib.tonemap_quantize_launch(
            x.data_ptr(), out.data_ptr(), *x.shape[:3], *x.stride(),
            torch.cuda.current_stream(color.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tonemap_quantize kernel launch failed: CUDA error {err} "
                           f"({lib.trace_error_string(err).decode()})")
    tonemap_quantize.launches += 1
    return out


tonemap_quantize.launches = 0
