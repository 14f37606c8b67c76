"""The least time the card could take for a kernel's work: frozen operation
counts of the port's CUDA kernels and the published peaks of one NVIDIA
H100 SXM.

A roofline share is this least time over the kernel's device time from the
profiler. The least time is the larger of the operations of each type over
the peak rate of that type and the bytes over HBM's rate. The work (useful
march steps, hits, pixels) comes from the reference's march on the same
inputs (``reference/terrain.py:Trace``), never from the program's counters,
so a share reads the same work whatever kernel runs.
"""

from __future__ import annotations

# Published peaks of the H100 SXM at its 700 W limit (NVIDIA's data sheet
# and Hopper white paper): HBM 3.35 TB/s; FP32 67 TFLOP/s outside the tensor
# cores (132 SMs x 128 lanes x 2 for an FMA x 1.98 GHz); INT32 on 64 lanes
# per SM; bf16 outside the tensor cores 133.8 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"fp32": 67e12, "int32": 132 * 64 * 1.98e9, "bf16": 133.8e12}

# Operations per pixel, counted operator by operator in the port's CUDA
# sources (kernels/csrc/field.cuh, trace_fwd.cu, trace_bwd.cu): each +, -, *,
# /, min, max, floor, compare, select and conversion is one operation of its
# operands' type; a multiply-add counts two. "step": one march step's ray
# point, field sum, hit and escape tests and advance; "octave": one octave of
# the value-only heightfield (rotation, floors, four corner hashes and
# gradients, dots, fades, blend); "grad_octave": the same with derivatives,
# which the polish runs newton_iters + 1 times per hit; "pixel": raygen,
# envelope and shade. Backward per hit pixel and octave: one noise2_hess
# with its rotation and the recompute and adjoint sums; per pixel the raygen
# and shade adjoint and the column sums.
OPS = {
    "step": {"fp32": 25, "int32": 2},
    "octave": {"fp32": 77, "int32": 49},
    "grad_octave": {"fp32": 117, "int32": 49},
    "pixel": {"fp32": 90},
    "bwd_octave": {"fp32": 260, "int32": 49},
    "bwd_pixel": {"fp32": 260},
}

# Bytes a pixel moves: the forward reads its prime map (when primed) and
# writes colour (3 floats), t and hit; the backward reads t, hit and the
# three cotangent planes; tonemap-and-quantize reads 3 floats and writes 3
# bytes.
FWD_BYTES = 20
PRIME_BYTES = 4
BWD_BYTES = 20
QUANTIZE_BYTES = 15


def add_ops(total: dict, part: dict, times: float) -> dict:
    for k, n in part.items():
        total[k] = total.get(k, 0.0) + n * times
    return total


def least_s(ops: dict, nbytes: float) -> tuple[float, str]:
    """(least seconds, "operations" or "bytes": which bound sets it)."""
    t_ops = max((n / PEAK_OPS_PER_S[k] for k, n in ops.items()), default=0.0)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def step_ops(octaves: int) -> dict:
    """Operations of one march step of one pixel."""
    ops = add_ops({}, OPS["step"], 1)
    return add_ops(ops, OPS["octave"], octaves)


def fwd_least(octaves: int, newton_iters: int, primed: bool, steps: float, hits: float,
              pixels: float) -> tuple[float, str]:
    """Least time of one forward launch over ``pixels`` pixels that march
    ``steps`` useful steps in all and polish ``hits`` hits."""
    ops = add_ops({}, step_ops(octaves), steps)
    add_ops(ops, OPS["grad_octave"], hits * (newton_iters + 1) * octaves)
    add_ops(ops, OPS["pixel"], pixels)
    return least_s(ops, pixels * (FWD_BYTES + PRIME_BYTES * primed))


def bwd_least(octaves: int, hits: float, pixels: float) -> tuple[float, str]:
    """Least time of one backward (both stages) over ``pixels`` pixels with
    ``hits`` hits."""
    ops = add_ops({}, OPS["bwd_octave"], hits * octaves)
    add_ops(ops, OPS["bwd_pixel"], pixels)
    return least_s(ops, pixels * BWD_BYTES)


def quantize_least(pixels: float) -> tuple[float, str]:
    """Least time of tonemap-and-quantize over ``pixels`` pixels: bytes."""
    return least_s({}, pixels * QUANTIZE_BYTES)


def trace_least(octaves: int, newton_iters: int, tr) -> dict:
    """Least seconds of one traced band's kernels, from its reference
    ``Trace``: the forward (the coarse pass and the primed fine pass) and the
    backward, each with what bounds it."""
    fine = fwd_least(octaves, newton_iters, tr.coarse_pixels > 0, tr.steps, tr.hits,
                     tr.pixels)
    out = {"fwd": fine[0], "fwd_by": fine[1]}
    if tr.coarse_pixels:
        out["fwd"] += fwd_least(octaves, 1, False, tr.coarse_steps, tr.coarse_hits,
                                tr.coarse_pixels)[0]
    out["bwd"], out["bwd_by"] = bwd_least(octaves, tr.hits, tr.pixels)
    return out
