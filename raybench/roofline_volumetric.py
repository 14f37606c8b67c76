"""The least time of the forward and backward kernels on the volumetric
terrain: ``roofline.py``'s counts and peaks plus the 3D fBm warp's work,
which the same kernels (csrc/field.cuh, trace_fwd.cu, trace_bwd.cu) run in
every march step, every polish and every backward pixel there.

Operations counted operator by operator in those sources as ``roofline.py``
counts them (chip_smoke.py's OPS, whose counts these are): "warp_step": the
warp's share of a march step's field (wf times each of p's three
components, wa times fbm3, the subtraction); "warp_octave": one 3D warp
octave (noise3_value, eight corners); "grad_warp_octave": the same in
Field::value_grad (fbm3_hess), which the polish calls newton_iters + 1
times per hit; "bwd_warp_octave": the backward's one fbm3_hess per hit
pixel and warp octave with its adjoint sums. The warp adds no bytes: its
two parameters ride in the packed row the heightfield reads.
"""

from __future__ import annotations

from raybench import roofline
from raybench.roofline import BWD_BYTES, FWD_BYTES, PRIME_BYTES, add_ops, least_s

OPS = {
    **roofline.OPS,
    "warp_step": {"fp32": 5},
    "warp_octave": {"fp32": 147, "int32": 125},
    "grad_warp_octave": {"fp32": 480, "int32": 125},
    "bwd_warp_octave": {"fp32": 485, "int32": 125},
}


def step_ops(octaves: int, warp_octaves: int) -> dict:
    """Operations of one march step of one pixel."""
    ops = roofline.step_ops(octaves)
    add_ops(ops, OPS["warp_step"], 1)
    return add_ops(ops, OPS["warp_octave"], warp_octaves)


def fwd_least(octaves: int, warp_octaves: int, newton_iters: int, primed: bool,
              steps: float, hits: float, pixels: float) -> tuple[float, str]:
    """Least time of one forward launch over ``pixels`` pixels that march
    ``steps`` useful steps in all and polish ``hits`` hits."""
    ops = add_ops({}, step_ops(octaves, warp_octaves), steps)
    add_ops(ops, OPS["grad_octave"], hits * (newton_iters + 1) * octaves)
    add_ops(ops, OPS["grad_warp_octave"], hits * (newton_iters + 1) * warp_octaves)
    add_ops(ops, OPS["pixel"], pixels)
    return least_s(ops, pixels * (FWD_BYTES + PRIME_BYTES * primed))


def bwd_least(octaves: int, warp_octaves: int, hits: float,
              pixels: float) -> tuple[float, str]:
    """Least time of one backward (both stages) over ``pixels`` pixels with
    ``hits`` hits."""
    ops = add_ops({}, OPS["bwd_octave"], hits * octaves)
    add_ops(ops, OPS["bwd_warp_octave"], hits * warp_octaves)
    add_ops(ops, OPS["bwd_pixel"], pixels)
    return least_s(ops, pixels * BWD_BYTES)


def trace_least(octaves: int, warp_octaves: int, newton_iters: int, tr) -> dict:
    """``roofline.trace_least`` on the volumetric terrain: least seconds of
    the forward (coarse pass and primed fine pass) and the backward of one
    traced band, from its reference ``Trace``, each with what bounds it."""
    fine = fwd_least(octaves, warp_octaves, newton_iters, tr.coarse_pixels > 0, tr.steps,
                     tr.hits, tr.pixels)
    out = {"fwd": fine[0], "fwd_by": fine[1]}
    if tr.coarse_pixels:
        out["fwd"] += fwd_least(octaves, warp_octaves, 1, False, tr.coarse_steps,
                                tr.coarse_hits, tr.coarse_pixels)[0]
    out["bwd"], out["bwd_by"] = bwd_least(octaves, warp_octaves, tr.hits, tr.pixels)
    return out
