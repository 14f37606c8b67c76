"""Reductions that several per-layer readers share (``metrics/<name>.py``
imports the one it reports)."""

from __future__ import annotations

NCCL = ("nccl", "Nccl")
# The f32 all-reduces the row-band step captures (parallel/mesh.py:all_reduce).
STEP_ALL_REDUCE = "AllReduce_Sum_f32"


def idle_pct(profiles) -> float | None:
    """Share of the traced stretch in which no operation ran on the card
    (100 - the union of the device intervals over the stretch), the mean
    over the ranks."""
    if not any(p.ops for p in profiles):
        return None
    return 100.0 * sum(1.0 - p.busy_s() / p.window_s for p in profiles) / len(profiles)


def fwd_roofline_pct(profiles) -> float | None:
    """The forward kernel's share of its roofline: the least time its
    launches (coarse and fine pass, csrc/trace_fwd.cu) could take on the
    traced inputs, from the reference's useful steps and hits
    (raybench/roofline.py), over their device time, summed over the ranks."""
    device = sum(p.device_s("trace_fwd_kernel") for p in profiles)
    if device <= 0:
        return None
    return 100.0 * sum(p.work["fwd"] * p.units for p in profiles) / device


def compute_s_per_unit(p) -> float:
    """A rank's device time per unit outside NCCL's kernels."""
    return sum(o[2] for o in p.ops if not any(n in o[0] for n in NCCL)) / p.units


def slowest_rank(profiles):
    """The rank whose device time outside NCCL per unit is largest: the
    last to reach each all-reduce, so its NCCL kernels wait least."""
    ranks = [p for p in profiles if p.units]
    return max(ranks, key=compute_s_per_unit) if ranks else None
