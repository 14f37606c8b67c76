"""The numbers that decide ``correct``: a training run's first steps against
the reference's, and frames against the reference's frames."""

from __future__ import annotations

import statistics

import torch

# Leaves whose reference gradient is under this share of the median leaf's
# move under Adam by round-off alone; their change is not compared.
STILL_LEAF = 1e-3
# A display value off by more than this many levels counts as an outlier.
OUTLIER_LEVELS = 8


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double().cpu()))


def leaf_gaps(prog: dict, ref: dict, names) -> dict:
    """Per leaf |‖prog‖ - ‖ref‖| / max(‖ref‖, median leaf ‖ref‖)."""
    refn = {n: _norm(ref[n]) for n in names}
    med = statistics.median(refn.values())
    return {n: abs(_norm(prog[n]) - refn[n]) / max(refn[n], med) for n in names}


def worst_leaf_gap(prog: dict, ref: dict, names) -> float:
    """The largest of ``leaf_gaps``; NaN where any leaf's is."""
    gaps = list(leaf_gaps(prog, ref, names).values())
    return float("nan") if any(g != g for g in gaps) else max(gaps)


def train_gaps(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref`` hold ``losses`` (the first steps' losses),
    ``grad`` (the first gradient by leaf) and ``change`` (each leaf's change
    over those steps). Returns loss_gap (the first step's relative loss
    gap: Adam's first steps move a component whose gradient is near 0 by a
    whole step of either sign, so the later steps' losses part by round-off),
    grad_gap and change_gap (``worst_leaf_gap``; the change over the leaves
    the reference's gradient moves)."""
    p0, r0 = float(prog["losses"][0]), float(ref["losses"][0])
    loss_gap = abs(p0 - r0) / abs(r0)
    names = list(ref["grad"])
    gnorm = {n: _norm(ref["grad"][n]) for n in names}
    med = statistics.median(gnorm.values())
    moved = [n for n in names if gnorm[n] >= STILL_LEAF * med]
    details = {"loss_gaps": [abs(float(p) - float(r)) / abs(float(r))
                             for p, r in zip(prog["losses"], ref["losses"])],
               "grad_leaf": leaf_gaps(prog["grad"], ref["grad"], names),
               "change_leaf": leaf_gaps(prog["change"], ref["change"], moved),
               "grad_norm": gnorm, "losses": [float(r) for r in ref["losses"]]}
    return {"loss_gap": loss_gap,
            "grad_gap": worst_leaf_gap(prog["grad"], ref["grad"], names),
            "change_gap": worst_leaf_gap(prog["change"], ref["change"], moved),
            "details": details}


def frame_gaps(prog: list, ref: list) -> dict:
    """Frames in display levels (uint8, or tonemapped floats times 255):
    mean_level_diff, the mean absolute difference over every value, and
    outlier_share, the share of values off by more than OUTLIER_LEVELS."""
    total, over, count = 0.0, 0, 0
    for p, r in zip(prog, ref):
        p = torch.as_tensor(p).to(torch.float64)
        r = torch.as_tensor(r).to(torch.float64)
        d = (p - r).abs()
        total += float(d.sum())
        over += int((d > OUTLIER_LEVELS).sum())
        count += d.numel()
    return {"mean_level_diff": total / count, "outlier_share": over / count}
