"""The row bands' imbalance (parallel/mesh.py:band): the slowest rank's
device time per step outside NCCL over the fastest rank's."""

from raybench.readers import compute_s_per_unit


def read(profiles):
    per = [compute_s_per_unit(p) for p in profiles if p.units]
    if len(per) < 2 or min(per) <= 0:
        return None
    return max(per) / min(per)
