"""Device time per step of the f32 all-reduces that the row-band step
captures (parallel/sharded.py, parallel/mesh.py:all_reduce), on the slowest
rank: the last to reach each all-reduce, so its time is the exchange's and
not a wait for a later band. No other collective runs in the window."""

from raybench.readers import STEP_ALL_REDUCE, slowest_rank


def read(profiles):
    p = slowest_rank(profiles)
    if p is None or not p.ops_matching(STEP_ALL_REDUCE):
        return None
    return 1e3 * p.device_s(STEP_ALL_REDUCE) / p.units
