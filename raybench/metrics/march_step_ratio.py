"""Lane-steps the forward kernel's fine pass executed over the useful steps
the reference marched, on the scenes at the traced stretch's start and end
(the mean of the two): how much longer a 4x8 warp marches than its lanes
need, counted with the kernel's ``debug_steps`` counter outside the timed
window (``drivers/fitvol.py:Run.work``)."""


def read(profiles):
    ratios = [p.work["march_step_ratio"] for p in profiles if "march_step_ratio" in p.work]
    if not ratios:
        return None
    return sum(ratios) / len(ratios)
