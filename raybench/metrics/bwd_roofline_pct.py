"""The backward kernel's share of its roofline: the least time of both
stages (csrc/trace_bwd.cu) on the traced inputs, from the reference's hits
(raybench/roofline.py), over their device time, summed over the ranks."""


def read(profiles):
    device = sum(p.device_s("trace_bwd") for p in profiles)
    if device <= 0:
        return None
    return 100.0 * sum(p.work["bwd"] * p.units for p in profiles) / device
