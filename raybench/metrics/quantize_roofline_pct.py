"""Tonemap-and-quantize's share of its roofline (csrc/quantize.cu): the
bytes it must move (3 floats in, 3 bytes out a pixel) over HBM's rate,
over its device time."""


def read(profiles):
    device = sum(p.device_s("tonemap_quantize", exclude=("scan",)) for p in profiles)
    if device <= 0:
        return None
    return 100.0 * sum(p.work["quantize"] * p.units for p in profiles) / device
