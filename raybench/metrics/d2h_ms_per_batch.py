"""Device time of the copies of frames to the host (FlyBatch.host_frames'
pinned copy), per batch."""


def read(profiles):
    p = profiles[0]
    ops = p.ops_matching("DtoH")
    if not ops or not p.units:
        return None
    return 1e3 * sum(o[2] for o in ops) / p.units
