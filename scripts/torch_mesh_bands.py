"""Each rank's band of a row-band training step alone, on one card: what a
rank of ``bench --mesh N`` computes between its all-reduces.

For each world size n of ``--ranks`` and each rank r < n, the salted fwd+bwd
steps of r's band (``parallel/sharded.py:band_loss_and_grad``: the band's
forward and backward kernels, no collective) toward a zero target, every
float parameter trainable, at the bench's config (``bench.py:bench_config``),
timed as ``bench --mesh`` times the whole step (``utils/timing.py:
measure_kernel``: CUDA graphs of 1 and K steps beside the eager loop, the
lower middle of 3 measurements, ``graph_check``). A world size of 1 is the
whole frame's step. The step of n ranks takes at least its slowest band;
what it takes beyond that is the all-reduces and the wait for that band.
Prints one JSON line per band, then one with the card's name and power
limit; exits 1 when a ``graph_check`` fails.

    python scripts/torch_mesh_bands.py --size 3840x2160 --ranks 1,2
    python scripts/torch_mesh_bands.py --size 512 --ranks 1,2,4
    python scripts/torch_mesh_bands.py --device cpu --size 64x32 --octaves 2 --ranks 2 --k 2
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from gpgpuraytrace_tpu_torch.bench import (  # noqa: E402
    MESH_K, bench_config, bench_device, device_info,
)
from gpgpuraytrace_tpu_torch.models.scene import default_scene  # noqa: E402
from gpgpuraytrace_tpu_torch.ops.fit import partition_scene  # noqa: E402
from gpgpuraytrace_tpu_torch.parallel.mesh import band  # noqa: E402
from gpgpuraytrace_tpu_torch.parallel.sharded import (  # noqa: E402
    band_loss_and_grad, step_launches,
)
from gpgpuraytrace_tpu_torch.utils.timing import (  # noqa: E402
    FwdBwdSteps, lower_middle, measure_kernel,
)


def band_record(cfg, rank: int, world_size: int, k: int, device: torch.device) -> dict:
    """The timing of ``rank``'s band of ``world_size`` alone."""
    scene = default_scene(cfg.num_octaves, device=device)
    params = partition_scene(scene, trainable=lambda name: True)
    row0, h = band(cfg, rank, world_size)
    target = torch.zeros((h, cfg.width, 3), device=device)
    steps = FwdBwdSteps(params,
                        lambda: band_loss_and_grad(scene, params, cfg, target, row0, h))
    m = measure_kernel(steps, k, cfg.height * cfg.width, step_launches)
    return {"size": f"{cfg.width}x{cfg.height}", "octaves": cfg.num_octaves,
            "world": world_size, "rank": rank, "row0": row0, "rows": h,
            "timing": m["timing"], "K": k,
            "ms_per_step": lower_middle(m["measurements"])["ms_per_step"],
            "eager_ms_per_step": lower_middle(m["eager"])["ms_per_step"],
            "measurements": m["measurements"], "graph_check": m["graph_check"],
            "launches_per_step": m["launches_per_step"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--size", default="512", help="N or WxH")
    p.add_argument("--octaves", type=int, default=6)
    p.add_argument("--ranks", default="1,2,4", help="world sizes, comma-separated")
    p.add_argument("--k", type=int, default=MESH_K, help="K of the slope")
    a = p.parse_args(argv)
    from gpgpuraytrace_tpu_torch.cli import _parse_size

    device = bench_device(a.device)
    height, width = _parse_size(a.size)
    cfg = bench_config(height, width, a.octaves)
    ok = True
    for n in (int(x) for x in a.ranks.split(",")):
        for r in range(n):
            record = band_record(cfg, r, n, max(a.k, 2), device)
            print(json.dumps(record), flush=True)
            ok = ok and (record["graph_check"] is None or record["graph_check"]["ok"])
    print(json.dumps({"device": device_info(device)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
