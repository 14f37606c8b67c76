"""Host time of a fly batch before its frames are waited for, in checkouts of
the port, in turns, on one NVIDIA GPU.

    python scripts/torch_fly_host.py --tree parent=DIR --tree new=DIR [--rounds 2]
        [--out build/ab/fly_host.json]

Each tree is a checkout of the repository (``git archive`` of a commit,
unpacked) with ``ops/flythrough.py:FlyBatch``. For each round the trees take
turns (in order, then reversed), each turn a fresh Python process in that
tree's root (``torch_fly_ab.py:main``, whose first, untimed turn in each
tree builds its kernels). A turn keeps one ``FlyBatch`` of ``b`` frames at
1920x1080 (6 octaves, the default config), b in 1, 4 and 8, warmed up and
captured, and times REPS batches on the host clock, no
profiler: each from a synchronised start, as ``fly_frames`` finds the card
after the frames before, with the fBm amplitudes edited in place every 8th
batch as the ``fly1080`` cell edits them. ``load_us``: the load of the
caller's scene and times (``FlyBatch.load``, or ``_load`` in a tree from
before it); ``replay_us``: the graph's launch (``CapturedProgram``'s call);
``frames_us``: ``FlyBatch.frames``, both of them with their span; ``batch_ms``:
``host_frames`` to the frames on the host; ``split_load_us``: the same load
as the plain copy split by dtype, which the load kernel was weighed against
(the float32 leaves in one ``_foreach_copy_``, the int32 seed on its own,
the times through pinned memory; its private leaves checked bit for bit
once). Medians and 90th percentiles. ``device_ops``: the device kernels and
copies one call of each load enqueues (the profiler, over 5 calls). Prints
one JSON line per turn and writes them all to ``--out``.
"""

from __future__ import annotations

import torch_fly_ab

CHILD = r"""
import json, operator, statistics, time
import torch
from torch.profiler import ProfilerActivity, profile
from gpgpuraytrace_tpu_torch import RenderConfig, default_scene
from gpgpuraytrace_tpu_torch.ops.flythrough import FlyBatch
from gpgpuraytrace_tpu_torch.utils.convert import LEAF_NAMES

REPS = 200
scene = default_scene(6, device="cuda")
cfg = RenderConfig(num_octaves=6, height=1080, width=1920)
base = scene.noise.amplitudes.detach().clone()
clock = time.perf_counter


def times(k, b):
    return torch.arange(k * b, k * b + b, dtype=torch.float32) / 30.0


def stats(xs, scale):
    xs = sorted(scale * x for x in xs)
    return {"median": statistics.median(xs), "p90": xs[int(0.9 * (len(xs) - 1))]}


GET = [operator.attrgetter(n) for n in LEAF_NAMES]


def split_loader(program):  # the load as the plain copy split by dtype
    dst = [get(program.scene) for get in GET]
    floats = [k for k, x in enumerate(dst) if x.dtype == torch.float32]
    rest = [k for k in range(len(dst)) if k not in floats]
    fdst = [dst[k] for k in floats]

    def load(scene, t):
        with torch.no_grad():
            src = [get(scene).detach() for get in GET]
            torch._foreach_copy_(fdst, [src[k] for k in floats])
            for k in rest:
                dst[k].copy_(src[k])
            program.times.copy_(t.pin_memory(), non_blocking=True)

    return load


def device_ops(fn):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 5


res = {"device": torch.cuda.get_device_name(0)}
for b in (1, 4, 8):
    program = FlyBatch(scene, cfg, b)
    load = getattr(program, "load", None) or program._load
    split = split_loader(program)
    for k in range(3):  # the warm-up, the capture, a replay
        program.host_frames(scene, times(k, b), b)
    other = default_scene(6, device="cuda")
    with torch.no_grad():
        for x in other.parameters():
            x.mul_(1.03)
    split(other, times(5, b))
    torch.cuda.synchronize()
    want = [get(other).detach() for get in GET] + [times(5, b).cuda()]
    got = [get(program.scene).detach() for get in GET] + [program.times]
    assert all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(got, want))
    ops = {"load": device_ops(lambda: load(scene, times(0, b))),
           "split_load": device_ops(lambda: split(scene, times(0, b)))}
    got = {"load_us": [], "split_load_us": [], "replay_us": [], "frames_us": [], "batch_ms": []}
    for k in range(REPS):
        if k % 8 == 0:
            with torch.no_grad():
                scene.noise.amplitudes.copy_(base * (1.0 + 0.05 * ((k // 8) % 3 - 1)))
        t = times(k, b)
        torch.cuda.synchronize()
        t0 = clock()
        load(scene, t)
        t1 = clock()
        program.program()
        t2 = clock()
        torch.cuda.synchronize()
        t3 = clock()
        program.frames(scene, t)
        t4 = clock()
        torch.cuda.synchronize()
        t5 = clock()
        program.host_frames(scene, t, b)
        t6 = clock()
        torch.cuda.synchronize()
        t7 = clock()
        split(scene, t)
        t8 = clock()
        got["load_us"].append(t1 - t0)
        got["split_load_us"].append(t8 - t7)
        got["replay_us"].append(t2 - t1)
        got["frames_us"].append(t4 - t3)
        got["batch_ms"].append(t6 - t5)
    res[f"1920x1080 batch {b}"] = {**{k: stats(v, 1e3 if k == "batch_ms" else 1e6)
                                      for k, v in got.items()}, "device_ops": ops}
print(json.dumps(res))
"""


if __name__ == "__main__":
    torch_fly_ab.main(CHILD, "build/ab/fly_host.json", __doc__)
