"""Serving frame and training step times of checkouts of the port, in turns,
on one NVIDIA GPU.

    python scripts/torch_tree_ab.py --tree parent=DIR --tree new=DIR [--rounds 2]
        [--out build/ab/tree_ab.json]

Each tree is a checkout of the repository (``git archive`` of a commit,
unpacked). For each round the trees take turns (in order, then reversed), and
each turn is a fresh Python process in that tree's root, which builds or
loads its own kernels and times, on both terrains at 512x512 with 6 octaves
under the default config, what chip_smoke.py's phases 7, 9, 12, 14 and 21
time: a serving frame (``render`` under ``torch.no_grad()``) and a training
step (``ops.fit.fit_step``, Adam, from a perturbed scene), each the median of
10 calls by CUDA events after a warm-up; and the flythrough's frames per
second without writing (``fly_frames``, 8 frames in batches of 4, host
clock, the median of 5 after a warm-up; heightfield); and the host time per
``trace_frame`` call of the coarse and the fine pass (the least of 5 runs of
200 calls enqueued after a synchronisation, host clock). One process per tree runs first
to build its kernels. Prints one JSON line per turn and writes
them all to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, statistics, time
import torch
from gpgpuraytrace_tpu_torch import RenderConfig, default_scene, render
from gpgpuraytrace_tpu_torch.ops import fit as fitmod
from gpgpuraytrace_tpu_torch.ops.flythrough import fly_frames


def median_ms(fn, n=10):
    fn()
    out = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


res = {}
serve = torch.no_grad()(render)
for terrain, vol in (("heightfield", False), ("volumetric", True)):
    scene = default_scene(6, volumetric=vol, device="cuda")
    cfg = RenderConfig(num_octaves=6, volumetric=vol)
    target = serve(scene, cfg)
    start = fitmod.perturb_scene(scene, torch.Generator().manual_seed(0), rel=0.15)
    opt = fitmod.make_optimizer(fitmod.partition_scene(start), 5e-3)
    res[terrain] = {"frame_ms": median_ms(lambda: serve(scene, cfg)),
                    "step_ms": median_ms(lambda: fitmod.fit_step(start, cfg, target, opt))}


def fly_fps(scene, cfg):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = sum(1 for _ in fly_frames(scene, cfg, 8, batch=4))
    return n / (time.perf_counter() - t0)


scene, cfg = default_scene(6, device="cuda"), RenderConfig(num_octaves=6)
fly_fps(scene, cfg)
res["fly_fps"] = statistics.median(fly_fps(scene, cfg) for _ in range(5))


def launch_host_us(*args, n=200, reps=5):
    for _ in range(10):
        trace_frame(*args)
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            trace_frame(*args)
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * best / n


from gpgpuraytrace_tpu_torch.kernels.trace import _prime_map, trace_frame
from gpgpuraytrace_tpu_torch.ops.march import coarse_prime_cfg
try:  # a tree with the pack kernel packs CUDA scenes there
    from gpgpuraytrace_tpu_torch.kernels.pack import pack_scene
except ImportError:
    from gpgpuraytrace_tpu_torch.utils.packing import pack_scene

with torch.no_grad():
    packed, seed = pack_scene(scene, 512, 512, 0.0)
    ccfg = coarse_prime_cfg(cfg)
    cpacked, cseed = pack_scene(scene, ccfg.height, ccfg.width, -1.0)
    res["launch_host_us"] = {
        "coarse": launch_host_us(cpacked, cseed, ccfg, 66),
        "fine": launch_host_us(packed, seed, cfg, 512, _prime_map(scene, cfg, 0.0, 512))}
print(json.dumps(res))
"""


def run(tree: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"{tree}: exited {proc.returncode}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True, help="name=checkout directory")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default="build/ab/tree_ab.json")
    args = ap.parse_args()
    trees = {k: Path(v).resolve() for k, v in (t.split("=", 1) for t in args.tree)}
    for tree in trees.values():  # build each tree's kernels
        run(tree)
    order = list(trees)
    turns = []
    for r in range(args.rounds):
        for name in (order + order[::-1]) if r % 2 == 0 else (order[::-1] + order):
            turns.append({"tree": name, "round": r, **run(trees[name])})
            print(json.dumps(turns[-1]), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(turns, indent=1))


if __name__ == "__main__":
    main()
