"""Flythrough frames per second of checkouts of the port, in turns, on one
NVIDIA GPU.

    python scripts/torch_fly_ab.py --tree parent=DIR --tree new=DIR [--rounds 2]
        [--out build/ab/fly_ab.json]

Each tree is a checkout of the repository (``git archive`` of a commit,
unpacked). For each round the trees take turns (in order, then reversed), and
each turn is a fresh Python process in that tree's root, which builds or
loads its own kernels and times ``fly_frames`` without writing (host clock,
FRAMES frames, the median of REPS calls after a warm-up) on the heightfield
with 6 octaves under the default config, at 512x512 and 1920x1080, in
batches of 1, 4 and 8: "per call" is a fresh ``fly_frames`` call each time,
as a user makes one (on a tree with ``ops/flythrough.py:FlyBatch`` its
warm-up batch and its graph's capture included); "kept" (only on such a
tree) hands every call one ``FlyBatch`` warmed up before, so every timed
batch replays its graph. One process per tree runs first to build its kernels.
Prints one JSON line per turn and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import dataclasses, json, statistics, time
import torch
from gpgpuraytrace_tpu_torch import RenderConfig, default_scene
from gpgpuraytrace_tpu_torch.ops import flythrough

FRAMES, REPS = 24, 3
scene = default_scene(6, device="cuda")
base = RenderConfig(num_octaves=6)
graph = hasattr(flythrough, "FlyBatch")


def fps(cfg, b, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in flythrough.fly_frames(scene, cfg, FRAMES, batch=b, **kw):
        pass
    return FRAMES / (time.perf_counter() - t0)


res = {"graph": graph}
for size in ((512, 512), (1080, 1920)):
    cfg = dataclasses.replace(base, height=size[0], width=size[1])
    for b in (1, 4, 8):
        key = f"{size[1]}x{size[0]} batch {b}"
        fps(cfg, b)
        row = {"per_call": statistics.median(fps(cfg, b) for _ in range(REPS))}
        if graph:
            program = flythrough.FlyBatch(scene, cfg, b)
            fps(cfg, b, program=program)
            row["kept"] = statistics.median(fps(cfg, b, program=program) for _ in range(REPS))
        res[key] = row
print(json.dumps(res))
"""


def run(tree: Path, child: str) -> dict:
    """The last line of ``child``'s output as JSON, run in a fresh process in
    ``tree``'s root."""
    proc = subprocess.run([sys.executable, "-c", child], cwd=tree, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"{tree}: exited {proc.returncode}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(child: str = CHILD, out: str = "build/ab/fly_ab.json", doc: str = __doc__) -> None:
    """Parse ``--tree``, ``--rounds`` and ``--out`` (default ``out``), run
    ``child`` once in each tree (its kernels' build), then in turns."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True, help="name=checkout directory")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=out)
    args = ap.parse_args()
    trees = {k: Path(v).resolve() for k, v in (t.split("=", 1) for t in args.tree)}
    for tree in trees.values():  # build each tree's kernels
        run(tree, child)
    order = list(trees)
    turns = []
    for r in range(args.rounds):
        for name in (order + order[::-1]) if r % 2 == 0 else (order[::-1] + order):
            turns.append({"tree": name, "round": r, **run(trees[name], child)})
            print(json.dumps(turns[-1]), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(turns, indent=1))


if __name__ == "__main__":
    main()
