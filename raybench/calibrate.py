"""Readings of a cell's compared numbers over many seeds in one process, for
setting its limits: sound runs of the program, its lower-precision control
(``march_bf16``), and the faults a test plants. One JSON line per run, then
a summary of each number: the largest sound reading and the smallest of each
other arm.

    python3 -m raybench.calibrate --workload fit512 --seeds 1-12 \\
        --arms sound,control@1-3,fault:unchanged@1-3 --seconds 1

A cell on several cards runs in one process per card, as ``raybench.run``
does; a run that fails there stops the job.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


from raybench import core, run  # noqa: E402


def seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi) + 1)) if hi else [int(lo)]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="e.g. 1-12,40")
    p.add_argument("--arms", default="sound,control",
                   help="comma-separated; arm@lo-hi runs that arm on its own seeds")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--override", default="{}")
    p.add_argument("--seed-offset", type=int, default=0,
                   help="added to every seed (large seeds, as the driver draws)")
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    cell = core.load_cell(a.workload)
    shared = ["--workload", a.workload, "--seeds", a.seeds, "--arms", a.arms, "--seconds",
              str(a.seconds), "--device", a.device, "--override", a.override,
              "--seed-offset", str(a.seed_offset)]
    group = run.join_group(a, cell, "raybench.calibrate", shared)
    world = group.world
    override = json.loads(a.override)
    readings: dict = {}
    for spec in a.arms.split(","):
        arm, _, own = spec.partition("@")
        for s in seeds(own or a.seeds):
            seed = s + a.seed_offset
            fault = arm.split(":", 1)[1] if arm.startswith("fault:") else None
            ctx = core.Context(cell, seed, a.seconds, False, group.device, a.rank, world,
                               control=arm == "control",
                               fault=fault, render=override.get("render", {}),
                               traffic=override.get("traffic", {}), store=group.store)
            t0 = time.perf_counter()
            try:
                part = core.run_rank(ctx, t0, log=lambda m: None)
            except Exception as e:  # a run that fails gives no reading; report and go on
                if world > 1:
                    raise
                print(json.dumps({"arm": arm, "seed": seed, "error": repr(e)}), flush=True)
                continue
            if a.rank != 0:
                continue
            vals = {c.name: c.value for c in part["checks"]}
            for k, v in vals.items():
                readings.setdefault(arm, {}).setdefault(k, []).append(v)
            print(json.dumps({"arm": arm, "seed": seed, "checks": vals,
                              "details": part["details"],
                              "measured": part["measured"], "setup_s": part["setup_s"],
                              "seconds": time.perf_counter() - t0}), flush=True)
    _, rc = run.finish_group(group, {})
    if a.rank != 0 or rc:
        return rc
    summary = {arm: {k: (max(v) if arm == "sound" else min(v)) for k, v in nums.items()}
               for arm, nums in readings.items()}
    print(json.dumps({"summary": summary, "counts": {arm: len(next(iter(n.values())))
                                                       for arm, n in readings.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
