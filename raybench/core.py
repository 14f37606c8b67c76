"""The harness: finds a cell's configuration, traffic, driver, limits and
per-layer readers by name, runs set-up, the window and the comparison, and
builds the result line.

A cell (``BENCHMARK.json``'s ``workloads`` entry) names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<traffic>.json``,
whose ``entry`` names the driver ``drivers/<entry>.py`` that runs it); its
comparison limits are ``limits/<cell>.json``; each per-layer metric that
lists the cell is read by ``metrics/<metric>.py``. A later cell is new files
and new entries, with no edit to these.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import random
import subprocess
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gpgpuraytrace_tpu")


def root() -> Path:
    """The checkout's root: the directory that holds ``BENCHMARK.json``."""
    return PKG.parent


def manifest() -> dict:
    with open(root() / "BENCHMARK.json") as fh:
        return json.load(fh)


def load_module(path: Path):
    """A module from a file by path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"raybench_{path.parent.name}_"
                                                  f"{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclasses.dataclass
class Cell:
    """Everything one cell runs with, found by name."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    metrics: list  # BENCHMARK.json entries of the per-layer metrics of this cell
    end_to_end: list

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def driver(self):
        return load_module(PKG / "drivers" / f"{self.traffic['entry']}.py")


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = manifest() if bench is None else bench
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"raybench: no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(root() / configs[entry["config"]]["file"])
    traffic = read_json(PKG / "traffic" / f"{entry['traffic']}.json")
    limits = read_json(PKG / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    return Cell(name, entry, config, traffic, limits, per_layer, e2e)


@dataclasses.dataclass
class Context:
    """What a driver runs with. ``render`` and ``traffic`` may be overridden
    (the tests run toy sizes on the CPU); ``control`` runs the program's
    lower-precision path (``march_bf16``); ``fault`` names a fault planted
    for the tests."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    rank: int = 0
    world: int = 1
    control: bool = False
    fault: str | None = None
    render: dict = dataclasses.field(default_factory=dict)
    traffic: dict = dataclasses.field(default_factory=dict)
    trace_path: str = ""
    store: object = None  # the process group's store, on several cards
    log: object = None  # set by run_rank: where set-up's phases are reported

    def __post_init__(self):
        self.render = {**self.cell.config["render"], **self.render}
        self.traffic = {**self.cell.traffic, **self.traffic}

    @property
    def scene_values(self) -> dict:
        return self.cell.config["scene"]

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Report how long a phase of set-up took (to the card's finish)."""
        t0 = time.perf_counter()
        yield
        self.sync()
        if self.log:
            self.log(f"set-up: {name} {time.perf_counter() - t0:.3f} s")


@dataclasses.dataclass
class Check:
    """A number compared with its limit: the run is correct where every
    value is at most its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def judge(values: dict, limits: dict) -> list:
    """``Check``s of the computed ``values`` against the cell's limits: each
    number has its limit, and each limit its number."""
    values = {k: v for k, v in values.items() if k != "details"}
    if set(values) != set(limits):
        raise RuntimeError(f"readings {sorted(values)} against limits {sorted(limits)}")
    return [Check(k, float(v), float(limits[k])) for k, v in values.items()]


class Reservoir:
    """A uniform sample of ``k`` items of a stream, drawn from ``seed``."""

    def __init__(self, k: int, seed: int):
        self.k, self.n, self.items = k, 0, []
        self.rng = random.Random(seed)

    def offer(self, item) -> None:
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.n)
            if j < self.k:
                self.items[j] = item


def p95(values) -> float:
    """The 95th percentile by nearest rank: the least value with at least
    95% of the values at or below it."""
    xs = sorted(values)
    return xs[max(0, math.ceil(0.95 * len(xs)) - 1)]


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one the run may not hold."""
    import sys

    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def card_lines(device: torch.device) -> list:
    """The card's name, power limit and SM clock (nvidia-smi), as lines."""
    lines = [f"card: {torch.cuda.get_device_name(device)}"]
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}",
             "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        lines.append(f"nvidia-smi (name, power limit, SM clock, max SM clock, draw): "
                     f"{out.stdout.strip() or out.stderr.strip()}")
    except (OSError, subprocess.SubprocessError) as e:
        lines.append(f"nvidia-smi: {e}")
    return lines


def run_rank(ctx: Context, t_start: float, log=print) -> dict:
    """Set-up, window and comparison of one rank: its part of the result."""
    ctx.log = log
    drv = ctx.cell.driver()
    run = drv.Run(ctx)
    log(f"set-up: {time.perf_counter() - t_start:.3f} s to the driver (imports, CUDA)")
    run.setup()
    ctx.sync()
    if ctx.world > 1:
        torch.distributed.barrier()
    setup_s = time.perf_counter() - t_start
    if ctx.device.type == "cuda":
        for line in card_lines(ctx.device):
            log(f"before the window: {line}")
    measured = run.window()
    ctx.sync()
    if ctx.device.type == "cuda":
        for line in card_lines(ctx.device):
            log(f"after the window: {line}")
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    part = {"setup_s": setup_s, "measured": measured, "peak": peak,
            "attempted": run.attempted, "failed": run.failed}
    if ctx.trace:
        from raybench.tracing import load_profile

        path = run.tracer.export()
        part["profile"] = load_profile(path, run.tracer.units, run.work()).to_json()
    run.release()
    t0 = time.perf_counter()
    part["checks"] = run.check()
    part["details"] = getattr(run, "details", None)
    log(f"the comparison took {time.perf_counter() - t0:.3f} s")
    return part
