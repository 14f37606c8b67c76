"""Run one cell of the benchmark and print its result as the last line of
standard output:

    python3 -m raybench.run --workload fit512 --seed 1 --seconds 10 --trace 0

With ``--trace 0`` the metrics are the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read from a profiled stretch of the
window. The last lines of standard error, and the result's ``checks``, give
each number compared against the reference beside its limit. A cell on
several cards starts one process per card (this one is rank 0).

Exits non-zero, printing no result, without enough CUDA cards, when the
port or this package's files are missing, when a rank it started exits
non-zero, or when this process or any rank holds JAX or the JAX package
once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import datetime  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

import torch  # noqa: E402

from raybench import core  # noqa: E402

CHILD_WAIT_S = 120.0


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # Set by rank 0 for the processes it starts, and by the tests.
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--control", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    p.add_argument("--override", default="{}", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def setup_env() -> None:
    """Kernel caches at fixed paths inside the checkout."""
    cache = core.root() / "build" / "raybench-cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(module: str, argv: list, world: int, port: int) -> list:
    """Start ranks 1 .. world-1 as processes of ``python -m module argv``."""
    procs = []
    for r in range(1, world):
        cmd = [sys.executable, "-m", module, *argv, "--rank", str(r), "--world", str(world),
               "--port", str(port)]
        procs.append(subprocess.Popen(cmd, cwd=str(core.root()), stdout=subprocess.DEVNULL))
    return procs


def child_argv(a) -> list:
    """The arguments every rank shares."""
    argv = ["--workload", a.workload, "--seed", str(a.seed), "--seconds", str(a.seconds),
            "--trace", str(a.trace), "--device", a.device, "--override", a.override]
    if a.control:
        argv.append("--control")
    if a.fault:
        argv += ["--fault", a.fault]
    return argv


def watch(procs: list) -> threading.Event:
    """End this process if a rank it started fails while the ranks still
    meet in collectives (the others would wait on it there). Setting the
    returned event ends the watch."""
    over = threading.Event()

    def loop():
        while not over.is_set():
            for p in procs:
                rc = p.poll()
                if rc not in (None, 0):
                    log(f"raybench: a rank exited with code {rc}; stopping the job")
                    for q in procs:
                        if q.poll() is None:
                            q.kill()
                    os._exit(1)
            if all(p.poll() is not None for p in procs):
                return
            time.sleep(0.2)

    threading.Thread(target=loop, daemon=True).start()
    return over


def stop(procs: list) -> int:
    """Wait for the ranks this process started (killing any that outlast
    ``CHILD_WAIT_S``): 0 where every one exited with 0."""
    deadline = time.monotonic() + CHILD_WAIT_S
    worst = 0
    for p in procs:
        try:
            rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rc = -9
        worst = worst or rc
    return worst


def per_layer(cell, parts: list) -> dict:
    """Each per-layer metric of the cell that its reader finds."""
    from raybench.tracing import Profile

    profiles = [Profile(**p["profile"]) for p in parts]
    out = {}
    for m in cell.metrics:
        reader = core.load_module(core.PKG / "metrics" / f"{m['name']}.py")
        value = reader.read(profiles)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result(cell, parts: list, trace: bool, device: torch.device) -> dict:
    rank0 = parts[0]
    checks = [c for p in parts for c in p["checks"]]
    correct = all(c.ok for c in checks) and bool(checks)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": len(parts), "memory_peak_bytes": max(p["peak"] for p in parts)}
    out = {"correct": correct, "attempted": rank0["attempted"],
           "failed": sum(p["failed"] for p in parts)}
    if trace:
        from raybench.tracing import Profile, breakdown

        profiles = [Profile(**p["profile"]) for p in parts]
        out["metrics"] = per_layer(cell, parts)
        dev["busy_s"] = sum(p.busy_s() for p in profiles) / len(profiles)
        dev["window_s"] = sum(p.window_s for p in profiles) / len(profiles)
        out["device"] = dev
        out["breakdown"] = breakdown(profiles)
    else:
        metrics = {}
        for m in cell.end_to_end:
            v = rank0["setup_s"] if m["name"] == "setup_s" else rank0["measured"][m["name"]]
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        out["metrics"] = metrics
        out["device"] = dev
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return out


@dataclasses.dataclass
class Group:
    """This process's place in a cell: its device, the world size, the
    process group's store (None on one card), the rank processes it started
    and the event that ends their watch."""

    device: torch.device
    world: int
    store: object = None
    procs: list = dataclasses.field(default_factory=list)
    watching: threading.Event | None = None


def join_group(a, cell, module: str, argv: list) -> Group:
    """A cell on several cards starts one process per card (this one is rank
    0) and joins them in one process group (NCCL; gloo on the CPU) over a
    TCP store that rank 0 serves."""
    device = torch.device(a.device)
    world = a.world or cell.chips
    if world == 1:
        if device.type == "cuda":
            device = torch.device("cuda", 0)
            torch.cuda.set_device(device)
        return Group(device, world)
    import torch.distributed as dist

    group = Group(device, world)
    port = a.port
    if a.rank == 0:
        port = free_port()
        group.procs = start_ranks(module, argv, world, port)
        group.watching = watch(group.procs)
    if device.type == "cuda":
        group.device = torch.device("cuda", a.rank)
        torch.cuda.set_device(group.device)
    timeout = datetime.timedelta(seconds=300)
    group.store = dist.TCPStore("127.0.0.1", port, world, a.rank == 0, timeout=timeout)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", store=group.store,
                            world_size=world, rank=a.rank, timeout=timeout)
    return group


def finish_group(group: Group, part: dict) -> tuple[list, int]:
    """Every rank's part (gathered on each), then the group destroyed and
    the started ranks waited for: (parts, 0 or a started rank's non-zero
    exit code)."""
    if group.world == 1:
        return [part], 0
    import torch.distributed as dist

    parts = [None] * group.world
    dist.all_gather_object(parts, part)
    if group.watching is not None:
        group.watching.set()
    dist.destroy_process_group()
    return parts, stop(group.procs)


def plant_held(a) -> None:
    """The tests' fault ``held_on_rank1``: rank 1 holds a module named
    ``jax`` once the window has closed."""
    if a.fault == "held_on_rank1" and a.rank == 1:
        import types

        sys.modules.setdefault("jax", types.ModuleType("jax"))


def main(argv=None) -> int:
    a = parse(argv)
    setup_env()
    bench = core.manifest()
    cell = core.load_cell(a.workload, bench)
    if a.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            log(f"raybench: {a.workload} needs {cell.chips} CUDA card(s); this machine has {n}")
            return 2
    group = join_group(a, cell, "raybench.run", child_argv(a))
    override = json.loads(a.override)
    ctx = core.Context(cell, a.seed, a.seconds, bool(a.trace), group.device, a.rank,
                       group.world, a.control, a.fault, override.get("render", {}),
                       override.get("traffic", {}),
                       str(core.root() / "build" / "raybench" /
                           f"trace-{a.workload}-rank{a.rank}.json"), store=group.store)
    part = core.run_rank(ctx, T_START, log)
    plant_held(a)
    part["held"] = core.forbidden_modules()
    parts, rc = finish_group(group, part)
    held = sorted({m for p in parts for m in p["held"]})
    if held:
        log(f"raybench: rank {a.rank} sees {held} held after the window "
            f"(by rank: {[p['held'] for p in parts]})")
        return 3
    if rc:
        log(f"raybench: a rank exited with code {rc}")
        return 3
    if a.rank != 0:
        return 0
    out = result(cell, parts, bool(a.trace), group.device)
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
