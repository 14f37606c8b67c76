"""Bring-up of one rank, and a local job of several CPU processes
(counterpart of ``gpgpuraytrace_tpu/parallel/launch.py``).

``distributed_context()`` brings this process's rank up from the
environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``)
and tears it down after; it does nothing in a single-process run, so the
same program runs alone or as one rank of many. ``launch_local_processes``
starts N processes on localhost as one job, on a free port, each told its
``LOCAL_RANK`` (on the card, rank r runs on card r). Run a 2-rank job of
``parallel/worker.py`` on two cards, or on the CPU over gloo:

    python -m gpgpuraytrace_tpu_torch.parallel.launch --num-processes 2
    python -m gpgpuraytrace_tpu_torch.parallel.launch --num-processes 2 --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch.distributed as dist

from gpgpuraytrace_tpu_torch.parallel.mesh import initialize_distributed, world

REPO = Path(__file__).resolve().parents[2]
TIMEOUT_S = 600.0


@contextlib.contextmanager
def distributed_context(device="cuda", world_size: int | None = None):
    """Join the process group described by the environment for the body
    (``mesh.initialize_distributed``) and destroy it after, if this call
    made it. Yields (rank, world size): (0, 1) for a single process. A
    ``world_size`` given joins a group of that size even when it is 1 (a
    launched job of one rank)."""
    made = initialize_distributed(device, world_size=world_size)
    try:
        yield world()
    finally:
        if made:
            dist.destroy_process_group()


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago (bound to port 0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local_processes(module: str, num_processes: int = 2, args=(),
                           timeout_s: float = TIMEOUT_S) -> list[str]:
    """Run ``python -m module *args`` as ``num_processes`` ranks of one job on
    localhost: each gets ``MASTER_ADDR``/``MASTER_PORT`` (a free port),
    ``RANK``, ``LOCAL_RANK`` and ``WORLD_SIZE``. Returns each rank's output
    (stdout and stderr). Raises ``RuntimeError`` if any rank exits non-zero
    or the job outlasts ``timeout_s``; the other ranks are killed then, as
    they would wait on the lost one."""
    port = free_port()
    procs, logs = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for rank in range(num_processes):
            env = dict(os.environ)
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                       LOCAL_RANK=str(rank), WORLD_SIZE=str(num_processes),
                       PYTHONPATH=os.pathsep.join(filter(None, (str(REPO),
                                                                env.get("PYTHONPATH")))))
            log = open(os.path.join(tmp, f"rank{rank}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen([sys.executable, "-m", module, *args], env=env,
                                          stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            failed = any(p.poll() not in (None, 0) for p in procs)
            if failed or time.monotonic() > deadline:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                for p in procs:
                    p.wait()
                break
            time.sleep(0.05)
        outputs = []
        for log in logs:
            log.seek(0)
            outputs.append(log.read())
            log.close()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        msgs = "\n".join(f"[rank {r} rc={rc}]\n{outputs[r][-2000:]}" for r, rc in bad)
        raise RuntimeError(f"{len(bad)} rank(s) failed:\n{msgs}")
    return outputs


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="a local job of parallel/worker.py")
    p.add_argument("--num-processes", type=int, default=2)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda: rank r on card r over NCCL; cpu: gloo")
    p.add_argument("worker_args", nargs="*",
                   help="more arguments for the worker (after --)")
    a = p.parse_args(argv)
    outputs = launch_local_processes("gpgpuraytrace_tpu_torch.parallel.worker",
                                     a.num_processes, ["--device", a.device, *a.worker_args])
    for out in outputs:
        print(out.strip())


if __name__ == "__main__":
    main()
