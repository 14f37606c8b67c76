"""Helpers of the benchmark's own tests: toy-size runs of a cell on the CPU
(the port's plain versions of its kernels), the harness's look for a card
skipped."""

from __future__ import annotations

import json

import pytest
import torch

from raybench import core

# Toy sizes: a whole number of 8-pixel coarse cells, and of 4-row bands over
# two ranks for the row-band cell.
TOY = {
    "fit512": {"render": {"height": 32, "width": 32, "max_steps": 32}},
    "fly1080": {"render": {"height": 32, "width": 48, "max_steps": 32}},
    "fit4k.x4": {"render": {"height": 32, "width": 48, "max_steps": 32},
                 "traffic": {"ref_block_rows": 8}},
}


def toy_run(cell: str, seed: int = 3, control: bool = False, fault: str | None = None,
            seconds: float = 0.05) -> dict:
    """One rank's set-up, window and comparison of ``cell`` at its toy size on
    the CPU: what ``raybench.run`` computes past its look for a card."""
    over = TOY[cell]
    ctx = core.Context(core.load_cell(cell), seed, seconds, False, torch.device("cpu"),
                       control=control, fault=fault, render=over.get("render", {}),
                       traffic=over.get("traffic", {}))
    return core.run_rank(ctx, 0.0, log=lambda m: None)


def correct(part: dict) -> bool:
    return all(c.ok for c in part["checks"]) and bool(part["checks"])


def run_json(args: list, cwd, env=None, timeout: float = 600) -> tuple[int, dict | None, str]:
    """``python -m raybench.run *args`` in ``cwd``: (exit code, result or
    None, standard error)."""
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, "-m", "raybench.run", *args], cwd=str(cwd),
                          capture_output=True, text=True, timeout=timeout, env=env)
    lines = proc.stdout.strip().splitlines()
    out = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    return proc.returncode, out, proc.stderr


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)
