"""A later cell, mix, configuration or metric is new files and new entries in
BENCHMARK.json alone; and the command refuses to run where it must."""

from __future__ import annotations

import json
import os
import shutil

from raybench import core
from raybench.tests.conftest import run_json

TOY = json.dumps({"render": {"height": 32, "width": 32, "max_steps": 32}})


def checkout(tmp_path, with_port: bool):
    """A copy of BENCHMARK.json and the benchmark's files (and the port's
    package on the path when ``with_port``): (root, environment)."""
    shutil.copytree(core.PKG, tmp_path / "raybench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(core.root() / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    if with_port:
        env["PYTHONPATH"] = str(core.root())
    return tmp_path, env


def test_new_cell_traffic_config_and_metric_as_files_alone(tmp_path):
    root, env = checkout(tmp_path, with_port=True)
    before = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    config = json.loads((root / "raybench/configs/terrain6-512.json").read_text())
    config.update(name="terrain6-256", render={**config["render"], "height": 256,
                                               "width": 256})
    (root / "raybench/configs/terrain6-256.json").write_text(json.dumps(config))
    traffic = json.loads((root / "raybench/traffic/fly.json").read_text())
    (root / "raybench/traffic/fly-b2.json").write_text(json.dumps({**traffic, "batch": 2}))
    (root / "raybench/limits/fly256.b2.json").write_text(
        (root / "raybench/limits/fly1080.json").read_text())
    (root / "raybench/metrics/frames_per_batch.py").write_text(
        "def read(profiles):\n    return 2.0\n")
    bench["configs"].append({"name": "terrain6-256", "source": config["source"],
                             "file": "raybench/configs/terrain6-256.json", "reduced": [],
                             "why": "a smaller frame"})
    bench["workloads"].append({"name": "fly256.b2", "config": "terrain6-256",
                               "traffic": "fly-b2", "chips": 1, "why": "batches of 2"})
    for m in bench["end_to_end"]:
        if m["name"] in ("frames_per_s", "frame_ms_p95"):
            m["workloads"].append("fly256.b2")
    bench["per_layer"].append({"name": "frames_per_batch", "unit": "frames", "better":
                               "higher", "source": "program_counter", "layer": "fly batch",
                               "moves": "frames_per_s", "workloads": ["fly256.b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}
    edited = {p for p in before if p in after and before[p] != after[p]}
    assert edited == {root.joinpath("BENCHMARK.json").relative_to(root)}
    rc, out, err = run_json(["--workload", "fly256.b2", "--seed", "2147483990", "--seconds",
                             "0.05", "--device", "cpu", "--override", TOY], root, env)
    assert rc == 0 and out["correct"], err[-3000:]
    assert set(out["metrics"]) == {"frames_per_s", "frame_ms_p95", "setup_s"}
    assert out["attempted"] % 2 == 0


def test_refuses_without_the_port(tmp_path):
    root, env = checkout(tmp_path, with_port=False)
    for device in ("cuda", "cpu"):
        rc, out, _ = run_json(["--workload", "fit512", "--seed", "1", "--seconds", "0.05",
                               "--device", device, "--override", TOY], root, env)
        assert rc != 0 and out is None


def test_refuses_without_a_card():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc, out, err = run_json(["--workload", "fit512", "--seed", "1", "--seconds", "1"],
                            core.root())
    assert rc == 2 and out is None and "needs 1 CUDA card" in err
