"""The port's benchmark (``gpgpuraytrace_tpu_torch/bench.py``) on the CPU,
where the kernel path runs the kernels' plain versions.

* One and two steps of the bench workload against the JAX package's
  ``bench.py:96-122``, built here as that file builds it (every float leaf
  trainable, ``mean(img * img)``, ``value_and_grad``, the salted
  ``fori_loop``, ``use_pallas=False``), at 64x64, 2 octaves, ``max_steps``
  32, on both of the port's paths. With tests/test_torch_bwd.py:133-145's
  tolerances: each leaf's gradient at rtol 2.5e-2 plus 1e-3 of the leaf's
  largest component (amplitudes at rtol 5e-3, atol 1e-5), the loss at rtol
  1e-4, and the accumulator (loss plus the sum of every gradient, per step)
  within the sum of those per-entry bounds.
* The slope, the lower middle and a measurement's run order, on fake times
  (``utils/timing.py``).
* The parity gate's comparison passes equal inputs and fails an image off by
  1e-2 or a gradient off by 1e-3; the gate itself on a small frame.
* ``step_check`` (one bench step of the kernel path against the plain
  path's) holds at 32x32 and fails against a scene with other amplitudes;
  ``failures`` reads the gate and the checks.
* ``cli bench --device cpu`` prints one JSON line with the reference's keys
  and none of its substitution keys; a failed gate or check exits 1; the
  CLI and ``python -m ...bench`` take K from one place.
* No fallback: ``--device cuda`` without a card raises, and so does
  ``run_bench_mesh(N)`` with fewer than N cards.
* The worker's timed mode on 2 gloo ranks, and ``run_bench_mesh(2)`` on
  gloo ranks, a job of one rank as a group of one.

``graph_check`` needs CUDA graphs: ``chip_smoke.py`` phase 29 runs it.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpgpuraytrace_tpu.models.scene import RenderConfig as JaxConfig
from gpgpuraytrace_tpu.models.scene import default_scene as jax_default_scene
from gpgpuraytrace_tpu.ops.fit import partition_scene as jax_partition_scene
from gpgpuraytrace_tpu.ops.render import render as jax_render
from gpgpuraytrace_tpu_torch import bench, cli
from gpgpuraytrace_tpu_torch.models.scene import RenderConfig, default_scene
from gpgpuraytrace_tpu_torch.parallel import launch
from gpgpuraytrace_tpu_torch.utils import timing
from gpgpuraytrace_tpu_torch.utils.convert import scene_from_numpy

torch.set_num_threads(2)

H, W, OCT, MAX_STEPS = 64, 64, 2, 32
SALT = 37.0
WORKER = "gpgpuraytrace_tpu_torch.parallel.worker"
REPO = launch.REPO
# bench.py's keys that say a value was recorded or substituted: the port's
# record never has them.
SUBSTITUTION_KEYS = {"headline_recorded", "baseline_recorded", "note", "status"}


def jax_scene_dict(scene):
    flat, _ = jax.tree_util.tree_flatten_with_path(scene)
    return {".".join(p.name for p in path): np.asarray(leaf) for path, leaf in flat}


@pytest.fixture(scope="module")
def jax_bench():
    """bench.py's workload in the JAX package: the accumulator of 1 and of 2
    salted steps, and step 0's loss and gradients by leaf name."""
    scene = jax_default_scene(num_octaves=OCT)
    cfg = JaxConfig(height=H, width=W, max_steps=MAX_STEPS, num_octaves=OCT, use_pallas=False)
    leaves, merge = jax_partition_scene(scene, trainable=lambda name: True)

    def loss(leaves):
        img = jax_render(merge(leaves), cfg)
        return jnp.mean(img * img)

    grad_fn = jax.value_and_grad(loss)

    @jax.jit
    def run(leaves, n, salt):
        def body(i, acc):
            eps = 1e-6 * (salt + i.astype(jnp.float32))
            v, g = grad_fn([leaf + eps for leaf in leaves])
            return acc + v + sum(jnp.sum(x) for x in jax.tree_util.tree_leaves(g))
        return jax.lax.fori_loop(0, n, body, jnp.float32(0.0))

    acc = {n: float(run(leaves, n, jnp.float32(SALT))) for n in (1, 2)}
    eps = 1e-6 * jnp.float32(SALT)
    v, g = jax.jit(grad_fn)([leaf + eps for leaf in leaves])
    grads = {n: x for n, x in jax_scene_dict(merge(g)).items() if n != "noise.seed"}
    return acc, float(v), grads, jax_scene_dict(scene)


def _entry_bound(name: str, ref: np.ndarray) -> np.ndarray:
    if name == "noise.amplitudes":
        return 1e-5 + 5e-3 * np.abs(ref)
    return 1e-3 * np.abs(ref).max() + 2.5e-2 * np.abs(ref)


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel_path", "plain_path"])
@pytest.mark.parametrize("n", [1, 2])
def test_bench_steps_match_jax(jax_bench, use_kernel, n):
    acc_ref, loss_ref, grads_ref, scene_dict = jax_bench
    scene = scene_from_numpy(scene_dict, device="cpu")
    cfg = RenderConfig(height=H, width=W, max_steps=MAX_STEPS, num_octaves=OCT,
                       use_kernel=use_kernel)
    steps = bench.bench_steps(scene, cfg)
    steps.salt.fill_(SALT)
    acc = steps.run(n).item()
    assert steps.step_i.item() == n
    # Step 0's parameters back, then its loss and gradients by name.
    steps.run(1)
    loss, grads = steps.loss_and_grads()
    names = [name for name, _ in scene.named_parameters()]
    assert sorted(names) == sorted(grads_ref)
    np.testing.assert_allclose(loss.item(), loss_ref, rtol=1e-4)
    bound = 1e-4 * abs(loss_ref)
    for name, g in zip(names, grads):
        ref = grads_ref[name]
        assert np.all(np.abs(g.numpy() - ref) <= _entry_bound(name, ref)), (name, g, ref)
        bound += _entry_bound(name, ref).sum()
    assert abs(acc - acc_ref[n]) <= n * bound, (acc, acc_ref[n], n * bound)


def test_slope_and_lower_middle():
    got = timing.slope(1.3, 0.1, 5, 100)
    assert got["ms_per_step"] == pytest.approx(300.0)
    assert got["rays_per_sec"] == pytest.approx(100 / 0.3)
    assert got["rays_per_sec_wall"] == pytest.approx(100 / (1.3 / 5))
    for t_k in (0.1, 0.05):  # no step time, or less: not clamped, raises
        with pytest.raises(ValueError, match="not positive"):
            timing.slope(t_k, 0.1, 5, 100)
    runs = [{"rays_per_sec": r} for r in (30.0, 10.0, 20.0)]
    assert timing.lower_middle(runs)["rays_per_sec"] == 20.0
    assert timing.lower_middle(runs + [{"rays_per_sec": 40.0}])["rays_per_sec"] == 20.0
    assert timing.lower_middle(runs[:1]) is runs[0]


def test_measure_takes_the_least_of_each():
    """A warm-up run of K, then T(K) and T(1) each the least of 3 runs, each
    run with its own salt (bench.py:163-165)."""
    calls = []
    fake = {(40, 100.0): 0.5, (40, 200.0): 0.45, (40, 300.0): 0.6,
            (1, 150.0): 0.03, (1, 250.0): 0.04, (1, 350.0): 0.05}

    def timed_run(n, salt):
        calls.append((n, salt))
        return fake.get((n, salt), 9.0)

    got = timing.measure(timed_run, 40, 1000)
    assert calls[0] == (40, 800.0) and len(calls) == 7
    assert len({salt for _, salt in calls}) == 7
    assert (got["t_k_s"], got["t_1_s"]) == (0.45, 0.03)
    assert got["ms_per_step"] == pytest.approx((0.45 - 0.03) / 39 * 1e3)


@pytest.mark.parametrize("n,sweep", [(1, [1]), (2, [1, 2]), (4, [1, 2, 4]), (6, [1, 2, 4, 6])])
def test_mesh_sweep(n, sweep):
    assert bench.mesh_sweep(n) == sweep


def _verdict_inputs():
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.random((16, 16, 3), dtype=np.float32))
    grads = {"noise.amplitudes": torch.from_numpy(rng.standard_normal(4).astype(np.float32)),
             "camera.yaw": torch.tensor(0.25)}
    return img, grads


def test_parity_verdict_passes_equal_and_fails_off_inputs():
    img, grads = _verdict_inputs()
    assert bench.parity_verdict("heightfield", img, img.clone(), grads, dict(grads)) == ""
    off = bench.parity_verdict("heightfield", img + 1e-2, img, grads, grads)
    assert "heightfield: image parity 0.0000" in off and "mean err" in off
    bad = dict(grads, **{"camera.yaw": grads["camera.yaw"] + 1e-3})
    got = bench.parity_verdict("volumetric", img, img, bad, grads)
    assert got.startswith("volumetric: camera.yaw kernel_bwd gradient off at 1 of 1")


def test_parity_gate(monkeypatch):
    assert bench.parity_gate(32, 2, "cpu") == "ok"
    monkeypatch.setattr(bench, "parity_check",
                        lambda volumetric, *a: "volumetric: off" if volumetric else "")
    assert bench.parity_gate(32, 2, "cpu") == "fail: volumetric: off"


def test_cli_bench_cpu_prints_one_json_line():
    # One intra-op thread in the child, as every test process here keeps to
    # two. With one per core (eight on an 8-core CPU) it oversubscribes the
    # suite's workers, and a step's time then swings several-fold between
    # runs (T(4) / T(1) read 1.64 to 9.27 under load, where 4 is right): a
    # burst during the T(1) runs makes the slope non-positive, and the
    # bench refuses it.
    proc = subprocess.run(
        [sys.executable, "-m", "gpgpuraytrace_tpu_torch.cli", "bench", "--device", "cpu",
         "--size", "32x16", "--octaves", "2", "--iters", "4"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert {"metric", "value", "unit", "vs_baseline", "detail", "backend", "parity",
            "device"} <= set(out)
    assert not SUBSTITUTION_KEYS & set(out)
    assert out["metric"] == "rays_per_sec_fwd_bwd_32x16" and out["unit"] == "rays/s/chip"
    assert out["backend"] == "cpu" and out["parity"] == "ok"
    assert out["device"] == {"name": "cpu", "power_limit": None, "count": 1}
    d = out["detail"]
    assert {"kernel", "plain", "kernel_ms_per_step", "march"} <= set(d)
    assert out["value"] == d["kernel"] > 0 and d["plain"] > 0 and d["K"] == 4
    assert d["checks"]["graph_vs_eager"] is None  # no CUDA graph on the CPU
    step = d["checks"]["kernel_vs_plain"]
    assert step["ok"] and step["acc_err"] <= step["acc_bound"]
    assert out["vs_baseline"] == pytest.approx(d["kernel"] / d["plain"])
    assert len(d["kernel_measurements"]) == 3 and d["kernel_timing"] == "eager"
    assert all(m["ms_per_step"] > 0 for m in d["kernel_measurements"])
    assert {"hit_rate", "steps_mean", "steps_p99", "exhausted_lanes",
            "histogram"} <= set(d["march"])
    assert sum(d["march"]["histogram"]) == 32 * 16


def test_cli_bench_exits_1_when_parity_fails(monkeypatch, capsys):
    monkeypatch.setattr(bench, "run_bench", lambda *a, **k: {"parity": "fail: x", "value": 1.0})
    with pytest.raises(SystemExit) as e:
        cli.main(["bench", "--device", "cpu"])
    assert e.value.code == 1
    assert json.loads(capsys.readouterr().out) == {"parity": "fail: x", "value": 1.0}


@pytest.mark.parametrize("check", ["graph_vs_eager", "kernel_vs_plain"])
def test_bench_exits_1_when_a_check_fails(monkeypatch, capsys, check):
    checks = {"graph_vs_eager": {"ok": True}, "kernel_vs_plain": {"ok": True}}
    checks[check] = {"ok": False, "acc_err": 1.0}
    result = {"parity": "ok", "value": 1.0, "detail": {"checks": checks}}
    monkeypatch.setattr(bench, "run_bench", lambda *a, **k: result)
    assert bench.main(["--device", "cpu"]) == 1
    out = capsys.readouterr()
    assert json.loads(out.out) == result
    assert f"FAIL: {check}: " in out.err


def test_failures():
    ok = {"parity": "ok", "detail": {"checks": {"graph_vs_eager": None,
                                                "kernel_vs_plain": {"ok": True}}}}
    assert bench.failures(ok) == []
    assert bench.failures({"metric": "scaling_efficiency_mesh2_32x16", "detail": {}}) == []
    bad = {"parity": "fail: volumetric: off",
           "detail": {"checks": {"graph_vs_eager": {"ok": False}, "kernel_vs_plain": None}}}
    assert bench.failures(bad) == ["parity: fail: volumetric: off",
                                   'graph_vs_eager: {"ok": false}']


@pytest.mark.parametrize("argv,call,k", [
    (["cli", "bench"], "run_bench", 20),
    (["cli", "bench", "--iters", "7"], "run_bench", 7),
    (["cli", "bench", "--mesh", "2"], "run_bench_mesh", 8),
    (["bench"], "run_bench", 40),
    (["bench", "--mesh", "2"], "run_bench_mesh", 8),
    (["bench", "--mesh", "2", "--iters", "5"], "run_bench_mesh", 5),
], ids=["cli", "cli_iters", "cli_mesh", "bench", "bench_mesh", "bench_mesh_iters"])
def test_cli_and_bench_take_k_from_one_place(monkeypatch, capsys, argv, call, k):
    """The CLI's K is the JAX CLI's 20, ``python -m ...bench``'s 40; with
    ``--mesh`` both hand the scaling harness bench's MESH_K."""
    got = {}

    def fake(*args, **kwargs):
        got[call] = args
        return {"metric": "m", "value": 1.0, "parity": "ok"}

    monkeypatch.setattr(bench, call, fake)
    if argv[0] == "cli":
        cli.main(argv[1:] + ["--device", "cpu", "--size", "32x16"])
    else:
        assert bench.main(argv[1:] + ["--device", "cpu", "--size", "32x16"]) == 0
    args = got[call]
    assert (args[-2], args[-1]) == (k, "cpu")
    assert args[-4:-2] == ((16, 32), 6)
    capsys.readouterr()


def _step_pair(scale: float):
    cfg = RenderConfig(height=32, width=32, max_steps=MAX_STEPS, num_octaves=OCT)
    kernel = bench.bench_steps(default_scene(OCT, device="cpu"), cfg)
    scene = default_scene(OCT, device="cpu")
    with torch.no_grad():
        scene.noise.amplitudes.mul_(scale)
    plain = bench.bench_steps(scene, RenderConfig(height=32, width=32, max_steps=MAX_STEPS,
                                                  num_octaves=OCT, use_kernel=False))
    return kernel, plain


def test_step_check_holds_and_fails():
    got = bench.step_check(*_step_pair(1.0))
    assert got["ok"] and got["salt"] == timing.SALT_CHECK
    assert got["acc_err"] <= got["acc_bound"] and got["worst_leaf_share"] <= 1.0
    # Amplitudes 1% off: every part fails; 50% off: the leaves and the loss.
    off = bench.step_check(*_step_pair(1.01))
    assert not off["ok"] and off["acc_err"] > off["acc_bound"], off
    assert off["worst_leaf_share"] > 1.0
    off = bench.step_check(*_step_pair(1.5))
    assert not off["ok"] and off["worst_leaf_share"] > 1.0, off


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["bench", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.run_bench((16, 32), 2, 4, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.run_bench_mesh(1, (16, 32), 2, device="cuda")


def test_mesh_with_fewer_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(launch, "launch_local_processes", lambda *a, **k: pytest.fail("ran"))
    with pytest.raises(RuntimeError, match="a mesh of 2 needs 2 cards, this machine has 1"):
        bench.run_bench_mesh(2)


def _timed(out: str) -> dict:
    [line] = [ln for ln in out.splitlines() if ln.startswith("TIMED ")]
    return json.loads(line[len("TIMED "):])


def test_worker_timed_mode_on_two_gloo_ranks():
    outputs = launch.launch_local_processes(
        WORKER, 2, ["--device", "cpu", "--size", "32x16", "--octaves", "2", "--max-steps", "8",
                    "--time-k", "4"], timeout_s=420)
    hexes = [out.split("losshex=")[1].split(",")[0] for out in outputs]
    assert hexes[0] == hexes[1]
    timed = [_timed(out) for out in outputs]
    assert [t["rank"] for t in timed] == [0, 1]
    for t in timed:
        assert t["world"] == 2 and t["backend"] == "gloo" and t["device"] == "cpu"
        assert t["config"] == "32x16x2oct" and t["ms_per_step"] > 0 and t["rays_per_sec"] > 0
        assert t["build_s"] > 0
    # The same salts on both ranks: the same all-reduced sums.
    assert timed[0]["acchex"] == timed[1]["acchex"]


def test_run_bench_mesh_on_gloo_ranks():
    out = bench.run_bench_mesh(2, (16, 32), 2, iters=4, device="cpu")
    assert out["metric"] == "scaling_efficiency_mesh2_32x16"
    assert out["unit"] == "parallel_efficiency" and out["backend"] == "cpu"
    d = out["detail"]
    assert set(d["rays_per_sec"]) == {"1", "2"} and d["efficiency"]["1"] == 1.0
    assert out["value"] == d["efficiency"]["2"] > 0
    assert out["vs_baseline"] == pytest.approx(out["value"] / 0.8)
    # A job of one rank runs a group of one too (the worker's --world-size).
    assert [r["backend"] for r in d["ranks"]["1"]] == ["gloo"]
    assert [r["world"] for r in d["ranks"]["2"]] == [2, 2]
