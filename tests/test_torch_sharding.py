"""Row bands on torch.distributed (``parallel/``), against the whole frame
and against the JAX package's ``sharded_loss_and_grad``, on the CPU (ports
tests/test_sharding.py and tests/test_multiprocess.py).

One gloo job of 4 CPU ranks (``parallel/launch.py`` running
``parallel/worker.py``; torch imported once per rank) at the reference's
sharding config, 16x32, 8 march steps, 2 octaves, 4-row bands (unprimed:
``prime_ds`` resolves to 0 below 64 rows, so the bands need not be whole
coarse rows). Against the port's whole frame in this process, with
tests/test_sharding.py's tolerances: the gathered frame at rtol 1e-5, atol
1e-6 (and each band its rows); the loss at rtol 1e-5 and each gradient at
rtol 1e-4, atol 1e-7; 10 sharded Adam steps lower the loss. Against JAX's
``sharded_loss_and_grad`` on 4 of conftest's virtual devices, with
tests/test_torch_bwd.py's end-to-end gradient tolerance: amplitudes at rtol
5e-3, atol 1e-5, every leaf at rtol 2.5e-2 plus 1e-3 of its largest
component; the loss at rtol 1e-4.

One gloo job of 2 ranks at 128x64 (bands of 32 rows, primed), 32 march
steps: 3 steps of the port's ``make_sharded_fit_step`` (Adam, lr 5e-3, from
amplitudes scaled by 1.3 toward the scene's own frame) against 3 steps of
the JAX package's ``make_sharded_fit_step`` with optax Adam on 2 of
conftest's virtual devices, at tests/test_torch_checkpoint.py's tolerance
against JAX's chunked fit (losses at rtol 1e-4, every trainable component
within 0.1·lr); the same job's ``--time-k`` records on gloo (the eager loop,
with the keys the card's graphs fill). ``bench.run_bench_mesh`` refuses 4K
over 4 ranks (bands of 540 rows at ``prime_ds`` 8) before any rank starts.

Both jobs' ranks keep one stripe each, their band (``mesh.stripes``). The
stripe layout on every world size and shape of a sweep: the ranks' stripes
tile the frame once, each whole coarse rows. One gloo job of 2 ranks at
64x128 (rows 0-31 and 64-95 on rank 0, primed at ``prime_ds`` 8, 24 march
steps), where each rank renders 2 stripes: the gathered frame equal to the
whole frame, the summed loss and gradients within the 4-rank job's
tolerances of the whole frame's and of JAX's contiguous ``shard_map``
bands', and the stripe counter at 2.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gpgpuraytrace_tpu.models.scene import RenderConfig as JaxConfig
from gpgpuraytrace_tpu.models.scene import default_scene as jax_default_scene
from gpgpuraytrace_tpu.ops.fit import partition_scene as jax_partition_scene
from gpgpuraytrace_tpu.ops.render import render_jax
from gpgpuraytrace_tpu.parallel.mesh import make_mesh
from gpgpuraytrace_tpu.parallel.sharded import make_sharded_fit_step as jax_fit_step
from gpgpuraytrace_tpu.parallel.sharded import shard_target as jax_shard_target
from gpgpuraytrace_tpu.parallel.sharded import sharded_loss_and_grad as jax_sharded
from gpgpuraytrace_tpu_torch import RenderConfig, bench, default_scene, render
from gpgpuraytrace_tpu_torch.ops.fit import make_optimizer, partition_scene, pixel_loss
from gpgpuraytrace_tpu_torch.parallel import launch, mesh
from gpgpuraytrace_tpu_torch.parallel.sharded import (
    band_loss_and_grad, make_sharded_fit_step, shard_target, sharded_render,
)
from gpgpuraytrace_tpu_torch.parallel.worker import scaled

torch.set_num_threads(2)

RANKS = 4
CFG = RenderConfig(height=16, width=32, max_steps=8, num_octaves=2)
JCFG = JaxConfig(height=16, width=32, max_steps=8, num_octaves=2, use_pallas=False)
TRAINABLE = ("noise.amplitudes", "camera.position", "camera.yaw", "camera.pitch",
             "camera.fov_y")
WORKER = "gpgpuraytrace_tpu_torch.parallel.worker"


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The 4-rank job's results: {rank: npz}, and each rank's output."""
    out = tmp_path_factory.mktemp("ranks")
    outputs = launch.launch_local_processes(
        WORKER, RANKS, ["--device", "cpu", "--size", "32x16", "--octaves", "2",
                        "--max-steps", "8", "--fit-steps", "10", "--out", str(out)],
        timeout_s=600)
    return {r: np.load(os.path.join(out, f"rank{r}.npz")) for r in range(RANKS)}, outputs


@pytest.fixture(scope="module")
def whole():
    """The port's whole-frame loss and gradients in this process."""
    scene = default_scene(num_octaves=2, device="cpu")
    with torch.no_grad():
        target = render(scaled(scene, 1.2), CFG)
    params = partition_scene(scene)
    d = render(scene, CFG) - target
    loss = torch.mean(d * d)
    grads = torch.autograd.grad(loss, params)
    with torch.no_grad():
        frame = render(scene, CFG)
    return frame.numpy(), loss.item(), {n: g.numpy() for n, g in zip(TRAINABLE, grads)}


def test_sharded_render_matches_single_device(job, whole):
    results, outputs = job
    for r in range(RANKS):
        np.testing.assert_allclose(results[r]["frame"], whole[0], rtol=1e-5, atol=1e-6)
        band = results[r]["band"]
        assert band.shape == (CFG.height // RANKS, CFG.width, 3)
        np.testing.assert_array_equal(band, results[r]["frame"][4 * r:4 * r + 4])
        assert f"rank {r}/{RANKS}:" in outputs[r] and "OK" in outputs[r]


def test_sharded_grads_match_unsharded(job, whole):
    results, outputs = job
    _, loss, grads = whole
    hexes = {re.search(r"losshex=(\S+),", out).group(1) for out in outputs}
    assert len(hexes) == 1, f"the summed loss differs across ranks: {hexes}"
    for r in range(RANKS):
        np.testing.assert_allclose(float(results[r]["loss"]), loss, rtol=1e-5)
        for name in TRAINABLE:
            np.testing.assert_array_equal(results[r][f"grad.{name}"],
                                          results[0][f"grad.{name}"])
            np.testing.assert_allclose(results[r][f"grad.{name}"], grads[name],
                                       rtol=1e-4, atol=1e-7, err_msg=name)


def test_sharded_grads_match_jax_sharded(job):
    """JAX's shard_map over 4 virtual devices at the same config, target and
    scene: the same band-wise loss and psum'd gradients."""
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    jmesh = make_mesh(jax.devices()[:RANKS])
    scene = jax_default_scene(num_octaves=2)
    bright = dataclasses.replace(scene, noise=dataclasses.replace(
        scene.noise, amplitudes=scene.noise.amplitudes * 1.2))
    target = render_jax(bright, JCFG)
    leaves, merge = jax_partition_scene(scene)
    loss, grads = jax_sharded(leaves, merge, JCFG, jax_shard_target(target, jmesh), jmesh)
    results, _ = job
    np.testing.assert_allclose(float(results[0]["loss"]), float(loss), rtol=1e-4)
    for name, g in zip(TRAINABLE, grads):
        got, ref = results[0][f"grad.{name}"], np.asarray(g)
        if name == "noise.amplitudes":
            np.testing.assert_allclose(got, ref, rtol=5e-3, atol=1e-5, err_msg=name)
        scale = float(np.max(np.abs(ref)))
        np.testing.assert_allclose(got, ref, rtol=2.5e-2, atol=1e-3 * scale, err_msg=name)


def test_sharded_fit_step_decreases_loss(job):
    results, _ = job
    losses = results[0]["fit_losses"]
    assert len(losses) == 10 and losses[-1] < losses[0], losses
    for r in range(RANKS):  # every rank takes the same steps
        np.testing.assert_array_equal(results[r]["fit_losses"], losses)


def test_band_layout():
    assert [mesh.band(CFG, r, RANKS) for r in range(RANKS)] == [
        (0.0, 4), (4.0, 4), (8.0, 4), (12.0, 4)]
    assert mesh.band(CFG) == (0.0, 16)  # no group: one rank, the whole frame
    with pytest.raises(ValueError, match="divide evenly"):
        mesh.band(CFG, 0, 3)
    # A primed frame's bands must be whole coarse rows: 64 rows over 16
    # ranks gives 4-row bands, which prime_ds=8 refuses.
    primed = RenderConfig(height=64, width=64, max_steps=8, num_octaves=1)
    assert primed.prime_ds == 8
    row0, h = mesh.band(primed, 1, 16)
    scene = default_scene(num_octaves=1, device="cpu")
    with pytest.raises(ValueError, match="whole coarse rows"):
        render(scene, primed, row0, h)
    assert mesh.backend_for("cpu") == "gloo" and mesh.backend_for("cuda") == "nccl"


SWEEP_SHAPES = [(16, 32), (64, 64), (64, 128), (128, 64), (384, 64), (512, 512),
                (1080, 1920), (2160, 3840, 4)]


@pytest.mark.parametrize("shape", SWEEP_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("world_size", [1, 2, 3, 4, 8, 16])
def test_stripes_tile_the_frame_in_whole_coarse_rows(shape, world_size):
    """Every rank's stripes of a frame that splits over the ranks: h rows a
    rank, the ranks' rows the frame's once each, every stripe S rows from
    (j·N + r)·S; where the rank's band is whole coarse rows, so is every
    stripe; one stripe a rank, its band, in a group of one and where the
    rank has rows for fewer than ``MIN_STRIPES`` stripes of at least
    ``STRIPE_ROWS``."""
    height, width, *ds = shape
    cfg = RenderConfig(height=height, width=width, max_steps=8, num_octaves=2,
                       prime_ds=ds[0] if ds else None)
    if height % world_size:
        with pytest.raises(ValueError, match="divide evenly"):
            mesh.stripes(cfg, 0, world_size)
        return
    h, q = height // world_size, cfg.prime_ds or 1
    seen = []
    for r in range(world_size):
        row0s, s = mesh.stripes(cfg, r, world_size)
        assert len(row0s) * s == h and row0s == tuple(
            float((j * world_size + r) * s) for j in range(len(row0s)))
        if len(row0s) == 1:
            assert (row0s[0], s) == mesh.band(cfg, r, world_size)
        if h % q == 0:
            assert s % q == 0 and all(r0 % q == 0 for r0 in row0s)
        seen += [int(r0) + i for r0 in row0s for i in range(s)]
    assert sorted(seen) == list(range(height))
    if world_size == 1 or h < mesh.MIN_STRIPES * mesh.STRIPE_ROWS:
        assert len(mesh.stripes(cfg, 0, world_size)[0]) == 1


def test_stripe_rows_come_from_the_shape():
    """S at the benchmark's 4K over 4 ranks (prime_ds 4) is 36 rows, 15
    stripes a rank; the sharding jobs' toy frames keep their bands."""
    cfg4k = RenderConfig(height=2160, width=3840, max_steps=8, num_octaves=2, prime_ds=4)
    assert mesh.stripe_rows(cfg4k, 4) == 36 and len(mesh.stripes(cfg4k, 3, 4)[0]) == 15
    assert mesh.stripes(cfg4k, 0, 1) == ((0.0,), 2160)
    assert mesh.stripes(CFG, 1, RANKS) == ((4.0,), 4)
    fit = RenderConfig(height=64, width=128, max_steps=32, num_octaves=2)
    assert [mesh.stripes(fit, r, 2) for r in range(2)] == [((0.0,), 32), ((32.0,), 32)]
    assert [mesh.stripes(STRIPED_CFG, r, 2) for r in range(2)] == [
        ((0.0, 64.0), 32), ((32.0, 96.0), 32)]


def test_initialize_distributed_is_a_noop_for_one_process(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert not mesh.initialize_distributed("cpu")
    with launch.distributed_context("cpu") as (rank, world_size):
        assert (rank, world_size) == (0, 1)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("world_size", [None, "1"], ids=["unset", "one"])
def test_master_addr_alone_is_a_noop(monkeypatch, world_size):
    """A shell that exports MASTER_ADDR (and MASTER_PORT) still runs a single
    process alone: only a world size above 1, or one given, makes a group."""
    for var in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    if world_size is not None:
        monkeypatch.setenv("WORLD_SIZE", world_size)
    assert not mesh.initialize_distributed("cpu")
    with launch.distributed_context("cpu") as (rank, n):
        assert (rank, n) == (0, 1)
    assert not torch.distributed.is_initialized()


def test_launch_raises_when_a_rank_fails():
    with pytest.raises(RuntimeError, match=r"rank\(s\) failed"):
        launch.launch_local_processes("gpgpuraytrace_tpu_torch.parallel.no_such_module", 2,
                                      timeout_s=120)


@pytest.mark.slow
def test_two_process_identical_loss():
    """The launcher's own entry point: 2 gloo ranks print the same loss."""
    outputs = launch.launch_local_processes(WORKER, 2, ["--device", "cpu"], timeout_s=420)
    hexes = [re.search(r"losshex=(\S+),", out).group(1) for out in outputs]
    assert all("OK" in out and "rank " in out for out in outputs)
    assert hexes[0] == hexes[1], f"the summed loss differs across ranks: {hexes}"


def test_group_of_one_equals_the_whole_frame():
    """A group of world size 1, made explicitly (what a one-card machine runs
    on NCCL; gloo here): the sharded render is ``render`` bit for bit and a
    sharded fit step's loss is ``pixel_loss`` within rtol 1e-6."""

    assert mesh.initialize_distributed("cpu", f"tcp://127.0.0.1:{launch.free_port()}", 1, 0)
    try:
        assert not mesh.initialize_distributed("cpu")  # already up
        assert mesh.world() == (0, 1)
        scene = default_scene(num_octaves=2, device="cpu")
        with torch.no_grad():
            whole = render(scene, CFG)
            target = render(scaled(scene, 1.2), CFG)
        assert torch.equal(sharded_render(scene, CFG), whole)
        with torch.no_grad():
            want = pixel_loss(scene, CFG, target).item()
        params = partition_scene(scene)
        step = make_sharded_fit_step(scene, CFG, params, make_optimizer(params, 5e-3))
        np.testing.assert_allclose(step(shard_target(target, CFG)).item(), want, rtol=1e-6)
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("local_rank,rank,world_size,device,card", [
    (None, 0, 4, "cuda", 0),
    (None, 3, 4, "cuda", 3),
    ("1", 5, 8, "cuda", 1),      # a job over several machines: LOCAL_RANK
    (None, 0, 2, "cuda:3", 3),   # an index given is taken as given
    (None, 0, 5, "cuda", "needs 5 cards"),
    ("4", 4, 8, "cuda", "LOCAL_RANK 4 needs card 4"),
])
def test_cuda_ranks_bind_their_own_card(monkeypatch, local_rank, rank, world_size, device,
                                        card):
    """On the card every rank binds a card of its own (NCCL puts one rank on
    each card), or raises: ``torch.cuda`` stubbed as a machine of 4 cards,
    the group's creation recorded instead of made."""
    bound, made = [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", bound.append)
    monkeypatch.setattr(mesh.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(mesh.dist, "init_process_group",
                        lambda backend, **kw: made.append((backend, kw)))
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    if isinstance(card, str):
        with pytest.raises(ValueError, match=card):
            mesh.initialize_distributed(device, "tcp://127.0.0.1:1", world_size, rank)
        assert bound == [] and made == []
        return
    assert mesh.initialize_distributed(device, "tcp://127.0.0.1:1", world_size, rank)
    assert bound == [card]
    assert made == [("nccl", {"init_method": "tcp://127.0.0.1:1", "world_size": world_size,
                              "rank": rank})]


@pytest.mark.parametrize("argv,device", [([], "cuda"), (["--device", "cpu"], "cpu")])
def test_launch_runs_on_the_card_unless_asked(monkeypatch, argv, device):
    """``python -m ...parallel.launch`` gives its workers ``--device cuda``
    unless the caller asks for the CPU; worker arguments follow ``--``."""
    calls = []
    monkeypatch.setattr(launch, "launch_local_processes",
                        lambda module, n, args: calls.append((module, n, args)) or [])
    launch.main(["--num-processes", "3", *argv, "--", "--size", "64"])
    assert calls == [(WORKER, 3, ["--device", device, "--size", "64"])]


# The 2-rank job at 128x64: bands of 32 rows, whole coarse rows at prime_ds 8.
FIT_RANKS, FIT_STEPS, FIT_LR, FIT_K = 2, 3, 5e-3, 4
FIT_CFG = JaxConfig(height=64, width=128, max_steps=32, num_octaves=2, use_pallas=False)


@pytest.fixture(scope="module")
def fit_job(tmp_path_factory):
    """The 2-rank job's results ({rank: npz}) and each rank's TIMED record."""
    out = tmp_path_factory.mktemp("fit_ranks")
    outputs = launch.launch_local_processes(
        WORKER, FIT_RANKS, ["--device", "cpu", "--size", "128x64", "--octaves", "2",
                            "--max-steps", "32", "--fit-steps", str(FIT_STEPS),
                            "--time-k", str(FIT_K), "--out", str(out)], timeout_s=600)
    timed = [json.loads(line[len("TIMED "):]) for o in outputs for line in o.splitlines()
             if line.startswith("TIMED ")]
    return {r: np.load(os.path.join(out, f"rank{r}.npz")) for r in range(FIT_RANKS)}, timed


def test_sharded_fit_steps_match_jax_fit_step(fit_job):
    """k steps of the port's make_sharded_fit_step on 2 gloo ranks against k
    steps of the JAX package's on 2 virtual devices (optax Adam)."""
    import optax

    assert RenderConfig(height=64, width=128, max_steps=32, num_octaves=2).prime_ds == 8
    jmesh = make_mesh(jax.devices()[:FIT_RANKS])
    scene = jax_default_scene(num_octaves=2)
    target = render_jax(scene, FIT_CFG)
    bad = dataclasses.replace(scene, noise=dataclasses.replace(
        scene.noise, amplitudes=scene.noise.amplitudes * 1.3))
    leaves, merge = jax_partition_scene(bad)
    tx = optax.adam(FIT_LR)
    opt_state = tx.init(leaves)
    step = jax_fit_step(FIT_CFG, jmesh, merge, tx)
    target_s = jax_shard_target(target, jmesh)
    losses = []
    for _ in range(FIT_STEPS):
        leaves, opt_state, loss = step(leaves, opt_state, target_s)
        losses.append(float(loss))
    results, _ = fit_job
    for r in range(FIT_RANKS):
        np.testing.assert_allclose(results[r]["fit_losses"], losses, rtol=1e-4)
        for name, ref in zip(TRAINABLE, leaves):
            np.testing.assert_allclose(results[r][f"fit.{name}"], np.asarray(ref), rtol=0,
                                       atol=0.1 * FIT_LR, err_msg=name)
        np.testing.assert_array_equal(results[r]["fit_losses"], results[0]["fit_losses"])


def test_worker_timed_mode_on_gloo_is_the_eager_loop(fit_job):
    """``--time-k`` on gloo: timing "eager", the eager loop's numbers beside
    the headline (the same loop here), no graph to check, and one all-reduce
    per parameter and one for the loss per step."""
    _, timed = fit_job
    n_params = len(list(default_scene(num_octaves=2, device="cpu").parameters()))
    assert [t["rank"] for t in timed] == list(range(FIT_RANKS))
    for t in timed:
        assert t["timing"] == "eager" and t["K"] == FIT_K and t["backend"] == "gloo"
        assert t["eager_ms_per_step"] == t["ms_per_step"] > 0
        assert t["eager_rays_per_sec"] == t["rays_per_sec"] > 0
        assert len(t["measurements"]) == 3 and t["eager_measurements"] == t["measurements"]
        assert t["graph_check"] is None and t["peak_memory_bytes"] is None
        assert t["launches_per_step"] == {"forward": {}, "backward": {},
                                          "all_reduce": {"sum": n_params + 1}}
    assert timed[0]["acchex"] == timed[1]["acchex"]


def test_band_script_times_each_band_alone():
    """``scripts/torch_mesh_bands.py`` on the CPU: one line per band of each
    world size, the bands tiling the frame, the eager loop with no graph to
    check, and no launch counted (the plain versions, no collective); the
    bands' losses sum to the whole frame's."""
    proc = subprocess.run(
        [sys.executable, os.path.join("scripts", "torch_mesh_bands.py"), "--device", "cpu",
         "--size", "64x32", "--octaves", "2", "--ranks", "2", "--k", "4"],
        cwd=launch.REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    *bands, tail = [json.loads(line) for line in proc.stdout.strip().splitlines()]
    assert [(b["world"], b["rank"], b["row0"], b["rows"]) for b in bands] == [
        (2, 0, 0.0, 16), (2, 1, 16.0, 16)]
    for b in bands:
        assert b["timing"] == "eager" and b["K"] == 4 and b["graph_check"] is None
        assert b["ms_per_step"] == b["eager_ms_per_step"] > 0
        assert b["launches_per_step"] == {"forward": {}, "backward": {}, "all_reduce": {}}
    assert tail == {"device": {"name": "cpu", "power_limit": None, "count": 1}}
    cfg = RenderConfig(height=16, width=32, max_steps=8, num_octaves=2)
    scene = default_scene(2, device="cpu")
    params = partition_scene(scene)
    target = torch.zeros((16, 32, 3))
    whole, whole_grads = band_loss_and_grad(scene, params, cfg, target, 0.0, 16)
    parts = [band_loss_and_grad(scene, params, cfg, target[r * 8:(r + 1) * 8], r * 8.0, 8)
             for r in range(2)]
    torch.testing.assert_close(parts[0][0] + parts[1][0], whole, rtol=1e-5, atol=0)
    for a, b, w in zip(parts[0][1], parts[1][1], whole_grads):
        torch.testing.assert_close(a + b, w, rtol=1e-4, atol=1e-6 * w.abs().max().item())


def test_mesh_of_4k_over_4_ranks_raises_before_a_rank_starts(monkeypatch):
    """540-row bands are not whole coarse rows at prime_ds 8: the harness
    raises naming prime_ds, and launches no rank."""
    monkeypatch.setattr(launch, "launch_local_processes", lambda *a, **k: pytest.fail("ran"))
    with pytest.raises(ValueError, match=r"a mesh of 4 ranks at 3840x2160: prime_ds=8 "
                                         r"must divide the band's local height 540"):
        bench.run_bench_mesh(4, size=(2160, 3840), device="cpu")


# The 2-rank job at 64x128 where each rank renders two stripes of 32 rows.
STRIPED_RANKS = 2
STRIPED_CFG = RenderConfig(height=128, width=64, max_steps=24, num_octaves=2)
STRIPED_JCFG = JaxConfig(height=128, width=64, max_steps=24, num_octaves=2, use_pallas=False)


@pytest.fixture(scope="module")
def striped_job(tmp_path_factory):
    """The striped 2-rank job's results: {rank: npz}."""
    out = tmp_path_factory.mktemp("striped_ranks")
    launch.launch_local_processes(
        WORKER, STRIPED_RANKS, ["--device", "cpu", "--size", "64x128", "--octaves", "2",
                                "--max-steps", "24", "--fit-steps", "1", "--out", str(out)],
        timeout_s=600)
    return {r: np.load(os.path.join(out, f"rank{r}.npz")) for r in range(STRIPED_RANKS)}


def test_striped_render_gathers_the_whole_frame(striped_job):
    """Each rank's two stripes, gathered and put back in frame order, give
    the whole frame (rtol 1e-5, atol 1e-6); a rank's rows are its stripes'
    rows of that frame; each rendered two stripes in its loss."""
    assert STRIPED_CFG.prime_ds == 8
    scene = default_scene(num_octaves=2, device="cpu")
    with torch.no_grad():
        whole = render(scene, STRIPED_CFG).numpy()
    for r in range(STRIPED_RANKS):
        frame = striped_job[r]["frame"]
        np.testing.assert_allclose(frame, whole, rtol=1e-5, atol=1e-6)
        rows = np.concatenate([frame[32 * r:32 * r + 32], frame[64 + 32 * r:96 + 32 * r]])
        np.testing.assert_array_equal(striped_job[r]["band"], rows)
        assert int(striped_job[r]["stripes"]) == 2


def test_striped_grads_match_unsharded_and_jax_contiguous_bands(striped_job):
    """The summed loss and gradients of the stripes: within rtol 1e-5 (loss)
    and rtol 1e-4, atol 1e-7 (each gradient) of the whole frame's, and
    within tests/test_torch_bwd.py's end-to-end tolerances of JAX's
    ``sharded_loss_and_grad`` over 2 contiguous bands on 2 virtual devices;
    the same on both ranks."""
    scene = default_scene(num_octaves=2, device="cpu")
    with torch.no_grad():
        target = render(scaled(scene, 1.2), STRIPED_CFG)
    params = partition_scene(scene)
    d = render(scene, STRIPED_CFG) - target
    loss = torch.mean(d * d)
    grads = torch.autograd.grad(loss, params)
    jmesh = make_mesh(jax.devices()[:STRIPED_RANKS])
    jscene = jax_default_scene(num_octaves=2)
    bright = dataclasses.replace(jscene, noise=dataclasses.replace(
        jscene.noise, amplitudes=jscene.noise.amplitudes * 1.2))
    jtarget = render_jax(bright, STRIPED_JCFG)
    leaves, merge = jax_partition_scene(jscene)
    jloss, jgrads = jax_sharded(leaves, merge, STRIPED_JCFG,
                                jax_shard_target(jtarget, jmesh), jmesh)
    for r in range(STRIPED_RANKS):
        got = striped_job[r]
        np.testing.assert_allclose(float(got["loss"]), loss.item(), rtol=1e-5)
        np.testing.assert_allclose(float(got["loss"]), float(jloss), rtol=1e-4)
        for name, g, jg in zip(TRAINABLE, grads, jgrads):
            mine = got[f"grad.{name}"]
            np.testing.assert_array_equal(mine, striped_job[0][f"grad.{name}"])
            np.testing.assert_allclose(mine, g.numpy(), rtol=1e-4, atol=1e-7, err_msg=name)
            ref = np.asarray(jg)
            if name == "noise.amplitudes":
                np.testing.assert_allclose(mine, ref, rtol=5e-3, atol=1e-5, err_msg=name)
            np.testing.assert_allclose(mine, ref, rtol=2.5e-2,
                                       atol=1e-3 * float(np.max(np.abs(ref))), err_msg=name)
