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
"""

import dataclasses
import os
import re

import jax
import numpy as np
import pytest
import torch

from gpgpuraytrace_tpu.models.scene import RenderConfig as JaxConfig
from gpgpuraytrace_tpu.models.scene import default_scene as jax_default_scene
from gpgpuraytrace_tpu.ops.fit import partition_scene as jax_partition_scene
from gpgpuraytrace_tpu.ops.render import render_jax
from gpgpuraytrace_tpu.parallel.mesh import make_mesh
from gpgpuraytrace_tpu.parallel.sharded import shard_target as jax_shard_target
from gpgpuraytrace_tpu.parallel.sharded import sharded_loss_and_grad as jax_sharded
from gpgpuraytrace_tpu_torch import RenderConfig, default_scene, render
from gpgpuraytrace_tpu_torch.ops.fit import make_optimizer, partition_scene, pixel_loss
from gpgpuraytrace_tpu_torch.parallel import launch, mesh
from gpgpuraytrace_tpu_torch.parallel.sharded import (
    make_sharded_fit_step, shard_target, sharded_render,
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


def test_initialize_distributed_is_a_noop_for_one_process(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert not mesh.initialize_distributed("cpu")
    with launch.distributed_context("cpu") as (rank, world_size):
        assert (rank, world_size) == (0, 1)
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
