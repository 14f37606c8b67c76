"""One rank of a row-band render and fit job (counterpart of
``scripts/multihost_worker.py``).

Run as ``python -m gpgpuraytrace_tpu_torch.parallel.worker`` on each rank
with ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` set, or
locally through ``parallel/launch.py``; alone it runs a group of one. On
``default_scene(octaves)`` it checks that the sharded render equals the
whole frame rendered by this rank, takes the band-wise loss and gradient
toward the frame of the scene with its amplitudes scaled by 1.2, and runs
``--fit-steps`` sharded Adam steps (lr 5e-3) from amplitudes scaled by 1.3
toward the scene's own frame (``make_sharded_fit_step``: on the card the
first step eager, every later one a replay of its CUDA graph), and as many
eager steps (``ShardedFitStep.eager``) from a copy, which must give the
same losses and parameters bit for bit. It prints the loss's hex and the
last fit loss's, which every rank must print alike. ``--out DIR`` writes
``DIR/rank{r}.npz``: the gathered frame, the rank's rows of it (its stripes
in stripe order, ``shard_target``; one stripe: its band), the loss, the
gradient of each trainable parameter, the stripes its loss and gradient
rendered (``sharded_loss_and_grad.stripes``), the fit's losses and its
fitted parameters.

``--time-k K`` (the counterpart of the reference worker's ``WORKER_TIME_K``
and of ``bench.py``'s ``_MESH_CODE``, which time one jitted ``fori_loop`` of
K sharded steps) then times the row-band training step,
``sharded_loss_and_grad`` toward a zero target with every float parameter
trainable (each step its band's forward and backward and, above one rank,
one ``all_reduce`` per parameter and one for the loss), at the worker's
config, through the bench's timing loop (``utils/timing.py:measure_kernel``):
on the card CUDA graphs of 1 and K steps, the all-reduces captured with the
kernels, beside the eager loop; on gloo the eager loop alone. Every rank
runs the same constant salts and captures the same graphs in the same
order, so the ranks step in lockstep. ``--world-size N`` joins a group of N
ranks even when N is 1 (``bench.run_bench_mesh`` times one rank on NCCL
so); without it the environment decides, and a single process runs alone.
Each rank prints one ``TIMED {json}`` line: rank, world, config, ``timing``
("cuda_graph" or "eager"), ms per step and the whole frame's rays/s (the
lower middle of the measurements: the graphs' on the card) with the eager
loop's beside them, ``graph_check`` (each graph replayed at a fixed salt
equal to the eager loop bit for bit on this rank; None on gloo), the
forward, backward and all-reduce launches per captured step (counted at
capture; on gloo the all-reduces only), peak memory, the first step's
seconds (the kernels' build or load), the device, the group's backend and
the last run's accumulator as hex (equal on every rank).
"""

from __future__ import annotations

import argparse
import copy
import json
import os

import numpy as np
import torch

from gpgpuraytrace_tpu_torch.cli import _parse_size
from gpgpuraytrace_tpu_torch.models.scene import RenderConfig, default_scene
from gpgpuraytrace_tpu_torch.ops.fit import make_optimizer, partition_scene
from gpgpuraytrace_tpu_torch.ops.render import render
from gpgpuraytrace_tpu_torch.parallel.launch import distributed_context
from gpgpuraytrace_tpu_torch.parallel.mesh import rank_device, world
from gpgpuraytrace_tpu_torch.parallel.sharded import (
    make_sharded_fit_step, shard_target, sharded_loss_and_grad, sharded_render, step_launches,
)
from gpgpuraytrace_tpu_torch.utils.timing import FwdBwdSteps, lower_middle, measure_kernel


def scaled(scene, factor: float):
    out = copy.deepcopy(scene)
    with torch.no_grad():
        out.noise.amplitudes.mul_(factor)
    return out


def run(device, cfg: RenderConfig, fit_steps: int) -> dict:
    """This rank's part of the job; the results on the host."""
    scene = default_scene(cfg.num_octaves, device=device)
    frame = sharded_render(scene, cfg)
    with torch.no_grad():
        whole = render(scene, cfg)
    if frame.shape != whole.shape or not torch.allclose(frame, whole, rtol=1e-5, atol=1e-6):
        raise AssertionError("the sharded render differs from the whole frame")
    with torch.no_grad():
        target = render(scaled(scene, 1.2), cfg)
    params = partition_scene(scene)
    names = [n for n, p in scene.named_parameters() if p.requires_grad]
    counted = sharded_loss_and_grad.stripes
    loss, grads = sharded_loss_and_grad(scene, params, cfg, shard_target(target, cfg))
    stripes = sharded_loss_and_grad.stripes - counted
    fit_target = shard_target(whole, cfg)
    fits = []
    for _ in range(2):
        bad = scaled(scene, 1.3)
        bad_params = partition_scene(bad)
        fits.append((bad_params, make_sharded_fit_step(bad, cfg, bad_params,
                                                        make_optimizer(bad_params, 5e-3))))
    (bad_params, step), (twin_params, twin) = fits
    fit_losses = [step(fit_target).item() for _ in range(fit_steps)]
    eager_losses = [twin.eager(fit_target).item() for _ in range(fit_steps)]
    graph_equals_eager = fit_losses == eager_losses and all(
        torch.equal(a, b) for a, b in zip(bad_params, twin_params))
    replays = max(step.program.calls - 1, 0) if step.graphed else 0
    step.close()  # before the group goes: NCCL waits for graphs holding its collectives
    return {"frame": frame.cpu().numpy(), "band": shard_target(frame, cfg).cpu().numpy(),
            "bitwise": torch.equal(frame, whole), "loss": loss.item(), "stripes": stripes,
            "grads": {n: g.cpu().numpy() for n, g in zip(names, grads)},
            "fit_losses": np.asarray(fit_losses),
            "fit_params": {n: p.detach().cpu().numpy() for n, p in zip(names, bad_params)},
            "fit_replays": replays,
            "fit_graph_equals_eager": graph_equals_eager}


def sharded_steps(scene, cfg: RenderConfig) -> FwdBwdSteps:
    """Salted steps of ``sharded_loss_and_grad`` toward a zero target, every
    float parameter trainable (the reference's ``run_fb``,
    ``scripts/contract_configs.py:342-367``)."""
    params = partition_scene(scene, trainable=lambda name: True)
    device = params[0].device
    target = shard_target(torch.zeros((cfg.height, cfg.width, 3), device=device), cfg)
    return FwdBwdSteps(params, lambda: sharded_loss_and_grad(scene, params, cfg, target))


def timed_step(device, cfg: RenderConfig, k: int) -> dict:
    """The ``TIMED`` record of this rank (see the module's docstring)."""
    import torch.distributed as dist

    steps = sharded_steps(default_scene(cfg.num_octaves, device=device), cfg)
    m = measure_kernel(steps, k, cfg.height * cfg.width, step_launches)
    head, eager = lower_middle(m["measurements"]), lower_middle(m["eager"])
    rank, world_size = world()
    return {"rank": rank, "world": world_size,
            "config": f"{cfg.width}x{cfg.height}x{cfg.num_octaves}oct",
            "timing": m["timing"], "K": k,
            "ms_per_step": head["ms_per_step"], "rays_per_sec": head["rays_per_sec"],
            "eager_ms_per_step": eager["ms_per_step"],
            "eager_rays_per_sec": eager["rays_per_sec"],
            "measurements": m["measurements"], "eager_measurements": m["eager"],
            "graph_check": m["graph_check"], "launches_per_step": m["launches_per_step"],
            "peak_memory_bytes": m["peak_memory_bytes"],
            "build_s": m["build_s"], "device": str(device),
            "backend": dist.get_backend() if dist.is_initialized() else None,
            "acchex": steps.acc.item().hex()}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--size", default="32x16", help="N or WxH")
    p.add_argument("--octaves", type=int, default=2)
    p.add_argument("--max-steps", type=int, default=8)
    p.add_argument("--fit-steps", type=int, default=1)
    p.add_argument("--out", default="")
    p.add_argument("--time-k", type=int, default=0, metavar="K",
                   help="then time the sharded fwd+bwd step by the slope over K steps")
    p.add_argument("--world-size", type=int, default=0, metavar="N",
                   help="join a group of N ranks, even of one (default: as the environment says)")
    a = p.parse_args(argv)
    if a.device == "cpu":
        torch.set_num_threads(1)  # one core per rank
    height, width = _parse_size(a.size)
    cfg = RenderConfig(height=height, width=width, max_steps=a.max_steps,
                       num_octaves=a.octaves)
    with distributed_context(a.device, a.world_size or None) as (rank, world_size):
        device = rank_device(a.device, rank, world_size)
        r = run(device, cfg, a.fit_steps)
        if a.out:
            np.savez(os.path.join(a.out, f"rank{rank}.npz"), frame=r["frame"],
                     band=r["band"], loss=r["loss"], stripes=r["stripes"],
                     fit_losses=r["fit_losses"],
                     **{f"grad.{n}": g for n, g in r["grads"].items()},
                     **{f"fit.{n}": v for n, v in r["fit_params"].items()})
        fit = r["fit_losses"]
        print(f"rank {rank}/{world_size}: render {r['frame'].shape} (band {r['band'].shape[0]} "
              f"rows, {'bit for bit' if r['bitwise'] else 'within rtol 1e-5'} the whole "
              f"frame), loss {r['loss']:.6f} losshex={r['loss'].hex()}, fit "
              + (f"{fit[0]:.4e} -> {fit[-1]:.4e} over {len(fit)} steps "
                 f"({r['fit_replays']} of them CUDA graph replays, "
                 f"{'bit for bit' if r['fit_graph_equals_eager'] else 'NOT equal to'} "
                 f"{len(fit)} eager steps) fithex={fit[-1].hex()}" if len(fit) else "none")
              + ", OK", flush=True)
        if not r["fit_graph_equals_eager"]:
            raise AssertionError("the sharded fit step's replays differ from its eager steps")
        if a.time_k > 0:
            print("TIMED " + json.dumps(timed_step(device, cfg, max(a.time_k, 2))),
                  flush=True)


if __name__ == "__main__":
    main()
