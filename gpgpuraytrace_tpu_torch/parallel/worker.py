"""One rank of a row-band render and fit job (counterpart of
``scripts/multihost_worker.py``).

Run as ``python -m gpgpuraytrace_tpu_torch.parallel.worker`` on each rank
with ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` set, or
locally through ``parallel/launch.py``; alone it runs a group of one. On
``default_scene(octaves)`` it checks that the sharded render equals the
whole frame rendered by this rank, takes the band-wise loss and gradient
toward the frame of the scene with its amplitudes scaled by 1.2, and runs
``--fit-steps`` sharded Adam steps (lr 5e-3) from amplitudes scaled by 1.3
toward the scene's own frame. It prints the loss's hex, which every rank
must print alike. ``--out DIR`` writes ``DIR/rank{r}.npz``: the gathered
frame, the band, the loss, the gradient of each trainable parameter and
the fit's losses.
"""

from __future__ import annotations

import argparse
import copy
import os

import numpy as np
import torch

from gpgpuraytrace_tpu_torch.cli import _parse_size
from gpgpuraytrace_tpu_torch.models.scene import RenderConfig, default_scene
from gpgpuraytrace_tpu_torch.ops.fit import make_optimizer, partition_scene
from gpgpuraytrace_tpu_torch.ops.render import render
from gpgpuraytrace_tpu_torch.parallel.launch import distributed_context
from gpgpuraytrace_tpu_torch.parallel.mesh import band, rank_device
from gpgpuraytrace_tpu_torch.parallel.sharded import (
    make_sharded_fit_step, shard_target, sharded_loss_and_grad, sharded_render,
)


def scaled(scene, factor: float):
    out = copy.deepcopy(scene)
    with torch.no_grad():
        out.noise.amplitudes.mul_(factor)
    return out


def run(device, cfg: RenderConfig, fit_steps: int) -> dict:
    """This rank's part of the job; the results on the host."""
    scene = default_scene(cfg.num_octaves, device=device)
    row0, h = band(cfg)
    frame = sharded_render(scene, cfg)
    with torch.no_grad():
        whole = render(scene, cfg)
    if frame.shape != whole.shape or not torch.allclose(frame, whole, rtol=1e-5, atol=1e-6):
        raise AssertionError("the sharded render differs from the whole frame")
    with torch.no_grad():
        target = render(scaled(scene, 1.2), cfg)
    params = partition_scene(scene)
    names = [n for n, p in scene.named_parameters() if p.requires_grad]
    loss, grads = sharded_loss_and_grad(scene, params, cfg, shard_target(target, cfg))
    bad = scaled(scene, 1.3)
    bad_params = partition_scene(bad)
    step = make_sharded_fit_step(bad, cfg, bad_params, make_optimizer(bad_params, 5e-3))
    fit_target = shard_target(whole, cfg)
    fit_losses = [step(fit_target).item() for _ in range(fit_steps)]
    return {"frame": frame.cpu().numpy(), "band": frame[int(row0):int(row0) + h].cpu().numpy(),
            "bitwise": torch.equal(frame, whole), "loss": loss.item(),
            "grads": {n: g.cpu().numpy() for n, g in zip(names, grads)},
            "fit_losses": np.asarray(fit_losses)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--size", default="32x16", help="N or WxH")
    p.add_argument("--octaves", type=int, default=2)
    p.add_argument("--max-steps", type=int, default=8)
    p.add_argument("--fit-steps", type=int, default=1)
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    if a.device == "cpu":
        torch.set_num_threads(1)  # one core per rank
    height, width = _parse_size(a.size)
    cfg = RenderConfig(height=height, width=width, max_steps=a.max_steps,
                       num_octaves=a.octaves)
    with distributed_context(a.device) as (rank, world_size):
        r = run(rank_device(a.device, rank, world_size), cfg, a.fit_steps)
        if a.out:
            np.savez(os.path.join(a.out, f"rank{rank}.npz"), frame=r["frame"],
                     band=r["band"], loss=r["loss"], fit_losses=r["fit_losses"],
                     **{f"grad.{n}": g for n, g in r["grads"].items()})
        fit = r["fit_losses"]
        print(f"rank {rank}/{world_size}: render {r['frame'].shape} (band {r['band'].shape[0]} "
              f"rows, {'bit for bit' if r['bitwise'] else 'within rtol 1e-5'} the whole "
              f"frame), loss {r['loss']:.6f} losshex={r['loss'].hex()}, fit "
              + (f"{fit[0]:.4e} -> {fit[-1]:.4e} over {len(fit)} steps" if len(fit) else "none")
              + ", OK", flush=True)


if __name__ == "__main__":
    main()
