"""Contract configs 3, 4 and 5 (BASELINE.json) through the PyTorch + CUDA port
on the card: the port's counterpart of ``scripts/contract_configs.py``. It
imports torch and the port only, and prints one JSON line per config, each
with the card's name and power limit (``bench.py:device_info``).

  config 3: ``fit`` at 512x512, 6 octaves, the reference's arguments (120
            steps, Adam lr 5e-3, ``steps_per_call`` 10: on the card a CUDA
            graph of 10 steps) from ``perturb_scene(…, rel 0.15)``; the loss
            curve and the recovered parameters' errors.
  config 4: the 1920x1080 flythrough, 48 frames in batches of 4 through
            ``ops/flythrough.py:FlyBatch`` (one CUDA graph a batch): frames
            per second of the replays alone, by the slope of K batches and
            1, and of ``fly_frames`` writing PNGs through
            ``utils/native_io.py:AsyncFrameWriter``.
  config 5: one 3840x2160 frame, 6 octaves, ``max_steps`` 128, default
            priming (``prime_ds`` 8), on a process group of one (NCCL on the
            card): ``sharded_render`` bit for bit ``render``, finite, its
            mean pixel; the frame's ms by the slope of CUDA graphs of 1 and
            K salted frames (the height offset moved per frame,
            ``utils/timing.py:FwdSteps``, the reference's ``run_fwd``); the fwd+bwd ms per step by the slope of CUDA graphs
            of 1 and K salted ``sharded_loss_and_grad`` steps, every float
            parameter trainable, toward a zero target (``parallel/worker.py:
            timed_step``, the reference's ``run_fb``); each with the eager
            loop's time beside it and ``graph_check``; the peak memory of each.

Times come from ``utils/timing.py:measure_kernel`` (K = 6, as the
reference's config 5; the lower middle of 3 measurements). The script exits
1 when a check fails (config 4: every frame written; config 5: the sharded
frame, finiteness, a ``graph_check``).

    python scripts/torch_contract_configs.py                  # all three, on the card
    python scripts/torch_contract_configs.py --config 5
    python scripts/torch_contract_configs.py --config 5 --device cpu --size 128x72 --octaves 2 --k 2
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from gpgpuraytrace_tpu_torch.bench import bench_device, device_info  # noqa: E402
from gpgpuraytrace_tpu_torch.models.scene import RenderConfig, default_scene  # noqa: E402
from gpgpuraytrace_tpu_torch.ops.render import render  # noqa: E402
from gpgpuraytrace_tpu_torch.parallel.sharded import step_launches  # noqa: E402
from gpgpuraytrace_tpu_torch.utils.timing import (  # noqa: E402
    FwdSteps, lower_middle, measure_kernel, slope, sync,
)

MAX_STEPS = 128
K5 = 6  # the slope's K of config 5 (scripts/contract_configs.py:327)


def config3(steps: int = 120, size: int = 512, lr: float = 5e-3, chunk: int = 10,
            device="cuda") -> dict:
    """``scripts/contract_configs.py:config3``: the fit in chunks of
    ``chunk`` steps (``ops/fit.py:StepChunk``). The first chunk runs eagerly
    (the kernels' build, the graph's warm-up), the second captures the graph
    and replays it; the chunks after them are timed, their losses kept on
    the device until the end."""
    from gpgpuraytrace_tpu_torch.ops.fit import (
        StepChunk, make_optimizer, partition_scene, perturb_scene,
    )

    dev = bench_device(device)
    if steps % chunk or steps < 3 * chunk:
        raise ValueError(f"steps={steps} must be at least 3 chunks of {chunk}")
    cfg = RenderConfig(height=size, width=size, max_steps=MAX_STEPS, num_octaves=6)
    target_scene = default_scene(6, device=dev)
    with torch.no_grad():
        target = render(target_scene, cfg)
    scene = perturb_scene(target_scene, torch.Generator().manual_seed(0), rel=0.15)
    start = {n: p.detach().clone() for n, p in scene.named_parameters()}
    opt = make_optimizer(partition_scene(scene), lr)
    run = StepChunk(scene, cfg, target, opt, chunk)
    seconds, chunks = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        chunks.append(run())
        sync(dev)
        seconds.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(steps // chunk - 2):
        chunks.append(run())
    sync(dev)
    fit_s = time.perf_counter() - t0
    losses = torch.cat(chunks).tolist()
    sec_per_step = fit_s / (steps - 2 * chunk)
    fitted = dict(scene.named_parameters())
    truth = dict(target_scene.named_parameters())

    def err(name: str, p: dict) -> float:
        d = (p[name].detach() - truth[name].detach()).double()
        return (torch.linalg.norm(d) if name == "camera.position" else d.abs().max()).item()

    return {
        "config": 3,
        "desc": f"fit {size}x{size} 6-octave {steps} steps adam(lr={lr}) "
                f"steps_per_call={chunk}",
        "backend": dev.type, "device": device_info(dev),
        "timing": "cuda_graph" if run.graphed else "eager",
        "first_chunk_s": seconds[0], "capture_chunk_s": seconds[1],
        "sec_per_step": sec_per_step, "rays_per_sec_fwd_bwd": size * size / sec_per_step,
        "loss_first": losses[0], "loss_last": losses[-1],
        "loss_curve_every10": losses[::10],
        "amp_maxerr_start": err("noise.amplitudes", start),
        "amp_maxerr_end": err("noise.amplitudes", fitted),
        "campos_err_start": err("camera.position", start),
        "campos_err_end": err("camera.position", fitted),
        "yaw_err_start": err("camera.yaw", start), "yaw_err_end": err("camera.yaw", fitted),
    }


def config4(frames: int = 48, batch: int = 4, device="cuda") -> dict:
    """``scripts/contract_configs.py:config4``: the replays' frame rate by
    the slope (T(K) − T(1)) / (K − 1) of K = frames / batch batches and 1
    (each the least of 3 runs, after a warm-up run), frames left on the
    card; then ``fly_frames`` of ``frames`` frames through the same program
    (its graph kept), written as PNGs by ``AsyncFrameWriter``."""
    from gpgpuraytrace_tpu_torch.ops.flythrough import FlyBatch, fly_frames
    from gpgpuraytrace_tpu_torch.utils.native_io import AsyncFrameWriter

    dev = bench_device(device)
    cfg = RenderConfig(height=1080, width=1920, max_steps=MAX_STEPS, num_octaves=6)
    scene = default_scene(6, device=dev)
    program = FlyBatch(scene, cfg, batch)
    k = max(frames // batch, 2)

    def timed(n: int, first: int) -> float:
        sync(dev)
        t0 = time.perf_counter()
        for i in range(n):
            times = (torch.arange(batch, dtype=torch.float32) + (first + i) * batch) / 30.0
            program.frames(scene, times)
        sync(dev)
        return time.perf_counter() - t0

    build_s = timed(1, 0)  # the eager batch: the kernels' build
    capture_s = timed(1, 1)  # the capture and its first replay
    timed(k, 0)
    t_k = min(timed(k, 100 * r) for r in range(1, 4))
    t_1 = min(timed(1, 100 * r + 50) for r in range(1, 4))
    s = slope(t_k, t_1, k, 1920 * 1080 * batch)
    with tempfile.TemporaryDirectory() as out, AsyncFrameWriter(num_threads=2) as writer:
        t0 = time.perf_counter()
        n = 0
        for idx, frame in fly_frames(scene, cfg, frames, batch=batch, program=program):
            writer.push(os.path.join(out, f"frame_{idx:04d}.png"), frame)
            n += 1
        errs = writer.close()
        io_s = time.perf_counter() - t0
        wrote = len(os.listdir(out))
    ms_per_batch = s["ms_per_step"]
    return {
        "config": 4,
        "desc": f"fly 1920x1080 6-octave batch={batch} x {frames} frames",
        "backend": dev.type, "device": device_info(dev),
        "timing": "cuda_graph" if program.graphed else "eager",
        "first_batch_s": build_s, "capture_batch_s": capture_s, "K": k,
        "fps_render_only": 1e3 * batch / ms_per_batch,
        "ms_per_frame_render_only": ms_per_batch / batch,
        "mrays_per_sec_render_only": s["rays_per_sec"] / 1e6,
        "fps_with_async_png_io": n / io_s, "frames_written": wrote, "write_errors": errs,
        "launches_per_batch": dict(program.launches), "busy": program.busy(),
        "ok": errs == 0 and wrote == frames,
    }


def config5(height: int = 2160, width: int = 3840, octaves: int = 6, k: int = K5,
            device="cuda") -> dict:
    """``scripts/contract_configs.py:config5`` on a process group of one (an
    existing group is used as it is): see the module's docstring."""
    import torch.distributed as dist

    from gpgpuraytrace_tpu_torch.parallel.launch import free_port
    from gpgpuraytrace_tpu_torch.parallel.mesh import initialize_distributed, world
    from gpgpuraytrace_tpu_torch.parallel.sharded import sharded_render
    from gpgpuraytrace_tpu_torch.parallel.worker import timed_step

    dev = bench_device(device)
    cfg = RenderConfig(height=height, width=width, max_steps=MAX_STEPS, num_octaves=octaves)
    made = initialize_distributed(dev, f"tcp://localhost:{free_port()}", 1, 0)
    try:
        scene = default_scene(octaves, device=dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            img = render(scene, cfg)
        sync(dev)
        render_s = time.perf_counter() - t0
        sharded = sharded_render(scene, cfg)
        salted = default_scene(octaves, device=dev)
        frame = measure_kernel(FwdSteps([salted.noise.height_offset],
                                        lambda: render(salted, cfg)), k, height * width,
                               step_launches)
        step = timed_step(dev, cfg, k)
        group = {"backend": dist.get_backend(), "world": world()[1]}
    finally:
        if made:
            dist.destroy_process_group()
    head, eager = lower_middle(frame["measurements"]), lower_middle(frame["eager"])
    out = {
        "config": 5,
        "desc": f"sharded {width}x{height} {octaves}-octave, prime_ds {cfg.prime_ds}, on a "
                f"process group of one",
        "backend": dev.type, "device": device_info(dev), "group": group, "K": k,
        "render_s": render_s,
        "shape": list(img.shape),
        "sharded_bitwise": torch.equal(sharded, img),
        "finite": bool(torch.isfinite(img).all()),
        "mean_pixel": img.mean().item(),
        "frame_timing": frame["timing"],
        "frame_ms": head["ms_per_step"], "mrays_per_sec": head["rays_per_sec"] / 1e6,
        "frame_ms_eager": eager["ms_per_step"],
        "frame_graph_check": frame["graph_check"],
        "frame_launches": frame["launches_per_step"],
        "fwd_bwd_timing": step["timing"],
        "fwd_bwd_ms_per_step": step["ms_per_step"],
        "fwd_bwd_mrays_per_sec": step["rays_per_sec"] / 1e6,
        "fwd_bwd_ms_per_step_eager": step["eager_ms_per_step"],
        "fwd_bwd_graph_check": step["graph_check"],
        "fwd_bwd_launches": step["launches_per_step"],
        "fwd_bwd_build_s": step["build_s"],
        # From each timing's first step on (measure_kernel).
        "frame_peak_memory_bytes": frame["peak_memory_bytes"],
        "fwd_bwd_peak_memory_bytes": step["peak_memory_bytes"],
    }
    checks = [out["sharded_bitwise"], out["finite"], list(out["shape"]) == [height, width, 3]]
    checks += [c is None or c["ok"] for c in (out["frame_graph_check"],
                                             out["fwd_bwd_graph_check"])]
    out["ok"] = all(checks)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="all", choices=["3", "4", "5", "all"])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--steps", type=int, default=120, help="config 3's steps")
    p.add_argument("--frames", type=int, default=48, help="config 4's frames")
    p.add_argument("--size", default="3840x2160", help="config 5's frame, WxH")
    p.add_argument("--octaves", type=int, default=6, help="config 5's octaves")
    p.add_argument("--k", type=int, default=K5, help="config 5's K of the slope")
    a = p.parse_args(argv)
    from gpgpuraytrace_tpu_torch.cli import _parse_size

    height, width = _parse_size(a.size)
    runs = {"3": lambda: config3(a.steps, device=a.device),
            "4": lambda: config4(a.frames, device=a.device),
            "5": lambda: config5(height, width, a.octaves, a.k, device=a.device)}
    ok = True
    for key in (["3", "4", "5"] if a.config == "all" else [a.config]):
        result = runs[key]()
        print(json.dumps(result), flush=True)
        ok = ok and result.get("ok", True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
