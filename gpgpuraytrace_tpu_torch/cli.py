"""Command line: render one frame, fit scene parameters to a target, render
flythrough frames with live tweaks, or write a tweak template.

  python -m gpgpuraytrace_tpu_torch.cli render --size 512 --octaves 6 -o frame.png
  python -m gpgpuraytrace_tpu_torch.cli fit --size 512 --steps 100
  python -m gpgpuraytrace_tpu_torch.cli fit --steps 100 --steps-per-call 8 --save fit.npz --resume
  python -m gpgpuraytrace_tpu_torch.cli render --volumetric --size 512 -o frame.png
  python -m gpgpuraytrace_tpu_torch.cli render --march-mode compact -o frame.png
  python -m gpgpuraytrace_tpu_torch.cli fly --size 512 --frames 60 --tweak live.json -o frames/
  python -m gpgpuraytrace_tpu_torch.cli tweaks -o live.json
  python -m gpgpuraytrace_tpu_torch.cli bench --size 512 --octaves 6 --iters 40
  python -m gpgpuraytrace_tpu_torch.cli bench --mesh 4

``--device cuda`` (the default) requires a CUDA GPU and raises without one;
``--device cpu`` runs the plain PyTorch versions. ``--kernel`` (the default)
renders through the trace kernel path, ``--no-kernel`` through the plain
op-by-op path. ``render`` and ``fly`` take ``--march-mode`` (the march
variant; RenderConfig's defaults for the rest, compaction's budget too).
``fit`` checkpoints and resumes (``--save``, ``--save-every``, ``--resume``)
and runs ``--steps-per-call`` steps per chunk (on the card one CUDA graph);
``fly`` renders each ``--batch`` of frames as one launch per pass (the
kernels' frame axis), on the card as one CUDA graph replayed per batch
(``ops/flythrough.py:FlyBatch``), and writes them through the native
writer's worker threads (``utils/native_io.py``), or the Python encoder when
it cannot be built; it reports the kernel launches of a batch and the
graph's replays. ``bench`` prints the benchmark's JSON line (``bench.py``: fwd+bwd
rays/s, its same-run parity gate, the checks of what was timed, the march
statistics; ``--mesh N`` the row-band scaling over N cards) and exits 1 when
the parity gate or a check fails.
There is no ``--aot-cache``: the port's compiled artifact is the kernel
library, built once per source hash (``kernels/build.py``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

BENCH_ITERS = 20  # bench's K, the JAX CLI's default (gpgpuraytrace_tpu/cli.py:360-363)


def _parse_size(s: str) -> tuple[int, int]:
    if "x" in s:
        w, h = s.split("x")
        return int(h), int(w)
    return int(s), int(s)


def _cfg_from_args(args):
    from gpgpuraytrace_tpu_torch.models.scene import RenderConfig

    h, w = _parse_size(args.size)
    # step_relax stays None: RenderConfig resolves 1.0 (heightfield) or 0.9
    # (volumetric) itself.
    return RenderConfig(
        height=h,
        width=w,
        max_steps=args.max_steps,
        num_octaves=args.octaves,
        use_kernel=args.kernel,
        volumetric=args.volumetric,
        supersample=args.supersample,
        prime_ds=args.prime_ds,
        **({"prime_margin": args.prime_margin}
           if args.prime_margin is not None else {}),
        **({"march_mode": args.march_mode} if "march_mode" in args else {}),
    )


def _device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda: CUDA is not available (no GPU, or a CPU-only "
            "torch); pass --device cpu to run the plain PyTorch versions"
        )
    return torch.device(name)


def _frame_seconds(render_fn, device: torch.device) -> float:
    """One frame's time: CUDA events on the GPU, the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        render_fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    render_fn()
    return time.perf_counter() - t0


def cmd_render(args):
    from gpgpuraytrace_tpu_torch.models.scene import default_scene
    from gpgpuraytrace_tpu_torch.ops.render import render
    from gpgpuraytrace_tpu_torch.ops.shade import tonemap
    from gpgpuraytrace_tpu_torch.utils.image import write_npy, write_png
    from gpgpuraytrace_tpu_torch.utils.profiling import warn_if_rough

    device = _device(args.device)
    cfg = _cfg_from_args(args)
    scene = default_scene(num_octaves=cfg.num_octaves, volumetric=cfg.volumetric,
                          device=device)
    warn_if_rough(scene, cfg)
    serve = torch.no_grad()(render)  # serving builds no autograd graph
    t0 = time.perf_counter()
    img = serve(scene, cfg)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    first_s = time.perf_counter() - t0  # includes the kernel build, if any
    frame_s = _frame_seconds(lambda: serve(scene, cfg), device)
    out = tonemap(img).cpu().numpy()
    if args.out.endswith(".npy"):
        write_npy(args.out, out)
    else:
        write_png(args.out, out)
    clock = "CUDA events" if device.type == "cuda" else "host clock"
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(
        f"rendered {cfg.width}x{cfg.height} ({cfg.num_octaves} octaves, "
        f"{'volumetric' if cfg.volumetric else 'heightfield'}, "
        f"kernel={cfg.use_kernel}, {name}) -> {args.out}  "
        f"first frame {first_s:.2f}s  frame {frame_s * 1e3:.3f} ms ({clock})  "
        f"{cfg.height * cfg.width / frame_s / 1e6:.1f} Mrays/s"
    )


def cmd_fit(args):
    from gpgpuraytrace_tpu_torch.models.scene import default_scene
    from gpgpuraytrace_tpu_torch.ops.fit import fit, perturb_scene
    from gpgpuraytrace_tpu_torch.ops.render import render

    device = _device(args.device)
    cfg = _cfg_from_args(args)
    target_scene = default_scene(num_octaves=cfg.num_octaves, volumetric=cfg.volumetric,
                                 device=device)
    with torch.no_grad():
        target = render(target_scene, cfg)
    scene0 = perturb_scene(target_scene, torch.Generator().manual_seed(args.seed), rel=0.15)
    t0 = time.perf_counter()
    scene, losses = fit(
        scene0, cfg, target, steps=args.steps, learning_rate=args.lr,
        save_path=args.save, save_every=args.save_every, resume=args.resume,
        steps_per_call=args.steps_per_call,
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    fit_s = time.perf_counter() - t0
    print(
        f"fit: loss {losses[0]:.4e} -> {losses[-1]:.4e} over {len(losses)} steps "
        f"({fit_s * 1e3:.1f} ms host clock for this run's steps, "
        f"steps_per_call={args.steps_per_call}; the first step includes the kernel build)"
    )
    amp_err = (scene.noise.amplitudes - target_scene.noise.amplitudes).abs().max().item()
    print(f"max |amplitude error| = {amp_err:.4f}")
    if args.out:
        np.savez(args.out, losses=np.asarray(losses),
                 amplitudes=scene.noise.amplitudes.detach().cpu().numpy())


def cmd_fly(args):
    from gpgpuraytrace_tpu_torch.models.scene import default_scene
    from gpgpuraytrace_tpu_torch.ops.flythrough import FlyBatch, fly_frames
    from gpgpuraytrace_tpu_torch.utils.image import write_png
    from gpgpuraytrace_tpu_torch.utils.profiling import warn_if_rough
    from gpgpuraytrace_tpu_torch.utils.tweak import TweakWatcher, apply_tweaks

    device = _device(args.device)
    cfg = _cfg_from_args(args)
    scene = default_scene(num_octaves=cfg.num_octaves, volumetric=cfg.volumetric,
                          device=device)
    warn_if_rough(scene, cfg)
    # Live tweaks: the watched JSON file is re-read before each batch.
    watcher = TweakWatcher(args.tweak) if args.tweak else None

    def on_batch(s):
        tweaks = None if watcher is None else watcher.poll()
        if tweaks is None:
            return s
        s, rejected = apply_tweaks(s, tweaks)
        warn_if_rough(s, cfg)  # live edits can push the scene rough
        applied = [k for k in tweaks if k not in rejected]
        if applied:
            print(f"tweaks applied: {', '.join(applied)}")
        for name in rejected:
            print(f"tweak rejected (unknown name or bad shape): {name}")
        return s

    os.makedirs(args.out, exist_ok=True)
    ext = args.format
    level = args.encode_level
    # The native writer's worker threads encode and write while the card
    # renders the next batch; without g++ or zlib, synchronous Python writes.
    writer = None
    try:
        from gpgpuraytrace_tpu_torch.utils.native_io import AsyncFrameWriter

        writer = AsyncFrameWriter(num_threads=2, level=level)
    except RuntimeError:
        pass
    program = FlyBatch(scene, cfg, args.batch)
    t0 = time.perf_counter()
    n = 0
    try:
        for idx, frame in fly_frames(scene, cfg, args.frames, batch=args.batch,
                                     on_batch=on_batch, program=program):
            path = os.path.join(args.out, f"frame_{idx:04d}.{ext}")
            if writer is not None:
                writer.push(path, frame)
            else:
                write_png(path, frame, level=level)
            n += 1
    finally:
        errs = writer.close() if writer is not None else 0
    dt = time.perf_counter() - t0  # the writer's queue drained
    if errs:
        raise RuntimeError(f"the native writer failed to write {errs} frames")
    runs = f"a CUDA graph replayed {program.replays} times" if program.graphed else "eager"
    print(
        f"flythrough: {n} frames {cfg.width}x{cfg.height} in {dt:.2f}s "
        f"({n / dt:.2f} fps incl. writing, host clock; on the card the first "
        f"batch includes the kernel build, the second the graph's capture; native={writer is not None}, format={ext}"
        + (f" zlib={level}" if ext == "png" else "")
        + f", march_mode={cfg.march_mode}; batches of {args.batch}, "
        f"{program.launches.total()} kernel launches per batch, {runs})"
    )


def cmd_tweaks(args):
    from gpgpuraytrace_tpu_torch.models.scene import default_scene
    from gpgpuraytrace_tpu_torch.utils.tweak import write_template

    device = _device(args.device)
    cfg = _cfg_from_args(args)
    scene = default_scene(num_octaves=cfg.num_octaves, volumetric=cfg.volumetric,
                          device=device)
    write_template(args.out, scene)
    print(f"wrote tweak template -> {args.out} (edit while `fly --tweak {args.out}` runs)")


def cmd_bench(args):
    """``bench.main`` with these options; K is the JAX CLI's 20 unless
    ``--iters`` or ``--mesh`` is given (then the bench's own default)."""
    from gpgpuraytrace_tpu_torch import bench

    iters = args.iters if args.iters is not None or args.mesh else BENCH_ITERS
    rc = bench.main(["--device", args.device, "--size", args.size, "--octaves",
                     str(args.octaves), "--mesh", str(args.mesh)]
                    + (["--iters", str(iters)] if iters is not None else []))
    if rc:
        sys.exit(rc)


def _common(sp, march_mode: bool = False):
    sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    sp.add_argument("--size", default="512", help="N or WxH")
    sp.add_argument("--octaves", type=int, default=6)
    sp.add_argument("--max-steps", type=int, default=128)
    sp.add_argument(
        "--kernel", default=True, action=argparse.BooleanOptionalAction,
        help="render through the trace kernel path (default) or the plain "
        "op-by-op PyTorch path",
    )
    sp.add_argument("--supersample", type=int, default=1, help="SSAA factor")
    if march_mode:
        sp.add_argument(
            "--march-mode", choices=["chunked", "fixed", "lod", "compact"],
            default="chunked",
            help="the march: chunked (default), fixed (no early exit), lod "
            "(coarse field first) or compact (two-phase ray compaction)",
        )
    sp.add_argument(
        "--volumetric", action="store_true",
        help="3D-warped terrain volume (overhangs; step relax 0.9)",
    )
    sp.add_argument(
        "--prime-ds", type=int, default=None,
        help="depth-priming coarse-prepass factor (default: auto, 8 when "
        "eligible; 0 disables)",
    )
    sp.add_argument(
        "--prime-margin", type=float, default=None,
        help="pull-back on the coarse neighbourhood min (default 0.95)",
    )


def main(argv=None):
    p = argparse.ArgumentParser(prog="gpgpuraytrace_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("render", help="render one frame")
    _common(sp, march_mode=True)
    sp.add_argument("-o", "--out", default="frame.png")
    sp.set_defaults(fn=cmd_render)
    sp = sub.add_parser("fit", help="recover params from a target image")
    _common(sp)
    sp.add_argument("--steps", type=int, default=300)
    sp.add_argument("--lr", type=float, default=5e-3)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--save", default="", metavar="PATH",
                    help="checkpoint the trainable params and Adam's state to PATH (.npz)")
    sp.add_argument("--save-every", type=int, default=25,
                    help="checkpoint interval in steps (with --save)")
    sp.add_argument("--resume", action="store_true",
                    help="resume from --save PATH if it exists (exact continuation)")
    sp.add_argument("--steps-per-call", type=int, default=1,
                    help="Adam steps per chunk; on the card one CUDA graph of the "
                    "chunk's steps, same trajectory, far fewer launches from the host")
    sp.add_argument("-o", "--out", default="",
                    help="write the losses and the fitted amplitudes to this .npz")
    sp.set_defaults(fn=cmd_fit)
    sp = sub.add_parser("fly", help="animated flythrough frames")
    _common(sp, march_mode=True)
    sp.add_argument("--frames", type=int, default=60)
    sp.add_argument("--batch", type=int, default=4, help="frames per batch")
    sp.add_argument(
        "--tweak", default="",
        help="watched JSON file of live scene overrides "
        '(e.g. {"noise.height_scale": 8.0}); re-read whenever it changes',
    )
    sp.add_argument("--encode-level", type=int, default=6, metavar="0-9",
                    help="PNG zlib effort; lower is faster, files larger")
    sp.add_argument(
        "--format", choices=["png", "rgb"], default="png",
        help="rgb = raw rgb24 frame dumps (ffmpeg -f rawvideo -pix_fmt rgb24 -s WxH)",
    )
    sp.add_argument("-o", "--out", default="frames")
    sp.set_defaults(fn=cmd_fly)
    sp = sub.add_parser("tweaks", help="write an editable tweak-file template of the scene")
    _common(sp)
    sp.add_argument("-o", "--out", default="tweaks.json")
    sp.set_defaults(fn=cmd_tweaks)
    sp = sub.add_parser("bench", help="benchmark fwd+bwd rays/s (one JSON line)")
    sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    sp.add_argument("--size", default="512", help="N or WxH")
    sp.add_argument("--octaves", type=int, default=6)
    sp.add_argument("--iters", type=int, default=None,
                    help=f"K of the slope (T(K) - T(1)) / (K - 1) (default {BENCH_ITERS}; "
                         "with --mesh, the bench's)")
    sp.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="the row-band scaling harness over 1, 2, 4, ... N cards")
    sp.set_defaults(fn=cmd_bench)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
