"""Command line: render one frame, or fit scene parameters to a target.

  python -m gpgpuraytrace_tpu_torch.cli render --size 512 --octaves 6 -o frame.png
  python -m gpgpuraytrace_tpu_torch.cli fit --size 512 --steps 100
  python -m gpgpuraytrace_tpu_torch.cli render --volumetric --size 512 -o frame.png

``--device cuda`` (the default) requires a CUDA GPU and raises without one;
``--device cpu`` runs the plain PyTorch versions. ``--kernel`` (the default)
renders through the trace kernel path, ``--no-kernel`` through the plain
op-by-op path.
"""

from __future__ import annotations

import argparse
import time

import torch


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
    from gpgpuraytrace_tpu_torch.utils.profiling import warn_if_rough

    device = _device(args.device)
    cfg = _cfg_from_args(args)
    target_scene = default_scene(num_octaves=cfg.num_octaves, volumetric=cfg.volumetric,
                                 device=device)
    warn_if_rough(target_scene, cfg)
    with torch.no_grad():
        target = render(target_scene, cfg)
    scene0 = perturb_scene(target_scene, torch.Generator().manual_seed(args.seed), rel=0.15)
    t0 = time.perf_counter()
    scene, losses = fit(scene0, cfg, target, steps=args.steps, learning_rate=args.lr)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    fit_s = time.perf_counter() - t0
    print(
        f"fit: loss {losses[0]:.4e} -> {losses[-1]:.4e} over {len(losses)} steps "
        f"({fit_s / len(losses) * 1e3:.2f} ms/step host clock, first step "
        f"includes the kernel build)"
    )
    amp_err = (scene.noise.amplitudes - target_scene.noise.amplitudes).abs().max().item()
    print(f"max |amplitude error| = {amp_err:.4f}")


def _common(sp):
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
    _common(sp)
    sp.add_argument("-o", "--out", default="frame.png")
    sp.set_defaults(fn=cmd_render)
    sp = sub.add_parser("fit", help="recover params from a target image")
    _common(sp)
    sp.add_argument("--steps", type=int, default=300)
    sp.add_argument("--lr", type=float, default=5e-3)
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(fn=cmd_fit)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
