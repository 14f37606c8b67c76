"""Command line: render one frame.

  python -m gpgpuraytrace_tpu_torch.cli render --size 512 --octaves 6 -o frame.png

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

    if args.volumetric:
        from gpgpuraytrace_tpu_torch.ops.field import VOLUMETRIC_TODO

        raise NotImplementedError(VOLUMETRIC_TODO)
    h, w = _parse_size(args.size)
    return RenderConfig(
        height=h,
        width=w,
        max_steps=args.max_steps,
        num_octaves=args.octaves,
        use_kernel=args.kernel,
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

    device = _device(args.device)
    cfg = _cfg_from_args(args)
    scene = default_scene(num_octaves=cfg.num_octaves, device=device)
    t0 = time.perf_counter()
    img = render(scene, cfg)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    first_s = time.perf_counter() - t0  # includes the kernel build, if any
    frame_s = _frame_seconds(lambda: render(scene, cfg), device)
    out = tonemap(img).cpu().numpy()
    if args.out.endswith(".npy"):
        write_npy(args.out, out)
    else:
        write_png(args.out, out)
    clock = "CUDA events" if device.type == "cuda" else "host clock"
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(
        f"rendered {cfg.width}x{cfg.height} ({cfg.num_octaves} octaves, "
        f"kernel={cfg.use_kernel}, {name}) -> {args.out}  "
        f"first frame {first_s:.2f}s  frame {frame_s * 1e3:.3f} ms ({clock})  "
        f"{cfg.height * cfg.width / frame_s / 1e6:.1f} Mrays/s"
    )


def main(argv=None):
    p = argparse.ArgumentParser(prog="gpgpuraytrace_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("render", help="render one frame")
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
        help="3D-warped terrain volume (not ported yet: raises)",
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
    sp.add_argument("-o", "--out", default="frame.png")
    sp.set_defaults(fn=cmd_render)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
