"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (``gpgpuraytrace_tpu_torch.render`` of a 512x512,
6-octave frame under the default RenderConfig) through the hand-written CUDA
trace kernel, in phases; each prints one line and any failure exits non-zero:

1. host: CUDA present; card name and power limit; CUDA and nvcc versions;
2. build: the kernels from gpgpuraytrace_tpu_torch/kernels/csrc;
3. the kernel against its plain PyTorch version on the card, at the main
   path's shapes (coarse prime pass 66x64, then the 512x512 pass);
4. the main path: 3 frames at 3 camera yaws, 2 kernel launches each;
5. the frozen golden image (tests/golden/config1_128.npy) through the kernel;
6. the command line renders a PNG;
7. frame times, kernel path vs plain path, with CUDA events.

The second-to-last line is a JSON record of the kernel; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "golden" / "config1_128.npy"
# Kernel vs plain version on the card. 99.9% of colour values within 2e-3
# (grazing rays are chaotic: one rounding can make a ray catch or skim a
# ridge) and 99% within 1e-4: FMA contraction and rsqrtf's 2-ulp error move
# the rounding of the bulk, so 1e-4 rather than the CPU suite's 1e-5.
COLOR_ATOL, COLOR_FRAC = 2e-3, 0.999
BULK_ATOL, BULK_FRAC = 1e-4, 0.99
HIT_AGREE = 0.995
T_ATOL, T_FRAC = 5e-2, 0.999


def phase(n: int, name: str, msg: str) -> None:
    print(f"[{n}] {name}: {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def frac_within(a: torch.Tensor, b: torch.Tensor, atol: float) -> float:
    return (a - b).abs().le(atol).float().mean().item()


def check_close(name, a, b, atol, frac):
    got = frac_within(a, b, atol)
    if got < frac:
        fail(f"{name}: {100 * got:.4f}% within {atol} (need {100 * frac}%)")
    return got


def compare_trace(tag, kern, ref):
    """Hold a kernel result (color, t, hit) against the plain version's."""
    (ck, tk, hk), (cr, tr, hr) = kern, ref
    for x in (ck, tk):
        if not torch.isfinite(x).all():
            fail(f"{tag}: kernel output not finite")
    c2 = check_close(f"{tag} color", ck, cr, COLOR_ATOL, COLOR_FRAC)
    c4 = check_close(f"{tag} color bulk", ck, cr, BULK_ATOL, BULK_FRAC)
    agree = (hk == hr).float().mean().item()
    if agree <= HIT_AGREE:
        fail(f"{tag}: hit masks agree on {100 * agree:.3f}% (need > {100 * HIT_AGREE}%)")
    both = (hk > 0.5) & (hr > 0.5)
    tf = check_close(f"{tag} t", tk[both], tr[both], T_ATOL, T_FRAC) if both.any() else 1.0
    err = (ck - cr).abs().max().item()
    return err, (f"{tag}: color {100 * c2:.4f}% <= {COLOR_ATOL}, {100 * c4:.4f}% <= "
                 f"{BULK_ATOL}, max abs err {err:.3e}; hit agree {100 * agree:.4f}%; "
                 f"t {100 * tf:.4f}% <= {T_ATOL}")


def cuda_ms(fn, reps: int) -> list[float]:
    """Per-call device times (ms) of ``fn`` by CUDA events, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def cuda_ms_back_to_back(fn, reps: int) -> float:
    """Device time (ms) per call of ``reps`` calls enqueued back to back
    between one pair of CUDA events, after a warm-up: for a kernel that
    outlasts its launch, the host's launch latency drops out."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profile_frames(fn, frame_ms: float, frames: int = 5) -> str:
    """Device time by kernel over ``frames`` calls (torch.profiler), and the
    device's busy share of the frame time measured with CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            fn()
        torch.cuda.synchronize()
    # Device-side events only (kernels, copies): the host ops that launched
    # them report the same device time again.
    per_kernel = sorted(
        ((e.self_device_time_total / frames, e.key) for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and e.self_device_time_total > 0),
        reverse=True,
    )
    if not per_kernel:
        return "the profiler saw no device time"
    busy_us = sum(us for us, _ in per_kernel)
    top = "; ".join(f"{us:.1f} us {key[:60]}" for us, key in per_kernel[:6])
    return (f"device busy {busy_us:.1f} us of a {frame_ms * 1e3:.1f} us frame "
            f"({100 * busy_us / (frame_ms * 1e3):.1f}%), {len(per_kernel)} kernels; "
            f"top: {top}")


def main() -> None:
    # --- 1. host -----------------------------------------------------------
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke run needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from gpgpuraytrace_tpu_torch import RenderConfig, default_scene, render
    from gpgpuraytrace_tpu_torch.kernels import build
    from gpgpuraytrace_tpu_torch.kernels.trace import trace_frame, trace_frame_reference
    from gpgpuraytrace_tpu_torch.ops.march import coarse_prime_cfg, prime_from_coarse
    from gpgpuraytrace_tpu_torch.utils.packing import pack_scene

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    phase(1, "host", f"{name}; nvidia-smi '{smi}'; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}; nvcc {build.find_nvcc()}")

    # --- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, log = build.build_library()
    build_s = time.perf_counter() - t0
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"    ptxas: {line.strip()}")
    phase(2, "build", f"{lib_path.relative_to(REPO)} in {build_s:.2f} s")

    # --- 3. kernel vs plain version at the main path's shapes --------------
    cfg = RenderConfig(num_octaves=6)  # 512x512, the default march
    scene = default_scene(6, device=dev)
    ccfg = coarse_prime_cfg(cfg)
    ch = cfg.height // cfg.prime_ds + 2
    with torch.no_grad():
        packed_c, seed = pack_scene(scene, ccfg.height, ccfg.width, -1.0)
        coarse_k = trace_frame(packed_c, seed, ccfg, ch)
        coarse_r = trace_frame_reference(packed_c, seed, ccfg, ch)
        torch.cuda.synchronize()
        _, line_c = compare_trace(f"coarse {ch}x{ccfg.width}", coarse_k, coarse_r)
        prime = prime_from_coarse(coarse_k[1], cfg)
        packed, seed = pack_scene(scene, cfg.height, cfg.width, 0.0)
        fine_k = trace_frame(packed, seed, cfg, cfg.height, prime)
        fine_r = trace_frame_reference(packed, seed, cfg, cfg.height, prime)
        torch.cuda.synchronize()
        err, line_f = compare_trace(f"fine {cfg.height}x{cfg.width}", fine_k, fine_r)
        kern_ms = cuda_ms_back_to_back(
            lambda: trace_frame(packed, seed, cfg, cfg.height, prime), 50)
        plain_ms = cuda_ms_back_to_back(
            lambda: trace_frame_reference(packed, seed, cfg, cfg.height, prime), 3)
    phase(3, "kernel vs plain", f"{line_c} | {line_f} | fine pass {kern_ms:.4f} ms "
          f"kernel (50 back to back), {plain_ms:.3f} ms plain (3) ({name}, {smi})")

    # --- 4. the main path ----------------------------------------------------
    yaws = (0.0, 0.7, -1.3)
    frames = []
    trace_frame.launches = 0
    for yaw in yaws:
        with torch.no_grad():
            scene.camera.yaw.fill_(yaw)
        frames.append(render(scene, cfg))
    torch.cuda.synchronize()
    launches = trace_frame.launches
    if launches != 2 * len(yaws):
        fail(f"main path launched the trace kernel {launches} times, "
             f"expected {2 * len(yaws)} (coarse + fine per frame)")
    for yaw, img in zip(yaws, frames):
        if img.shape != (cfg.height, cfg.width, 3) or not torch.isfinite(img).all():
            fail(f"frame at yaw {yaw}: shape {tuple(img.shape)} or non-finite")
        if img.min().item() < 0.0:
            fail(f"frame at yaw {yaw}: negative colour")
        top = img[:8].mean(dim=(0, 1))
        if not top[2] > top[0]:
            fail(f"frame at yaw {yaw}: top rows not blue-dominant sky ({top.tolist()})")
    means = ", ".join(f"{img.mean().item():.4f}" for img in frames)
    phase(4, "main path", f"{len(frames)} frames 512x512, {launches} kernel launches; "
          f"mean colour {means}")

    # --- 5. golden image through the kernel ---------------------------------
    cfg1 = RenderConfig(height=128, width=128, max_steps=96, num_octaves=1,
                        step_floor_t=0.0, step_relax=0.7, newton_iters=4, prime_ds=0)
    golden = torch.from_numpy(np.load(GOLDEN)).to(dev)
    before = trace_frame.launches
    img1 = render(default_scene(1, device=dev), cfg1)
    if trace_frame.launches != before + 1:
        fail("golden render did not go through the kernel")
    g2 = check_close("golden", img1, golden, COLOR_ATOL, COLOR_FRAC)
    g4 = check_close("golden bulk", img1, golden, BULK_ATOL, BULK_FRAC)
    phase(5, "golden", f"config1_128: {100 * g2:.4f}% <= {COLOR_ATOL}, "
          f"{100 * g4:.4f}% <= {BULK_ATOL}, max abs err "
          f"{(img1 - golden).abs().max().item():.3e}")

    # --- 6. command line -----------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "frame.png")
        proc = subprocess.run(
            [sys.executable, "-m", "gpgpuraytrace_tpu_torch.cli", "render",
             "--size", "512", "--octaves", "6", "-o", png],
            cwd=REPO, capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            fail(f"cli render exited {proc.returncode}: {proc.stderr[-2000:]}")
        with open(png, "rb") as fh:
            if fh.read(8) != b"\x89PNG\r\n\x1a\n":
                fail("cli render wrote no valid PNG")
    phase(6, "cli", proc.stdout.strip())

    # --- 7. frame times --------------------------------------------------------
    scene = default_scene(6, device=dev)
    plain_cfg = RenderConfig(num_octaves=6, use_kernel=False)
    times = {}
    for label, c in (("kernel", cfg), ("plain", plain_cfg), ("kernel", cfg),
                     ("plain", plain_cfg)):
        times.setdefault(label, []).extend(cuda_ms(lambda: render(scene, c), 5))
    frame_kernel = statistics.median(times["kernel"])
    frame_plain = statistics.median(times["plain"])
    phase(7, "times", f"512x512 6 octaves, median of {len(times['kernel'])} frames: "
          f"kernel path {frame_kernel:.4f} ms, plain path {frame_plain:.3f} ms "
          f"({name}, {smi})")
    print(f"    where a kernel-path frame goes: {profile_frames(lambda: render(scene, cfg), frame_kernel)}")

    record = {"kernels": [{
        "name": "trace_fwd",
        "route": "cuda",
        "source": "gpgpuraytrace_tpu_torch/kernels/csrc/trace_fwd.cu",
        "replaces": "gpgpuraytrace_tpu/kernels/trace.py:510",
        "launches": launches,
        "max_abs_err": err,
        "ms": kern_ms,
        "plain_ms": plain_ms,
    }]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
