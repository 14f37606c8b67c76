"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two main paths at 512x512 with 6 octaves under the default
RenderConfig, through the hand-written CUDA trace kernels: serving
(``gpgpuraytrace_tpu_torch.render`` of a frame) and training (``ops.fit.fit``,
forward and backward, Adam steps), on the heightfield (phases 3-10) and on
the volumetric terrain with its 2-octave 3D warp (phases 11-14). In phases;
each prints one line and any failure exits non-zero:

1. host: CUDA present; card name and power limit; CUDA and nvcc versions;
2. build: the kernels from gpgpuraytrace_tpu_torch/kernels/csrc, one nvcc
   per source, in parallel;
3. the forward kernel against its plain PyTorch version on the card, at the
   main path's shapes (coarse prime pass 66x64, then the 512x512 pass);
4. the serving path: 3 frames at 3 camera yaws, 2 forward launches each;
5. the frozen golden image (tests/golden/config1_128.npy) through the kernel;
6. the command line renders a PNG, heightfield and volumetric;
7. serving frame times, kernel path vs plain path, with CUDA events;
8. the backward kernel against its plain version at 512x512, on the forward
   kernel's own (t, hit), bitwise repeatable, and its time;
9. the training path: 5 Adam steps of fit, 2 forward and 1 backward launch
   each, falling loss; kernel_bwd True vs False gradients; step times;
10. AD against finite differences through the kernel path at 512x512, on
    tests/test_grad.py's 2-octave scene (the 6-octave scene reported only);
11. volumetric: the forward kernel against its plain version (coarse and fine
    pass, phase 3's gates) and its time;
12. volumetric serving: 3 frames at 3 yaws, 2 forward launches each; frame
    times, kernel path vs plain path; the device's busy share;
13. volumetric: the backward kernel against its plain version on the forward
    kernel's own (t, hit), bitwise repeatable, warp entries non-zero; time;
14. volumetric training: 5 Adam steps of fit with the warp amplitude
    trainable, 2 forward and 1 backward launch each, falling loss;
    kernel_bwd True vs False gradients; step times; AD vs FD of the warp
    amplitude on a 2-octave volumetric scene, reported only.

A line before the last is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import dataclasses
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
# Backward kernel vs its plain version: every packed entry within rtol 1e-3
# plus 1e-4 of the largest. The sums over 262,144 pixels run in another order,
# and rsqrtf, expf and FMA contraction round differently from torch.
BWD_RTOL, BWD_ATOL_REL = 1e-3, 1e-4
# Range of the serving frame times recorded before the training path was
# added, on an H100 80GB HBM3 at 700 W (PERF.md, section 5, runs 1-5).
RECORDED_FRAME_MS = (1.0306, 1.4094)
# The packed entries of the volumetric warp's amplitude and frequency
# (utils/packing.py WARP_AMP, WARP_FREQ).
WARP_ENTRIES = slice(48, 50)
# AD vs FD checks of tests/test_grad.py: (leaf, component, eps, rtol, t_cap).
FD_CHECKS = (
    ("noise.amplitudes", 0, 3e-3, 5e-2, 0.03),
    ("camera.yaw", None, 3e-3, 5e-2, 0.1),
    ("materials.fog_density", None, 1e-4, 1e-2, 0.1),
)


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


def bwd_error(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs error, worst error as a fraction of its tolerance)."""
    err = (got - ref).abs()
    tol = BWD_RTOL * ref.abs() + BWD_ATOL_REL * ref.abs().max()
    return err.max().item(), (err / tol).max().item()


def reset_counts(*wrappers) -> None:
    for w in wrappers:
        w.launches = 0


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
    # them report the same device time again, and a user annotation such as
    # Optimizer.step's reports the span of its kernels, gaps included.
    per_kernel = sorted(
        ((e.self_device_time_total / frames, e.key) for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and not getattr(e, "is_user_annotation", False)
         and e.self_device_time_total > 0),
        reverse=True,
    )
    if not per_kernel:
        return "the profiler saw no device time"
    busy_us = sum(us for us, _ in per_kernel)
    top = "; ".join(f"{us:.1f} us {key[:60]}" for us, key in per_kernel[:6])
    return (f"device busy {busy_us:.1f} us of a {frame_ms * 1e3:.1f} us call "
            f"({100 * busy_us / (frame_ms * 1e3):.1f}%), {len(per_kernel)} kernels; "
            f"top: {top}")


def forward_vs_plain(scene, cfg, tag: str) -> tuple[float, str, float, float]:
    """The forward kernel against its plain version at the main path's shapes
    (the coarse prime pass, then the fine pass from the kernel's prime map)
    with phase 3's gates, and the fine pass's time: (max abs colour error,
    report, kernel ms, plain ms)."""
    from gpgpuraytrace_tpu_torch.kernels.trace import trace_frame, trace_frame_reference
    from gpgpuraytrace_tpu_torch.ops.march import coarse_prime_cfg, prime_from_coarse
    from gpgpuraytrace_tpu_torch.utils.packing import pack_scene

    ccfg = coarse_prime_cfg(cfg)
    ch = cfg.height // cfg.prime_ds + 2
    with torch.no_grad():
        packed_c, seed = pack_scene(scene, ccfg.height, ccfg.width, -1.0)
        coarse_k = trace_frame(packed_c, seed, ccfg, ch)
        coarse_r = trace_frame_reference(packed_c, seed, ccfg, ch)
        torch.cuda.synchronize()
        _, line_c = compare_trace(f"{tag}coarse {ch}x{ccfg.width}", coarse_k, coarse_r)
        prime = prime_from_coarse(coarse_k[1], cfg)
        packed, seed = pack_scene(scene, cfg.height, cfg.width, 0.0)
        fine_k = trace_frame(packed, seed, cfg, cfg.height, prime)
        fine_r = trace_frame_reference(packed, seed, cfg, cfg.height, prime)
        torch.cuda.synchronize()
        err, line_f = compare_trace(f"{tag}fine {cfg.height}x{cfg.width}", fine_k, fine_r)
        kern_ms = cuda_ms_back_to_back(
            lambda: trace_frame(packed, seed, cfg, cfg.height, prime), 50)
        plain_ms = cuda_ms_back_to_back(
            lambda: trace_frame_reference(packed, seed, cfg, cfg.height, prime), 3)
    return err, (f"{line_c} | {line_f} | fine pass {kern_ms:.4f} ms kernel (50 back to "
                 f"back), {plain_ms:.3f} ms plain (3)"), kern_ms, plain_ms


def serve_frames(scene, cfg, yaws) -> tuple[int, str]:
    """The serving path: one frame per camera yaw under ``torch.no_grad()``,
    with the launch counts read around exactly these frames: (forward
    launches, mean colours)."""
    from gpgpuraytrace_tpu_torch import render
    from gpgpuraytrace_tpu_torch.kernels.trace import trace_frame, trace_frame_bwd

    frames = []
    reset_counts(trace_frame, trace_frame_bwd)
    with torch.no_grad():  # serving builds no autograd graph
        for yaw in yaws:
            scene.camera.yaw.fill_(yaw)
            frames.append(render(scene, cfg))
    torch.cuda.synchronize()
    launches = trace_frame.launches
    if launches != 2 * len(yaws) or trace_frame_bwd.launches:
        fail(f"serving path launched the forward kernel {launches} times and the "
             f"backward {trace_frame_bwd.launches} times, expected "
             f"{2 * len(yaws)} (coarse + fine per frame) and 0")
    for yaw, img in zip(yaws, frames):
        if img.shape != (cfg.height, cfg.width, 3) or not torch.isfinite(img).all():
            fail(f"frame at yaw {yaw}: shape {tuple(img.shape)} or non-finite")
        if img.min().item() < 0.0:
            fail(f"frame at yaw {yaw}: negative colour")
        top = img[:8].mean(dim=(0, 1))
        if not top[2] > top[0]:
            fail(f"frame at yaw {yaw}: top rows not blue-dominant sky ({top.tolist()})")
    return launches, ", ".join(f"{img.mean().item():.4f}" for img in frames)


def frame_times(scene, cfg, reps: dict[str, int]) -> tuple[dict, dict, str]:
    """Serving frame times by CUDA events, kernel and plain path in turns
    (kernel, plain, kernel, plain; ``reps`` frames each): (median ms by
    path, frames by path, profile of a kernel-path frame)."""
    from gpgpuraytrace_tpu_torch import render

    plain_cfg = dataclasses.replace(cfg, use_kernel=False)
    serve = torch.no_grad()(render)
    times = {}
    for label, c in (("kernel", cfg), ("plain", plain_cfg)) * 2:
        times.setdefault(label, []).extend(cuda_ms(lambda: serve(scene, c), reps[label]))
    median = {k: statistics.median(v) for k, v in times.items()}
    prof = profile_frames(lambda: serve(scene, cfg), median["kernel"])
    return median, {k: len(v) for k, v in times.items()}, prof


def backward_vs_plain(scene, cfg) -> dict:
    """The backward kernel against its plain version at 512x512, on the
    forward kernel's own (t, hit): finite, two launches bitwise equal, every
    entry within BWD_RTOL plus BWD_ATOL_REL of the largest; and its time."""
    from gpgpuraytrace_tpu_torch.kernels.trace import (
        render_kernel_raw, trace_bwd_reference, trace_frame_bwd,
    )
    from gpgpuraytrace_tpu_torch.utils.packing import pack_scene

    _, t_fwd, hit_fwd = render_kernel_raw(scene, cfg)
    hit_fwd = hit_fwd.float()
    packed, seed = pack_scene(scene, cfg.height, cfg.width, 0.0)
    packed = packed.detach()
    g = torch.randn(3, cfg.height, cfg.width,
                    generator=torch.Generator().manual_seed(0)).to(packed.device)
    args = (packed, seed, cfg, cfg.height, t_fwd, hit_fwd, g)
    pbar_k = trace_frame_bwd(*args)
    pbar_k2 = trace_frame_bwd(*args)
    pbar_r = trace_bwd_reference(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(pbar_k).all():
        fail("backward kernel output not finite")
    if not torch.equal(pbar_k, pbar_k2):
        fail("two backward launches differ: the reduction is not deterministic")
    err, worst = bwd_error(pbar_k, pbar_r)
    if worst > 1.0:
        fail(f"backward kernel vs plain: worst entry at {worst:.3f} of its "
             f"tolerance (max abs err {err:.3e})")
    return {
        "pbar": pbar_k, "ref": pbar_r, "err": err, "worst": worst,
        "hits": int(hit_fwd.sum().item()),
        "ms": cuda_ms_back_to_back(lambda: trace_frame_bwd(*args), 50),
        "plain_ms": cuda_ms_back_to_back(lambda: trace_bwd_reference(*args), 3),
    }


def bwd_report(b: dict) -> str:
    return (f"{b['pbar'].shape[1]} packed entries on the fine pass's (t, hit), "
            f"{b['hits']} hits: max abs err {b['err']:.3e}, worst entry at "
            f"{b['worst']:.4f} of rtol {BWD_RTOL} + {BWD_ATOL_REL} x max|pbar| "
            f"({b['ref'].abs().max().item():.4e}); two launches bitwise equal; "
            f"{b['ms']:.4f} ms kernel (50 back to back), {b['plain_ms']:.3f} ms plain (3)")


def train(start, target, cfg, trainable, steps: int, reps: dict[str, int]) -> dict:
    """The training path: ``steps`` Adam steps of fit from ``start`` with the
    launch counts read around exactly them (2 forward and 1 backward launch
    per step), a falling loss, kernel_bwd True vs False gradients on every
    trainable leaf, and step times by CUDA events (``reps`` steps per
    variant, two rounds in turns) with a profile of a kernel-path step."""
    from gpgpuraytrace_tpu_torch.kernels.trace import trace_frame, trace_frame_bwd
    from gpgpuraytrace_tpu_torch.ops import fit as fitmod

    reset_counts(trace_frame, trace_frame_bwd)
    _, losses = fitmod.fit(copy.deepcopy(start), cfg, target, steps=steps,
                           learning_rate=5e-3, trainable=trainable, log_every=0)
    torch.cuda.synchronize()
    fwd, bwd = trace_frame.launches, trace_frame_bwd.launches
    if (fwd, bwd) != (2 * steps, steps):
        fail(f"training path launched the forward kernel {fwd} and the backward "
             f"{bwd} times in {steps} steps, expected {2 * steps} and {steps}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"fit losses not finite or not falling: {losses}")
    grads = []
    for kernel_bwd in (True, False):
        s = copy.deepcopy(start)
        fitmod.partition_scene(s, trainable)
        fitmod.pixel_loss(s, dataclasses.replace(cfg, kernel_bwd=kernel_bwd),
                          target).backward()
        grads.append({n: p.grad for n, p in s.named_parameters() if p.grad is not None})
    worst_leaf = 0.0
    for leaf, ref in grads[1].items():
        _, w = bwd_error(grads[0][leaf], ref)
        worst_leaf = max(worst_leaf, w)
        if w > 1.0:
            fail(f"{leaf}: kernel_bwd gradient at {w:.3f} of its tolerance vs the "
                 f"plain re-shade")
    step_cfgs = {"kernel": cfg, "kernel fwd + plain bwd":
                 dataclasses.replace(cfg, kernel_bwd=False),
                 "plain": dataclasses.replace(cfg, use_kernel=False)}
    step_times = {}
    for _ in range(2):
        for label, c in step_cfgs.items():
            s = copy.deepcopy(start)
            opt = fitmod.make_optimizer(fitmod.partition_scene(s, trainable), 5e-3)
            step_times.setdefault(label, []).extend(
                cuda_ms(lambda: fitmod.fit_step(s, c, target, opt), reps[label]))
    step_ms = {k: statistics.median(v) for k, v in step_times.items()}
    s = copy.deepcopy(start)
    opt = fitmod.make_optimizer(fitmod.partition_scene(s, trainable), 5e-3)
    prof = profile_frames(lambda: fitmod.fit_step(s, cfg, target, opt), step_ms["kernel"])
    return {"losses": losses, "fwd": fwd, "bwd": bwd, "leaves": sorted(grads[1]),
            "worst_leaf": worst_leaf, "step_ms": step_ms, "prof": prof}


def train_report(r: dict, steps: int) -> str:
    return (f"{steps} Adam steps: loss " + " ".join(f"{x:.4e}" for x in r["losses"])
            + f"; {r['fwd']} forward and {r['bwd']} backward launches; "
            f"{len(r['leaves'])} leaves kernel_bwd True vs False, worst at "
            f"{r['worst_leaf']:.4f} of tolerance; step time (median, CUDA events): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in r["step_ms"].items()))


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
    from gpgpuraytrace_tpu_torch.kernels.trace import trace_frame, trace_frame_bwd
    from gpgpuraytrace_tpu_torch.ops import fit as fitmod
    from gpgpuraytrace_tpu_torch.ops.fd_check import fd_check_scalar, scene_with

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card = f"({smi})"
    phase(1, "host", f"{name}; nvidia-smi '{smi}'; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}; nvcc {build.find_nvcc()}")

    # --- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, log = build.build_library()
    build_s = time.perf_counter() - t0
    for line in log.splitlines():
        if line.startswith("---") or "registers" in line or "spill" in line:
            print(f"    ptxas: {line.strip()}")
    phase(2, "build", f"{lib_path.relative_to(REPO)} in {build_s:.2f} s")

    # --- 3. kernel vs plain version at the main path's shapes --------------
    cfg = RenderConfig(num_octaves=6)  # 512x512, the default march
    err, line, kern_ms, plain_ms = forward_vs_plain(default_scene(6, device=dev), cfg, "")
    phase(3, "kernel vs plain", f"{line} {card}")

    # --- 4. the main path ----------------------------------------------------
    yaws = (0.0, 0.7, -1.3)
    serve_launches, means = serve_frames(default_scene(6, device=dev), cfg, yaws)
    phase(4, "serving path", f"{len(yaws)} frames 512x512, {serve_launches} kernel "
          f"launches; mean colour {means}")

    # --- 5. golden image through the kernel ---------------------------------
    cfg1 = RenderConfig(height=128, width=128, max_steps=96, num_octaves=1,
                        step_floor_t=0.0, step_relax=0.7, newton_iters=4, prime_ds=0)
    golden = torch.from_numpy(np.load(GOLDEN)).to(dev)
    before = trace_frame.launches
    with torch.no_grad():
        img1 = render(default_scene(1, device=dev), cfg1)
    if trace_frame.launches != before + 1:
        fail("golden render did not go through the kernel")
    g2 = check_close("golden", img1, golden, COLOR_ATOL, COLOR_FRAC)
    g4 = check_close("golden bulk", img1, golden, BULK_ATOL, BULK_FRAC)
    phase(5, "golden", f"config1_128: {100 * g2:.4f}% <= {COLOR_ATOL}, "
          f"{100 * g4:.4f}% <= {BULK_ATOL}, max abs err "
          f"{(img1 - golden).abs().max().item():.3e}")

    # --- 6. command line -----------------------------------------------------
    cli_lines = []
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "frame.png")
        for extra in ([], ["--volumetric"]):
            proc = subprocess.run(
                [sys.executable, "-m", "gpgpuraytrace_tpu_torch.cli", "render",
                 "--size", "512", "--octaves", "6", *extra, "-o", png],
                cwd=REPO, capture_output=True, text=True, timeout=600,
            )
            if proc.returncode != 0:
                fail(f"cli render {extra} exited {proc.returncode}: {proc.stderr[-2000:]}")
            with open(png, "rb") as fh:
                if fh.read(8) != b"\x89PNG\r\n\x1a\n":
                    fail(f"cli render {extra} wrote no valid PNG")
            os.remove(png)
            cli_lines.append(proc.stdout.strip())
    phase(6, "cli", " | ".join(cli_lines))

    # --- 7. serving frame times -------------------------------------------------
    frame, n_frames, prof = frame_times(
        default_scene(6, device=dev), cfg, {"kernel": 5, "plain": 5})
    frame_kernel = frame["kernel"]
    lo, hi = RECORDED_FRAME_MS
    moved = ("within" if lo <= frame_kernel <= hi else
             "below" if frame_kernel < lo else "above")
    phase(7, "serving times", f"512x512 6 octaves, median of {n_frames['kernel']} "
          f"frames: kernel path {frame_kernel:.4f} ms, plain path {frame['plain']:.3f} ms "
          f"{card}; {moved} the recorded {lo}-{hi} ms (PERF.md runs 1-5)")
    print(f"    where a kernel-path frame goes: {prof}")

    # --- 8. backward kernel vs plain version at 512x512 ---------------------------
    bwd = backward_vs_plain(default_scene(6, device=dev), cfg)
    phase(8, "backward kernel vs plain", f"{bwd_report(bwd)} {card}")

    # --- 9. the training path --------------------------------------------------------
    target_scene = default_scene(6, device=dev)
    with torch.no_grad():
        target = render(target_scene, cfg)
    start = fitmod.perturb_scene(target_scene, torch.Generator().manual_seed(0), rel=0.15)
    steps = 5
    tr = train(start, target, cfg, fitmod.default_trainable, steps,
               {"kernel": 10, "kernel fwd + plain bwd": 3, "plain": 2})
    phase(9, "training path", f"fit 512x512 6 octaves, {train_report(tr, steps)} {card}")
    print(f"    where a kernel-path training step goes: {tr['prof']}")

    # --- 10. AD vs finite differences through the kernel path ---------------------
    # Gated on tests/test_grad.py's scene (2 octaves) at 512x512, primed. The
    # 6-octave scene is measured and reported only: the JAX reference's own
    # fd_check shows the same gap there (ROADMAP.md section C).
    reset_counts(trace_frame, trace_frame_bwd)
    fd_lines = []
    for octaves, gated in ((2, True), (6, False)):
        fd_cfg = RenderConfig(num_octaves=octaves)
        scene = default_scene(octaves, device=dev)
        bright = copy.deepcopy(scene)
        with torch.no_grad():
            bright.noise.amplitudes.mul_(1.1)
            target = render(bright, fd_cfg)
        for leaf, index, eps, rtol, t_cap in FD_CHECKS:
            base = dict(scene.named_parameters())[leaf].detach()
            theta0 = base if index is None else base[index]
            ad, fd = fd_check_scalar(lambda th: scene_with(scene, leaf, th, index),
                                     theta0, fd_cfg, target, eps=eps, t_cap=t_cap)
            label = f"{octaves} oct {leaf}" + ("" if index is None else f"[{index}]")
            rel = abs(ad - fd) / max(abs(fd), 1e-5)
            if gated and not (np.isfinite(ad) and np.isfinite(fd) and rel <= rtol):
                fail(f"AD vs FD {label}: ad={ad} fd={fd} (rtol {rtol})")
            fd_lines.append(f"{label} ad {ad:.6e} fd {fd:.6e} rel {rel:.2e}"
                            + ("" if gated else " (not gated)"))
    if not (trace_frame.launches and trace_frame_bwd.launches):
        fail("the FD checks did not run through both kernels")
    phase(10, "AD vs FD", "; ".join(fd_lines)
          + f" ({trace_frame.launches} forward, {trace_frame_bwd.launches} backward launches)")

    # --- 11. volumetric: forward kernel vs plain version ------------------------------
    vcfg = RenderConfig(num_octaves=6, volumetric=True)  # relax 0.9, prime 8, 128 steps
    vcfg_line = (f"512x512 6 octaves, warp_octaves {vcfg.warp_octaves}, relax "
                 f"{vcfg.step_relax}, prime_ds {vcfg.prime_ds}")
    verr, line, vkern_ms, vplain_ms = forward_vs_plain(
        default_scene(6, volumetric=True, device=dev), vcfg, "volumetric ")
    phase(11, "volumetric kernel vs plain", f"{vcfg_line}: {line} {card}")

    # --- 12. volumetric serving --------------------------------------------------------
    vserve_launches, means = serve_frames(default_scene(6, volumetric=True, device=dev),
                                          vcfg, yaws)
    vframe, n_frames, prof = frame_times(
        default_scene(6, volumetric=True, device=dev), vcfg, {"kernel": 5, "plain": 2})
    phase(12, "volumetric serving", f"{vcfg_line}: {len(yaws)} frames, {vserve_launches} "
          f"kernel launches, mean colour {means}; median frame time (CUDA events): "
          f"kernel path {vframe['kernel']:.4f} ms ({n_frames['kernel']} frames), plain "
          f"path {vframe['plain']:.3f} ms ({n_frames['plain']} frames) {card}")
    print(f"    where a volumetric kernel-path frame goes: {prof}")

    # --- 13. volumetric: backward kernel vs plain version -------------------------------
    vbwd = backward_vs_plain(default_scene(6, volumetric=True, device=dev), vcfg)
    warp_bars = vbwd["pbar"][0, WARP_ENTRIES]
    if not (warp_bars != 0).all():
        fail(f"volumetric backward: warp entries {warp_bars.tolist()} must be non-zero")
    phase(13, "volumetric backward kernel vs plain", f"{bwd_report(vbwd)}; warp amplitude "
          f"and frequency entries {warp_bars.tolist()} (plain "
          f"{vbwd['ref'][0, WARP_ENTRIES].tolist()}) {card}")

    # --- 14. volumetric training ----------------------------------------------------------
    target_scene = default_scene(6, volumetric=True, device=dev)
    with torch.no_grad():
        target = render(target_scene, vcfg)
    start = fitmod.perturb_scene(target_scene, torch.Generator().manual_seed(0), rel=0.15)
    with torch.no_grad():
        start.noise.warp_amplitude.mul_(1.1)  # so the warp has a value to recover

    def vtrainable(name: str) -> bool:
        return fitmod.default_trainable(name) or name == "noise.warp_amplitude"

    vtr = train(start, target, vcfg, vtrainable, steps,
                {"kernel": 10, "kernel fwd + plain bwd": 3, "plain": 1})
    if "noise.warp_amplitude" not in vtr["leaves"]:
        fail("volumetric training: the warp amplitude got no gradient")
    phase(14, "volumetric training", f"fit {vcfg_line}, warp amplitude trainable, "
          f"{train_report(vtr, steps)} {card}")
    print(f"    where a volumetric kernel-path training step goes: {vtr['prof']}")
    # AD vs FD of the warp amplitude through the kernel path, reported only:
    # the warp's net pixel-loss gradient is small against FD noise
    # (tests/test_volumetric.py checks it per pixel, as the CPU suite does).
    fd_cfg = RenderConfig(num_octaves=2, volumetric=True)
    scene = default_scene(2, volumetric=True, device=dev)
    warped = copy.deepcopy(scene)
    with torch.no_grad():
        warped.noise.warp_amplitude.mul_(1.1)
        target = render(warped, fd_cfg)
    ad, fd = fd_check_scalar(
        lambda th: scene_with(scene, "noise.warp_amplitude", th),
        scene.noise.warp_amplitude.detach(), fd_cfg, target, eps=3e-3, t_cap=0.03)
    print(f"    AD vs FD, 2 oct volumetric noise.warp_amplitude at 512x512 (not gated): "
          f"ad {ad:.6e} fd {fd:.6e} rel {abs(ad - fd) / max(abs(fd), 1e-5):.2e}")

    paths = {"fwd": {"serving": serve_launches, "training": tr["fwd"],
                     "volumetric serving": vserve_launches,
                     "volumetric training": vtr["fwd"]},
             "bwd": {"serving": 0, "training": tr["bwd"], "volumetric serving": 0,
                     "volumetric training": vtr["bwd"]}}
    record = {"kernels": [
        {
            "name": "trace_fwd",
            "route": "cuda",
            "source": "gpgpuraytrace_tpu_torch/kernels/csrc/trace_fwd.cu",
            "replaces": "gpgpuraytrace_tpu/kernels/trace.py:510",
            "variants": ["heightfield", "volumetric"],
            "launches": sum(paths["fwd"].values()),
            "launches_by_path": paths["fwd"],
            "max_abs_err": max(err, verr),
            "ms": kern_ms,
            "plain_ms": plain_ms,
            "volumetric": {"max_abs_err": verr, "ms": vkern_ms, "plain_ms": vplain_ms},
        },
        {
            "name": "trace_bwd",
            "route": "cuda",
            "source": "gpgpuraytrace_tpu_torch/kernels/csrc/trace_bwd.cu",
            "replaces": "gpgpuraytrace_tpu/kernels/trace.py:716",
            "variants": ["heightfield", "volumetric"],
            "launches": sum(paths["bwd"].values()),
            "launches_by_path": paths["bwd"],
            "max_abs_err": max(bwd["err"], vbwd["err"]),
            "ms": bwd["ms"],
            "plain_ms": bwd["plain_ms"],
            "volumetric": {"max_abs_err": vbwd["err"], "ms": vbwd["ms"],
                           "plain_ms": vbwd["plain_ms"]},
        },
    ]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
