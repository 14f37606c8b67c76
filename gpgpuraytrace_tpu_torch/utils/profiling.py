"""Observability: march statistics, the scene-roughness warning, a frame
timer and profiler traces (counterpart of
``gpgpuraytrace_tpu/utils/profiling.py``).

* ``march_stats`` runs the plain march (``ops/march.py:march_with_stats``)
  on the scene's device and reports where the march's work goes: hit rate,
  useful steps per ray, lanes that ran out of steps, a 16-bin histogram.
  The JAX package measures the same with its XLA march, never through the
  TPU kernel; the CUDA kernel's own executed-step count comes from
  ``kernels/trace.py:trace_frame(..., debug_steps=True)``.
* ``roughness_proxy`` and ``warn_if_rough``: the terrain's slope scale, and
  a warning where the march is known to skip ridges.
* ``Timer``: min-of-N time of a call, by CUDA events on the card.
* ``trace``: a ``torch.profiler`` trace of the block it wraps.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
import warnings

import numpy as np
import torch

from gpgpuraytrace_tpu_torch.models.scene import RenderConfig, Scene, check_device
from gpgpuraytrace_tpu_torch.ops.camera import generate_rays
from gpgpuraytrace_tpu_torch.ops.march import march_with_stats
from gpgpuraytrace_tpu_torch.ops.render import prime_map_torch

# Above this proxy the march's relax·f step can skip ridges: the JAX
# package's default scene family sits near 1.8 and renders right, its rough
# variant at about 4.0 mis-renders 27.5% of pixels (BASELINE.md robustness
# table, measured on the JAX package).
ROUGHNESS_WARN_THRESHOLD = 2.5


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the wrapped block (host, and the card where CUDA is present)
    with ``torch.profiler``; on exit write a Chrome/Perfetto trace to
    ``log_dir/trace.json`` (default: a directory under the temporary
    directory). Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "gpgpuraytrace_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@torch.no_grad()
def march_stats(scene: Scene, cfg: RenderConfig, t0_prime=None) -> dict:
    """Step-count histogram, hit rate and exhausted lanes of a frame, from
    the plain march on the scene's device.

    With ``cfg.prime_ds`` the march starts from a prime map, so the steps
    are those of the march the config runs: ``t0_prime`` when given (the
    kernel path's map, say), else the plain path's (``prime_map_torch``).
    The JAX package's keys, with the same meanings."""
    o, d = generate_rays(scene.camera, cfg.height, cfg.width)
    if cfg.prime_ds and t0_prime is None:
        t0_prime = prime_map_torch(scene, cfg)
    t, hit, steps = march_with_stats(cfg, o, d, scene.noise, t0_prime)
    t, hit, steps = (x.cpu().numpy() for x in (t, hit, steps))
    # Exhausted lanes: still marching at max_steps, neither hit nor escaped
    # (an escape or a marched-out ray ends exactly at t_max); they render as
    # sky.
    exhausted = (~hit) & (t < cfg.t_max)
    hist, edges = np.histogram(steps, bins=16, range=(0, cfg.max_steps))
    return {
        "hit_rate": float(hit.mean()),
        "steps_mean": float(steps.mean()),
        "steps_p50": float(np.percentile(steps, 50)),
        "steps_p99": float(np.percentile(steps, 99)),
        "steps_max": int(steps.max()),
        "exhausted_lanes": int(exhausted.sum()),
        "exhausted_frac": float(exhausted.mean()),
        "histogram": hist.tolist(),
        "bin_edges": edges.tolist(),
        "t_mean_hit": float(t[hit].mean()) if hit.any() else None,
    }


def roughness_proxy(noise, num_octaves: int) -> float:
    """Σᵢ |ampᵢ|·lacunarityⁱ × height_scale × horizontal_scale over the
    first ``num_octaves`` octaves: the fBm heightfield's slope scale. The
    field bounds the distance to the surface only while slopes stay small;
    above ``ROUGHNESS_WARN_THRESHOLD`` the relax·f step oversteps ridges."""
    amps = np.abs(noise.amplitudes.detach().cpu().numpy().astype(np.float64))
    lac = float(noise.lacunarity.detach().cpu())
    freqs = lac ** np.arange(min(num_octaves, amps.size))
    slope = float((amps[: freqs.size] * freqs).sum())
    return (slope * float(noise.height_scale.detach().cpu())
            * float(noise.horizontal_scale.detach().cpu()))


def warn_if_rough(scene: Scene, cfg: RenderConfig) -> float:
    """Warn when the scene is rougher than the march is known to handle;
    returns the proxy."""
    r = roughness_proxy(scene.noise, cfg.num_octaves)
    if r > ROUGHNESS_WARN_THRESHOLD:
        warnings.warn(
            f"scene roughness proxy {r:.2f} > {ROUGHNESS_WARN_THRESHOLD} "
            f"(amplitude·frequency × height_scale × horizontal_scale): the "
            f"march's relax·f step can silently skip ridges on terrain this "
            f"rough at step_relax={cfg.step_relax}. Lower step_relax and raise "
            f"max_steps for quality-critical renders.",
            stacklevel=2,
        )
    return r


class Timer:
    """Min-of-N time of a call: ``Timer()(fn, *args)`` -> seconds.

    On a CUDA ``device`` (the default; it raises without CUDA) each call is
    timed by CUDA events around it; on the CPU by the host clock."""

    def __init__(self, iters: int = 10, warmup: int = 2, device="cuda"):
        self.iters = iters
        self.warmup = warmup
        self.device = check_device(device)

    def _once(self, fn, args) -> float:
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            fn(*args)
            return time.perf_counter() - t0
        with torch.cuda.device(self.device):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3

    def __call__(self, fn, *args) -> float:
        for _ in range(self.warmup):
            self._once(fn, args)
        return min(self._once(fn, args) for _ in range(self.iters))
