"""Animated flythrough: a camera path over time and batches of uint8 frames
made on the device (counterpart of ``gpgpuraytrace_tpu/ops/flythrough.py``).

A batch of frames renders as one launch per pass (temporal ray batching, the
JAX package's ``jit(vmap(render))``): ``flythrough_cameras`` gives the
batch's cameras, ``kernels/trace.py:render_frames_raw`` traces the coarse
prime pass of every frame in one launch and the fine pass in another
(compaction: phase 1 and phase 2 once each), and ``quantize``
(``kernels/quantize.py``, one kernel on the card) tonemaps and quantizes the
batch on its device, so a batch leaves it in one device-to-host copy of 3
bytes per pixel. Each frame is bit for bit ``render_frame_uint8`` of its
time, the per-frame path that ``cfg.use_kernel=False`` runs.

On the card ``FlyBatch`` runs a batch as one CUDA graph, as the JAX package
runs its batch as one compiled program: ``fly_frames`` replays it for every
batch after the first, the short last batch included (it renders a full
batch and keeps the first frames, as the reference does).
"""

from __future__ import annotations

import collections
import copy
import functools
import operator
from typing import Callable, Iterator

import numpy as np
import torch

from gpgpuraytrace_tpu_torch.kernels.quantize import tonemap_quantize
from gpgpuraytrace_tpu_torch.kernels.trace import render_frames_raw, trace_frames
from gpgpuraytrace_tpu_torch.models.scene import Camera, RenderConfig, Scene
from gpgpuraytrace_tpu_torch.ops.camera import Cameras
from gpgpuraytrace_tpu_torch.ops.render import render
from gpgpuraytrace_tpu_torch.utils.convert import LEAF_NAMES
from gpgpuraytrace_tpu_torch.utils.graphs import CapturedProgram
from gpgpuraytrace_tpu_torch.utils.profiling import span


def _path(position, yaw, t):
    """The fly path's (position, yaw) at times ``t`` (0-d or (B,))."""
    offset = torch.stack([2.0 * torch.sin(0.15 * t), 0.8 * torch.sin(0.23 * t), 3.0 * t],
                         dim=-1)
    return position + offset, yaw + 0.12 * torch.sin(0.2 * t)


@torch.no_grad()
def flythrough_camera(scene: Scene, time_s) -> Camera:
    """The default fly path at ``time_s`` seconds: forward drift, a gentle
    yaw sweep and a bob. Returns a new ``Camera`` (the scene's is left as it
    is) holding the path's values, float32 on the camera's device."""
    cam = scene.camera
    t = torch.as_tensor(time_s, dtype=torch.float32, device=cam.position.device)
    out = copy.deepcopy(cam)
    position, yaw = _path(cam.position, cam.yaw, t)
    out.position.copy_(position)
    out.yaw.copy_(yaw)
    return out


@torch.no_grad()
def flythrough_cameras(scene: Scene, times: torch.Tensor) -> Cameras:
    """The fly path at a (B,) vector of times (seconds, float32) for a batch:
    camera b is ``flythrough_camera(scene, times[b])``'s, entry by entry,
    computed for all frames at once. CPU times go to the camera's device
    without a host sync."""
    cam = scene.camera
    t = times.to(device=cam.position.device, dtype=torch.float32, non_blocking=True)
    position, yaw = _path(cam.position, cam.yaw, t)
    return Cameras(position, yaw, cam.pitch.detach(), cam.fov_y.detach())


# Tonemap and quantize linear RGB (..., H, W, 3) to uint8 on its device: the
# kernel on a CUDA tensor, its plain version on a CPU tensor.
quantize = tonemap_quantize


@torch.no_grad()
def render_frame_uint8(scene: Scene, cfg: RenderConfig, time_s) -> torch.Tensor:
    """The flythrough's frame at ``time_s``: ``render`` from
    ``flythrough_camera``, tonemapped and quantized on the scene's device,
    (H, W, 3) uint8."""
    cam = flythrough_camera(scene, time_s)
    return quantize(render(Scene(scene.noise, cam, scene.materials), cfg))


@torch.no_grad()
def render_batch_uint8(scene: Scene, cfg: RenderConfig, times: torch.Tensor) -> torch.Tensor:
    """The flythrough's frames at a (B,) vector of times, (B, H, W, 3) uint8
    on the scene's device: one ``render_frames_raw`` of the batch on the
    kernel path, ``render_frame_uint8`` frame by frame on the plain one."""
    if not cfg.use_kernel:
        return torch.stack([render_frame_uint8(scene, cfg, t) for t in times])
    color, _, _ = render_frames_raw(scene, flythrough_cameras(scene, times), cfg)
    return quantize(color)


def launch_counts() -> collections.Counter:
    """Kernel launches so far on the fly path, by kernel: the trace kernels'
    instantiations (``trace_frames.launches``) and ``tonemap_quantize``."""
    counts = collections.Counter(trace_frames.launches)
    counts["tonemap_quantize"] = tonemap_quantize.launches
    return counts


class _Tally:
    """The kernel launches of one batch (``launch_counts``) and the number
    of batches counted."""

    def __init__(self):
        self.launches: collections.Counter = collections.Counter()
        self.counted = 0


def _render_counted(tally: _Tally, cfg: RenderConfig, scene: Scene,
                    times: torch.Tensor) -> torch.Tensor:
    """``render_batch_uint8``, its launches counted in ``tally``."""
    before = launch_counts()
    out = render_batch_uint8(scene, cfg, times)
    tally.launches = launch_counts() - before
    tally.counted += 1
    return out


class FlyBatch:
    """A flythrough batch of ``batch`` frames as one program: ``frames(scene,
    times)`` is ``render_batch_uint8(scene, cfg, times)`` (the counterpart of
    the JAX package's compiled ``jit(vmap(render_one))``,
    ``gpgpuraytrace_tpu/ops/flythrough.py:39-55``).

    On a CUDA scene with ``cfg.use_kernel`` the batch runs as one CUDA graph
    (``graphed``, ``utils/graphs.py:CapturedProgram``). The first call runs
    eagerly on a side stream: PyTorch's warm-up before a capture, and the
    kernels' build. The second captures the batch into the graph (which
    runs nothing) and replays it, as does every later call. Nothing falls
    back: a capture that fails raises. The
    graph reads a private copy of the scene and a (batch,) buffer of times
    by address; before each call the caller's current leaves
    (``utils/convert.py:LEAF_NAMES``) are copied into that copy, so a
    replaced scene (a live tweak hands over a deep copy) and an edit in
    place both show in the next batch, and the caller's scene is never
    written. The times are computed on the host, as ``fly_frames`` does,
    and copied into the buffer from pinned memory (dividing on the card
    would multiply by the reciprocal and move the camera by an ulp). A call
    takes exactly ``batch`` times; it returns the graph's output buffer,
    which the next call overwrites.

    ``launches`` holds the kernel launches of one batch (``launch_counts``),
    read at the eager call and at the capture: the launch counters count a
    capture's launches once, not per replay, so over a run they rise by
    ``launches`` times ``counted`` (the eager calls and the capture).
    ``replays`` counts replays. Under a profiler ``host_frames`` is the span
    ``fly.batch`` (``utils/profiling.py:span``), holding ``fly.load`` (the
    copies in), the graph's own spans, ``fly.to_host`` (the host tensor and
    the copy's enqueue) and ``fly.wait`` (the host waiting for the frames).

    On the CPU, or with ``use_kernel=False``, a call is the eager
    ``render_batch_uint8`` of the times it is given."""

    def __init__(self, scene: Scene, cfg: RenderConfig, batch: int):
        self.cfg = cfg
        self.batch = batch
        self.device = scene.camera.position.device
        self.graphed = cfg.use_kernel and self.device.type == "cuda"
        self.calls = 0
        self.replays = 0
        self.tally = _Tally()
        if self.graphed:
            self.scene = copy.deepcopy(scene)
            self.leaves = [operator.attrgetter(n)(self.scene) for n in LEAF_NAMES]
            self.times = torch.zeros(batch, dtype=torch.float32, device=self.device)
            self.program = CapturedProgram(
                functools.partial(_render_counted, self.tally, cfg, self.scene, self.times),
                self.device)

    @property
    def launches(self) -> collections.Counter:
        return self.tally.launches

    @property
    def counted(self) -> int:
        return self.tally.counted

    def _load(self, scene: Scene, times: torch.Tensor) -> None:
        """Copy the caller's leaves and the batch's times into the graph's."""
        if tuple(times.shape) != (self.batch,):
            raise ValueError(f"FlyBatch of {self.batch} frames: got times of shape "
                             f"{tuple(times.shape)}")
        with span("gpgpuraytrace_tpu_torch.fly.load"), torch.no_grad():
            src = [operator.attrgetter(n)(scene).detach() for n in LEAF_NAMES]
            torch._foreach_copy_(self.leaves, src)
            host = times.to(torch.float32)
            if host.device.type == "cpu":
                host = host.pin_memory()
            self.times.copy_(host, non_blocking=True)

    def frames(self, scene: Scene, times: torch.Tensor) -> torch.Tensor:
        """The batch's frames, (len(times), H, W, 3) uint8 on the device."""
        self.calls += 1
        if not self.graphed:
            return _render_counted(self.tally, self.cfg, scene, times)
        self._load(scene, times)
        if self.program.calls == 0:
            return self.program()  # the eager warm-up
        out = self.program()
        self.replays += 1
        return out

    def host_frames(self, scene: Scene, times: torch.Tensor, n: int) -> np.ndarray:
        """The first ``n`` frames of ``frames(scene, times)`` on the host,
        (n, H, W, 3) uint8, copied into a tensor made for this batch (on the
        card pinned, through torch's caching host allocator, and copied
        without blocking, then waited for): the graph's output buffer is
        overwritten by the next batch, a frame handed out never is."""
        with span("gpgpuraytrace_tpu_torch.fly.batch"):
            out = self.frames(scene, times)[:n]
            on_card = out.device.type == "cuda"
            with span("gpgpuraytrace_tpu_torch.fly.to_host"):
                host = torch.empty(out.shape, dtype=torch.uint8, pin_memory=on_card)
                host.copy_(out, non_blocking=on_card)
                if on_card:
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(self.device))
            with span("gpgpuraytrace_tpu_torch.fly.wait"):
                if on_card:
                    done.synchronize()
            return host.numpy()


def fly_frames(scene: Scene, cfg: RenderConfig, num_frames: int, batch: int = 4,
               fps: float = 30.0,
               on_batch: Callable[[Scene], Scene] | None = None,
               program: FlyBatch | None = None,
               ) -> Iterator[tuple[int, np.ndarray]]:
    """Yield (frame index, (H, W, 3) uint8 numpy array), ready for a PNG.

    Frames come in batches of ``batch``, each one call of ``program`` (a
    ``FlyBatch(scene, cfg, batch)`` unless one is given: on the card every
    batch after the first replays its CUDA graph); frame i shows the path at
    i / fps seconds. The last batch may hold fewer frames: on the graph it
    renders the full batch's times and keeps the first ones, elsewhere only
    the frames left. ``on_batch(scene) -> scene`` runs before each batch
    (the live-tweak hook, ``utils/tweak.py``): its scene renders that batch
    and the ones after. A yielded frame is never written again."""
    if program is None:
        program = FlyBatch(scene, cfg, batch)
    elif (program.cfg, program.batch) != (cfg, batch):
        raise ValueError(f"program renders batches of {program.batch} under {program.cfg}, "
                         f"not of {batch} under {cfg}")
    for start in range(0, num_frames, batch):
        if on_batch is not None:
            scene = on_batch(scene)
        n = min(batch, num_frames - start)
        count = batch if program.graphed else n
        times = torch.arange(start, start + count, dtype=torch.float32) / fps
        host = program.host_frames(scene, times, n)
        for k in range(n):
            yield start + k, host[k]
