"""Animated flythrough: a camera path over time and batches of uint8 frames
made on the device (counterpart of ``gpgpuraytrace_tpu/ops/flythrough.py``).

A batch of frames renders as one launch per pass (temporal ray batching, the
JAX package's ``jit(vmap(render))``): ``flythrough_cameras`` gives the
batch's cameras, ``kernels/trace.py:render_frames_raw`` traces the coarse
prime pass of every frame in one launch and the fine pass in another
(compaction: phase 1 and phase 2 once each); tonemap and quantization run on
the batch on its device, so a batch leaves it in one device-to-host copy of
3 bytes per pixel. Each frame is bit for bit ``render_frame_uint8`` of its
time, the per-frame path that ``cfg.use_kernel=False`` runs.
"""

from __future__ import annotations

import copy
from typing import Callable, Iterator

import numpy as np
import torch

from gpgpuraytrace_tpu_torch.kernels.trace import render_frames_raw
from gpgpuraytrace_tpu_torch.models.scene import Camera, RenderConfig, Scene
from gpgpuraytrace_tpu_torch.ops.camera import Cameras
from gpgpuraytrace_tpu_torch.ops.render import render
from gpgpuraytrace_tpu_torch.ops.shade import tonemap


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


def quantize(img: torch.Tensor) -> torch.Tensor:
    """Tonemap and quantize linear RGB to uint8, on its device."""
    return (torch.clamp(tonemap(img), 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


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


def fly_frames(scene: Scene, cfg: RenderConfig, num_frames: int, batch: int = 4,
               fps: float = 30.0,
               on_batch: Callable[[Scene], Scene] | None = None,
               ) -> Iterator[tuple[int, np.ndarray]]:
    """Yield (frame index, (H, W, 3) uint8 numpy array), ready for a PNG.

    Frames come in batches of ``batch``, each one ``render_batch_uint8``
    (the last batch holds only the frames left); frame i shows the path at
    i / fps seconds. ``on_batch(scene) -> scene`` runs before each batch (the
    live-tweak hook, ``utils/tweak.py``): its scene renders that batch and
    the ones after."""
    for start in range(0, num_frames, batch):
        if on_batch is not None:
            scene = on_batch(scene)
        n = min(batch, num_frames - start)
        times = torch.arange(start, start + n, dtype=torch.float32) / fps
        host = render_batch_uint8(scene, cfg, times).cpu().numpy()  # one copy per batch
        for k in range(n):
            yield start + k, host[k]
