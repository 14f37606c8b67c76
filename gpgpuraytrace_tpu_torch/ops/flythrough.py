"""Animated flythrough: a camera path over time and batches of uint8 frames
made on the device (counterpart of ``gpgpuraytrace_tpu/ops/flythrough.py``).

Each frame of a batch goes through ``render`` under ``torch.no_grad()``;
tonemap and quantization run on the frame's device, so a batch leaves it in
one device-to-host copy of 3 bytes per pixel. The JAX package marches a
batch as one launch (``vmap`` over its kernels); here the frames of a batch
are rendered one by one (ROADMAP.md B: a frame dimension in the kernels).
"""

from __future__ import annotations

import copy
from typing import Callable, Iterator

import numpy as np
import torch

from gpgpuraytrace_tpu_torch.models.scene import Camera, RenderConfig, Scene
from gpgpuraytrace_tpu_torch.ops.render import render
from gpgpuraytrace_tpu_torch.ops.shade import tonemap


@torch.no_grad()
def flythrough_camera(scene: Scene, time_s) -> Camera:
    """The default fly path at ``time_s`` seconds: forward drift, a gentle
    yaw sweep and a bob. Returns a new ``Camera`` (the scene's is left as it
    is) holding the path's values, float32 on the camera's device."""
    cam = scene.camera
    t = torch.as_tensor(time_s, dtype=torch.float32, device=cam.position.device)
    out = copy.deepcopy(cam)
    out.position.copy_(cam.position + torch.stack([
        2.0 * torch.sin(0.15 * t), 0.8 * torch.sin(0.23 * t), 3.0 * t,
    ]))
    out.yaw.copy_(cam.yaw + 0.12 * torch.sin(0.2 * t))
    return out


@torch.no_grad()
def render_frame_uint8(scene: Scene, cfg: RenderConfig, time_s) -> torch.Tensor:
    """The flythrough's frame at ``time_s``: ``render`` from
    ``flythrough_camera``, tonemapped and quantized on the scene's device,
    (H, W, 3) uint8."""
    cam = flythrough_camera(scene, time_s)
    img = tonemap(render(Scene(scene.noise, cam, scene.materials), cfg))
    return (torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def fly_frames(scene: Scene, cfg: RenderConfig, num_frames: int, batch: int = 4,
               fps: float = 30.0,
               on_batch: Callable[[Scene], Scene] | None = None,
               ) -> Iterator[tuple[int, np.ndarray]]:
    """Yield (frame index, (H, W, 3) uint8 numpy array), ready for a PNG.

    Frames come in batches of ``batch``; frame i shows the path at i / fps
    seconds. ``on_batch(scene) -> scene`` runs before each batch (the
    live-tweak hook, ``utils/tweak.py``): its scene renders that batch and
    the ones after."""
    for start in range(0, num_frames, batch):
        if on_batch is not None:
            scene = on_batch(scene)
        n = min(batch, num_frames - start)
        times = torch.arange(start, start + n, dtype=torch.float32) / fps
        frames = torch.stack([render_frame_uint8(scene, cfg, t) for t in times])
        host = frames.cpu().numpy()  # one device-to-host copy per batch
        for k in range(n):
            yield start + k, host[k]
