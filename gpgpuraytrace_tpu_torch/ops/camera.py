"""Per-pixel camera rays (counterpart of ``gpgpuraytrace_tpu/ops/camera.py``).

``row0`` and ``local_height`` select a horizontal band of the full image; the
depth-prime coarse pass renders one virtual halo row above the frame, so
``row0`` may be negative. ``Cameras`` holds a batch of cameras (a flythrough
batch, the JAX package's ``vmap`` over cameras).
"""

from __future__ import annotations

import dataclasses

import torch

from gpgpuraytrace_tpu_torch.models.scene import Camera


@dataclasses.dataclass(frozen=True)
class Cameras:
    """A batch of B cameras as plain tensors on one device: ``position``
    (B, 3); ``yaw``, ``pitch`` and ``fov_y`` (B,) each, or 0-d where the
    frames share it. Frame b is the ``Camera`` whose leaves are entry b."""

    position: torch.Tensor
    yaw: torch.Tensor
    pitch: torch.Tensor
    fov_y: torch.Tensor


def camera_basis(camera: Camera | Cameras):
    """Orthonormal (forward, right, up) from yaw/pitch (world up = +y): (3,)
    each for a ``Camera``, (B, 3) for ``Cameras``, entry by entry the same."""
    cy, sy = torch.cos(camera.yaw), torch.sin(camera.yaw)
    cp, sp = torch.cos(camera.pitch), torch.sin(camera.pitch)
    forward = torch.stack(torch.broadcast_tensors(sy * cp, sp, cy * cp), dim=-1)
    right = torch.stack([cy, torch.zeros_like(cy), -sy], dim=-1)
    up = torch.linalg.cross(*torch.broadcast_tensors(forward, right))
    return forward, right, up


def pixel_ndc(height: int, width: int, row0=0.0, local_height: int | None = None,
              device=None):
    """Pixel-centre NDC grids (x left→right, y up), shapes (local_height, width)."""
    local_height = height if local_height is None else local_height
    row0 = torch.as_tensor(row0, dtype=torch.float32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    ys = (torch.arange(local_height, **f32) + row0 + 0.5) / height * 2.0 - 1.0
    xs = (torch.arange(width, **f32) + 0.5) / width * 2.0 - 1.0
    ndc_y = -ys[:, None] * torch.ones((1, width), **f32)
    ndc_x = torch.ones((local_height, 1), **f32) * xs[None, :]
    return ndc_x, ndc_y


def ray_directions_from_ndc(camera: Camera, ndc_x, ndc_y, aspect):
    """Normalized world-space directions (..., 3):
    normalize(forward + tan(fov/2)·(aspect·ndc_x·right + ndc_y·up))."""
    forward, right, up = camera_basis(camera)
    t = torch.tan(0.5 * camera.fov_y)
    aspect = torch.as_tensor(aspect, dtype=torch.float32, device=t.device)
    d = (
        forward
        + (t * aspect * ndc_x)[..., None] * right
        + (t * ndc_y)[..., None] * up
    )
    return d * torch.rsqrt(torch.sum(d * d, dim=-1, keepdim=True))


def generate_rays(camera: Camera, height: int, width: int, row0=0.0,
                  local_height: int | None = None):
    """Primary rays for a full frame or a row band:
    (origins (h, W, 3), directions (h, W, 3))."""
    local_height = height if local_height is None else local_height
    device = camera.position.device
    ndc_x, ndc_y = pixel_ndc(height, width, row0, local_height, device)
    dirs = ray_directions_from_ndc(camera, ndc_x, ndc_y, width / height)
    origins = camera.position.expand(local_height, width, 3)
    return origins, dirs
