"""The procedural terrain field f(p) = p.y - h(p.x, p.z), heightfield mode
(counterpart of ``gpgpuraytrace_tpu/ops/field.py``).

The volumetric mode (a 3D fBm warp) is still to be ported: ROADMAP.md,
"TPU kernels still to port", item 2. Asking for it raises.
"""

from __future__ import annotations

import torch

from gpgpuraytrace_tpu_torch.models.scene import NoiseParams
from gpgpuraytrace_tpu_torch.ops.noise import fbm2

VOLUMETRIC_TODO = (
    "volumetric terrain is not ported to the PyTorch package yet "
    "(ROADMAP.md, TPU kernels still to port: volumetric)"
)


def check_heightfield(volumetric: bool) -> None:
    if volumetric:
        raise NotImplementedError(VOLUMETRIC_TODO)


def terrain_height(x, z, noise: NoiseParams):
    """Heightfield h(x, z) and its analytic derivatives (h, dh/dx, dh/dz)."""
    hs = noise.horizontal_scale
    n, nx, nz = fbm2(x * hs, z * hs, noise.amplitudes, noise.lacunarity, noise.seed)
    h = noise.height_offset + noise.height_scale * n
    dh_dx = noise.height_scale * hs * nx
    dh_dz = noise.height_scale * hs * nz
    return h, dh_dx, dh_dz


def envelope_height(noise: NoiseParams, volumetric: bool = False,
                    warp_octaves: int = 2) -> torch.Tensor:
    """Certified upper bound on the surface height: every octave lies in
    [-1, 1], so no surface exists above offset + |scale|·Σ|amp|."""
    check_heightfield(volumetric)
    return noise.height_offset + torch.abs(noise.height_scale) * torch.sum(
        torch.abs(noise.amplitudes)
    )


def field(p, noise: NoiseParams, volumetric: bool = False,
          warp_octaves: int = 2) -> torch.Tensor:
    """Signed field value, > 0 above the surface. (..., 3) -> (...)."""
    check_heightfield(volumetric)
    h, _, _ = terrain_height(p[..., 0], p[..., 2], noise)
    return p[..., 1] - h


def field_and_grad(p, noise: NoiseParams, volumetric: bool = False,
                   warp_octaves: int = 2):
    """f(p) and its analytic spatial gradient, shape (..., 3)."""
    check_heightfield(volumetric)
    h, dh_dx, dh_dz = terrain_height(p[..., 0], p[..., 2], noise)
    f = p[..., 1] - h
    grad = torch.stack([-dh_dx, torch.ones_like(h), -dh_dz], dim=-1)
    return f, grad
