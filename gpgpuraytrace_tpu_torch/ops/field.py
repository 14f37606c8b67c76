"""The procedural terrain field (counterpart of
``gpgpuraytrace_tpu/ops/field.py``), in both modes:

* heightfield: f(p) = p.y - h(p.x, p.z), h an fBm heightfield;
* volumetric: f(p) = p.y - h(p.x, p.z) - warp_amplitude · fbm3(p · wf), a
  3D noise volume with overhangs; ``warp_amplitude`` and ``warp_frequency``
  are differentiable scene parameters.
"""

from __future__ import annotations

import torch

from gpgpuraytrace_tpu_torch.models.scene import NoiseParams
from gpgpuraytrace_tpu_torch.ops.noise import fbm2, fbm3

WARP_LACUNARITY = 2.0
WARP_GAIN = 0.5


def terrain_height(x, z, noise: NoiseParams):
    """Heightfield h(x, z) and its analytic derivatives (h, dh/dx, dh/dz)."""
    hs = noise.horizontal_scale
    n, nx, nz = fbm2(x * hs, z * hs, noise.amplitudes, noise.lacunarity, noise.seed)
    h = noise.height_offset + noise.height_scale * n
    dh_dx = noise.height_scale * hs * nx
    dh_dz = noise.height_scale * hs * nz
    return h, dh_dx, dh_dz


def warp_term(p, noise: NoiseParams, warp_octaves: int):
    """Volumetric displacement w(p) = warp_amplitude · fbm3(p · wf) and its
    spatial gradient (..., 3)."""
    wf = noise.warp_frequency
    n, nx, ny, nz = fbm3(p[..., 0] * wf, p[..., 1] * wf, p[..., 2] * wf,
                         warp_octaves, WARP_LACUNARITY, WARP_GAIN, noise.seed)
    wa = noise.warp_amplitude
    grad = torch.stack([wa * wf * nx, wa * wf * ny, wa * wf * nz], dim=-1)
    return wa * n, grad


def warp_tail(warp_octaves: int) -> float:
    """Σ gain^i over the warp octaves: |fbm3| never exceeds it."""
    return float(sum(WARP_GAIN ** i for i in range(warp_octaves)))


def envelope_height(noise: NoiseParams, volumetric: bool = False,
                    warp_octaves: int = 2) -> torch.Tensor:
    """Certified upper bound on the surface height: every octave lies in
    [-1, 1], so no surface exists above offset + |scale|·Σ|amp| (plus
    |warp_amplitude|·Σ gain^i in volumetric mode)."""
    env = noise.height_offset + torch.abs(noise.height_scale) * torch.sum(
        torch.abs(noise.amplitudes)
    )
    if volumetric:
        env = env + torch.abs(noise.warp_amplitude) * warp_tail(warp_octaves)
    return env


def field(p, noise: NoiseParams, volumetric: bool = False,
          warp_octaves: int = 2) -> torch.Tensor:
    """Signed field value, > 0 above the surface. (..., 3) -> (...)."""
    h, _, _ = terrain_height(p[..., 0], p[..., 2], noise)
    f = p[..., 1] - h
    if volumetric:
        w, _ = warp_term(p, noise, warp_octaves)
        f = f - w
    return f


def field_and_grad(p, noise: NoiseParams, volumetric: bool = False,
                   warp_octaves: int = 2):
    """f(p) and its analytic spatial gradient, shape (..., 3)."""
    h, dh_dx, dh_dz = terrain_height(p[..., 0], p[..., 2], noise)
    f = p[..., 1] - h
    grad = torch.stack([-dh_dx, torch.ones_like(h), -dh_dz], dim=-1)
    if volumetric:
        w, wgrad = warp_term(p, noise, warp_octaves)
        f = f - w
        grad = grad - wgrad
    return f, grad


def surface_normal(p, noise: NoiseParams, volumetric: bool = False,
                   warp_octaves: int = 2) -> torch.Tensor:
    """Unit surface normal from the analytic field gradient."""
    _, grad = field_and_grad(p, noise, volumetric, warp_octaves)
    return grad * torch.rsqrt(torch.sum(grad * grad, dim=-1, keepdim=True))
