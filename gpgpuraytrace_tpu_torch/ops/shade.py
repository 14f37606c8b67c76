"""Shading: gradient normals, Lambert lighting, procedural sky, distance fog
(counterpart of ``gpgpuraytrace_tpu/ops/shade.py``)."""

from __future__ import annotations

import torch

from gpgpuraytrace_tpu_torch.models.scene import Materials, NoiseParams
from gpgpuraytrace_tpu_torch.ops.field import surface_normal, terrain_height


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v * torch.rsqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-12)


def _smoothstep(lo, hi, x):
    u = torch.clamp((x - lo) / (hi - lo), 0.0, 1.0)
    return u * u * (3.0 - 2.0 * u)


def sky_color(ray_d, mat: Materials):
    """Procedural sky for miss rays: zenith/horizon gradient + sun glow."""
    sun = _normalize(mat.sun_dir)
    up_amount = torch.clamp(ray_d[..., 1], 0.0, 1.0)
    base = mat.sky_horizon + (mat.sky_zenith - mat.sky_horizon) * up_amount[..., None]
    cos_sun = torch.clamp(torch.sum(ray_d * sun, dim=-1), 0.0, 1.0)
    glow = cos_sun ** 64.0
    disc = cos_sun ** 512.0
    return base + (0.25 * glow + 1.5 * disc)[..., None] * mat.sun_color


def surface_color(p, normal, mat: Materials, height):
    """Slope/height-based albedo + Lambert sun + hemispherical ambient."""
    sun = _normalize(mat.sun_dir)
    steep = _smoothstep(0.85, 0.55, normal[..., 1])  # 0 flat -> 1 steep
    albedo = mat.albedo_low + (mat.albedo_high - mat.albedo_low) * steep[..., None]
    snow = _smoothstep(mat.snow_height, mat.snow_height + 1.0, height) * (1.0 - steep)
    albedo = albedo + (mat.snow_color - albedo) * snow[..., None]
    diffuse = torch.clamp(torch.sum(normal * sun, dim=-1), 0.0, 1.0)
    sky_fill = 0.5 + 0.5 * normal[..., 1]
    light = mat.sun_color * diffuse[..., None] + mat.ambient_color * sky_fill[..., None]
    return albedo * light


def apply_fog(color, sky, t, mat: Materials):
    """Exponential distance fog blending toward the sky/fog colour."""
    f = 1.0 - torch.exp(-mat.fog_density * t)
    fog_tint = 0.5 * (mat.fog_color + sky)
    return color + (fog_tint - color) * f[..., None]


def shade(ray_o, ray_d, t, hit, noise: NoiseParams, mat: Materials,
          volumetric: bool = False, warp_octaves: int = 2):
    """March result -> linear RGB (h, W, 3) in [0, ~1.5]. In volumetric
    mode the normal includes the warp; snow still reads the heightfield h."""
    p = ray_o + t[..., None] * ray_d
    h, dh_dx, dh_dz = terrain_height(p[..., 0], p[..., 2], noise)
    if volumetric:
        normal = surface_normal(p, noise, volumetric, warp_octaves)
    else:
        normal = _normalize(torch.stack([-dh_dx, torch.ones_like(h), -dh_dz], dim=-1))
    sky = sky_color(ray_d, mat)
    surf = surface_color(p, normal, mat, h)
    surf = apply_fog(surf, sky, t, mat)
    return torch.where(hit[..., None], surf, sky)


def tonemap(color: torch.Tensor) -> torch.Tensor:
    """Reinhard + gamma for display output."""
    c = color / (1.0 + color)
    return torch.clamp(c, 0.0, 1.0) ** (1.0 / 2.2)
