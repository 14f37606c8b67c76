"""The render pipeline: raygen -> march -> shade (counterpart of
``gpgpuraytrace_tpu/ops/render.py``).

``render`` is the entry point, differentiable with respect to every float
scene parameter. With ``cfg.use_kernel`` (the default) it runs the trace
kernel path (``kernels/trace.py:render_kernel``: the hand-written CUDA
kernels on a CUDA scene, their plain PyTorch versions on a CPU scene);
otherwise the plain op-by-op path ``render_torch``, whose march backward is
the implicit-function VJP of ``ops/march.py``.
"""

from __future__ import annotations

import dataclasses

import torch

from gpgpuraytrace_tpu_torch.kernels.trace import render_kernel, render_kernel_raw
from gpgpuraytrace_tpu_torch.models.scene import RenderConfig, Scene
from gpgpuraytrace_tpu_torch.ops.camera import generate_rays
from gpgpuraytrace_tpu_torch.ops.march import (
    check_prime_band, coarse_prime_cfg, march, march_from_saved, march_primed,
    prime_from_coarse,
)
from gpgpuraytrace_tpu_torch.ops.shade import shade


@torch.no_grad()
def prime_map_torch(scene: Scene, cfg: RenderConfig, row0=0.0,
                    local_height: int | None = None) -> torch.Tensor:
    """Depth-prime map from the plain coarse march: march a (h/ds + 2)
    × (w/ds) coarse pass (one halo row above and below the band) and
    expand its 3×3-neighbourhood minimum to full resolution. Detached: the
    prime says where the march starts, it is not a differentiable input."""
    check_prime_band(cfg, row0, local_height)
    ds = cfg.prime_ds
    ccfg = coarse_prime_cfg(cfg)
    lh = (cfg.height if local_height is None else local_height) // ds
    o_c, d_c = generate_rays(
        scene.camera, ccfg.height, ccfg.width, row0 / ds - 1.0, lh + 2
    )
    t_c, _ = march(ccfg, o_c, d_c, scene.noise)
    return prime_from_coarse(t_c, cfg)


def _march_torch(scene: Scene, cfg: RenderConfig, ray_o, ray_d, row0,
                 local_height):
    if cfg.prime_ds:
        t0p = prime_map_torch(scene, cfg, row0, local_height)
        return march_primed(cfg, ray_o, ray_d, scene.noise, t0p)
    return march(cfg, ray_o, ray_d, scene.noise)


def render_torch(scene: Scene, cfg: RenderConfig, row0=0.0,
                 local_height: int | None = None) -> torch.Tensor:
    """Plain PyTorch render: (h, W, 3) linear RGB."""
    ray_o, ray_d = generate_rays(scene.camera, cfg.height, cfg.width, row0,
                                 local_height)
    t, hit = _march_torch(scene, cfg, ray_o, ray_d, row0, local_height)
    return shade(ray_o, ray_d, t, hit, scene.noise, scene.materials,
                 cfg.volumetric, cfg.warp_octaves)


def render_from_checkpoint(scene: Scene, cfg: RenderConfig, t_saved, hit_saved,
                           row0=0.0, local_height: int | None = None) -> torch.Tensor:
    """Render with the march replaced by a saved per-pixel (t, hit)
    checkpoint: the plain backward of the kernel path. Gradients flow
    through shading directly and through the hit distance by the
    implicit-function VJP of ``march_from_saved``; nothing re-marches."""
    ray_o, ray_d = generate_rays(scene.camera, cfg.height, cfg.width, row0,
                                 local_height)
    t, hit = march_from_saved(cfg, ray_o, ray_d, scene.noise, t_saved, hit_saved)
    return shade(ray_o, ray_d, t, hit, scene.noise, scene.materials,
                 cfg.volumetric, cfg.warp_octaves)


@torch.no_grad()
def hit_distances(scene: Scene, cfg: RenderConfig, row0=0.0,
                  local_height: int | None = None):
    """(t, hit) per pixel as ``render`` marches them: through the trace
    kernel path with ``cfg.use_kernel``, else the plain march; primed
    whenever ``cfg`` primes."""
    if cfg.use_kernel:
        _, t, hit = render_kernel_raw(scene, cfg, row0, local_height)
        return t, hit
    ray_o, ray_d = generate_rays(scene.camera, cfg.height, cfg.width, row0,
                                 local_height)
    return _march_torch(scene, cfg, ray_o, ray_d, row0, local_height)


def render(scene: Scene, cfg: RenderConfig, row0=0.0,
           local_height: int | None = None) -> torch.Tensor:
    """Main entry: (h, W, 3) linear RGB of a full frame or a row band.

    ``cfg.supersample`` > 1 renders at k× resolution and box-downsamples."""
    ss = cfg.supersample
    if ss > 1:
        hi_cfg = dataclasses.replace(
            cfg, height=cfg.height * ss, width=cfg.width * ss, supersample=1
        )
        lh = None if local_height is None else local_height * ss
        img = render(scene, hi_cfg, row0 * ss, lh)
        h = img.shape[0] // ss
        w = img.shape[1] // ss
        return img.reshape(h, ss, w, ss, 3).mean(dim=(1, 3))
    if cfg.use_kernel:
        return render_kernel(scene, cfg, row0, local_height)
    return render_torch(scene, cfg, row0, local_height)
