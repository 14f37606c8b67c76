"""The render pipeline: raygen -> march -> shade (counterpart of
``gpgpuraytrace_tpu/ops/render.py``).

``render`` is the entry point. With ``cfg.use_kernel`` (the default) it runs
the trace kernel path (``kernels/trace.py``: the hand-written CUDA kernel on
a CUDA scene, its plain PyTorch version on a CPU scene); otherwise the plain
op-by-op path ``render_torch``. Forward only: gradients come with the
backward kernel (ROADMAP.md), so ``render`` returns a tensor that does not
require grad.
"""

from __future__ import annotations

import dataclasses

import torch

from gpgpuraytrace_tpu_torch.kernels.trace import render_kernel_raw
from gpgpuraytrace_tpu_torch.models.scene import RenderConfig, Scene
from gpgpuraytrace_tpu_torch.ops.camera import generate_rays
from gpgpuraytrace_tpu_torch.ops.march import (
    check_prime_band, coarse_prime_cfg, march, march_primed, prime_from_coarse,
)
from gpgpuraytrace_tpu_torch.ops.shade import shade


@torch.no_grad()
def prime_map_torch(scene: Scene, cfg: RenderConfig, row0=0.0,
                    local_height: int | None = None) -> torch.Tensor:
    """Depth-prime map from the plain coarse march: march a (h/ds + 2)
    × (w/ds) coarse pass (one halo row above and below the band) and
    expand its 3×3-neighbourhood minimum to full resolution."""
    check_prime_band(cfg, row0, local_height)
    ds = cfg.prime_ds
    ccfg = coarse_prime_cfg(cfg)
    lh = (cfg.height if local_height is None else local_height) // ds
    o_c, d_c = generate_rays(
        scene.camera, ccfg.height, ccfg.width, row0 / ds - 1.0, lh + 2
    )
    t_c, _ = march(ccfg, o_c, d_c, scene.noise)
    return prime_from_coarse(t_c, cfg)


@torch.no_grad()
def render_torch(scene: Scene, cfg: RenderConfig, row0=0.0,
                 local_height: int | None = None) -> torch.Tensor:
    """Plain PyTorch render: (h, W, 3) linear RGB."""
    ray_o, ray_d = generate_rays(scene.camera, cfg.height, cfg.width, row0,
                                 local_height)
    if cfg.prime_ds:
        t0p = prime_map_torch(scene, cfg, row0, local_height)
        t, hit = march_primed(cfg, ray_o, ray_d, scene.noise, t0p)
    else:
        t, hit = march(cfg, ray_o, ray_d, scene.noise)
    return shade(ray_o, ray_d, t, hit, scene.noise, scene.materials,
                 cfg.volumetric, cfg.warp_octaves)


@torch.no_grad()
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
        return render_kernel_raw(scene, cfg, row0, local_height)[0]
    return render_torch(scene, cfg, row0, local_height)
