"""Finite-difference gradient checker: autodiff pixel-loss gradients against
central finite differences for one scalar parameter (counterpart of
``gpgpuraytrace_tpu/ops/fd_check.py``).

Silhouette pixels, where a parameter nudge flips hit and miss, make the true
derivative a delta function, so the loss is restricted to pixels whose hit
mask is stable under ±eps and whose hit distance moves smoothly.

Unlike the JAX harness, which always marches unprimed, both the mask and the
loss go through ``render``: the check marches primed whenever the config
primes, and on a CUDA scene it runs the trace kernels forward and backward.
"""

from __future__ import annotations

import copy
from typing import Callable

import torch

from gpgpuraytrace_tpu_torch.models.scene import RenderConfig, Scene
from gpgpuraytrace_tpu_torch.ops.render import hit_distances, render


def scene_with(scene: Scene, name: str, theta: torch.Tensor,
               index: int | None = None) -> Scene:
    """A copy of ``scene`` whose dotted leaf ``name`` (component ``index`` of
    it, if given) is the 0-d tensor ``theta``, differentiably: gradients of
    a render of the copy flow back to ``theta``. The other leaves are
    detached copies."""
    out = copy.deepcopy(scene)
    mod_name, attr = name.rsplit(".", 1)
    mod = out.get_submodule(mod_name)
    base = getattr(mod, attr).detach()
    if index is None:
        value = theta.reshape(base.shape).to(base.dtype)
    else:
        mask = torch.arange(base.numel(), device=base.device) == index
        value = torch.where(mask, theta.to(base.device, base.dtype), base)
    delattr(mod, attr)
    setattr(mod, attr, value)  # a plain tensor attribute, no longer a Parameter
    return out


def _stable_hit_mask(get_scene: Callable[[torch.Tensor], Scene], theta, eps,
                     cfg: RenderConfig, t_cap: float = 0.1) -> torch.Tensor:
    """Pixels where the derivative exists and FD is trustworthy: the hit mask
    agrees at θ-eps, θ, θ+eps and the hit distance moves by less than
    ``t_cap`` (grazing rays can re-route around ridges chaotically)."""
    masks, ts = [], []
    for dt in (-eps, 0.0, eps):
        t, hit = hit_distances(get_scene(theta + dt), cfg)
        masks.append(hit)
        ts.append(t)
    stable = (masks[0] == masks[1]) & (masks[1] == masks[2])
    smooth = (torch.abs(ts[2] - ts[0]) < t_cap) & (torch.abs(ts[1] - ts[0]) < t_cap)
    return stable & smooth


def fd_check_scalar(get_scene: Callable[[torch.Tensor], Scene], theta0,
                    cfg: RenderConfig, target: torch.Tensor, eps: float = 1e-3,
                    t_cap: float = 0.1) -> tuple[float, float]:
    """(autodiff gradient, finite-difference gradient) of the masked pixel
    loss with respect to the scalar ``theta`` that ``get_scene`` builds the
    scene from (``scene_with`` makes such a scene). ``t_cap`` is the
    smoothness filter's |Δt| bound (see ``_stable_hit_mask``)."""
    if cfg.supersample > 1:
        raise ValueError("fd_check_scalar compares at render resolution: "
                         "supersample must be 1")
    theta0 = torch.as_tensor(theta0, dtype=torch.float32,
                             device=target.device).detach()
    stable = _stable_hit_mask(get_scene, theta0, eps, cfg, t_cap=t_cap)
    w = stable.to(torch.float32)[..., None]
    denom = torch.sum(w) * 3.0

    def loss(theta):
        img = render(get_scene(theta), cfg)
        return torch.sum(w * (img - target) ** 2) / denom

    theta = theta0.clone().requires_grad_()
    (ad,) = torch.autograd.grad(loss(theta), theta)
    with torch.no_grad():
        fd = (loss(theta0 + eps) - loss(theta0 - eps)) / (2.0 * eps)
    return float(ad), float(fd)
