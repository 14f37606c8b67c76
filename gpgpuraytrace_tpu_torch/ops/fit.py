"""Differentiable fitting: recover scene parameters from a target image by
pixel-gradient descent (counterpart of ``gpgpuraytrace_tpu/ops/fit.py``).

The training step of the system: loss = mean squared pixel error, gradients
through shading and through the march by the implicit-function VJP (on the
kernel path: the backward trace kernel), parameters updated with Adam.

The port updates the scene's parameters in place, where the JAX package
returns a new scene: the scene is an ``nn.Module`` and ``torch.optim``
steps its parameters.
"""

from __future__ import annotations

import copy
from typing import Callable

import torch

from gpgpuraytrace_tpu_torch.models.scene import RenderConfig, Scene
from gpgpuraytrace_tpu_torch.ops.render import render

DEFAULT_TRAINABLE = ("noise.amplitudes", "camera.")


def default_trainable(name: str) -> bool:
    return name.startswith(DEFAULT_TRAINABLE)


def partition_scene(scene: Scene,
                    trainable: Callable[[str], bool] = default_trainable
                    ) -> list[torch.nn.Parameter]:
    """Mark the scene's trainable parameters by dotted name: sets
    ``requires_grad`` on those ``trainable`` accepts, clears it on the others,
    and returns the trainable ones in ``named_parameters()`` order. The
    integer seed is a buffer, never trained."""
    train = []
    for name, p in scene.named_parameters():
        keep = bool(trainable(name))
        p.requires_grad_(keep)
        if keep:
            train.append(p)
    return train


def pixel_loss(scene: Scene, cfg: RenderConfig, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error over linear-RGB pixels."""
    diff = render(scene, cfg) - target
    return torch.mean(diff * diff)


def make_optimizer(params, learning_rate: float) -> torch.optim.Adam:
    """Adam with optax ``adam``'s defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def fit_step(scene: Scene, cfg: RenderConfig, target: torch.Tensor,
             opt: torch.optim.Optimizer) -> torch.Tensor:
    """One training step: loss, backward, optimizer update. Returns the
    loss, still on the device."""
    opt.zero_grad(set_to_none=True)
    loss = pixel_loss(scene, cfg, target)
    loss.backward()
    opt.step()
    return loss.detach()


def fit(scene: Scene, cfg: RenderConfig, target: torch.Tensor, steps: int = 200,
        learning_rate: float = 2e-2, trainable: Callable[[str], bool] | None = None,
        log_every: int = 20, log_fn=print) -> tuple[Scene, list[float]]:
    """Gradient-descend the scene's parameters toward ``target`` with Adam
    (the update of optax's ``adam``: m̂ / (√v̂ + 1e-8)). Updates ``scene`` in
    place and returns it with the loss of every step.

    ``trainable`` filters dotted parameter names (default: the fBm
    amplitudes and the camera pose). Losses stay on the device between log
    points: fetching one is a host sync, which would stall the queue of
    launches every step."""
    opt = make_optimizer(partition_scene(scene, trainable or default_trainable),
                         learning_rate)
    losses: list[float] = []
    pending: list[torch.Tensor] = []

    def flush() -> None:
        losses.extend(torch.stack(pending).tolist())
        pending.clear()

    for i in range(steps):
        pending.append(fit_step(scene, cfg, target, opt))
        if log_every and (i % log_every == 0 or i == steps - 1):
            flush()
            log_fn(f"fit step {i:4d}  loss {losses[-1]:.6e}")
    if pending:
        flush()
    return scene, losses


def perturb_scene(scene: Scene, generator: torch.Generator, rel: float = 0.25) -> Scene:
    """A perturbed copy of ``scene`` for fit demos and tests: the fBm
    amplitudes scaled by 1 + rel·U(-1, 1) and the camera's yaw and pitch
    nudged by rel·0.2·N(0, 1) and rel·0.1·N(0, 1). The draws come from
    ``generator`` (on the CPU) and move to the scene's device."""
    out = copy.deepcopy(scene)
    n, cam = out.noise, out.camera
    u = torch.rand(n.amplitudes.shape, generator=generator) * 2.0 - 1.0
    z = torch.randn(2, generator=generator)
    with torch.no_grad():
        n.amplitudes.mul_((1.0 + rel * u).to(n.amplitudes.device))
        cam.yaw.add_((rel * 0.2 * z[0]).to(cam.yaw.device))
        cam.pitch.add_((rel * 0.1 * z[1]).to(cam.pitch.device))
    return out
