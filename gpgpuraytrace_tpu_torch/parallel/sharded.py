"""Row-band render and fit over a process group (counterpart of
``gpgpuraytrace_tpu/parallel/sharded.py``).

Each rank renders its band (``mesh.band``) through ``render(scene, cfg,
row0, local_height)``, the kernels taking the band's first row; the forward
needs no collective. Training sums over the bands: each rank's loss is
``sum(d²) / (H·W·3)`` over its rows, so the sum over ranks is the frame's
mean, and one ``all_reduce`` (sum) per trainable parameter, plus one for the
loss, gives every rank the whole frame's gradient; each rank then takes the
same Adam step on its replica of the parameters.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gpgpuraytrace_tpu_torch.models.scene import RenderConfig, Scene
from gpgpuraytrace_tpu_torch.ops.render import render
from gpgpuraytrace_tpu_torch.parallel.mesh import band, world


def shard_target(target: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """This rank's rows of the whole (H, W, 3) ``target``."""
    row0, h = band(cfg)
    return target[int(row0):int(row0) + h]


@torch.no_grad()
def sharded_render(scene: Scene, cfg: RenderConfig, gather: bool = True) -> torch.Tensor:
    """This rank's band (h, W, 3) or, with ``gather``, the whole frame
    (H, W, 3) assembled by ``all_gather`` on every rank. Serving: builds no
    autograd graph."""
    row0, h = band(cfg)
    img = render(scene, cfg, row0, h)
    _, n = world()
    if not gather or n == 1:
        return img
    parts = [torch.empty_like(img) for _ in range(n)]
    dist.all_gather(parts, img.contiguous())
    return torch.cat(parts)


def sharded_loss_and_grad(scene: Scene, params: list[torch.nn.Parameter],
                          cfg: RenderConfig, target_local: torch.Tensor):
    """(loss, grads): the whole frame's mean squared pixel error and its
    gradient with respect to ``params`` (``ops/fit.py:partition_scene``'s),
    computed band-wise. ``target_local`` is this rank's band of the target
    (``shard_target``). Every rank gets the same values: the band sums go
    through one ``all_reduce`` for the loss and one per parameter."""
    row0, h = band(cfg)
    d = render(scene, cfg, row0, h) - target_local
    loss = torch.sum(d * d) * (1.0 / (cfg.height * cfg.width * 3))
    grads = list(torch.autograd.grad(loss, params, materialize_grads=True))
    loss = loss.detach()
    if world()[1] > 1:
        dist.all_reduce(loss)
        for g in grads:
            dist.all_reduce(g)
    return loss, grads


def make_sharded_fit_step(scene: Scene, cfg: RenderConfig,
                          params: list[torch.nn.Parameter], opt: torch.optim.Optimizer):
    """A training step over the bands: ``step(target_local) -> loss``, the
    summed gradient (``sharded_loss_and_grad``), then ``opt``'s update of
    ``params`` on every rank (``opt`` from ``ops/fit.py:make_optimizer``)."""

    def step(target_local: torch.Tensor) -> torch.Tensor:
        loss, grads = sharded_loss_and_grad(scene, params, cfg, target_local)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        return loss

    return step
