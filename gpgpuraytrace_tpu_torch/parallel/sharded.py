"""Row-band render and fit over a process group (counterpart of
``gpgpuraytrace_tpu/parallel/sharded.py``).

Each rank renders its rows, its interleaved stripes (``mesh.stripes``),
through ``render(scene, cfg, row0s, h)``, h its row count: the kernels
take the stripes as one frame-axis batch of the one camera, each frame's
packed row its stripe's first row (one stripe: the band as the JAX
package's ``mesh.band`` gives it). The forward needs no
collective. Training sums over the ranks: each rank's loss is ``sum(d²) /
(H·W·3)`` over its rows, so the sum over ranks is the frame's mean, and one
``all_reduce`` (sum) per trainable parameter, plus one for the loss, gives
every rank the whole frame's gradient; each rank then takes the same Adam
step on its replica of the parameters. A rank's target is its stripes' rows
in stripe order (``shard_target``); ``sharded_render`` puts the gathered
stripes back in frame order.

On the card the training step (``make_sharded_fit_step``) runs as one CUDA
graph, the counterpart of the reference's ``@jax.jit`` step
(``gpgpuraytrace_tpu/parallel/sharded.py:151-158``): the band's forward and
backward kernels, the NCCL all-reduces and the ``capturable`` Adam update,
captured once and replayed.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from gpgpuraytrace_tpu_torch.kernels.trace import trace_frames, trace_frames_bwd
from gpgpuraytrace_tpu_torch.models.scene import RenderConfig, Scene
from gpgpuraytrace_tpu_torch.ops.render import render
from gpgpuraytrace_tpu_torch.parallel.mesh import all_reduce, band, stripes, world
from gpgpuraytrace_tpu_torch.utils.graphs import CapturedProgram


def shard_target(target: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """This rank's rows of the whole (H, W, 3) ``target``: its stripes', in
    stripe order."""
    row0s, s = stripes(cfg)
    return torch.cat([target[int(r):int(r) + s] for r in row0s])


@torch.no_grad()
def sharded_render(scene: Scene, cfg: RenderConfig, gather: bool = True) -> torch.Tensor:
    """This rank's rows (h, W, 3), its stripes in stripe order, or, with
    ``gather``, the whole frame (H, W, 3) assembled by ``all_gather`` on every
    rank and put back in frame order. Serving: builds no autograd graph."""
    row0s, s = stripes(cfg)
    img = render(scene, cfg, row0s, len(row0s) * s)
    _, n = world()
    if not gather or n == 1:
        return img
    parts = [torch.empty_like(img) for _ in range(n)]
    dist.all_gather(parts, img.contiguous())
    # Rank r's stripe j is the frame's stripe j·n + r.
    frame = torch.stack(parts).reshape(n, len(row0s), s, cfg.width, 3).transpose(0, 1)
    return frame.reshape(cfg.height, cfg.width, 3)


def band_loss_and_grad(scene: Scene, params: list[torch.nn.Parameter], cfg: RenderConfig,
                       target_local: torch.Tensor, row0, local_height: int):
    """(loss, grads) of one rank's rows alone: their share sum(d²) / (H·W·3)
    of the frame's mean squared pixel error and its gradient with respect
    to ``params``, no collective. The rows are the ``local_height`` rows of
    the band at ``row0``, or, where ``row0`` is a sequence of first rows, of
    those stripes, which split them evenly, one after another (``render``)."""
    d = render(scene, cfg, row0, local_height) - target_local
    loss = torch.sum(d * d) * (1.0 / (cfg.height * cfg.width * 3))
    grads = list(torch.autograd.grad(loss, params, materialize_grads=True))
    return loss.detach(), grads


def step_launches() -> dict[str, dict]:
    """The launch counts a row-band step moves, by part and kind: the
    forward and backward kernels' and ``all_reduce``'s (the counters that
    ``utils/timing.py:measure_kernel`` reads)."""
    return {"forward": dict(trace_frames.launches), "backward": dict(trace_frames_bwd.launches),
            "all_reduce": dict(all_reduce.launches)}


def sharded_loss_and_grad(scene: Scene, params: list[torch.nn.Parameter],
                          cfg: RenderConfig, target_local: torch.Tensor):
    """(loss, grads): the whole frame's mean squared pixel error and its
    gradient with respect to ``params`` (``ops/fit.py:partition_scene``'s),
    computed rank by rank over each rank's stripes. ``target_local`` is this
    rank's rows of the target (``shard_target``). Every rank gets the same
    values: the ranks' sums go through one ``all_reduce`` for the loss and
    one per parameter (the reference's per-leaf ``psum``; none in a group of
    one). ``sharded_loss_and_grad.stripes`` counts the stripes rendered, as
    the kernels' launch counters count (a CUDA graph's capture once, its
    replays not)."""
    row0s, s = stripes(cfg)
    sharded_loss_and_grad.stripes += len(row0s)
    loss, grads = band_loss_and_grad(scene, params, cfg, target_local, row0s, len(row0s) * s)
    if world()[1] > 1:
        all_reduce(loss)
        for g in grads:
            all_reduce(g)
    return loss, grads


sharded_loss_and_grad.stripes = 0


def fit_step_eager(scene: Scene, cfg: RenderConfig, params: list[torch.nn.Parameter],
                   opt: torch.optim.Optimizer, target_local: torch.Tensor) -> torch.Tensor:
    """One row-band training step, eagerly: the summed gradient
    (``sharded_loss_and_grad``), then ``opt``'s update of ``params``; the
    frame's loss."""
    loss, grads = sharded_loss_and_grad(scene, params, cfg, target_local)
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    return loss


class ShardedFitStep:
    """A training step over the bands: ``step(target_local) -> loss``, the
    summed gradient (``sharded_loss_and_grad``), then ``opt``'s update of
    ``params`` on every rank (``opt`` from ``ops/fit.py:make_optimizer``:
    ``capturable`` on the card).

    On the card a step is one CUDA graph (``utils/graphs.py:
    CapturedProgram``): the first call runs eagerly on a side stream (the
    warm-up, which also creates NCCL's communicator and Adam's state), the
    second captures one whole step (band forward and backward, the loss's
    and every parameter's ``all_reduce``, Adam) and replays it, and every
    later call replays it. Every rank must make its calls in the same order.
    The graph reads the target from a buffer of its own, into which each
    call copies ``target_local``, and returns a clone of its loss. A capture
    that fails raises. Release the graph (``close()``, or drop the step)
    before destroying the process group: NCCL's communicator waits for every
    graph that holds its collectives. On the CPU (gloo) a call is the eager
    step. ``eager(target_local)`` runs the step without the graph."""

    def __init__(self, scene: Scene, cfg: RenderConfig, params: list[torch.nn.Parameter],
                 opt: torch.optim.Optimizer):
        self.args = (scene, cfg, params, opt)
        device = params[0].device
        self.graphed = device.type == "cuda"
        self.program = self.target = None
        if self.graphed:
            _, h = band(cfg)  # the rows of the rank's stripes
            self.target = torch.empty((h, cfg.width, 3), dtype=torch.float32, device=device)
            self.program = CapturedProgram(
                functools.partial(fit_step_eager, *self.args, self.target), device)

    def eager(self, target_local: torch.Tensor) -> torch.Tensor:
        return fit_step_eager(*self.args, target_local)

    def __call__(self, target_local: torch.Tensor) -> torch.Tensor:
        if not self.graphed:
            return self.eager(target_local)
        self.target.copy_(target_local)
        loss = self.program()
        return loss.clone() if self.program.captured else loss

    def close(self) -> None:
        """Release the CUDA graph (a later call captures anew)."""
        if self.program is not None:
            self.program.close()


def make_sharded_fit_step(scene: Scene, cfg: RenderConfig,
                          params: list[torch.nn.Parameter],
                          opt: torch.optim.Optimizer) -> ShardedFitStep:
    """The row-band training step ``step(target_local) -> loss``
    (``ShardedFitStep``: one CUDA graph on the card)."""
    return ShardedFitStep(scene, cfg, params, opt)
