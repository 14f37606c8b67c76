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
import functools
import os
from typing import Callable

import torch

from gpgpuraytrace_tpu_torch.models.scene import RenderConfig, Scene
from gpgpuraytrace_tpu_torch.ops.render import render
from gpgpuraytrace_tpu_torch.utils.checkpoint import load_fit_state, save_fit_state
from gpgpuraytrace_tpu_torch.utils.graphs import CapturedProgram
from gpgpuraytrace_tpu_torch.utils.profiling import warn_if_rough

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
    """Adam with optax ``adam``'s defaults (b1 0.9, b2 0.999, eps 1e-8).

    On the card it is ``capturable`` (its step counts live on the device, so
    a CUDA graph can capture the update), for every ``steps_per_call``: eager
    and captured steps then run the same arithmetic, which differs from
    torch's default CUDA path in the last bits. The CPU keeps the default
    (``capturable`` is for CUDA tensors only)."""
    params = list(params)
    capturable = bool(params) and params[0].device.type == "cuda"
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            capturable=capturable)


def fit_step(scene: Scene, cfg: RenderConfig, target: torch.Tensor,
             opt: torch.optim.Optimizer) -> torch.Tensor:
    """One training step: loss, backward, optimizer update. Returns the
    loss, still on the device."""
    opt.zero_grad(set_to_none=True)
    loss = pixel_loss(scene, cfg, target)
    loss.backward()
    opt.step()
    return loss.detach()


def fit_steps(args: tuple, n: int) -> torch.Tensor:
    """``n`` steps of ``fit_step(*args)``: their (n,) losses."""
    return torch.stack([fit_step(*args) for _ in range(n)])


class StepChunk:
    """``k`` whole training steps (``fit_step``) per call, returning their
    (k,) losses on the device (the counterpart of the JAX package's
    ``lax.scan`` chunk in ``make_fit_step``).

    On a CUDA scene with k > 1 the steps run as one CUDA graph
    (``utils/graphs.py:CapturedProgram``). The first call runs its k steps
    eagerly on a side stream: PyTorch's warm-up before a capture, and the
    kernels' build. The second captures k steps into the graph (which runs
    nothing) and replays it, as does every later call, each returning a
    device-side clone of the graph's (k,) losses. The graph holds the
    scene's parameters, Adam's state and ``target`` by address: they are
    updated in place, never replaced. The kernels' launch counters count
    the captured launches once, at capture, not per replay. On the CPU, and
    for k = 1, a call is a plain loop of k steps. ``eager(n)`` runs n steps
    without the graph (a shorter tail chunk)."""

    def __init__(self, scene: Scene, cfg: RenderConfig, target: torch.Tensor,
                 opt: torch.optim.Optimizer, k: int):
        self.args = (scene, cfg, target, opt)
        self.k = k
        self.graphed = k > 1 and target.device.type == "cuda"
        self.program = (CapturedProgram(functools.partial(fit_steps, self.args, k),
                                        target.device) if self.graphed else None)

    @property
    def graph(self) -> torch.cuda.CUDAGraph | None:
        """The captured graph (None before the capture, and off the card)."""
        return self.program.graph if self.graphed else None

    def eager(self, n: int) -> torch.Tensor:
        return fit_steps(self.args, n)

    def __call__(self) -> torch.Tensor:
        if not self.graphed:
            return self.eager(self.k)
        losses = self.program()
        return losses.clone() if self.program.captured else losses


def fit(scene: Scene, cfg: RenderConfig, target: torch.Tensor, steps: int = 200,
        learning_rate: float = 2e-2, trainable: Callable[[str], bool] | None = None,
        log_every: int = 20, log_fn=print, save_path: str = "", save_every: int = 25,
        resume: bool = False, steps_per_call: int = 1) -> tuple[Scene, list[float]]:
    """Gradient-descend the scene's parameters toward ``target`` with Adam
    (the update of optax's ``adam``: m̂ / (√v̂ + 1e-8)). Updates ``scene`` in
    place and returns it with the loss of every step.

    ``trainable`` filters dotted parameter names (default: the fBm
    amplitudes and the camera pose). Losses stay on the device between log
    and save points: fetching one is a host sync, which would stall the
    queue of launches. Warns first (``utils/profiling.py:warn_if_rough``)
    when the starting scene is rough enough for the march to skip ridges:
    a fit toward a target rendered there would be quietly wrong.

    ``steps_per_call`` runs the steps in chunks of that many (``StepChunk``:
    on the card, one CUDA graph of the whole chunk); a shorter tail chunk
    runs eagerly. Logging and saving happen at chunk boundaries, by absolute
    step index, so a resumed run logs the lines an unbroken one does.

    With ``save_path``, the trainable parameters, Adam's state, the step
    count and the losses are checkpointed (``utils/checkpoint.py``) every
    ``save_every`` steps and at the end; ``resume=True`` restores an existing
    checkpoint (none: a fresh start) and continues bit for bit the run that
    saved it. Each run of a kill-and-resume pair updates its own scene, so
    start each from its own copy."""
    warn_if_rough(scene, cfg)
    trainable = trainable or default_trainable
    names = [n for n, _ in scene.named_parameters() if trainable(n)]
    params = dict(zip(names, partition_scene(scene, trainable)))
    opt = make_optimizer(params.values(), learning_rate)
    start, losses = 0, []
    if resume and save_path and os.path.exists(save_path):
        start, losses = load_fit_state(save_path, params, opt)
        log_fn(f"fit: resumed from {save_path} at step {start}")
    chunk = max(1, min(steps_per_call, max(steps - start, 1)))
    run = StepChunk(scene, cfg, target, opt, chunk)
    pending: list[torch.Tensor] = []

    def flush() -> None:
        if pending:
            losses.extend(torch.cat(pending).tolist())
            pending.clear()

    i = start
    while i < steps:
        n = min(chunk, steps - i)
        pending.append(run() if n == chunk else run.eager(n))
        i += n
        if log_every and (any((i - 1 - k) % log_every == 0 for k in range(n))
                          or i == steps):
            flush()
            log_fn(f"fit step {i - 1:4d}  loss {losses[-1]:.6e}")
        if save_path and ((save_every and any((i - k) % save_every == 0 for k in range(n)))
                          or i == steps):
            flush()
            save_fit_state(save_path, params, opt, i, losses)
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
