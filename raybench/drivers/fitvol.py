"""The fit on the volumetric terrain: ``fit``'s loop (``drivers/fit.py``:
chunks of ``steps_per_call`` Adam steps as one CUDA graph, the losses read
back every ``log_every`` steps, the graph's first replay compared), on a
``RenderConfig`` with ``volumetric`` set, held to the volumetric reference
(``reference/volumetric.py``) and counted by ``roofline_volumetric.py``.

The start is ``fit``'s (``scene.perturbed``) with the warp amplitude scaled
too, by 1 + rel·U(-1, 1) from a generator of the seed; one fit runs the
whole window, as in ``fit``.

One fit left to run the window leaves the target's neighbourhood within a
few hundred steps and rests at a scene of each seed's own, where the
gradient the program and the reference compute (the implicit-function rule
through the hit point, which leaves out the terms of pixels that change
between terrain and sky or between occluders) vanishes while the loss's own
slope does not. The rate is then that scene's (PERF.md, section 7).

``work`` also counts, outside the timed window, the steps the forward
kernel's fine pass executed on the stretch's start and end scenes
(``debug_steps``), for ``march_step_ratio``.

Faults of the tests, beside ``fit``'s: ``no_warp`` (the program traces the
heightfield; the reference keeps the warp) and ``warp_grad_dropped`` (the
warp leaves' gradients zeroed before Adam's step, inside the capture on the
card and at every step off it).
"""

from __future__ import annotations

import numpy as np
import torch

from raybench import compare, core, roofline_volumetric as roofline, scene as sc
from raybench.reference import volumetric as ref

_fit = core.load_module(core.PKG / "drivers" / "fit.py")
WARP_LEAVES = ("noise.warp_amplitude", "noise.warp_frequency")


def perturbed(values: dict, seed: int, rel: float) -> dict:
    """``scene.perturbed``, and the warp amplitude scaled by
    1 + rel·U(-1, 1) drawn from a generator of ``seed`` of its own."""
    out = sc.perturbed(values, seed, rel)
    u = np.random.default_rng([seed, 1]).uniform(-1.0, 1.0)
    out["noise.warp_amplitude"] = np.float32(values["noise.warp_amplitude"] * (1.0 + rel * u))
    return out


def render_spec(render: dict) -> ref.RenderSpec:
    """The volumetric reference's ``RenderSpec`` of a ``render`` block."""
    keys = (*sc.SPEC_KEYS, "warp_octaves")
    return ref.RenderSpec(**{k: render[k] for k in keys if k in render})


class _Scenes:
    """``raybench.scene`` as ``fit``'s set-up reads it (its module global
    ``sc``, in this driver's own copy of that module), with the start
    ``perturbed`` above."""

    perturbed = staticmethod(perturbed)

    def __getattr__(self, name):
        return getattr(sc, name)


_fit.sc = _Scenes()


class Run(_fit.Run):
    def __init__(self, ctx: core.Context):
        super().__init__(ctx)
        self.spec = render_spec(ctx.render)

    def _plant(self, F) -> None:
        super()._plant(F)
        if self.ctx.fault == "no_warp":
            self.ctx.render = {**self.ctx.render, "volumetric": False}

    def _plant_in_capture(self) -> None:
        super()._plant_in_capture()
        if self.ctx.fault == "warp_grad_dropped":
            step = self.opt.step
            warp = [p for n, p in zip(self.names, self.opt.param_groups[0]["params"])
                    if n in WARP_LEAVES]
            off_card = self.ctx.device.type != "cuda"

            def step_without_warp(*args, **kwargs):
                if off_card or torch.cuda.is_current_stream_capturing():
                    for p in warp:
                        p.grad.zero_()
                return step(*args, **kwargs)

            self.opt.step = step_without_warp

    def work(self) -> dict:
        """Least seconds of a step's forward and backward kernels on the
        profiled inputs: the volumetric reference's march of the scene at
        the stretch's start and end, averaged; and ``march_step_ratio``,
        the lane-steps the program's fine pass executed on those scenes
        over the reference's useful steps, averaged."""
        least, ratio = [], []
        for which in ("start", "end"):
            values = {**self.start, **sc.host_values(self.marks[which])}
            t = ref.trace(sc.ref_scene(values, self.ctx.device), self.spec)
            least.append(roofline.trace_least(self.spec.num_octaves, self.spec.warp_octaves,
                                              self.spec.newton_iters, t))
            ratio.append(self.executed_steps(values) / t.steps)
        return {k: sum(x[k] for x in least) / 2 for k in ("fwd", "bwd")} | {
            "fwd_by": least[0]["fwd_by"], "bwd_by": least[0]["bwd_by"],
            "march_step_ratio": sum(ratio) / 2}

    def executed_steps(self, values: dict) -> int:
        """Lane-steps the fine pass's warps execute on the scene of
        ``values``: each warp's longest lane (``warp_steps`` of the
        kernel's per-lane ``debug_steps`` counts) times its lanes."""
        from gpgpuraytrace_tpu_torch.kernels import trace as K

        scene = sc.port_scene(values, self.ctx.device)
        *_, steps = K.render_kernel_raw(scene, self.cfg, debug_steps=True)
        return K.WARP * int(K.warp_steps(steps).sum())

    def check(self) -> list:
        c = self.ctx
        target = ref.frame(sc.ref_scene(c.scene_values, c.device), self.spec)
        want = ref.fit(sc.ref_scene(self.start, c.device), self.spec, target, self.names,
                       c.traffic["lr"], _fit.REF_STEPS)
        gaps = compare.train_gaps(
            {"losses": self.first, "grad": self.grad1,
             "change": {n: self.after[n] - self.start_leaves[n] for n in self.names}}, want)
        self.details = gaps.pop("details")
        return core.judge(gaps, c.cell.limits["limits"])
