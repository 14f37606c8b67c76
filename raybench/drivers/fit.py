"""The fit loop (``ops/fit.py``) as ``fit`` runs it: chunks of
``steps_per_call`` Adam steps (``StepChunk``, one CUDA graph on the card),
the losses read back at every ``log_every``-th step, no checkpoint.

Set-up renders the target with the port (the ``cli fit`` way), builds the
start scene from the seed, and drives the chunk through its first call (its
eager warm-up). It then puts the start scene and a fresh Adam state back in
place and makes the second call, which captures the graph and replays it:
the compared steps are that replay's. The chunk itself writes, at its first
step, Adam's first moment (over 1 - b1, the first gradient) and, at its
third, the parameters into buffers of the benchmark's (a step hook, so
the capture holds the two copies); the buffers are NaN before the replay,
so a replay that skips them fails. The first steps' losses come from the
replay's own output. After the window the reference renders its own target
and takes the same three steps from the same start.
"""

from __future__ import annotations

import time

import torch

from raybench import compare, core, roofline, scene as sc
from raybench.reference import terrain as ref
from raybench.tracing import Tracer, span

REF_STEPS = 3


class Run:
    def __init__(self, ctx: core.Context):
        self.ctx = ctx
        self.attempted = self.failed = 0
        self.tracer = Tracer(ctx.trace, ctx.trace_path, on_mark=self._mark)
        self.marks = {}
        self._undo = []

    def _plant(self, F) -> None:
        """The planted faults of the tests."""
        if self.ctx.fault == "half_batch":
            from gpgpuraytrace_tpu_torch.ops.render import render

            def half_loss(scene, cfg, target):
                d = render(scene, cfg) - target
                h = d.shape[0] // 2
                return torch.mean(d[:h] * d[:h])

            self._undo.append((F, "pixel_loss", F.pixel_loss))
            F.pixel_loss = half_loss

    def _plant_in_capture(self) -> None:
        """A fault of the replay alone: the optimizer's step is left out of
        the capture (the eager warm-up keeps it)."""
        if self.ctx.fault == "replay_no_update":
            step = self.opt.step

            def step_outside_capture(*args, **kwargs):
                if not torch.cuda.is_current_stream_capturing():
                    return step(*args, **kwargs)

            self.opt.step = step_outside_capture

    def setup(self) -> None:
        from gpgpuraytrace_tpu_torch.ops import fit as F
        from gpgpuraytrace_tpu_torch.ops.render import render

        c, tr = self.ctx, self.ctx.traffic
        self._plant(F)
        self.cfg = sc.render_config(c.render, march_bf16=c.control)
        with c.phase("the target's render"), torch.no_grad():
            self.target = render(sc.port_scene(c.scene_values, c.device), self.cfg)
        self.start = sc.perturbed(c.scene_values, c.seed, tr["perturb_rel"])
        self.scene = sc.port_scene(self.start, c.device)
        prefixes = tuple(tr["trainable"])
        self.names = [n for n, _ in self.scene.named_parameters() if n.startswith(prefixes)]
        params = F.partition_scene(self.scene, lambda n: n.startswith(prefixes))
        lr = 0.0 if c.fault == "unchanged" else tr["lr"]
        self.opt = F.make_optimizer(params, lr)
        self.start_leaves = sc.leaves(self.scene, self.names)
        self._plant_in_capture()
        self.k = tr["steps_per_call"]
        if self.k < REF_STEPS:
            raise ValueError(f"steps_per_call {self.k} < {REF_STEPS}: a call must hold the "
                             f"compared steps")
        moment = {n: torch.empty_like(p) for n, p in zip(self.names, params)}
        after = {n: torch.empty_like(p) for n, p in zip(self.names, params)}
        self.buffers = (moment, after)
        seen = {"n": 0}

        def after_step(opt, args, kwargs):
            seen["n"] += 1
            i = (seen["n"] - 1) % self.k + 1
            with torch.no_grad():
                if i == 1:
                    torch._foreach_copy_(list(moment.values()),
                                         [opt.state[p]["exp_avg"] for p in params])
                elif i == REF_STEPS:
                    torch._foreach_copy_(list(after.values()), [p.detach() for p in params])

        hook = self.opt.register_step_post_hook(after_step)
        self.run = F.StepChunk(self.scene, self.cfg, self.target, self.opt, self.k)
        with c.phase(f"the first call ({self.k} eager steps)"):
            self.run()
        self._restart(params)
        with c.phase("the second call (capture, replay from the start)"):
            first = self.run()
        hook.remove()
        self.first = first[:REF_STEPS].tolist()
        self.grad1 = {n: v.clone() / 0.1 for n, v in moment.items()}
        self.after = {n: v.clone() for n, v in after.items()}
        self.done = self.k

    def _restart(self, params) -> None:
        """The start scene and a fresh Adam state, written in place (the
        graph reads both by address), and the compared buffers made NaN."""
        with torch.no_grad():
            for n, p in zip(self.names, params):
                p.copy_(self.start_leaves[n])
            for p in params:
                for v in self.opt.state[p].values():
                    if torch.is_tensor(v):
                        v.zero_()
            for buf in self.buffers:
                for v in buf.values():
                    v.fill_(float("nan"))

    def _mark(self, which: str) -> None:
        self.marks[which] = sc.leaves(self.scene, self.names)

    def window(self) -> dict:
        c, tr = self.ctx, self.ctx.traffic
        log_every, k = tr["log_every"], self.k
        pending, steps, bad = [], 0, 0
        tracing = c.trace
        self.tracer.begin(c.seconds)
        t0 = time.perf_counter()
        while True:
            with span(tracing, "raybench.fit.chunk"):
                pending.append(self.run())
            self.done += k
            steps += k
            if any((self.done - 1 - j) % log_every == 0 for j in range(k)):
                with span(tracing, "raybench.fit.loss_readback"):
                    losses = torch.cat(pending).tolist()
                pending.clear()
                bad += sum(1 for x in losses if not x == x or abs(x) == float("inf"))
                self.tracer.tick(steps)
                if time.perf_counter() - t0 >= c.seconds and not self.tracer.open():
                    break
        c.sync()
        dt = time.perf_counter() - t0
        self.attempted, self.failed = steps, bad
        pixels = self.cfg.height * self.cfg.width
        return {"fwd_bwd_rays_per_s": steps * pixels / dt}

    def work(self) -> dict:
        """Least seconds a step's forward and backward kernels could take on
        the profiled inputs: the reference's march of the scene at the
        stretch's start and end, averaged."""
        spec = sc.render_spec(self.ctx.render)
        least = []
        for which in ("start", "end"):
            values = {**self.start, **sc.host_values(self.marks[which])}
            t = ref.trace(sc.ref_scene(values, self.ctx.device), spec)
            least.append(roofline.trace_least(spec.num_octaves, spec.newton_iters, t))
        return {k: sum(x[k] for x in least) / 2 for k in ("fwd", "bwd")} | {
            "fwd_by": least[0]["fwd_by"], "bwd_by": least[0]["bwd_by"]}

    def release(self) -> None:
        self.run = self.opt = self.scene = self.target = self.buffers = None
        for obj, attr, old in self._undo:
            setattr(obj, attr, old)
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list:
        c = self.ctx
        spec = sc.render_spec(c.render)
        target = ref.frame(sc.ref_scene(c.scene_values, c.device), spec)
        want = ref.fit(sc.ref_scene(self.start, c.device), spec, target, self.names,
                       c.traffic["lr"], REF_STEPS)
        gaps = compare.train_gaps(
            {"losses": self.first, "grad": self.grad1,
             "change": {n: self.after[n] - self.start_leaves[n] for n in self.names}}, want)
        self.details = gaps.pop("details")
        return core.judge(gaps, c.cell.limits["limits"])
