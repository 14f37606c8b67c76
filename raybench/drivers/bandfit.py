"""The row-band fit over NCCL ranks, one per card (``parallel/sharded.py``):
``make_sharded_fit_step`` replayed as its CUDA graph with the all-reduces
captured, each rank's band of the target cut by ``shard_target``, the
frame's loss read back every ``log_every`` steps.

Set-up renders the whole target on each rank with the port and cuts its
band, builds the start scene from the seed, and takes the first three steps
through the step's own call: the first runs eagerly (the warm-up, Adam's
first moment after it gives the summed first gradient), the second captures
the graph and replays it. After the window every rank's parameters are
gathered (they must be equal bit for bit), and rank 0 runs the reference on
the whole frame, in blocks of ``ref_block_rows`` rows.

The window ends when every rank has run ``seconds`` (and, traced, closed
its stretch). The ranks agree on it through the process group's store, on
the host, so that no collective but the step's own runs in the window: at
each read-back a rank that is done says so once, and rank 0, once all are,
names a last step two read-backs ahead, which every rank learns at its next
read-back (the step's all-reduces keep the ranks within one read-back of
each other). The rate counts the whole frame's pixels per step.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

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

    def _plant(self, S) -> None:
        """The planted faults of the tests."""
        if self.ctx.fault == "no_exchange":
            self._undo.append((S, "all_reduce", S.all_reduce))
            S.all_reduce = lambda t: None
        if self.ctx.fault == "half_batch":
            old = S.band_loss_and_grad

            def half(scene, params, cfg, target_local, row0, local_height):
                from gpgpuraytrace_tpu_torch.ops.render import render

                d = (render(scene, cfg, row0, local_height) - target_local)
                d = d[:local_height // 2]
                loss = torch.sum(d * d) * (2.0 / (cfg.height * cfg.width * 3))
                grads = list(torch.autograd.grad(loss, params, materialize_grads=True))
                return loss.detach(), grads

            self._undo.append((S, "band_loss_and_grad", old))
            S.band_loss_and_grad = half

    def setup(self) -> None:
        from gpgpuraytrace_tpu_torch.ops import fit as F
        from gpgpuraytrace_tpu_torch.ops.render import render
        from gpgpuraytrace_tpu_torch.parallel import sharded as S

        c, tr = self.ctx, self.ctx.traffic
        self._plant(S)
        self.cfg = sc.render_config(c.render, march_bf16=c.control)
        with c.phase("the target's render"), torch.no_grad():
            target = render(sc.port_scene(c.scene_values, c.device), self.cfg)
            self.target = S.shard_target(target, self.cfg).contiguous()
            del target
        self.start = sc.perturbed(c.scene_values, c.seed, tr["perturb_rel"])
        self.scene = sc.port_scene(self.start, c.device)
        prefixes = tuple(tr["trainable"])
        self.names = [n for n, _ in self.scene.named_parameters() if n.startswith(prefixes)]
        params = F.partition_scene(self.scene, lambda n: n.startswith(prefixes))
        lr = 0.0 if c.fault == "unchanged" else tr["lr"]
        self.opt = F.make_optimizer(params, lr)
        self.start_leaves = sc.leaves(self.scene, self.names)

        def after_step(opt, args, kwargs):
            self.grad1 = {n: opt.state[p]["exp_avg"].detach() / 0.1
                          for n, p in zip(self.names, params)}

        hook = self.opt.register_step_post_hook(after_step)
        self.step = S.make_sharded_fit_step(self.scene, self.cfg, params, self.opt)
        with c.phase("the first step (eager, NCCL's communicator)"):
            first = [self.step(self.target)]
        hook.remove()
        with c.phase("steps 2-3 (capture, replays)"):
            first += [self.step(self.target) for _ in range(REF_STEPS - 1)]
        self.after = sc.leaves(self.scene, self.names)
        self.first = [float(x) for x in first]
        self.done = REF_STEPS
        self.row0, self.rows = S.band(self.cfg)

    def _mark(self, which: str) -> None:
        self.marks[which] = sc.leaves(self.scene, self.names)

    def window(self) -> dict:
        c, tr = self.ctx, self.ctx.traffic
        every = tr["log_every"]
        pending, steps, bad = [], 0, 0
        done_key = f"raybench.done.{c.seed}.{c.control}.{c.fault}"
        last_key = f"raybench.last.{c.seed}.{c.control}.{c.fault}"
        said, last = False, None
        self.tracer.begin(c.seconds)
        t0 = time.perf_counter()
        while last is None or steps < last:
            with span(c.trace, "raybench.bandfit.step"):
                pending.append(self.step(self.target))
            self.done += 1
            steps += 1
            if self.done % every == 0:
                with span(c.trace, "raybench.bandfit.loss_readback"):
                    losses = torch.cat([x.reshape(1) for x in pending]).tolist()
                pending.clear()
                bad += sum(1 for x in losses if not x == x or abs(x) == float("inf"))
                self.tracer.tick(steps)
                if last is not None:
                    continue
                with span(c.trace, "raybench.bandfit.agree"):
                    if not said and (time.perf_counter() - t0 >= c.seconds
                                     and not self.tracer.open()):
                        c.store.add(done_key, 1)
                        said = True
                    if c.rank == 0:
                        if said and c.store.add(done_key, 0) == c.world:
                            last = steps + 2 * every
                            c.store.set(last_key, str(last))
                    elif c.store.check([last_key]):
                        last = int(c.store.get(last_key))
        c.sync()
        dt = time.perf_counter() - t0
        self.attempted, self.failed = steps, bad
        return {"fwd_bwd_rays_per_s": steps * self.cfg.height * self.cfg.width / dt}

    def work(self) -> dict:
        """Least seconds of this rank's band's forward and backward kernels
        per step: the reference's march of the band at the stretch's start
        and end, averaged."""
        spec = sc.render_spec(self.ctx.render)
        least = []
        for which in ("start", "end"):
            values = {**self.start, **sc.host_values(self.marks[which])}
            t = ref.trace(sc.ref_scene(values, self.ctx.device), spec, self.row0, self.rows)
            least.append(roofline.trace_least(spec.num_octaves, spec.newton_iters, t))
        return {k: sum(x[k] for x in least) / 2 for k in ("fwd", "bwd")}

    def release(self) -> None:
        self.final = torch.cat([p.reshape(-1) for p in
                                sc.leaves(self.scene, self.names).values()])
        self.step.close()
        self.step = self.opt = self.scene = self.target = None
        for obj, attr, old in self._undo:
            setattr(obj, attr, old)
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list:
        c = self.ctx
        parts = [torch.empty_like(self.final) for _ in range(c.world)]
        dist.all_gather(parts, self.final)
        if c.rank != 0:
            return []
        spread = max(float((p - parts[0]).abs().max()) for p in parts)
        spec, block = sc.render_spec(c.render), c.traffic["ref_block_rows"]
        target = ref.frame(sc.ref_scene(c.scene_values, c.device), spec, block)
        want = ref.fit(sc.ref_scene(self.start, c.device), spec, target, self.names,
                       c.traffic["lr"], REF_STEPS, block)
        gaps = compare.train_gaps(
            {"losses": self.first, "grad": self.grad1,
             "change": {n: self.after[n] - self.start_leaves[n] for n in self.names}}, want)
        self.details = gaps.pop("details")
        gaps["rank_param_diff"] = spread
        return core.judge(gaps, c.cell.limits["limits"])
