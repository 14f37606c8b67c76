"""The flythrough (``ops/flythrough.py``) as ``fly_frames`` drives it: one
``FlyBatch`` of ``batch`` frames (on the card one CUDA graph), every batch's
frames to the host (pinned), frame i at time (i0 + i) / fps with i0 drawn
from the seed, and a live edit of the scene every ``edit_every`` batches:
the fBm amplitudes scaled by 1 + ``edit_rel``·U(-1, 1), drawn from the
seed, handed to the next batch as ``fly_frames``' ``on_batch`` hands a tweak.

The latency of a frame is its batch's, from the call to its pixels on the
host. After the window the reference renders a sample of the delivered
frames, drawn from the seed, from their times and scenes.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from raybench import compare, core, roofline, scene as sc
from raybench.reference import terrain as ref
from raybench.tracing import Tracer, span


class Run:
    def __init__(self, ctx: core.Context):
        self.ctx = ctx
        self.attempted = self.failed = 0
        self.tracer = Tracer(ctx.trace, ctx.trace_path, on_mark=self._mark)
        self.marks = {}

    def setup(self) -> None:
        from gpgpuraytrace_tpu_torch.ops.flythrough import FlyBatch

        c, tr = self.ctx, self.ctx.traffic
        self.cfg = sc.render_config(c.render, march_bf16=c.control)
        self.scene = sc.port_scene(c.scene_values, c.device)
        self.base_amps = np.asarray(c.scene_values["noise.amplitudes"], np.float32)
        self.amps = self.base_amps
        self.rng = np.random.default_rng(c.seed)
        self.i0 = int(self.rng.integers(0, tr["start_frames"]))
        self.B = tr["batch"]
        self.prog = FlyBatch(self.scene, self.cfg, self.B)
        self.b = 0
        self.last = None
        self.sample = core.Reservoir(tr["sample_frames"], c.seed)
        with c.phase("the first batch (eager)"):
            self._batch()
        with c.phase("the second batch (capture, replay)"):
            self._batch()

    def _times(self, b: int) -> torch.Tensor:
        start = self.i0 + b * self.B
        return torch.arange(start, start + self.B, dtype=torch.float32) / self.ctx.traffic["fps"]

    def _batch(self):
        tr = self.ctx.traffic
        if self.b % tr["edit_every"] == 0:
            self.amps = (self.base_amps * (1.0 + tr["edit_rel"] * self.rng.uniform(
                -1.0, 1.0, self.base_amps.shape))).astype(np.float32)
            with torch.no_grad():
                self.scene.noise.amplitudes.copy_(torch.from_numpy(self.amps))
        times = self._times(self.b)
        self.last = (times, self.amps)
        host = self.prog.host_frames(self.scene, times, self.B)
        if self.ctx.fault == "altered":
            host[:, :64, :64] = 255 - host[:, :64, :64]
        self.b += 1
        return times, host

    def _mark(self, which: str) -> None:
        self.marks[which] = self.last

    def window(self) -> dict:
        c = self.ctx
        lat, frames, batches = [], 0, 0
        self.tracer.begin(c.seconds)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < c.seconds or self.tracer.open():
            t_req = time.perf_counter()
            with span(c.trace, "raybench.fly.batch"):
                times, host = self._batch()
            ms = 1e3 * (time.perf_counter() - t_req)
            lat += [ms] * self.B
            for k in range(self.B):
                self.sample.offer((host[k], float(times[k]), self.amps))
            frames += self.B
            batches += 1
            self.tracer.tick(batches)
        c.sync()
        dt = time.perf_counter() - t0
        self.attempted = frames
        return {"frames_per_s": frames / dt, "frame_ms_p95": core.p95(lat)}

    def _ref_scene(self, time_s: float, amps):
        values = {**self.ctx.scene_values, "noise.amplitudes": amps}
        return ref.flythrough_camera(sc.ref_scene(values, self.ctx.device),
                                     torch.tensor(time_s, dtype=torch.float32,
                                                  device=self.ctx.device))

    def work(self) -> dict:
        """Least seconds per batch of the forward and of tonemap-and-quantize
        on the profiled inputs: the reference's march of the last frame before
        the stretch and the stretch's last frame, averaged, times the batch."""
        spec = sc.render_spec(self.ctx.render)
        least = []
        for which in ("start", "end"):
            times, amps = self.marks[which]
            t = ref.trace(self._ref_scene(float(times[-1]), amps), spec)
            least.append(roofline.trace_least(spec.num_octaves, spec.newton_iters, t))
        pixels = spec.height * spec.width * self.B
        return {"fwd": self.B * sum(x["fwd"] for x in least) / 2,
                "fwd_by": least[0]["fwd_by"],
                "quantize": roofline.quantize_least(pixels)[0], "quantize_by": "bytes"}

    def release(self) -> None:
        self.prog = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list:
        spec = sc.render_spec(self.ctx.render)
        prog, want = [], []
        for frame, time_s, amps in self.sample.items:
            tr = ref.trace(self._ref_scene(time_s, amps), spec)
            want.append(ref.quantize(tr.color).cpu())
            prog.append(torch.from_numpy(np.array(frame)))
        return core.judge(compare.frame_gaps(prog, want), self.ctx.cell.limits["limits"])
