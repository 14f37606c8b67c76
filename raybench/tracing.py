"""The traced run: host spans from the benchmark's own code around each call
into a layer of the port, a ``torch.profiler`` trace of a bounded steady
stretch of the window, and its reduction to what the per-layer readers
need (device operations, idle share, idle gaps labelled by host span).

The stretch starts and ends at a point where the host has just waited for
the device (a loss read-back, a frame on the host), so every operation
launched inside it runs inside it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STRETCH = "raybench.stretch"


def span(on: bool, name: str):
    """A host span named ``name`` in the trace when ``on``; nothing else."""
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


class Tracer:
    """Profiles one stretch of the window when enabled: the profiler starts
    at the first sync point after ``start_after`` of the window, the stretch
    begins ``skip`` sync points later and ends at the first sync point
    ``stretch_s`` after it. The mix calls ``tick(units)`` at each sync point
    with the units (steps, batches, frames) done so far; ``on_mark(which)``,
    when given, runs at the stretch's start and end."""

    def __init__(self, enabled: bool, out_path: str, start_after: float = 0.3,
                 stretch_s: float = 0.4, skip: int = 3, on_mark=None):
        self.enabled = enabled
        self.out_path = out_path
        self.start_after = start_after
        self.stretch_s = stretch_s
        self.skip = skip
        self.on_mark = on_mark
        self.prof = None
        self.state = "idle"
        self.units = None
        self._rf = None
        self._t = 0.0
        self._skipped = 0
        self._u0 = 0

    def open(self) -> bool:
        """Whether a stretch is still to be traced: the window runs on until
        it closes."""
        return self.enabled and self.state != "done"

    def begin(self, seconds: float) -> None:
        """The window starts now and lasts ``seconds``."""
        self._t0 = time.perf_counter()
        self._seconds = seconds

    def tick(self, units: int) -> None:
        if not self.enabled or self.state == "done":
            return
        now = time.perf_counter()
        if self.state == "idle" and now - self._t0 >= self.start_after * self._seconds:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
            self.state = "warm"
        elif self.state == "warm":
            self._skipped += 1
            if self._skipped >= self.skip:
                if self.on_mark:
                    self.on_mark("start")
                self._rf = torch.profiler.record_function(STRETCH)
                self._rf.__enter__()
                self._t, self._u0 = now, units
                self.state = "on"
        elif self.state == "on" and now - self._t >= self.stretch_s:
            self._rf.__exit__(None, None, None)
            self.units = units - self._u0
            self.prof.stop()
            if self.on_mark:
                self.on_mark("end")
            self.state = "done"

    def export(self) -> str:
        """Write the trace (after the window) and return its path."""
        if self.state != "done":
            raise RuntimeError(f"the traced stretch never closed (state {self.state}): "
                               f"the window is too short for it")
        os.makedirs(os.path.dirname(self.out_path), exist_ok=True)
        self.prof.export_chrome_trace(self.out_path)
        self.prof = None
        return self.out_path


@dataclasses.dataclass
class Profile:
    """One rank's stretch, seconds on the trace's clock: device operations
    (name, start, duration), host spans (name, start, end), the stretch's
    (start, end), the units done in it, and the mix's work per unit."""

    ops: list
    spans: list
    stretch: tuple
    units: int
    work: dict = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.stretch[1] - self.stretch[0]

    def ops_matching(self, *needles, exclude=()) -> list:
        return [o for o in self.ops
                if any(n in o[0] for n in needles) and not any(x in o[0] for x in exclude)]

    def device_s(self, *needles, exclude=()) -> float:
        return sum(o[2] for o in self.ops_matching(*needles, exclude=exclude))

    def busy_s(self) -> float:
        return sum(b - a for a, b in union(self.ops, self.stretch))

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def union(ops, stretch) -> list:
    """The union of the operations' intervals, clipped to ``stretch``: sorted,
    disjoint (start, end) pairs."""
    lo, hi = stretch
    out = []
    for _, start, dur in sorted(ops, key=lambda o: o[1]):
        a, b = max(start, lo), min(start + dur, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def idle_gaps(ops, spans, stretch) -> list:
    """Each idle stretch of the device within ``stretch`` as (label,
    seconds), the label the innermost host span open at the gap's start."""
    busy = union(ops, stretch)
    edges = [stretch[0]] + [x for ab in busy for x in ab] + [stretch[1]]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b - a <= 0:
            continue
        open_ = [s for s in spans if s[1] <= a < s[2] and s[0] != STRETCH]
        label = min(open_, key=lambda s: s[2] - s[1])[0] if open_ else "no span"
        gaps.append((label, b - a))
    return gaps


def load_profile(path: str, units: int, work: dict, span_prefix: str = "raybench") -> Profile:
    """Reduce a Chrome trace to the stretch's ``Profile``."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    marks = [e for e in events if e.get("name") == STRETCH and e.get("ph") == "X"
             and e.get("cat") in ("user_annotation", "cpu_op")]
    if not marks:
        raise RuntimeError(f"{path}: no '{STRETCH}' span")
    s0 = marks[0]["ts"] * 1e-6
    stretch = (s0, s0 + marks[0]["dur"] * 1e-6)
    ops, spans = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        start, dur = e["ts"] * 1e-6, e.get("dur", 0) * 1e-6
        if cat in DEVICE_CATS and stretch[0] <= start < stretch[1]:
            ops.append((e["name"], start, dur))
        elif cat == "user_annotation" and e["name"].startswith(span_prefix):
            spans.append((e["name"], start, start + dur))
    return Profile(ops, spans, stretch, units, work)


def breakdown(profiles: list) -> dict:
    """The ten device operations that took most time and the ten host spans
    under which the device idled longest, summed over ranks (seconds)."""
    by_op: dict = {}
    by_gap: dict = {}
    for p in profiles:
        for name, _, dur in p.ops:
            key = short_name(name)
            by_op[key] = by_op.get(key, 0.0) + dur
        for label, s in idle_gaps(p.ops, p.spans, p.stretch):
            by_gap[label] = by_gap.get(label, 0.0) + s
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}


def short_name(name: str) -> str:
    """A kernel's name without its argument list, at most 120 characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            name = name[:i]
            break
    return name[:120]
