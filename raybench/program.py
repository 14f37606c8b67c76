"""The port's own spans (``gpgpuraytrace_tpu_torch/utils/profiling.py:span``)
in a rank's exported trace, with the graph launches and the device
operations that carry their correlation ids, for the readers of
``metrics/`` whose source is ``program_span``.

``tracing.py:load_profile`` keeps only the benchmark's own spans, so these
readers open the trace again: the file ``build/raybench/trace-*-rank*.json``
whose stretch is the ``Profile``'s. A program without the port's spans (a
commit before them) gives ``None`` from every reader here, never 0.

A replay is a ``graph.replay`` span that starts in the stretch and the
``cudaGraphLaunch`` inside it; its operations are the device operations
with that launch's correlation id, and its extent runs from the first of
them to the end of the last.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

from raybench import core
from raybench.tracing import DEVICE_CATS, STRETCH, union

PREFIX = "gpgpuraytrace_tpu_torch."
REPLAY = PREFIX + "graph.replay"
FLY_BATCH = PREFIX + "fly.batch"
FLY_WAIT = PREFIX + "fly.wait"
# Seconds an event may pass its span's edge and still lie inside it: the
# trace's microseconds, turned into seconds, round apart by an ulp.
EDGE_S = 1e-9


@dataclasses.dataclass
class PortTrace:
    """One rank's stretch, seconds on the trace's clock: the port's spans
    (name, start, end, thread), the graph launches (start, end, correlation
    id), the device operations that start from the stretch's start on (name,
    start, duration, correlation id or None), the stretch and its units."""

    spans: list
    launches: list
    ops: list
    stretch: tuple
    units: int

    def replays(self) -> list:
        """Each replay launched in the stretch, as the list of its device
        operations (name, start, duration), which may start after the
        stretch's end; a replay whose launch the trace lacks is left out."""
        lo, hi = self.stretch
        by_id: dict = {}
        for name, start, dur, corr in self.ops:
            if corr is not None:
                by_id.setdefault(corr, []).append((name, start, dur))
        out = []
        for name, a, b, _ in self.spans:
            if name != REPLAY or not lo <= a < hi:
                continue
            inside = [c for s, e, c in self.launches if within(s, e, a, b)]
            if inside:
                out.append(by_id.get(inside[0], []))
        return out


def within(s: float, e: float, a: float, b: float) -> bool:
    """Whether (s, e) lies inside (a, b)."""
    return a - EDGE_S <= s and e <= b + EDGE_S


def trace_dir() -> Path:
    return core.root() / "build" / "raybench"


def stretch_of(events: list):
    """The stretch (start, end) in seconds, as ``load_profile`` reads it."""
    for e in events:
        if (e.get("name") == STRETCH and e.get("ph") == "X"
                and e.get("cat") in ("user_annotation", "cpu_op")):
            s0 = e["ts"] * 1e-6
            return s0, s0 + e["dur"] * 1e-6
    return None


def find_events(profile, directory: Path | None = None, rank: int = 0) -> list | None:
    """The events of the trace whose stretch is ``profile``'s, or None. The
    files of ``rank`` are read first, the newest first: a trace of a large
    stretch takes seconds to read."""
    files = sorted((directory or trace_dir()).glob("trace-*-rank*.json"),
                   key=lambda f: (not f.name.endswith(f"-rank{rank}.json"),
                                  -f.stat().st_mtime))
    want = tuple(profile.stretch)
    for f in files:
        with open(f) as fh:
            events = json.load(fh)["traceEvents"]
        got = stretch_of(events)
        if got and all(math.isclose(x, y, rel_tol=0, abs_tol=1e-7) for x, y in zip(got, want)):
            return events
    return None


def port_trace(profile, directory: Path | None = None, rank: int = 0) -> PortTrace | None:
    """The port's spans, launches and device operations of ``profile``'s
    stretch (rank ``rank``'s); None where its trace is not found or holds
    none of the port's spans."""
    events = find_events(profile, directory, rank)
    if events is None:
        return None
    lo, hi = profile.stretch
    spans, launches, ops = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat"), e.get("name", "")
        start, dur = e["ts"] * 1e-6, e.get("dur", 0) * 1e-6
        args = e.get("args") or {}
        if cat == "user_annotation" and name.startswith(PREFIX):
            spans.append((name, start, start + dur, e.get("tid")))
        elif cat == "cuda_runtime" and name.startswith("cudaGraphLaunch"):
            launches.append((start, start + dur, args.get("correlation")))
        elif cat in DEVICE_CATS and start >= lo:
            ops.append((name, start, dur, args.get("correlation")))
    if not spans:
        return None
    return PortTrace(spans, launches, ops, (lo, hi), profile.units)


def port_traces(profiles, directory: Path | None = None) -> list | None:
    """Every rank's ``PortTrace`` (``profiles`` in rank order), or None where
    any rank's is missing."""
    out = [port_trace(p, directory, rank) for rank, p in enumerate(profiles)]
    return None if any(t is None for t in out) else out


def graph_gap_pct(profiles, directory: Path | None = None) -> float | None:
    """The card's idle time (no device operation of any kind running) inside
    the extents of the replays launched in the stretch, clipped to it, as a
    share of the stretch, the mean over the ranks. At most the idle share
    (``readers.py:idle_pct``), which counts the same operations."""
    traces = port_traces(profiles, directory)
    if traces is None:
        return None
    shares = []
    for t in traces:
        lo, hi = t.stretch
        extents = [(min(o[1] for o in ops), max(o[1] + o[2] for o in ops))
                   for ops in t.replays() if ops]
        if not extents:
            return None
        spans = union([("replay", a, b - a) for a, b in extents], t.stretch)
        busy = union([(n, s, d) for n, s, d, _ in t.ops if s < hi], t.stretch)
        idle = sum(b - a - overlap(a, b, busy) for a, b in spans)
        shares.append(100.0 * idle / (hi - lo))
    return sum(shares) / len(shares)


def overlap(a: float, b: float, intervals: list) -> float:
    """The length of (a, b) that the disjoint ``intervals`` cover."""
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in intervals)


def ops_per_step(profiles, directory: Path | None = None) -> float | None:
    """The device operations of the replays launched in the stretch over the
    units (steps) the stretch counted, the mean over the ranks."""
    traces = port_traces(profiles, directory)
    if traces is None:
        return None
    per = []
    for t in traces:
        n = sum(len(ops) for ops in t.replays())
        if not n or not t.units:
            return None
        per.append(n / t.units)
    return sum(per) / len(per)


def fly_host_ms_per_batch(profiles, directory: Path | None = None) -> float | None:
    """The port's own host time per fly batch: over the ``fly.batch`` spans
    that start in rank 0's stretch, the mean of the span's duration less its
    ``fly.wait`` (the host waiting for the frames), in ms."""
    t = port_trace(profiles[0], directory)
    if t is None:
        return None
    lo, hi = t.stretch
    waits = [s for s in t.spans if s[0] == FLY_WAIT]
    own = []
    for name, a, b, tid in t.spans:
        if name != FLY_BATCH or not lo <= a < hi:
            continue
        waited = sum(e - s for _, s, e, w in waits if w == tid and within(s, e, a, b))
        own.append(b - a - waited)
    if not own:
        return None
    return 1e3 * sum(own) / len(own)
