"""The readers of the port's spans (raybench/program.py) on synthetic Chrome
traces: graph gaps are idle time inside a replay's extent only, and at most
the idle share; operations per step count only a stretch's replays; the fly
batch's host time leaves out its wait; every reader gives None on a trace
without the port's spans; the rank's file is the one whose stretch matches."""

from __future__ import annotations

import json
import os

import pytest

from raybench import core, program
from raybench.readers import idle_pct
from raybench.tracing import STRETCH, load_profile

P = program.PREFIX
READERS = ("graph_gap_pct.train", "graph_gap_pct.frames", "ops_per_step",
           "fly_host_ms_per_batch")


def span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1}


def launch(ts, dur, corr, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": {"correlation": corr}}


def kernel(ts, dur, corr=None, name="k", cat="kernel"):
    args = {} if corr is None else {"correlation": corr}
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 7, "pid": 0,
            "args": args}


def write(directory, name, events, stretch=(1000.0, 1000.0)):
    """A rank's trace file with its stretch (start, length in us); returns its
    Profile as the harness loads it."""
    path = directory / f"trace-{name}.json"
    events = [span(STRETCH, *stretch)] + events
    path.write_text(json.dumps({"traceEvents": events}))
    return load_profile(str(path), 2, {})


def fit_trace():
    """Stretch 1000-2000 us. A replay launched before it (corr 6), two in it
    (corr 7, 8), the raybench chunk spans around them, an operation of no
    replay inside replay 7's extent, idle between the replays."""
    return [
        span("raybench.fit.chunk", 900, 20), span(P + "graph.replay", 905, 10),
        launch(906, 5, 6), kernel(950, 40, 6),
        span("raybench.fit.chunk", 1100, 20), span(P + "graph.replay", 1105, 10),
        launch(1106, 6, 7),
        kernel(1120, 80, 7), kernel(1250, 50, 7), kernel(1210, 10, name="cat"),
        span(P + "graph.replay", 1500, 10), launch(1502, 5, 8),
        kernel(1520, 80, 8), kernel(1610, 90, 8, cat="gpu_memset"),
        kernel(1800, 10, name="Memcpy DtoH", cat="gpu_memcpy"),
    ]


def test_graph_gaps_are_idle_inside_replays_only(tmp_path):
    p = write(tmp_path, "fit512-rank0", fit_trace())
    # Replay 7's extent 1120-1300 idles 1200-1210 and 1220-1250; replay 8's
    # 1520-1700 idles 1600-1610; the rest of the stretch's idle lies between.
    gap = program.graph_gap_pct([p], tmp_path)
    assert gap == pytest.approx(100.0 * 50 / 1000)
    assert gap <= idle_pct([p])
    assert idle_pct([p]) == pytest.approx(100.0 - 100.0 * 320 / 1000)
    q = write(tmp_path, "fit4k.x4-rank1", fit_trace()[:-4], stretch=(1000.0, 500.0))
    assert program.graph_gap_pct([p, q], tmp_path) == pytest.approx((5.0 + 40 / 5) / 2)


def test_ops_per_step_counts_the_stretchs_replays_only(tmp_path):
    p = write(tmp_path, "fit512-rank0", fit_trace())
    # Replays 7 and 8: two operations each, over the stretch's 2 steps; the
    # replay before the stretch, the cat and the copy are left out.
    assert program.ops_per_step([p], tmp_path) == pytest.approx(2.0)


def test_fly_host_time_leaves_out_the_wait(tmp_path):
    events = [span(P + "fly.batch", 900, 500), span(P + "fly.wait", 1000, 300)]
    for t0, wait in ((1100, 200), (1600, 300)):
        events += [span("raybench.fly.batch", t0 - 5, 410), span(P + "fly.batch", t0, 400),
                   span(P + "fly.load", t0 + 10, 50), span(P + "fly.to_host", t0 + 100, 50),
                   span(P + "fly.wait", t0 + 400 - wait, wait),
                   span(P + "fly.wait", t0 + 400 - wait, wait, tid=2)]
    p = write(tmp_path, "fly1080-rank0", events)
    # Batches in the stretch: 400 us less waits of 200 and 300 us; the batch
    # before the stretch and another thread's spans are left out.
    assert program.fly_host_ms_per_batch([p], tmp_path) == pytest.approx(0.15)


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_the_ports_spans(tmp_path, monkeypatch, name):
    monkeypatch.setattr(program, "trace_dir", lambda: tmp_path)
    reader = core.load_module(core.PKG / "metrics" / f"{name}.py")
    parent = [e for e in fit_trace() if not e["name"].startswith(P)]
    parent += [span("raybench.fly.batch", 1100, 500), launch(1700, 5, 9), kernel(1710, 5, 9)]
    p = write(tmp_path, "fit512-rank0", parent)
    assert reader.read([p]) is None
    assert reader.read([write(tmp_path, "fit512-rank1", [])]) is None
    missing = load_profile(str(tmp_path / "trace-fit512-rank0.json"), 2, {})
    missing.stretch = (0.5, 0.6)
    assert reader.read([missing]) is None


def test_graph_readers_give_none_where_no_operation_carries_the_launch(tmp_path):
    events = [e for e in fit_trace() if e["cat"] != "cuda_runtime"]
    events.append(launch(1106, 6, None))
    p = write(tmp_path, "fit512-rank0", events)
    assert program.graph_gap_pct([p], tmp_path) is None
    assert program.ops_per_step([p], tmp_path) is None


def test_the_rank_file_is_the_one_whose_stretch_matches(tmp_path):
    profiles = {}
    for i, name in enumerate(("fit512-rank0", "fit4k.x4-rank0", "fit4k.x4-rank1")):
        profiles[name] = write(tmp_path, name, [span(P + name, 1001, 1)],
                               stretch=(1000.0 + 0.25 * i, 1000.0))
        os.utime(tmp_path / f"trace-{name}.json", (1e9 - i, 1e9 - i))
    for name, p in profiles.items():
        for rank in (0, 1):
            t = program.port_trace(p, tmp_path, rank)
            assert [s[0] for s in t.spans] == [P + name]
