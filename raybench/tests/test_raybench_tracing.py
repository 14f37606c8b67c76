"""The reduction of a traced stretch: idle share as the union of device
intervals, idle gaps labelled by host span, the 95th percentile over all
frames, the sample of frames."""

from __future__ import annotations

import json

import pytest

from raybench import core
from raybench.tracing import STRETCH, Profile, breakdown, idle_gaps, load_profile, short_name, union


def test_union_merges_overlaps_and_clips():
    ops = [("a", 0.0, 2.0), ("nccl", 1.0, 2.0), ("b", 5.0, 1.0), ("c", 9.5, 2.0)]
    assert union(ops, (0.5, 10.0)) == [(0.5, 3.0), (5.0, 6.0), (9.5, 10.0)]


def test_idle_share_is_not_the_sum_of_overlapping_kernels():
    # Two streams busy over the same second: busy 1 s of 2, not 2 s of 2.
    p = Profile([("k1", 0.0, 1.0), ("k2", 0.0, 1.0)], [], (0.0, 2.0), 1)
    assert p.busy_s() == pytest.approx(1.0)


def test_idle_gaps_take_the_innermost_host_span():
    spans = [("raybench.fit.chunk", 0.0, 4.0), ("raybench.fit.loss_readback", 2.5, 3.5)]
    ops = [("k", 0.0, 1.0), ("k", 2.0, 0.5), ("k", 3.8, 0.2)]
    gaps = idle_gaps(ops, spans, (0.0, 5.0))
    assert gaps == [("raybench.fit.chunk", pytest.approx(1.0)),
                    ("raybench.fit.loss_readback", pytest.approx(1.3)),
                    ("no span", pytest.approx(1.0))]


def test_load_profile_keeps_the_stretch_only(tmp_path):
    ev = [{"ph": "X", "cat": "user_annotation", "name": STRETCH, "ts": 100.0, "dur": 1000.0},
          {"ph": "X", "cat": "kernel", "name": "void trace_fwd_kernel<0>(float*)", "ts": 50.0,
           "dur": 10.0},
          {"ph": "X", "cat": "kernel", "name": "void trace_fwd_kernel<0>(float*)", "ts": 200.0,
           "dur": 300.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)",
           "ts": 600.0, "dur": 100.0},
          {"ph": "X", "cat": "user_annotation", "name": "raybench.fly.batch", "ts": 150.0,
           "dur": 800.0}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    p = load_profile(str(path), 2, {"fwd": 1e-4})
    assert [o[0] for o in p.ops] == ["void trace_fwd_kernel<0>(float*)",
                                     "Memcpy DtoH (Device -> Pinned)"]
    assert p.window_s == pytest.approx(1e-3) and p.busy_s() == pytest.approx(4e-4)
    bd = breakdown([p])
    assert bd["device_ops"][0] == ["trace_fwd_kernel<0>", pytest.approx(3e-4)]
    assert bd["idle_gaps"][0][0] == "raybench.fly.batch"


def test_short_name_keeps_templates_and_drops_arguments():
    assert short_name("void (anonymous namespace)::k<1, (x)2>(int, float*)") == "k<1, (x)2>"


def test_p95_is_the_nearest_rank_over_all_frames():
    assert core.p95(range(1, 101)) == 95
    assert core.p95([5.0]) == 5.0
    assert core.p95(list(range(1, 21))) == 19


def test_reservoir_is_uniform_and_seeded():
    counts = [0] * 10
    for seed in range(2000):
        r = core.Reservoir(2, seed)
        for i in range(10):
            r.offer(i)
        for i in r.items:
            counts[i] += 1
    assert min(counts) > 300 and max(counts) < 500
    a, b = core.Reservoir(3, 7), core.Reservoir(3, 7)
    for i in range(50):
        a.offer(i)
        b.offer(i)
    assert a.items == b.items


def test_idle_reader_is_one_minus_the_union():
    reader = core.load_module(core.PKG / "metrics" / "device_idle_pct.train.py")
    p = Profile([("k1", 0.0, 1.0), ("k2", 0.5, 1.0)], [], (0.0, 3.0), 1)
    assert reader.read([p, p]) == pytest.approx(50.0)
    assert reader.read([Profile([], [], (0.0, 1.0), 1)]) is None


def test_allreduce_reader_takes_the_step_all_reduces_of_the_slowest_rank():
    reader = core.load_module(core.PKG / "metrics" / "allreduce_ms_per_step.py")
    imbalance = core.load_module(core.PKG / "metrics" / "band_imbalance.py")
    f32 = "ncclDevKernel_AllReduce_Sum_f32_RING_LL"
    # The fast band waits 3 ms a step in the all-reduce; the slow one 0.5 ms. A
    # u32 all-reduce that is not the step's own is left out.
    fast = Profile([("trace_fwd_kernel", 0.0, 2e-3), (f32, 2e-3, 3e-3),
                    ("ncclDevKernel_AllReduce_Sum_u32_RING_LL", 6e-3, 1e-3)],
                   [], (0.0, 0.01), 1)
    slow = Profile([("trace_fwd_kernel", 0.0, 4.5e-3), (f32, 4.5e-3, 0.5e-3)],
                   [], (0.0, 0.01), 1)
    assert reader.read([fast, slow]) == pytest.approx(0.5)
    assert imbalance.read([fast, slow]) == pytest.approx(2.25)
    assert reader.read([Profile([("trace_fwd_kernel", 0.0, 1.0)], [], (0.0, 1.0), 1)]) is None
