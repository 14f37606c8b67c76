"""The frozen roofline arithmetic gives chip_smoke.py's bounds for the same
work, and the readers turn a traced stretch into shares."""

from __future__ import annotations

import importlib.util
import types

import pytest

from raybench import core, roofline
from raybench.tracing import Profile


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_test",
                                                  core.root() / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("steps, hits, pixels", [
    (5.2446 * 262144, 150000, 262144), (1e6, 0, 4224), (8.1e6, 2.1e6, 2073600)])
def test_forward_bound_equals_chip_smoke(smoke, steps, hits, pixels):
    cfg = types.SimpleNamespace(march_bf16=False, volumetric=False, num_octaves=6,
                                newton_iters=3, prime_ds=8, warp_octaves=2)
    want_ms, want_by = smoke.fwd_bound(cfg, steps, hits, pixels)
    got_s, got_by = roofline.fwd_least(6, 3, True, steps, hits, pixels)
    assert 1e3 * got_s == pytest.approx(want_ms, rel=1e-12) and got_by == want_by


@pytest.mark.parametrize("hits, pixels", [(150000, 262144), (0, 262144), (5943464, 8294400)])
def test_backward_bound_equals_chip_smoke(smoke, hits, pixels):
    cfg = types.SimpleNamespace(march_bf16=False, volumetric=False, num_octaves=6)
    want_ms, want_by = smoke.bwd_bound(cfg, hits, pixels)
    got_s, got_by = roofline.bwd_least(6, hits, pixels)
    assert 1e3 * got_s == pytest.approx(want_ms, rel=1e-12) and got_by == want_by


def test_quantize_bound_is_bytes():
    s, by = roofline.quantize_least(1920 * 1080 * 4)
    assert by == "bytes" and 1e3 * s == pytest.approx(0.0371, abs=1e-4)


def test_peaks_are_the_published_ones(smoke):
    assert roofline.PEAK_OPS_PER_S == smoke.PEAK_OPS_PER_S
    assert roofline.HBM_BYTES_PER_S == smoke.HBM_BYTES_PER_S
    for k, v in roofline.OPS.items():
        assert smoke.OPS[k] == v


def test_roofline_readers():
    fwd = core.load_module(core.PKG / "metrics" / "fwd_roofline_pct.train.py")
    bwd = core.load_module(core.PKG / "metrics" / "bwd_roofline_pct.py")
    ops = [("void trace_fwd_kernel<0, 6>(a)", 0.0, 4e-4), ("void trace_bwd_kernel<0>(a)",
                                                          1e-3, 1e-4),
           ("void trace_bwd_sum(a)", 2e-3, 1e-4)]
    p = Profile(ops, [], (0.0, 1e-2), 4, {"fwd": 2e-5, "bwd": 1e-5})
    assert fwd.read([p]) == pytest.approx(20.0)
    assert bwd.read([p]) == pytest.approx(20.0)
    assert fwd.read([Profile([], [], (0.0, 1.0), 4, {"fwd": 1.0})]) is None
