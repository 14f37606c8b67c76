"""The volumetric cell ``fit512.vol``: its plain reference (``raybench/reference/volumetric.py``) against
the port's plain path on the CPU, its roofline counts against
``chip_smoke.py``'s, its ``march_step_ratio`` count and reader, and what
decides its ``correct``: a sound toy run
passes, the control (``march_bf16``) and each planted fault fail. One case runs the control at the cell's own size on the
card (``-m cuda``, with ``--noconftest``).

The toy runs trace 2 octaves of the heightfield under the 2-octave warp at
16x16, and the reference's side of their comparison (its target and its
three steps from the seed's start, the same whatever the port runs) is
computed once, so that all six take seconds; the comparisons at 48x64 keep
the cell's 6 octaves.
"""

from __future__ import annotations

import ast
import importlib.util
import types

import numpy as np
import pytest
import torch

from raybench import core, roofline_volumetric as rv, scene as sc
from raybench.reference import volumetric as ref

CONFIG = core.read_json(core.root() / "raybench/configs/terrain6-vol-512.json")
VALUES = CONFIG["scene"]
RENDER = {**CONFIG["render"], "height": 48, "width": 64, "max_steps": 64}
CELL = "fit512.vol"
TOY = {"render": {"height": 16, "width": 16, "max_steps": 16, "num_octaves": 2},
       "traffic": {"steps_per_call": 3, "log_every": 3}}
TOY_VALUES = {**VALUES, "noise.amplitudes": VALUES["noise.amplitudes"][:2]}
FAULTS = ["unchanged", "half_batch", "no_warp", "warp_grad_dropped"]


def spec(render: dict) -> ref.RenderSpec:
    return core.load_module(core.PKG / "drivers" / "fitvol.py").render_spec(render)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def whole():
    """The reference's trace of the 48x64 frame."""
    return ref.trace(sc.ref_scene(VALUES, "cpu"), spec(RENDER))


@pytest.fixture(scope="module")
def smoke():
    path = core.root() / "chip_smoke.py"
    loader = importlib.util.spec_from_file_location("chip_smoke_for_vol_test", path)
    mod = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(mod)
    return mod


# --- the reference against the port's plain path ----------------------------


def test_volumetric_reference_frame_matches_the_port_plain_path(whole):
    from gpgpuraytrace_tpu_torch.kernels.trace import render_kernel_raw

    color, _, hit = render_kernel_raw(sc.port_scene(VALUES, "cpu"), sc.render_config(RENDER))
    tr = whole
    assert (tr.hit == hit).float().mean() > 0.999
    assert (tr.color - color).abs().mean() < 1e-5
    assert (tr.color - color).abs().le(2e-3).float().mean() > 0.999
    assert tr.steps > tr.pixels and 0 < tr.hits < tr.pixels
    assert tr.coarse_pixels == (48 // 8 + 2) * (64 // 8)


def test_volumetric_reference_bands_make_the_frame(whole):
    s = spec(RENDER)
    parts = [ref.trace(sc.ref_scene(VALUES, "cpu"), s, r0, 24) for r0 in (0, 24)]
    assert torch.equal(torch.cat([p.color for p in parts]), whole.color)
    assert sum(p.steps for p in parts) == whole.steps


def test_volumetric_reference_gradient_matches_the_port_plain_path():
    from gpgpuraytrace_tpu_torch.ops import fit as F
    from gpgpuraytrace_tpu_torch.ops.render import render

    drv = core.load_module(core.PKG / "drivers" / "fitvol.py")
    cfg, s = sc.render_config(RENDER), spec(RENDER)
    with torch.no_grad():
        target = render(sc.port_scene(VALUES, "cpu"), cfg)
    start = drv.perturbed(VALUES, 5, 0.15)
    assert start["noise.warp_amplitude"] != VALUES["noise.warp_amplitude"]
    scene = sc.port_scene(start, "cpu")
    prefixes = tuple(core.load_cell(CELL).traffic["trainable"])
    params = F.partition_scene(scene, lambda n: n.startswith(prefixes))
    F.pixel_loss(scene, cfg, target).backward()
    names = [n for n, p in scene.named_parameters() if p.requires_grad]
    assert set(drv.WARP_LEAVES) <= set(names)
    _, grads = ref.loss_and_grads(sc.ref_scene(start, "cpu"), s, target, names)
    for n, p in zip(names, params):
        scale = max(float(grads[n].norm()), 1e-6)
        assert float((p.grad - grads[n]).norm()) / scale < 5e-3, n


def test_fitvol_start_is_fits_with_the_warp_amplitude_scaled():
    drv = core.load_module(core.PKG / "drivers" / "fitvol.py")
    seeds = (2147483999, 2147484000, 2147484001)
    starts = [drv.perturbed(VALUES, s, 0.15) for s in seeds]
    again = drv.perturbed(VALUES, seeds[0], 0.15)
    assert all(np.array_equal(starts[0][k], v) for k, v in again.items())
    for s, start in zip(seeds, starts):
        fit_start = sc.perturbed(VALUES, s, 0.15)
        assert all(np.array_equal(start[k], v) for k, v in fit_start.items()
                   if k != "noise.warp_amplitude")
    moved = {float(b["noise.warp_amplitude"]) for b in starts}
    assert len(moved) == 3 and all(abs(w - 1.2) <= 0.15 * 1.2 + 1e-6 for w in moved)


def test_noise3_gradient_is_its_values_derivative():
    g = torch.Generator().manual_seed(3)
    x, y, z = (torch.rand(64, generator=g, dtype=torch.float64) * 40 - 20 for _ in range(3))
    n, *d = ref.fbm3(x, y, z, 2, 7, True)
    h = 1e-6
    for a, da in enumerate(d):
        step = [h if k == a else 0.0 for k in range(3)]
        up = ref.fbm3(x + step[0], y + step[1], z + step[2], 2, 7, False)
        down = ref.fbm3(x - step[0], y - step[1], z - step[2], 2, 7, False)
        assert torch.allclose((up - down) / (2 * h), da, atol=1e-6), a
    assert float(n.abs().max()) <= sum(0.5 ** i for i in range(2))


def imports_of(path) -> tuple[set, set]:
    """(top-level names imported absolutely, modules imported relatively)."""
    absolute, relative = set(), set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            absolute |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level:
            relative |= {node.module} if node.module else {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            absolute.add(node.module.split(".")[0])
    return absolute, relative


def test_volumetric_reference_imports_neither_the_port_nor_jax():
    absolute, relative = imports_of(core.PKG / "reference" / "volumetric.py")
    assert absolute <= {"__future__", "dataclasses", "math", "torch"}
    assert relative == {"terrain"}
    for name in ("drivers/fitvol.py", "roofline_volumetric.py"):
        assert not imports_of(core.PKG / name)[0] & set(core.FORBIDDEN), name


# --- roofline and reader -----------------------------------------------------


@pytest.mark.parametrize("steps, hits, pixels, primed", [
    (9.1e6, 150000, 262144, True), (1e6, 0, 4224, False), (4.2e5, 2.1e5, 262144, True)])
def test_volumetric_forward_bound_equals_chip_smoke(smoke, steps, hits, pixels, primed):
    cfg = types.SimpleNamespace(march_bf16=False, volumetric=True, num_octaves=6,
                                newton_iters=3, prime_ds=8 * primed, warp_octaves=2)
    want_ms, want_by = smoke.fwd_bound(cfg, steps, hits, pixels)
    got_s, got_by = rv.fwd_least(6, 2, 3, primed, steps, hits, pixels)
    assert 1e3 * got_s == pytest.approx(want_ms, rel=1e-12) and got_by == want_by


@pytest.mark.parametrize("hits, pixels", [(150000, 262144), (0, 262144), (200000, 262144)])
def test_volumetric_backward_bound_equals_chip_smoke(smoke, hits, pixels):
    cfg = types.SimpleNamespace(march_bf16=False, volumetric=True, num_octaves=6,
                                warp_octaves=2)
    want_ms, want_by = smoke.bwd_bound(cfg, hits, pixels)
    got_s, got_by = rv.bwd_least(6, 2, hits, pixels)
    assert 1e3 * got_s == pytest.approx(want_ms, rel=1e-12) and got_by == want_by


def test_volumetric_counts_are_chip_smokes(smoke):
    for k, v in rv.OPS.items():
        assert smoke.OPS[k] == v, k
    tr = types.SimpleNamespace(steps=9.1e6, hits=1.5e5, pixels=262144, coarse_steps=2e5,
                               coarse_hits=2e3, coarse_pixels=4224)
    got = rv.trace_least(6, 2, 3, tr)
    assert got["fwd"] == pytest.approx(rv.fwd_least(6, 2, 3, True, 9.1e6, 1.5e5, 262144)[0]
                                       + rv.fwd_least(6, 2, 1, False, 2e5, 2e3, 4224)[0])
    assert got["bwd"] == rv.bwd_least(6, 2, 1.5e5, 262144)[0]


def test_march_step_ratio_reader():
    from raybench.tracing import Profile

    reader = core.load_module(core.PKG / "metrics" / "march_step_ratio.py")
    assert reader.read([Profile([], [], (0.0, 1.0), 4, {"fwd": 1e-5, "bwd": 1e-6})]) is None
    made_up = [Profile([], [], (0.0, 1.0), 4, {"march_step_ratio": r}) for r in (1.25, 1.5)]
    assert reader.read(made_up) == pytest.approx(1.375)


def test_fitvol_work_counts_the_fine_pass_lane_steps():
    from gpgpuraytrace_tpu_torch.kernels import trace as K

    cell = core.load_cell(CELL)
    cell.config = {**cell.config, "scene": TOY_VALUES}
    render = {**TOY["render"], "height": 8, "width": 16}
    ctx = core.Context(cell, 3, 0.01, False, torch.device("cpu"), render=render,
                       traffic=TOY["traffic"])
    run = cell.driver().Run(ctx)
    run.setup()
    run.marks = {"start": run.start_leaves, "end": sc.leaves(run.scene, run.names)}
    work = run.work()
    ratios = []
    for which in ("start", "end"):
        values = {**run.start, **sc.host_values(run.marks[which])}
        *_, steps = K.render_kernel_raw(sc.port_scene(values, "cpu"), run.cfg, debug_steps=True)
        # 8x16 pixels are four 4x8 warps: each runs as long as its longest lane.
        tiles = steps.reshape(2, 4, 2, 8).amax(dim=(1, 3))
        useful = ref.trace(sc.ref_scene(values, "cpu"), run.spec).steps
        assert int(steps.sum()) <= 32 * int(tiles.sum()) == run.executed_steps(values)
        ratios.append(32 * int(tiles.sum()) / useful)
    assert work["march_step_ratio"] == pytest.approx(sum(ratios) / 2)
    assert work["march_step_ratio"] >= 1.0
    run.release()


# --- what decides correct ----------------------------------------------------


def _key(x):
    if torch.is_tensor(x):
        return (x.dtype, tuple(x.shape), x.numpy().tobytes())
    if isinstance(x, dict):
        return tuple(sorted((k, _key(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_key(v) for v in x)
    return x


@pytest.fixture(scope="module")
def reference_once():
    """``ref.frame`` and ``ref.fit`` computed once for each set of
    arguments while the toy runs last."""
    seen = {}

    def once(fn):
        def call(*args):
            key = (fn.__name__, _key(args))
            if key not in seen:
                seen[key] = fn(*args)
            return seen[key]
        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref, "frame", once(ref.frame))
        mp.setattr(ref, "fit", once(ref.fit))
        yield seen


def toy_run(seed: int = 3, control: bool = False, fault: str | None = None) -> dict:
    """One rank's set-up, window and comparison of the cell at its toy size
    on the CPU."""
    cell = core.load_cell(CELL)
    cell.config = {**cell.config, "scene": TOY_VALUES}
    ctx = core.Context(cell, seed, 0.01, False, torch.device("cpu"), control=control,
                       fault=fault, render=TOY["render"], traffic=TOY["traffic"])
    return core.run_rank(ctx, 0.0, log=lambda m: None)


def correct(part: dict) -> bool:
    return all(c.ok for c in part["checks"]) and bool(part["checks"])


def test_toy_run_of_the_volumetric_cell_is_correct(reference_once):
    part = toy_run()
    assert correct(part), {c.name: c.value for c in part["checks"]}
    assert part["attempted"] >= 3 and part["failed"] == 0


@pytest.mark.parametrize("control, fault", [(True, None)] + [(False, f) for f in FAULTS])
def test_control_and_faults_of_the_volumetric_cell_are_not_correct(reference_once, control,
                                                                   fault):
    part = toy_run(control=control, fault=fault)
    assert not correct(part), {c.name: c.value for c in part["checks"]}


@pytest.mark.cuda
def test_control_of_the_volumetric_cell_fails_at_its_size_on_the_card(cuda_card):
    c = core.load_cell(CELL)
    for seed in (2147483931, 2147483932, 2147483933):
        ctx = core.Context(c, seed, 0.5, False, cuda_card, control=True)
        part = core.run_rank(ctx, 0.0, log=lambda m: None)
        assert not correct(part), {x.name: x.value for x in part["checks"]}
        torch.cuda.empty_cache()
