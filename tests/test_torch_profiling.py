"""Observability of the PyTorch port: the trace kernel's ``debug_steps``
executed-step counter, ``ops/march.py:march_with_stats`` and
``utils/profiling.py`` (``march_stats``, the roughness warning, ``Timer``,
``trace``), against the JAX package on the CPU, plus the device default of
the scene constructors. At 64x128, 3 octaves, 64 steps, on the heightfield
and on the volumetric terrain.

* Counter: ``tile_steps`` of the port's per-lane count equals JAX's
  ``_render_pallas_raw(..., debug_steps=True)`` tile for tile, both marching
  from JAX's prime map (each side's own coarse pass could move a lane's start
  by a last bit, and with it a whole tile's count by a chunk); the counter
  changes no output bit; JAX's bounds (tests/test_pallas.py) hold against the
  port's own ``march_with_stats``; fixed mode reads ``max_steps``.
* ``march_with_stats``: per-pixel useful steps equal JAX's on at least 99.9%
  of pixels from the same rays and prime map. ``march_stats``: hit rate within
  1e-3, mean steps within 1%, exhausted lanes equal.
* ``roughness_proxy`` equals JAX's to 1e-6; ``warn_if_rough`` warns above 2.5.
"""

import dataclasses
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from gpgpuraytrace_tpu.kernels.trace import _render_pallas_raw
from gpgpuraytrace_tpu.models.scene import RenderConfig as JaxConfig
from gpgpuraytrace_tpu.models.scene import default_scene as jax_default_scene
from gpgpuraytrace_tpu.ops import march as jmarch
from gpgpuraytrace_tpu.ops.camera import generate_rays as jax_generate_rays
from gpgpuraytrace_tpu.ops.render import prime_map_jax
from gpgpuraytrace_tpu.utils import profiling as jprof
from gpgpuraytrace_tpu_torch.kernels import trace as ktrace
from gpgpuraytrace_tpu_torch.models.scene import (
    Camera, Materials, NoiseParams, RenderConfig, default_scene,
)
from gpgpuraytrace_tpu_torch.ops import march as tmarch
from gpgpuraytrace_tpu_torch.ops.camera import generate_rays
from gpgpuraytrace_tpu_torch.utils import profiling as tprof
from gpgpuraytrace_tpu_torch.utils.convert import scene_from_numpy, scene_to_numpy
from gpgpuraytrace_tpu_torch.utils.packing import pack_scene

torch.set_num_threads(2)

H, W, OCT, STEPS = 64, 128, 3, 64
TERRAINS = ("heightfield", "volumetric")
CHUNK = 8


def configs(terrain: str, **kw):
    kw = dict(height=H, width=W, max_steps=STEPS, num_octaves=OCT,
              volumetric=terrain == "volumetric", **kw)
    return RenderConfig(**kw), JaxConfig(**kw, use_pallas=True, interpret=True)


def jax_scene_dict(scene):
    flat, _ = jax.tree_util.tree_flatten_with_path(scene)
    return {".".join(p.name for p in path): np.asarray(leaf) for path, leaf in flat}


@pytest.fixture(scope="module", params=TERRAINS)
def setup(request):
    """Per terrain: the configs, both scenes, and the port's counted frame
    from the kernel path's own prime map."""
    cfg, jcfg = configs(request.param)
    js = jax_default_scene(OCT, volumetric=cfg.volumetric)
    scene = scene_from_numpy(jax_scene_dict(js), device="cpu")
    counted = ktrace.render_kernel_raw(scene, cfg, debug_steps=True)
    return cfg, jcfg, js, scene, counted


def test_tile_steps_match_pallas_interpret(setup):
    cfg, jcfg, js, scene, _ = setup
    ccfg = jmarch.coarse_prime_cfg(jcfg)
    _, t_c, _ = _render_pallas_raw(js, ccfg, -1.0, H // cfg.prime_ds + 2)
    t0p = torch.from_numpy(np.array(jmarch.prime_from_coarse(t_c, jcfg)))
    *_, j_steps = _render_pallas_raw(js, jcfg, debug_steps=True)
    packed, seed = pack_scene(scene, H, W)
    *_, (steps,) = ktrace.trace_frames(packed.detach(), seed, cfg, H, t0p[None],
                                       debug_steps=True)
    assert steps.dtype == torch.int32 and tuple(steps.shape) == (H, W)
    tiles = ktrace.tile_steps(steps, cfg)
    assert tuple(tiles.shape) == (H // cfg.tile_h, W // ktrace.TILE_W)
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(j_steps))


def test_counter_changes_no_output(setup):
    cfg, _, _, scene, counted = setup
    plain = ktrace.render_kernel_raw(scene, cfg)
    assert len(counted) == 4 and len(plain) == 3
    for got, ref in zip(counted[:3], plain):
        assert torch.equal(got, ref)


def test_counter_bounds_against_march_with_stats(setup):
    """tests/test_pallas.py's bounds: each tile runs whole chunks, at least its
    lanes' longest useful march and less than two chunks more (the hit or
    escape is detected one step after the last useful one)."""
    cfg, _, _, scene, counted = setup
    steps = counted[3]
    tiles = ktrace.tile_steps(steps, cfg).numpy()
    assert (tiles % CHUNK == 0).all() and (tiles <= STEPS).all()
    o, d = generate_rays(scene.camera, H, W)
    (t0p,) = ktrace._prime_maps(scene, scene.camera, cfg)
    _, _, lanes = tmarch.march_with_stats(cfg, o, d, scene.noise, t0p)
    tile_max = lanes.numpy().reshape(H // cfg.tile_h, cfg.tile_h, W // 128, 128).max(axis=(1, 3))
    assert (tiles >= tile_max).all()
    assert (tiles <= tile_max + 2 * CHUNK).all()
    # Per lane: the kernel counts the useful steps plus the one that ends it.
    assert (steps >= lanes).float().mean().item() >= 0.999
    # A warp traces a 4x8 tile (H and W are whole tiles), tiles row-major.
    warps = ktrace.warp_steps(steps)
    by_tile = steps.numpy().reshape(H // 4, 4, W // 8, 8).max(axis=(1, 3))
    assert (warps.numpy() == by_tile.reshape(-1)).all()
    assert steps.float().mean() <= warps.float().mean() <= tiles.mean()


def test_fixed_counts_max_steps(setup):
    cfg, _, _, scene, _ = setup
    fixed = dataclasses.replace(cfg, march_mode="fixed")
    *_, steps = ktrace.render_kernel_raw(scene, fixed, debug_steps=True)
    assert (steps == STEPS).all()
    assert (ktrace.tile_steps(steps, fixed) == STEPS).all()


def test_lod_counts_the_fine_phase(setup):
    """lod's counter covers its fine phase only (as the TPU kernel's), which
    starts where phase 1 parked, so it marches fewer steps than chunked."""
    cfg, _, _, scene, _ = setup
    lod = dataclasses.replace(cfg, march_mode="lod")
    *_, steps = ktrace.render_kernel_raw(scene, lod, debug_steps=True)
    unprimed = dataclasses.replace(cfg, prime_ds=0)
    *_, base = ktrace.render_kernel_raw(scene, unprimed, debug_steps=True)
    assert 0 < steps.float().mean() < base.float().mean()


def test_tile_and_warp_steps_on_ragged_frames():
    """A frame that is not a whole number of tiles pads with zeros: a TPU
    tile of 16x128, a warp's tile of 4x8 (the last row and column of tiles
    masked)."""
    cfg = RenderConfig(height=20, width=130, max_steps=64, prime_ds=0)
    steps = torch.zeros((20, 130), dtype=torch.int32)
    steps[3, 5] = 9  # TPU tile (0, 0), warp tile (0, 0)
    steps[17, 129] = 17  # TPU tile (1, 1), warp tile (4, 16): the ragged corner
    np.testing.assert_array_equal(ktrace.tile_steps(steps, cfg).numpy(), [[16, 0], [0, 24]])
    warps = ktrace.warp_steps(steps)
    tiles_x = -(-130 // 8)
    assert tuple(warps.shape) == (5 * tiles_x,)
    assert warps[0] == 9 and warps[4 * tiles_x + 16] == 17
    assert warps.sum() == 26


@pytest.fixture(scope="module", params=TERRAINS)
def stats_setup(request):
    cfg, jcfg = configs(request.param)
    jcfg = dataclasses.replace(jcfg, use_pallas=False, interpret=False)
    js = jax_default_scene(OCT, volumetric=cfg.volumetric)
    scene = scene_from_numpy(jax_scene_dict(js), device="cpu")
    return cfg, jcfg, js, scene


def test_march_with_stats_matches_jax(stats_setup):
    cfg, jcfg, js, scene = stats_setup
    o, d = jax_generate_rays(js.camera, H, W)
    t0p = prime_map_jax(js, jcfg)
    _, j_hit, j_steps = jmarch.march_with_stats(jcfg, o, d, js.noise, t0p)
    t, hit, steps = tmarch.march_with_stats(
        cfg, torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d)), scene.noise,
        torch.from_numpy(np.array(t0p)))
    assert steps.dtype == torch.int32 and not t.requires_grad
    assert (steps.numpy() == np.asarray(j_steps)).mean() >= 0.999
    assert (hit.numpy() == np.asarray(j_hit)).mean() > 0.995


def test_march_with_stats_needs_the_prime_map(stats_setup):
    cfg, _, _, scene = stats_setup
    o, d = generate_rays(scene.camera, H, W)
    with pytest.raises(ValueError, match="t0_prime"):
        tmarch.march_with_stats(cfg, o, d, scene.noise)
    _, _, steps = tmarch.march_with_stats(dataclasses.replace(cfg, prime_ds=0), o, d,
                                          scene.noise)
    assert steps.max() > 0


def test_march_stats_matches_jax(stats_setup):
    cfg, jcfg, js, scene = stats_setup
    got = tprof.march_stats(scene, cfg)
    ref = jprof.march_stats(js, jcfg)
    assert got.keys() == ref.keys()
    assert abs(got["hit_rate"] - ref["hit_rate"]) <= 1e-3
    assert abs(got["steps_mean"] - ref["steps_mean"]) <= 0.01 * ref["steps_mean"]
    assert got["exhausted_lanes"] == ref["exhausted_lanes"]
    assert sum(got["histogram"]) == H * W and got["bin_edges"] == ref["bin_edges"]


def _rough(named: dict) -> dict:
    """BASELINE.md's rough variant: amplitude decay 0.65, height scale 8."""
    named = dict(named)
    n = named["noise.amplitudes"].size
    named["noise.amplitudes"] = (0.65 ** np.arange(n)).astype(np.float32)
    named["noise.height_scale"] = np.float32(8.0)
    return named


@pytest.mark.parametrize("rough", [False, True], ids=["default", "rough"])
def test_roughness_proxy_and_warning(rough):
    named = jax_scene_dict(jax_default_scene(6))
    if rough:
        named = _rough(named)
    scene = scene_from_numpy(named, device="cpu")
    cfg = RenderConfig(num_octaves=6)
    ref = jprof.roughness_proxy(jax_default_scene(6).noise.replace(
        amplitudes=named["noise.amplitudes"], height_scale=named["noise.height_scale"]), 6)
    assert abs(tprof.roughness_proxy(scene.noise, 6) - ref) <= 1e-6
    if rough:
        assert ref > tprof.ROUGHNESS_WARN_THRESHOLD == 2.5
        with pytest.warns(UserWarning, match="roughness proxy"):
            assert tprof.warn_if_rough(scene, cfg) == pytest.approx(ref)
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert tprof.warn_if_rough(scene, cfg) < tprof.ROUGHNESS_WARN_THRESHOLD


def test_fit_warns_on_rough_scene():
    """The warning is wired into the library fit loop, not just the CLI
    (tests/test_observability.py's config: 2 octaves keep the render cheap;
    height_scale 24 puts the proxy at about 2.8, past the threshold)."""
    from gpgpuraytrace_tpu_torch.ops.fit import fit
    from gpgpuraytrace_tpu_torch.ops.render import render

    cfg = RenderConfig(height=32, width=32, max_steps=32, num_octaves=2, use_kernel=False)
    named = _rough(jax_scene_dict(jax_default_scene(2)))
    named["noise.height_scale"] = np.float32(24.0)
    scene = scene_from_numpy(named, device="cpu")
    assert tprof.roughness_proxy(scene.noise, 2) > tprof.ROUGHNESS_WARN_THRESHOLD
    with torch.no_grad():
        target = render(scene, cfg)
    with pytest.warns(UserWarning, match="roughness proxy"):
        fit(scene, cfg, target, steps=1, log_fn=lambda *_: None)


def test_timer_and_trace_on_cpu(tmp_path):
    calls = []
    best = tprof.Timer(iters=3, warmup=1, device="cpu")(calls.append, 1)
    assert best >= 0.0 and len(calls) == 4
    with tprof.trace(str(tmp_path)) as log_dir:
        torch.ones(8).add_(1.0)
    assert os.path.isfile(os.path.join(log_dir, "trace.json"))


@pytest.mark.parametrize("make", [
    lambda: default_scene(2),
    lambda: scene_from_numpy(scene_to_numpy(default_scene(2, device="cpu"))),
    lambda: NoiseParams(amplitudes=[1.0], lacunarity=2.0, height_scale=1.0,
                        height_offset=0.0, horizontal_scale=0.1),
    lambda: Camera([0.0, 1.0, 0.0], 0.0, 0.0, 1.0),
    lambda: Materials(),
    lambda: tprof.Timer(),
], ids=["default_scene", "scene_from_numpy", "NoiseParams", "Camera", "Materials", "Timer"])
def test_card_is_the_default_device(make):
    """Entry points run on the card unless the caller asks for the CPU: without
    CUDA the default raises, and nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()

