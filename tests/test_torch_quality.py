"""March quality of the PyTorch port against a dense oracle (counterpart of
tests/test_quality.py, with its configs and bounds).

Nothing else in the suite fails when a change degrades the default march's
quality: kernel-vs-plain parity passes when both are wrong together, and the
golden image pins another regime. So, at a CPU-feasible scale:

* the oracle is the JAX package's dense march, marched as
  tests/test_quality.py marches it (``march_with_stats``, 1024 steps at relax
  0.35 with no step floor, unprimed; volumetric 512 steps at 0.25), on the
  same scene and rays as the port's; the port's own dense march equals it
  within tests/test_pallas.py's image contract (hit masks agree on more than
  99.5% of pixels, t within 5e-2 on 99.9% of the pixels both hit);
* the port's default config, primed as ``render`` marches it, stays within
  the reference's bounds against that oracle: heightfield 192x192, 4
  octaves, at most 12 holes (oracle hits the march misses) and 700 hits off
  by more than 0.05 in t; volumetric 128x128, 3 octaves, 20 holes and 400
  off; and its counts are within ``HOLES_MARGIN`` and ``T_OFF_SHARE`` of the
  JAX default march's own counts against the same oracle;
* an over-relaxed march (relax 1.6; volumetric 1.5) must violate the t bound,
  so the harness can fail;
* newton_iters 1 must be measurably worse than the default 3, and 4 match it.

``oracle`` and ``quality`` need no JAX: chip_smoke.py runs them on the card,
where the oracle is the port's own plain dense march. The ``cuda`` cases run
the default march through the forward trace kernel against that plain
oracle: at the reference's configs within its bounds, and at the main path's
6 octaves (the kernel's instantiation with its octaves unrolled) within the
same margins of the plain path's own counts.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gpgpuraytrace_tpu_torch.kernels.trace import render_kernel_raw
from gpgpuraytrace_tpu_torch.models.scene import RenderConfig, Scene, default_scene
from gpgpuraytrace_tpu_torch.ops.camera import generate_rays
from gpgpuraytrace_tpu_torch.ops.march import march_with_stats
from gpgpuraytrace_tpu_torch.ops.render import prime_map_torch
from gpgpuraytrace_tpu_torch.utils.convert import scene_from_numpy

torch.set_num_threads(2)

# Hit-distance error above this (world units) counts a pixel as off.
T_ERR = 0.05
HF = dict(size=192, octaves=4, holes_max=12, t_off_max=700)
VOL = dict(size=128, octaves=3, holes_max=20, t_off_max=400)
# The main path's octave count, run at the heightfield's harness size. The
# reference has no bound for it: the kernel is held to the plain path's counts.
MAIN_OCTAVES = 6
# Two marches of one config on the same inputs (the port's and JAX's, or the
# kernel and the plain path) may differ in holes by this many, and in t_off
# by this share of the pixels: the share of common hits whose t the image
# contract lets disagree by more than 5e-2 (0.1%).
HOLES_MARGIN, T_OFF_SHARE = 3, 1e-3


@dataclasses.dataclass
class Truth:
    """A dense oracle march: its scene and rays, and its (t, hit)."""

    scene: Scene
    rays: tuple[torch.Tensor, torch.Tensor]
    t: torch.Tensor
    hit: torch.Tensor
    octaves: int
    volumetric: bool


def dense_overrides(volumetric: bool) -> dict:
    """The oracle's march: dense, conservative, no step floor, unprimed."""
    return dict(max_steps=512 if volumetric else 1024,
                step_relax=0.25 if volumetric else 0.35, step_floor_t=0.0, prime_ds=0)


def t_off_margin(truth: Truth) -> int:
    return int(T_OFF_SHARE * truth.t.numel())


def dense_march(scene, rays, octaves: int, volumetric: bool):
    """The port's plain dense march of ``rays``: (t, hit)."""
    n = rays[0].shape[0]
    cfg = RenderConfig(height=n, width=rays[0].shape[1], num_octaves=octaves,
                       volumetric=volumetric, use_kernel=False, **dense_overrides(volumetric))
    with torch.no_grad():
        t, hit, _ = march_with_stats(cfg, *rays, scene.noise)
    return t, hit


def oracle(volumetric: bool, device="cpu", octaves: int | None = None) -> Truth:
    """The port's own dense oracle march on its default scene (``octaves``:
    the harness config's unless given)."""
    p = VOL if volumetric else HF
    octaves = octaves or p["octaves"]
    n = p["size"]
    scene = default_scene(octaves, volumetric=volumetric, device=device)
    rays = generate_rays(scene.camera, n, n)
    return Truth(scene, rays, *dense_march(scene, rays, octaves, volumetric), octaves,
                 volumetric)


def counts(truth: Truth, t: torch.Tensor, hit: torch.Tensor) -> tuple[int, int]:
    """(holes, t_off) of a march's (t, hit) against the oracle's."""
    holes = int((truth.hit & ~hit).sum())
    both = truth.hit & hit
    t_off = int(((t - truth.t).abs() > T_ERR)[both].sum())
    return holes, t_off


def quality(truth: Truth, kernel: bool = False, **overrides) -> tuple[int, int]:
    """(holes, t_off) of a 128-step march under ``overrides`` (the default
    config, primed as ``render`` primes it) on the oracle's scene and rays;
    ``kernel``: through the forward trace kernel, else the plain march."""
    n = truth.t.shape[0]
    cfg = RenderConfig(height=n, width=truth.t.shape[1], num_octaves=truth.octaves,
                       volumetric=truth.volumetric, max_steps=128, use_kernel=kernel,
                       **overrides)
    with torch.no_grad():
        if kernel:
            _, t, hit = render_kernel_raw(truth.scene, cfg)
        else:
            prime = prime_map_torch(truth.scene, cfg) if cfg.prime_ds else None
            t, hit, _ = march_with_stats(cfg, *truth.rays, truth.scene.noise, prime)
    return counts(truth, t, hit)


def jax_truth(volumetric: bool) -> tuple[Truth, tuple[int, int]]:
    """The JAX package's side at the harness config, marched as
    tests/test_quality.py marches it: its dense oracle as a ``Truth`` for the
    port (the scene converted, the rays as torch tensors), and the JAX
    default march's own (holes, t_off) against it."""
    # Imported here: chip_smoke.py imports this module where JAX is absent.
    import jax

    from gpgpuraytrace_tpu.models.scene import RenderConfig as JaxConfig
    from gpgpuraytrace_tpu.models.scene import default_scene as jax_default_scene
    from gpgpuraytrace_tpu.ops.camera import generate_rays as jax_generate_rays
    from gpgpuraytrace_tpu.ops.march import march_with_stats as jax_march_with_stats
    from gpgpuraytrace_tpu.ops.render import prime_map_jax

    p = VOL if volumetric else HF
    n = p["size"]
    js = jax_default_scene(num_octaves=p["octaves"], volumetric=volumetric)
    o, d = jax_generate_rays(js.camera, n, n)
    base = dict(height=n, width=n, num_octaves=p["octaves"], use_pallas=False,
                volumetric=volumetric)
    march = jax.jit(jax_march_with_stats, static_argnums=0)
    t_gt, hit_gt, _ = march(JaxConfig(**base, **dense_overrides(volumetric)), o, d, js.noise)
    cfg = JaxConfig(**base, max_steps=128)
    t0p = jax.jit(prime_map_jax, static_argnums=1)(js, cfg)
    t, hit, _ = march(cfg, o, d, js.noise, t0p)
    flat, _ = jax.tree_util.tree_flatten_with_path(js)
    scene = scene_from_numpy(
        {".".join(k.name for k in path): np.asarray(leaf) for path, leaf in flat},
        device="cpu")
    torch_of = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    truth = Truth(scene, (torch_of(o), torch_of(d)), torch_of(t_gt), torch_of(hit_gt),
                  p["octaves"], volumetric)
    return truth, counts(truth, torch_of(t), torch_of(hit))


@pytest.fixture(scope="module")
def hf_jax():
    return jax_truth(False)


@pytest.fixture(scope="module")
def vol_jax():
    return jax_truth(True)


@pytest.fixture(scope="module")
def hf_truth(hf_jax):
    return hf_jax[0]


@pytest.fixture(scope="module")
def vol_truth(vol_jax):
    return vol_jax[0]


@pytest.fixture(scope="module")
def hf_default(hf_truth):
    return quality(hf_truth)


@pytest.fixture(scope="module")
def vol_default(vol_truth):
    return quality(vol_truth)


def check_counts_near(got: tuple[int, int], ref: tuple[int, int], truth: Truth) -> None:
    """Two marches' (holes, t_off) within HOLES_MARGIN and T_OFF_SHARE."""
    assert abs(got[0] - ref[0]) <= HOLES_MARGIN, (got, ref)
    assert abs(got[1] - ref[1]) <= t_off_margin(truth), (got, ref, t_off_margin(truth))


@pytest.mark.parametrize("terrain", ["heightfield", "volumetric"])
def test_dense_oracle_matches_jax(request, terrain):
    """The port's dense march on the JAX oracle's scene and rays equals the
    JAX package's within the image contract."""
    truth = request.getfixturevalue("vol_truth" if terrain == "volumetric" else "hf_truth")
    t, hit = dense_march(truth.scene, truth.rays, truth.octaves, truth.volumetric)
    agree = (hit == truth.hit).float().mean().item()
    assert agree > 0.995, f"hit masks differ on {100 * (1 - agree):.3f}% px"
    both = hit & truth.hit
    assert both.float().mean() > 0.3  # the frame really hits terrain
    close = ((t - truth.t).abs() <= 5e-2)[both].float().mean().item()
    assert close >= 0.999, f"hit t: {100 * close:.3f}% within 5e-2"


def test_default_march_quality(hf_jax, hf_default):
    """The shipping defaults (relax 1.0, newton 3, floor 4e-3, primed) track
    the dense oracle, and as closely as the JAX package's own march does."""
    assert RenderConfig().step_relax == 1.0 and RenderConfig(height=192, width=192).prime_ds
    holes, t_off = hf_default
    assert holes <= HF["holes_max"], f"default config skips terrain: {holes}"
    assert t_off <= HF["t_off_max"], f"default hit distances drifted: {t_off}"
    check_counts_near(hf_default, hf_jax[1], hf_jax[0])


def test_quality_harness_is_sensitive(hf_truth, hf_default):
    """An over-relaxed march must violate the bound, or the harness guards
    nothing."""
    _, t_off_bad = quality(hf_truth, step_relax=1.6)
    assert t_off_bad > HF["t_off_max"], (
        f"relax 1.6 scored {t_off_bad} <= bound {HF['t_off_max']}: the bound is too "
        f"loose to detect a quality regression")
    assert t_off_bad > 2 * hf_default[1] + 50


def test_volumetric_default_march_quality(vol_jax, vol_default):
    """Volumetric defaults (relax 0.9, RenderConfig's resolution)."""
    assert RenderConfig(volumetric=True).step_relax == 0.9
    holes, t_off = vol_default
    assert holes <= VOL["holes_max"], f"volumetric budget exhaustion: {holes}"
    assert t_off <= VOL["t_off_max"], f"volumetric drift: {t_off}"
    check_counts_near(vol_default, vol_jax[1], vol_jax[0])


def test_volumetric_harness_is_sensitive(vol_truth, vol_default):
    _, t_off_bad = quality(vol_truth, step_relax=1.5)
    assert t_off_bad > VOL["t_off_max"], f"relax 1.5 scored {t_off_bad}"
    assert t_off_bad > 3 * vol_default[1] + 50


def test_newton_default_quality(hf_truth, hf_default):
    """newton_iters 1 measurably degrades the hit distances against the
    shipping 3, while 4 matches 3."""
    _, t_off_n1 = quality(hf_truth, newton_iters=1)
    _, t_off_n4 = quality(hf_truth, newton_iters=4)
    t_off_default = hf_default[1]
    assert t_off_n1 > 1.5 * t_off_default, (t_off_n1, t_off_default)
    assert abs(t_off_n4 - t_off_default) <= 0.25 * t_off_default + 20


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("volumetric", [False, True], ids=["heightfield", "volumetric"])
def test_kernel_march_quality(cuda, volumetric):
    """The forward trace kernel's default march within the same bounds,
    against the plain oracle on the card; the over-relaxed kernel march
    violates them."""
    p = VOL if volumetric else HF
    truth = oracle(volumetric, device=cuda)
    holes, t_off = quality(truth, kernel=True)
    assert holes <= p["holes_max"] and t_off <= p["t_off_max"], (holes, t_off)
    _, t_off_bad = quality(truth, kernel=True, step_relax=1.5 if volumetric else 1.6)
    assert t_off_bad > p["t_off_max"], t_off_bad


@pytest.mark.cuda
def test_kernel_march_quality_main_path(cuda):
    """At the main path's 6 octaves (the kernel's unrolled instantiation),
    the kernel's default march tracks the plain oracle as closely as the
    plain default march does."""
    truth = oracle(False, device=cuda, octaves=MAIN_OCTAVES)
    check_counts_near(quality(truth, kernel=True), quality(truth), truth)
