"""Two-phase ray compaction (``march_mode="compact"``) in the PyTorch port,
on the heightfield and on the volumetric terrain, at 64x128, 3 octaves, 64
steps. On the CPU the wrappers run the phases' plain versions; the CUDA
kernels are held to them by tests/test_torch_cuda.py (on a GPU) and
chip_smoke.py.

Contracts:

* compact equals the unprimed chunked march bit for bit (colour, t and hit)
  at compact_budget 8, 16 and max_steps - 8: phase 2 resumes the rays phase
  1 listed from their t and last advancing sample, not yet hit, so each ray
  runs the one-pass march's steps, whatever its slot;
* against JAX's ``_render_pallas_raw`` under compact in interpret mode: the
  image contract of tests/test_torch_trace.py;
* the survivors (phase 1's alive flags and its list of pixel ids) are the
  lanes the counted chunked march leaves active after compact_budget steps;
* gradients: compact's equal unprimed chunked's exactly (both backward
  routes; the backward takes the same saved (t, hit)); against ``jax.grad``
  of ``render_pallas`` under compact within rtol 2e-4 plus 2e-3 of each
  leaf's largest entry (tests/test_torch_variants.py's contract).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpgpuraytrace_tpu.kernels.trace import _render_pallas_raw, render_pallas
from gpgpuraytrace_tpu.models.scene import RenderConfig as JaxConfig
from gpgpuraytrace_tpu.models.scene import default_scene as jax_default_scene
from gpgpuraytrace_tpu.ops.fit import partition_scene as jax_partition_scene
from gpgpuraytrace_tpu_torch.kernels import trace as ktrace
from gpgpuraytrace_tpu_torch.models.scene import RenderConfig, default_scene
from gpgpuraytrace_tpu_torch.utils.convert import scene_from_numpy
from gpgpuraytrace_tpu_torch.utils.packing import pack_scene

torch.set_num_threads(2)

H, W, OCT, STEPS = 64, 128, 3, 64
TERRAINS = ("heightfield", "volumetric")
BUDGETS = (8, 16, STEPS - 8)


def configs(terrain: str, **kw):
    kw = {"height": H, "width": W, "max_steps": STEPS, "num_octaves": OCT,
          "volumetric": terrain == "volumetric", **kw}
    return RenderConfig(**kw), JaxConfig(**kw, use_pallas=True, interpret=True)


def compact_cfg(terrain: str, budget: int = 32, **kw):
    return configs(terrain, march_mode="compact", compact_budget=budget, **kw)


def jax_scene_dict(scene):
    flat, _ = jax.tree_util.tree_flatten_with_path(scene)
    return {".".join(p.name for p in path): np.asarray(leaf) for path, leaf in flat}


def assert_mostly_close(a, b, atol, frac, msg):
    close = np.abs(np.asarray(a) - np.asarray(b)) <= atol
    got = close.mean()
    assert got >= frac, f"{msg}: only {100 * got:.3f}% within {atol} (need {100 * frac}%)"


@pytest.fixture(scope="module")
def unprimed():
    """The unprimed chunked frame and its per-lane step counts, per terrain."""
    cache = {}

    def get(terrain):
        if terrain not in cache:
            cfg = configs(terrain, prime_ds=0)[0]
            scene = default_scene(OCT, volumetric=cfg.volumetric, device="cpu")
            cache[terrain] = ktrace.render_kernel_raw(scene, cfg, debug_steps=True)
        return cache[terrain]

    return get


@pytest.mark.parametrize("terrain", TERRAINS)
@pytest.mark.parametrize("budget", BUDGETS)
def test_compact_equals_unprimed_chunked_bitwise(unprimed, terrain, budget):
    cfg = compact_cfg(terrain, budget)[0]
    assert cfg.prime_ds == 0  # compaction owns its march start
    scene = default_scene(OCT, volumetric=cfg.volumetric, device="cpu")
    launches = ktrace.trace_frames.launches.total()
    got = ktrace.render_kernel_raw(scene, cfg)
    assert ktrace.trace_frames.launches.total() == launches  # plain versions ran
    for a, b, what in zip(got, unprimed(terrain)[:3], ("colour", "t", "hit")):
        assert torch.equal(a, b), what


@pytest.mark.parametrize("terrain", TERRAINS)
@pytest.mark.parametrize("budget", BUDGETS)
def test_survivors_are_the_lanes_still_active_after_the_budget(unprimed, terrain, budget):
    """Phase 1's alive flags are exactly the lanes the counted chunked march
    runs past ``budget`` iterations, and its first ``n_alive`` slots list
    them, in pixel order (the plain version's order)."""
    cfg = compact_cfg(terrain, budget)[0]
    scene = default_scene(OCT, volumetric=cfg.volumetric, device="cpu")
    packed, seed = pack_scene(scene, H, W)
    *_, alive, prev, ids, n_alive = ktrace.trace_phase1s(packed.detach(), seed, cfg, H)
    steps = unprimed(terrain)[3]
    assert torch.equal(alive[0] > 0.5, steps > budget)
    n = int(n_alive.item())
    assert n_alive.dtype == torch.int32 and n_alive.shape == (1,)
    assert n == int((steps > budget).sum()) > 0
    assert ids.dtype == torch.int32 and ids.shape == (1, H * W)
    assert torch.equal(ids[0, :n], (steps > budget).reshape(-1).nonzero()[:, 0].to(torch.int32))
    assert (prev[alive > 0.5] < cfg.t_max).all()


@pytest.mark.parametrize("order", ["reversed", "shuffled", "random_subset"])
def test_phase2_writes_the_listed_pixels_in_any_order(unprimed, order):
    """Phase 2 resumes exactly the pixels in its first ``n_alive`` slots,
    whatever their order (the CUDA phase 1 lists them in the order its warps
    finish): each listed pixel gets the one-pass march's result, and every
    other pixel keeps phase 1's."""
    cfg = compact_cfg("heightfield", 8)[0]
    scene = default_scene(OCT, device="cpu")
    packed, seed = pack_scene(scene, H, W)
    color, t, hit, _, prev, ids, n_alive = ktrace.trace_phase1s(packed.detach(), seed, cfg, H)
    before = [x[0].clone() for x in (color, t, hit)]
    listed = ids[0, :int(n_alive)]
    gen = torch.Generator().manual_seed(2)
    listed = {"reversed": listed.flip(0),
              "shuffled": listed[torch.randperm(listed.numel(), generator=gen)],
              "random_subset": listed[torch.randperm(listed.numel(), generator=gen)
                                      [:listed.numel() // 3]]}[order]
    slots = torch.full_like(ids, -1)
    slots[0, :listed.numel()] = listed  # past n_alive: never read
    ktrace.trace_phase2s(packed.detach(), seed, cfg, H,
                         torch.tensor([listed.numel()], dtype=torch.int32), slots, prev,
                         color, t, hit)
    mask = torch.zeros(H * W, dtype=torch.bool)
    mask[listed.long()] = True
    mask = mask.view(H, W)
    one_pass = unprimed("heightfield")[:3]
    for got, old, ref in zip((color[0].permute(1, 2, 0), t[0], hit[0] > 0.5),
                             (before[0].permute(1, 2, 0), before[1], before[2] > 0.5),
                             one_pass):
        assert torch.equal(got[mask], ref[mask])
        assert torch.equal(got[~mask], old[~mask])


def test_phase2_with_no_survivors_changes_nothing():
    cfg = compact_cfg("heightfield")[0]
    scene = default_scene(OCT, device="cpu")
    packed, seed = pack_scene(scene, H, W)
    color, t, hit, _, prev, ids, _ = ktrace.trace_phase1s(packed.detach(), seed, cfg, H)
    before = [x.clone() for x in (color, t, hit)]
    ktrace.trace_phase2s(packed.detach(), seed, cfg, H, torch.zeros(1, dtype=torch.int32),
                         ids, prev, color, t, hit)
    for a, b in zip((color, t, hit), before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["not_compact", "ids_dtype", "n_alive_shape", "prev_shape"])
def test_phase_wrappers_reject_bad_inputs(case):
    cfg = compact_cfg("heightfield")[0]
    scene = default_scene(OCT, device="cpu")
    packed, seed = pack_scene(scene, H, W)
    packed = packed.detach()
    if case == "not_compact":
        with pytest.raises(ValueError, match="compact"):
            ktrace.trace_phase1s(packed, seed, dataclasses.replace(cfg, march_mode="chunked"),
                                 H)
        return
    color, t, hit, _, prev, ids, n_alive = ktrace.trace_phase1s(packed, seed, cfg, H)
    if case == "ids_dtype":
        ids = ids.long()
    elif case == "n_alive_shape":
        n_alive = n_alive.reshape(1, 1)
    else:
        prev = prev[:, :-1]
    with pytest.raises(ValueError):
        ktrace.trace_phase2s(packed, seed, cfg, H, n_alive, ids, prev, color, t, hit)


@pytest.mark.parametrize("terrain", TERRAINS)
def test_compact_matches_pallas_interpret(terrain):
    """The port's compact frame against JAX's two Pallas kernels and their
    sort-based glue in interpret mode: tests/test_torch_trace.py's image
    contract."""
    cfg, jcfg = compact_cfg(terrain)
    js = jax_default_scene(OCT, volumetric=cfg.volumetric)
    color, t, hit = (x.numpy() for x in ktrace.render_kernel_raw(
        scene_from_numpy(jax_scene_dict(js), device="cpu"), cfg))
    j_color, j_t, j_hit = (np.asarray(x) for x in _render_pallas_raw(js, jcfg))
    assert_mostly_close(color, j_color, 2e-3, 0.999, "image")
    assert_mostly_close(color, j_color, 1e-5, 0.99, "image-exact")
    agree = (hit == j_hit).mean()
    assert agree > 0.995, f"hit masks differ on {100 * (1 - agree):.2f}% px"
    both = hit & j_hit
    assert both.mean() > 0.3
    assert_mostly_close(t[both], j_t[both], 5e-2, 0.999, "hit t")


def _leaf_grads(cfg, scene=None):
    if scene is None:
        scene = default_scene(OCT, volumetric=cfg.volumetric, device="cpu")
    img = ktrace.render_kernel(scene, cfg)
    torch.mean(img * torch.cos(img)).backward()
    return {n: p.grad for n, p in scene.named_parameters() if p.grad is not None}


def grad_configs(terrain: str, **kw):
    """The gradient tests' configs: 32 rows, 32 steps, budget 16."""
    return compact_cfg(terrain, 16, height=32, max_steps=32, **kw)


@pytest.mark.parametrize("terrain", TERRAINS)
@pytest.mark.parametrize("kernel_bwd", [True, False], ids=["kernel_bwd", "reshade"])
def test_compact_gradients_equal_unprimed_chunked(terrain, kernel_bwd):
    cfg = dataclasses.replace(grad_configs(terrain)[0], kernel_bwd=kernel_bwd)
    got = _leaf_grads(cfg)
    ref = _leaf_grads(dataclasses.replace(cfg, march_mode="chunked", prime_ds=0))
    assert got.keys() == ref.keys() and got.keys() >= {"noise.amplitudes", "camera.yaw"}
    for name, value in ref.items():
        assert torch.equal(got[name], value), name


@pytest.mark.parametrize("terrain", TERRAINS)
def test_compact_gradients_match_pallas_interpret(terrain):
    """render_kernel's leaf gradients under compact against jax.grad of
    render_pallas under compact in interpret mode, each side on its own
    march: every entry within rtol 2e-4 plus 2e-3 of the leaf's largest."""
    cfg, jcfg = grad_configs(terrain)
    js = jax_default_scene(OCT, volumetric=cfg.volumetric)
    leaves, merge = jax_partition_scene(js, trainable=lambda name: True)
    ref = jax_scene_dict(merge(jax.grad(
        lambda lv: jnp.mean((lambda img: img * jnp.cos(img))(render_pallas(merge(lv), jcfg)))
    )(leaves)))
    got = _leaf_grads(cfg, scene_from_numpy(jax_scene_dict(js), device="cpu"))
    assert got.keys() >= {"noise.amplitudes", "camera.yaw"}
    for name, value in got.items():
        scale = float(np.abs(ref[name]).max())
        np.testing.assert_allclose(value.numpy(), ref[name], rtol=2e-4, atol=2e-3 * scale,
                                   err_msg=name)


# Bands of the 64x128 frame at the edges of phase 2's schedule, found from
# the unprimed march's per-lane step counts: (row0, rows, budget).
EDGE_BANDS = {
    ("heightfield", "one_survivor"): (46, 16, 40),
    ("volumetric", "one_survivor"): (42, 16, 48),
    ("heightfield", "last_row_only"): (2, 16, 40),
    ("volumetric", "last_row_only"): (2, 16, 48),
}


@pytest.mark.parametrize("terrain, edge", [*EDGE_BANDS, ("volumetric", "nine_octaves")])
def test_compact_edges_match_pallas_interpret(terrain, edge):
    """The plain oracle of compaction at the edges of the CUDA phase 2's
    schedule (persistent ray groups of 2 lanes), against JAX's two Pallas
    kernels in interpret mode: a band whose phase 1 leaves one survivor, a
    band whose survivors all lie in its last row, and 9 octaves on the
    volumetric terrain (an odd octave count: one round of a group's lanes
    mixes the last heightfield octave with the warp's first). Each equals the unprimed chunked march bit for bit and holds
    tests/test_torch_trace.py's image contract against JAX; at 9 octaves its
    bulk bound is 1e-4 rather than 1e-5 on 99% of the colour values: the
    9th octave's frequency magnifies each implementation's last-bit
    differences, and the JAX package's own Pallas and XLA paths read 97.9%
    within 1e-5 (99.7% within 1e-4) on this config."""
    if edge == "nine_octaves":
        row0, h, budget, octaves = 0, 32, 16, 9
        kw = {"height": 32, "num_octaves": 9}
    else:
        (row0, h, budget), octaves, kw = EDGE_BANDS[terrain, edge], OCT, {}
    cfg, jcfg = compact_cfg(terrain, budget, **kw)
    js = jax_default_scene(octaves, volumetric=cfg.volumetric)
    scene = scene_from_numpy(jax_scene_dict(js), device="cpu")
    packed, seed = pack_scene(scene, cfg.height, W, float(row0))
    *_, alive, _, ids, n_alive = ktrace.trace_phase1s(packed.detach(), seed, cfg, h)
    n = int(n_alive)
    rows = (ids[0, :n] // W).unique()
    if edge == "one_survivor":
        assert n == 1
    elif edge == "last_row_only":
        assert n > 1 and rows.tolist() == [h - 1]
    else:
        assert n > 0
    got = ktrace.render_kernel_raw(scene, cfg, float(row0), h)
    chunked = ktrace.render_kernel_raw(
        scene, dataclasses.replace(cfg, march_mode="chunked", prime_ds=0), float(row0), h)
    for a, b, what in zip(got, chunked, ("colour", "t", "hit")):
        assert torch.equal(a, b), what
    color, t, hit = (x.numpy() for x in got)
    j_color, j_t, j_hit = (np.asarray(x) for x in _render_pallas_raw(js, jcfg, float(row0), h))
    assert_mostly_close(color, j_color, 2e-3, 0.999, "image")
    assert_mostly_close(color, j_color, 1e-4 if edge == "nine_octaves" else 1e-5, 0.99,
                        "image-exact")
    agree = (hit == j_hit).mean()
    assert agree > 0.995, f"hit masks differ on {100 * (1 - agree):.2f}% px"
    both = hit & j_hit
    if both.any():
        assert_mostly_close(t[both], j_t[both], 5e-2, 0.999, "hit t")
