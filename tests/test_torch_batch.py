"""A batch of frames through the PyTorch port's frame axis (a flythrough
batch, the JAX package's ``jit(vmap(render))``), on the CPU. The wrappers run
their plain versions here; tests/test_torch_cuda.py and chip_smoke.py hold
the CUDA kernels' frame axis to the one-frame launch on the card.

Contracts:

* ``pack_scenes``: row b equals ``pack_scene`` of frame b's camera bit for
  bit (the camera columns computed for all frames at once), and
  ``flythrough_cameras`` equals ``flythrough_camera`` frame by frame, at 4
  times and at 64 (past the width of the CPU's vectorized trig);
* ``prime_from_coarse`` of a (B, h_c + 2, w_c) batch equals each frame's map;
* ``trace_frames``, ``trace_phase1s`` and ``trace_phase2s`` with B = 3 equal
  three one-frame calls bit for bit (32x64, 3 octaves): chunked primed and
  unprimed, fixed, lod, the bf16 march field, the step counter and
  compaction's phases, both terrains;
* ``render_frames_raw`` against the JAX package's ``vmap`` of its Pallas
  kernels in interpret mode over 3 cameras (64x128, 3 octaves, 48 steps,
  primed; and compact at budget 16): tests/test_pallas.py's image contract
  (99.9% of colour values within 2e-3, 99% within 1e-5); ``fly_frames``
  against JAX's ``fly_frames`` on its Pallas kernels: uint8 within 1 level
  on 99.9% of values;
* ``trace_frames_bwd`` of B = 3 frames equals three ``trace_frame_bwd``
  calls bit for bit, the cotangent contiguous or the (B, h, W, 3) view,
  float32 and bf16, both terrains;
* a batch of stripes of one camera (a row-band rank's, ``render`` with
  ``row0`` a sequence; 128x64, stripes of 32 rows, primed): its colour
  equals each stripe's ``render`` bit for bit, and the plain path's; its
  gradient is the stripes' summed (rtol 1e-5), through the backward kernel's
  plain version and through ``render_from_checkpoint`` alike;
* a batch of the wrong shape, a ``t0_prime`` of another batch and a batch of
  more than ``MAX_FRAMES`` frames raise ``ValueError``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpgpuraytrace_tpu.models.scene import RenderConfig as JaxConfig
from gpgpuraytrace_tpu.models.scene import default_scene as jax_default_scene
from gpgpuraytrace_tpu.ops.flythrough import fly_frames as jax_fly_frames
from gpgpuraytrace_tpu.ops.flythrough import flythrough_camera as jax_flythrough_camera
from gpgpuraytrace_tpu.ops.render import render as jax_render
from gpgpuraytrace_tpu_torch.kernels import trace as ktrace
from gpgpuraytrace_tpu_torch.models.scene import RenderConfig, Scene, default_scene
from gpgpuraytrace_tpu_torch.ops.flythrough import (
    fly_frames, flythrough_camera, flythrough_cameras, render_frame_uint8,
)
from gpgpuraytrace_tpu_torch.ops.march import prime_from_coarse
from gpgpuraytrace_tpu_torch.ops.render import render
from gpgpuraytrace_tpu_torch.utils.convert import scene_from_numpy
from gpgpuraytrace_tpu_torch.utils.packing import pack_scene, pack_scenes

torch.set_num_threads(2)

TERRAINS = ("heightfield", "volumetric")
B = 3
H, W, OCT = 32, 64, 3
JAX_KW = {"height": 64, "width": 128, "max_steps": 48, "num_octaves": OCT}


def times_of(n: int) -> torch.Tensor:
    """fly_frames' times of frames 0 .. n - 1 at 30 fps."""
    return torch.arange(n, dtype=torch.float32) / 30.0


def scene_of(terrain: str):
    return default_scene(OCT, volumetric=terrain == "volumetric", device="cpu")


def frame_scene(scene, t):
    """The scene seen from the fly path's camera at time t."""
    return Scene(scene.noise, flythrough_camera(scene, t), scene.materials)


@pytest.mark.parametrize("frames", [4, 64])
@pytest.mark.parametrize("terrain", TERRAINS)
def test_pack_scenes_rows_equal_pack_scene(terrain, frames):
    scene = scene_of(terrain)
    times = times_of(frames) * 7.3  # yaws and bobs well apart
    cams = flythrough_cameras(scene, times)
    packed, seed = pack_scenes(scene, cams, 96, 160, -1.0)
    assert packed.shape == (frames, 50 + OCT) and packed.dtype == torch.float32
    for b, t in enumerate(times):
        cam = flythrough_camera(scene, t)
        assert torch.equal(cams.position[b], cam.position.detach())
        assert torch.equal(cams.yaw[b], cam.yaw.detach())
        one, one_seed = pack_scene(frame_scene(scene, t), 96, 160, -1.0)
        assert torch.equal(packed[b], one[0].detach()), b
        assert torch.equal(seed, one_seed)


def test_prime_map_of_a_batch_equals_each_frames():
    cfg = RenderConfig(height=H, width=W, num_octaves=OCT, prime_ds=4)
    gen = torch.Generator().manual_seed(0)
    t_c = torch.rand(B, H // cfg.prime_ds + 2, W // cfg.prime_ds, generator=gen) * 150.0
    t_c[1, 1:3, 2:5] = cfg.t_max
    got = prime_from_coarse(t_c, cfg)
    assert got.shape == (B, H, W)
    for b in range(B):
        assert torch.equal(got[b], prime_from_coarse(t_c[b], cfg))


# prime_ds 4: the default (8) primes frames of at least 64x64 only.
VARIANTS = {
    "chunked_primed": {"prime_ds": 4},
    "chunked": {"prime_ds": 0},
    "fixed": {"march_mode": "fixed"},
    "lod": {"march_mode": "lod"},
    "chunked_bf16": {"march_bf16": True, "prime_ds": 4},
    "lod_bf16": {"march_mode": "lod", "march_bf16": True},
    "chunked_primed_counted": {"prime_ds": 4},
}


def batch_inputs(terrain, cfg):
    """(packed (B, n), seed, t0_prime (B, H, W) or None, the one-frame
    (packed, t0_prime) of each frame): the fly path's first B frames."""
    scene = scene_of(terrain)
    times = times_of(B)
    cams = flythrough_cameras(scene, times)
    packed, seed = pack_scenes(scene, cams, cfg.height, cfg.width)
    packed = packed.detach()
    prime = ktrace._prime_maps(scene, cams, cfg)
    frames = []
    for b, t in enumerate(times):
        s = frame_scene(scene, t)
        p1 = pack_scene(s, cfg.height, cfg.width)[0].detach()
        frames.append((p1, ktrace._prime_map(s, cfg, 0.0, cfg.height)))
    return packed, seed, prime, frames


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("terrain", TERRAINS)
def test_trace_frames_equals_one_frame_calls(terrain, variant):
    cfg = RenderConfig(height=H, width=W, num_octaves=OCT, volumetric=terrain == "volumetric",
                       max_steps=48, step_relax=None, **VARIANTS[variant])
    debug_steps = variant.endswith("counted")
    packed, seed, prime, frames = batch_inputs(terrain, cfg)
    assert (prime is None) == (cfg.prime_ds == 0)
    got = ktrace.trace_frames(packed, seed, cfg, H, prime, debug_steps)
    assert len(got) == 3 + debug_steps
    assert got[0].shape == (B, 3, H, W) and got[1].shape == (B, H, W)
    for b, (p1, prime1) in enumerate(frames):
        if prime is not None:
            assert torch.equal(prime[b], prime1)
        one = ktrace.trace_frame(p1, seed, cfg, H, prime1, debug_steps)
        for x, y in zip(got, one):
            assert torch.equal(x[b], y), (variant, b)


@pytest.mark.parametrize("layout", ["contiguous", "view"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("terrain", TERRAINS)
def test_trace_frames_bwd_equals_one_frame_calls(terrain, bf16, layout):
    cfg = RenderConfig(height=H, width=W, num_octaves=OCT, volumetric=terrain == "volumetric",
                       max_steps=48, step_relax=None, march_bf16=bf16)
    packed, seed, prime, _ = batch_inputs(terrain, cfg)
    _, t, hit = ktrace.trace_frames(packed, seed, cfg, H, prime)
    g = torch.randn((B, H, W, 3), generator=torch.Generator().manual_seed(3))
    gp = g.permute(0, 3, 1, 2)
    if layout == "contiguous":
        gp = gp.contiguous()
    got = ktrace.trace_frames_bwd(packed, seed, cfg, H, t, hit, gp)
    assert got.shape == packed.shape
    for b in range(B):
        one = ktrace.trace_frame_bwd(packed[b:b + 1], seed, cfg, H, t[b], hit[b], gp[b])
        assert torch.equal(got[b:b + 1], one), b


STRIPE_CFG = RenderConfig(height=128, width=64, max_steps=32, num_octaves=OCT)
STRIPE_ROWS = (0.0, 64.0)


@pytest.mark.parametrize("kernel_bwd", [True, False], ids=["kernel_bwd", "checkpoint"])
def test_render_of_stripes_equals_each_stripe(kernel_bwd):
    cfg = dataclasses.replace(STRIPE_CFG, kernel_bwd=kernel_bwd)
    assert cfg.prime_ds == 8
    scene = scene_of("heightfield")
    params = [scene.noise.amplitudes, scene.camera.yaw, scene.camera.pitch]
    img = render(scene, cfg, STRIPE_ROWS, 64)
    parts = [render(scene, cfg, r, 32) for r in STRIPE_ROWS]
    assert torch.equal(img.detach(), torch.cat(parts).detach())
    with torch.no_grad():
        plain = render(scene, dataclasses.replace(cfg, use_kernel=False), STRIPE_ROWS, 64)
    torch.testing.assert_close(plain, img.detach(), rtol=0, atol=1e-6)
    g = torch.randn(img.shape, generator=torch.Generator().manual_seed(4))
    got = torch.autograd.grad(img, params, g)
    want = [sum(x) for x in zip(*(torch.autograd.grad(p, params, g[32 * b:32 * b + 32])
                                  for b, p in enumerate(parts)))]
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-6 * float(w.abs().max()))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("terrain", TERRAINS)
def test_compact_phases_of_a_batch_equal_one_frame_calls(terrain, bf16):
    cfg = RenderConfig(height=H, width=W, num_octaves=OCT, volumetric=terrain == "volumetric",
                       march_mode="compact", compact_budget=8, max_steps=48,
                       march_bf16=bf16)
    packed, seed, _, frames = batch_inputs(terrain, cfg)
    p1 = ktrace.trace_phase1s(packed, seed, cfg, H)
    color, t, hit, alive, prev, ids, n_alive = p1
    assert ids.shape == (B, H * W) and n_alive.shape == (B,) and n_alive.dtype == torch.int32
    ones = [ktrace.trace_phase1(f, seed, cfg, H) for f, _ in frames]
    for b, one in enumerate(ones):
        for x, y in zip(p1[:6], one[:6]):  # the lists in pixel order here
            assert torch.equal(x[b], y)
        assert n_alive[b] == one[6][0] > 0
    ktrace.trace_phase2s(packed, seed, cfg, H, n_alive, ids, prev, color, t, hit)
    for b, ((f, _), one) in enumerate(zip(frames, ones)):
        ktrace.trace_phase2(f, seed, cfg, H, one[6], one[5], one[4], *one[:3])
        for x, y in zip((color, t, hit), one[:3]):
            assert torch.equal(x[b], y)
    # Compaction through trace_frames: the two phases, the same frames.
    for x, y in zip(ktrace.trace_frames(packed, seed, cfg, H), (color, t, hit)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("terrain", TERRAINS)
def test_render_frames_raw_equals_render_of_each_camera(terrain):
    cfg = RenderConfig(height=H, width=W, num_octaves=OCT, volumetric=terrain == "volumetric",
                       max_steps=48, step_relax=None, prime_ds=4)
    scene = scene_of(terrain)
    times = times_of(B)
    color, t, hit = ktrace.render_frames_raw(scene, flythrough_cameras(scene, times), cfg)
    assert color.shape == (B, H, W, 3) and hit.dtype == torch.bool
    for b, tb in enumerate(times):
        one = ktrace.render_kernel_raw(frame_scene(scene, tb), cfg)
        for x, y in zip((color, t, hit), one):
            assert torch.equal(x[b], y)
        with torch.no_grad():
            assert torch.equal(color[b], render(frame_scene(scene, tb), cfg))


def test_supersampled_batch_equals_render():
    cfg = RenderConfig(height=16, width=32, num_octaves=2, supersample=2)
    scene = default_scene(2, device="cpu")
    times = times_of(2)
    color, t, _ = ktrace.render_frames_raw(scene, flythrough_cameras(scene, times), cfg)
    assert color.shape == (2, 16, 32, 3) and t.shape == (2, 32, 64)
    for b, tb in enumerate(times):
        with torch.no_grad():
            assert torch.equal(color[b], render(frame_scene(scene, tb), cfg))


def test_fly_batch_of_one_and_plain_path_equal_render_frame_uint8():
    cfg = RenderConfig(height=H, width=W, num_octaves=2, max_steps=48)
    scene = default_scene(2, device="cpu")
    for c, batch in ((cfg, 1), (dataclasses.replace(cfg, use_kernel=False), 2)):
        for i, frame in fly_frames(scene, c, 3, batch=batch):
            assert np.array_equal(frame, render_frame_uint8(scene, c, times_of(3)[i]).numpy())


def jax_scene_dict(scene):
    flat, _ = jax.tree_util.tree_flatten_with_path(scene)
    return {".".join(p.name for p in path): np.asarray(leaf) for path, leaf in flat}


def assert_mostly_close(a, b, atol, frac, msg):
    got = (np.abs(np.asarray(a) - np.asarray(b)) <= atol).mean()
    assert got >= frac, f"{msg}: only {100 * got:.3f}% within {atol} (need {100 * frac}%)"


@pytest.mark.parametrize("mode", ["primed", "compact"])
def test_render_frames_raw_matches_jax_vmap_of_pallas_interpret(mode):
    kw = dict(JAX_KW, **({"march_mode": "compact", "compact_budget": 16}
                         if mode == "compact" else {}))
    cfg, jcfg = RenderConfig(**kw), JaxConfig(**kw, use_pallas=True, interpret=True)
    assert bool(cfg.prime_ds) == (mode == "primed")
    js = jax_default_scene(OCT)
    scene = scene_from_numpy(jax_scene_dict(js), device="cpu")
    times = times_of(B)

    def one(t):
        cam = jax_flythrough_camera(js, t)
        return jax_render(dataclasses.replace(js, camera=cam), jcfg)

    ref = np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(times.numpy())))
    got = ktrace.render_frames_raw(scene, flythrough_cameras(scene, times), cfg)[0].numpy()
    assert got.shape == ref.shape == (B, 64, 128, 3)
    assert_mostly_close(got, ref, 2e-3, 0.999, "image")
    assert_mostly_close(got, ref, 1e-5, 0.99, "image-exact")
    jax.clear_caches()


@pytest.mark.parametrize("mode", ["primed", "compact"])
def test_fly_frames_match_jax_fly_frames_on_pallas(mode):
    kw = dict(JAX_KW, **({"march_mode": "compact", "compact_budget": 16}
                         if mode == "compact" else {}))
    js = jax_default_scene(OCT)
    scene = scene_from_numpy(jax_scene_dict(js), device="cpu")
    got = list(fly_frames(scene, RenderConfig(**kw), B, batch=B))
    ref = list(jax_fly_frames(js, JaxConfig(**kw, use_pallas=True, interpret=True), B,
                              batch=B))
    assert [i for i, _ in got] == [i for i, _ in ref] == list(range(B))
    for (i, a), (_, b) in zip(got, ref):
        diff = np.abs(a.astype(np.int16) - np.asarray(b).astype(np.int16))
        assert (diff <= 1).mean() >= 0.999, f"frame {i}"
    jax.clear_caches()


@pytest.mark.parametrize("case", ["packed_3d", "prime_batch", "prime_one_frame", "over_limit",
                                  "phase1s_packed", "phase2s_n_alive"])
def test_batched_wrappers_reject_bad_batches(case):
    cfg = RenderConfig(height=H, width=W, num_octaves=OCT, prime_ds=4)
    packed, seed, prime, _ = batch_inputs("heightfield", cfg)
    ccfg = dataclasses.replace(cfg, march_mode="compact")
    with pytest.raises(ValueError) as err:
        if case == "packed_3d":
            ktrace.trace_frames(packed[None], seed, cfg, H, prime)
        elif case == "prime_batch":
            ktrace.trace_frames(packed, seed, cfg, H, prime[:2])
        elif case == "prime_one_frame":
            ktrace.trace_frames(packed, seed, cfg, H, prime[0])
        elif case == "over_limit":
            big = packed[:1].expand(ktrace.MAX_FRAMES + 1, -1).contiguous()
            ktrace.trace_frames(big, seed, dataclasses.replace(cfg, prime_ds=0), H)
        elif case == "phase1s_packed":
            ktrace.trace_phase1s(packed[0], seed, ccfg, H)
        else:
            outs = ktrace.trace_phase1s(packed, seed, ccfg, H)
            ktrace.trace_phase2s(packed, seed, ccfg, H, outs[6][:1], *outs[5:6], outs[4],
                                 *outs[:3])
    if case == "over_limit":
        assert str(ktrace.MAX_FRAMES) in str(err.value)
