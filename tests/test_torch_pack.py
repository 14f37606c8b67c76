"""The scene packing's wrapper (``kernels/pack.py``) on the CPU, where it runs
the plain version; tests/test_torch_cuda.py and chip_smoke.py phase 32 hold
the kernels to it on the card.

Contracts:

* ``pack_frames`` gives ``utils/packing.py``'s rows bit for bit: one camera
  or a batch, a row band, and the coarse prime pass's rows (ROW0 =
  row0 / ds - 1 and the coarse config's aspect) from the same call; one
  camera over a batch of stripes (a ROW0 per frame, the coarse rows' too),
  each row the one-stripe call's; the kernel's evenly spaced ROW0s exact
  or refused;
  ``pack_scene`` and ``pack_scenes`` are the plain functions' shapes;
* its gradients (autograd through the plain ops on CPU leaves) equal
  ``torch.autograd.grad`` through the plain packing for every float leaf,
  a camera leaf per frame or shared by a batch, a leaf replaced by a plain
  tensor (``ops/fd_check.py:scene_with``) too; the coarse rows carry none;
* the launch counters stay 0 off the card;
* a leaf on another device, not float32, not contiguous or of the wrong
  shape, cameras of two frame counts and more than ``MAX_FRAMES`` cameras
  raise ``ValueError``; the plain packing refuses a leaf off the CPU.
"""

import dataclasses

import pytest
import torch

from gpgpuraytrace_tpu_torch.kernels import pack as kpack
from gpgpuraytrace_tpu_torch.kernels import trace as ktrace
from gpgpuraytrace_tpu_torch.models.scene import RenderConfig, default_scene
from gpgpuraytrace_tpu_torch.ops.camera import Cameras
from gpgpuraytrace_tpu_torch.ops.fd_check import scene_with
from gpgpuraytrace_tpu_torch.ops.flythrough import flythrough_cameras
from gpgpuraytrace_tpu_torch.ops.march import coarse_prime_cfg
from gpgpuraytrace_tpu_torch.ops.render import render
from gpgpuraytrace_tpu_torch.utils import packing as pk


def posed_scene(octaves=6, volumetric=False, yaw=0.37, pitch=-0.41):
    scene = default_scene(octaves, volumetric=volumetric, device="cpu")
    with torch.no_grad():
        scene.camera.yaw.fill_(yaw)
        scene.camera.pitch.fill_(pitch)
    return scene


def batch_cameras(scene, frames=4, shared_pitch=True):
    cams = flythrough_cameras(scene, torch.arange(frames, dtype=torch.float32) / 30.0)
    if shared_pitch:
        return cams
    return dataclasses.replace(cams, pitch=cams.pitch + 0.01 * torch.arange(frames))


def seeded(shape, seed):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("octaves, volumetric", [(3, False), (6, False), (6, True)])
@pytest.mark.parametrize("row0", [0.0, 128.0], ids=["frame", "band"])
def test_pack_frames_equals_plain_rows(octaves, volumetric, row0):
    scene = posed_scene(octaves, volumetric)
    cfg = RenderConfig(height=512, width=512, num_octaves=octaves, volumetric=volumetric,
                       step_relax=None)
    packed, coarse, seed = ktrace._packs(scene, scene.camera, cfg, row0)
    ccfg = coarse_prime_cfg(cfg)
    want, want_seed = pk.pack_scene(scene, cfg.height, cfg.width, row0)
    want_coarse, _ = pk.pack_scene(scene, ccfg.height, ccfg.width, row0 / cfg.prime_ds - 1.0)
    assert torch.equal(packed, want) and torch.equal(coarse, want_coarse)
    assert torch.equal(seed, want_seed) and seed.dtype == torch.int32
    assert float(coarse[0, pk.ROW0]) == row0 / 8 - 1.0
    assert torch.equal(coarse[0, pk.ASPECT], packed[0, pk.ASPECT])
    unprimed = dataclasses.replace(cfg, prime_ds=0)
    packed, coarse, _ = ktrace._packs(scene, scene.camera, unprimed, row0)
    assert coarse is None and torch.equal(packed, want)


@pytest.mark.parametrize("shared_pitch", [True, False], ids=["shared_pitch", "pitch_per_frame"])
def test_pack_frames_batch_rows_equal_plain_and_one_camera(shared_pitch):
    scene = posed_scene()
    cams = batch_cameras(scene, 4, shared_pitch)
    packed, coarse, _ = kpack.pack_frames(scene, cams, 96, 160, 0.0, (12, 20, -1.0))
    assert packed.shape == coarse.shape == (4, pk.AMPS + 6)
    assert torch.equal(packed, pk.pack_scenes(scene, cams, 96, 160)[0])
    assert torch.equal(coarse, pk.pack_scenes(scene, cams, 12, 20, -1.0)[0])
    one, _ = kpack.pack_scenes(scene, scene.camera, 96, 160)
    assert one.shape == (pk.AMPS + 6,)
    assert torch.equal(one, pk.pack_scenes(scene, scene.camera, 96, 160)[0])


STRIPES = (36.0, 180.0, 324.0, 468.0)  # rank 1's first rows at S = 36 over 4 ranks


@pytest.mark.parametrize("octaves, volumetric", [(3, False), (6, True)])
def test_pack_frames_of_stripes_equal_plain_and_one_stripe(octaves, volumetric):
    """One camera, a ROW0 per frame: row b is the one-stripe call's with
    row0 b, bit for bit, and the plain packing's; the coarse rows' ROW0 is
    row0 b / ds - 1."""
    scene = posed_scene(octaves, volumetric)
    cfg = RenderConfig(height=2160, width=3840, num_octaves=octaves, volumetric=volumetric,
                       prime_ds=4)
    packed, coarse, _ = ktrace._packs(scene, scene.camera, cfg, STRIPES)
    assert packed.shape == coarse.shape == (len(STRIPES), pk.AMPS + octaves)
    ones = [ktrace._packs(scene, scene.camera, cfg, r) for r in STRIPES]
    assert torch.equal(packed, torch.cat([o[0] for o in ones]))
    assert torch.equal(coarse, torch.cat([o[1] for o in ones]))
    assert packed[:, pk.ROW0].tolist() == list(STRIPES)
    assert coarse[:, pk.ROW0].tolist() == [r / 4 - 1.0 for r in STRIPES]
    assert torch.equal(packed, pk.pack_scenes(scene, scene.camera, 2160, 3840, STRIPES)[0])


def test_pack_grads_of_stripes_sum_the_stripes():
    """Every leaf of the one camera and the scene reads every stripe's row:
    its gradient is the sum of the one-stripe calls' (rtol 1e-6)."""
    scene = posed_scene()
    for p in scene.parameters():
        p.requires_grad_(True)
    leaves = kpack._leaves(scene, scene.camera)
    packed, _, _ = kpack.pack_frames(scene, scene.camera, 2160, 3840, STRIPES)
    g = seeded(packed.shape, 11)
    got = grads_through(packed, leaves, g)
    parts = [grads_through(kpack.pack_frames(scene, scene.camera, 2160, 3840, r)[0], leaves,
                           g[b:b + 1]) for b, r in enumerate(STRIPES)]
    assert_grads_close(got, [sum(x) for x in zip(*parts)], kpack.FLOAT_LEAVES)


def test_kernel_row0_spacing_is_exact_or_refused():
    """The kernel computes frame b's ROW0 as row0 + b·step in float32: the
    wrapper passes evenly spaced whole rows, and refuses a ROW0 per frame it
    would round or that is not evenly spaced; a ROW0 per frame and a batch
    of cameras must agree in count."""
    assert kpack._spacing(STRIPES) == (36.0, 144.0)
    assert kpack._spacing((8.0,)) == (8.0, 0.0)
    for bad in [(0.0, 1.0, 3.0), tuple(0.7 * b for b in range(16))]:
        with pytest.raises(ValueError, match="evenly spaced"):
            kpack._spacing(bad)
    scene = posed_scene(3)
    with pytest.raises(ValueError, match="frames"):
        kpack.pack_frames(scene, batch_cameras(scene, 3), 32, 32, (0.0, 8.0))


def grads_through(packed, leaves, g):
    grads = torch.autograd.grad(packed, leaves, g, allow_unused=True)
    return [torch.zeros_like(x) if d is None else d for x, d in zip(leaves, grads)]


def assert_grads_close(got, want, names):
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        err = float((a - b).norm() / max(float(b.norm()), 1e-30))
        assert err <= 1e-6, (name, err)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("octaves", [3, 6])
def test_pack_grads_equal_autograd_through_plain_packing(octaves, seed):
    """Every float leaf requires grad; a seeded cotangent of the fine rows
    (the coarse rows' is dropped)."""
    scene = posed_scene(octaves, yaw=0.37 + seed, pitch=-0.41 + 0.2 * seed)
    for p in scene.parameters():
        p.requires_grad_(True)
    leaves = kpack._leaves(scene, scene.camera)
    packed, coarse, _ = kpack.pack_frames(scene, scene.camera, 512, 512, 64.0, (64, 64, 7.0))
    assert not coarse.requires_grad
    g = seeded(packed.shape, seed)
    got = grads_through(packed, leaves, g)
    want = grads_through(pk.pack_scene(scene, 512, 512, 64.0)[0], leaves, g)
    assert_grads_close(got, want, kpack.FLOAT_LEAVES)
    assert all(bool(torch.any(d != 0)) for name, d in zip(kpack.FLOAT_LEAVES, got))


@pytest.mark.parametrize("shared_pitch", [True, False], ids=["shared_pitch", "pitch_per_frame"])
def test_pack_batch_grads_equal_autograd_through_plain_packing(shared_pitch):
    """A batch: per-frame camera leaves get per-frame gradients, the shared
    ones (the scene's leaves, and pitch and fov_y where shared) the sum over
    the frames."""
    scene = posed_scene()
    for p in scene.parameters():
        p.requires_grad_(True)
    cams = batch_cameras(scene, 3, shared_pitch)
    cams = Cameras(*(x.detach().clone().requires_grad_(True) for x in
                     (cams.position, cams.yaw, cams.pitch, cams.fov_y)))
    leaves = kpack._leaves(scene, cams)
    packed, _, _ = kpack.pack_frames(scene, cams, 64, 96)
    g = seeded(packed.shape, 5)
    got = grads_through(packed, leaves, g)
    want = grads_through(pk.pack_scenes(scene, cams, 64, 96)[0], leaves, g)
    assert_grads_close(got, want, kpack.FLOAT_LEAVES)
    assert got[kpack.FLOAT_LEAVES.index("camera.yaw")].shape == (3,)


def test_pack_grads_reach_a_plain_tensor_leaf():
    scene = posed_scene()
    theta = torch.tensor(-0.3, requires_grad=True)
    s = scene_with(scene, "camera.pitch", theta)
    packed, _, _ = kpack.pack_frames(s, s.camera, 64, 64)
    g = seeded(packed.shape, 9)
    (got,) = torch.autograd.grad(packed, theta, g)
    (want,) = torch.autograd.grad(pk.pack_scene(s, 64, 64)[0], theta, g)
    assert abs(float(got - want)) <= 1e-6 * abs(float(want))


def test_pack_counters_stay_zero_off_the_card():
    before = (kpack.pack_frames.launches, kpack.pack_vjp.launches)
    scene = posed_scene(3)
    cfg = RenderConfig(height=32, width=48, max_steps=32, num_octaves=3)
    scene.noise.amplitudes.requires_grad_(True)
    render(scene, cfg).sum().backward()
    assert scene.noise.amplitudes.grad is not None
    assert (kpack.pack_frames.launches, kpack.pack_vjp.launches) == before == (0, 0)


@pytest.mark.parametrize("fault", ["other_device", "float64", "not_contiguous", "shape"])
def test_pack_frames_rejects_a_bad_leaf(fault):
    scene = posed_scene(3)
    base = scene.materials.sun_color.detach()
    bad = {"other_device": base.to("meta"), "float64": base.double(),
           "not_contiguous": torch.zeros(3, 2)[:, 0], "shape": torch.zeros(4)}[fault]
    del scene.materials.sun_color
    scene.materials.sun_color = bad
    with pytest.raises(ValueError, match="materials.sun_color"):
        kpack.pack_frames(scene, scene.camera, 32, 32)


def test_pack_frames_rejects_cameras_of_two_frame_counts_and_too_many():
    scene = posed_scene(3)
    cams = batch_cameras(scene, 4)
    with pytest.raises(ValueError, match="frames"):
        kpack.pack_frames(scene, dataclasses.replace(cams, yaw=cams.yaw[:3].contiguous()), 32, 32)
    n = kpack.MAX_FRAMES + 1
    many = Cameras(scene.camera.position.detach(), torch.zeros(n), cams.pitch, cams.fov_y)
    with pytest.raises(ValueError, match=str(kpack.MAX_FRAMES)):
        kpack.pack_frames(scene, many, 32, 32)
    assert ktrace.MAX_FRAMES == kpack.MAX_FRAMES


def test_plain_packing_refuses_a_leaf_off_the_cpu():
    scene = posed_scene(3)
    cams = Cameras(scene.camera.position.detach().to("meta"), scene.camera.yaw.detach(),
                   scene.camera.pitch.detach(), scene.camera.fov_y.detach())
    with pytest.raises(ValueError, match="CPU tensors only"):
        pk.pack_scenes(scene, cams, 32, 32)
