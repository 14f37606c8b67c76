"""The CUDA trace kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and nvcc; skips without CUDA. Imports nothing of JAX, so
on a machine without jax run it without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

chip_smoke.py makes the same comparisons at 512x512.
"""

import collections
import copy
import dataclasses

import numpy as np
import pytest
import torch

from gpgpuraytrace_tpu_torch.kernels import trace as ktrace
from gpgpuraytrace_tpu_torch.kernels.pack import pack_frames
from gpgpuraytrace_tpu_torch.models.scene import RenderConfig, default_scene
from gpgpuraytrace_tpu_torch.ops import noise as tn
from gpgpuraytrace_tpu_torch.ops.march import coarse_prime_cfg, prime_from_coarse
from gpgpuraytrace_tpu_torch.utils import packing as pk

torch.set_num_threads(2)

CFG = RenderConfig(height=64, width=128, max_steps=64, num_octaves=3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def frac_within(a, b, atol):
    return ((a - b).abs() <= atol).float().mean().item()


# Volumetric configs: RenderConfig resolves step_relax to 0.9 for them.
VOL = {"volumetric": True, "step_relax": None}


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kw", [{}, {"march_eps_scale": 4.0}, {"prime_ds": 0}, VOL, {**VOL, "prime_ds": 0}],
    ids=["default", "residual_verdict", "unprimed", "volumetric", "volumetric_unprimed"])
def test_cuda_kernel_matches_plain_version(cuda, kw):
    cfg = dataclasses.replace(CFG, **kw)
    scene = default_scene(3, volumetric=cfg.volumetric, device=cuda)
    before = ktrace.trace_frames.launches.total()
    color, t, hit = ktrace.render_kernel_raw(scene, cfg)
    torch.cuda.synchronize()
    assert ktrace.trace_frames.launches.total() == before + (2 if cfg.prime_ds else 1)
    with torch.no_grad():
        prime = None
        if cfg.prime_ds:
            ccfg = coarse_prime_cfg(cfg)
            pc, _, seed = pack_frames(scene, scene.camera, ccfg.height, ccfg.width, -1.0)
            _, t_c, _ = ktrace.trace_frames(pc, seed, ccfg, cfg.height // cfg.prime_ds + 2)
            prime = prime_from_coarse(t_c, cfg)
        packed, _, seed = pack_frames(scene, scene.camera, cfg.height, cfg.width)
        ref_c, ref_t, ref_hit = (x[0] for x in ktrace.trace_frames_reference(
            packed, seed, cfg, cfg.height, prime))
    assert_matches_plain((color.permute(2, 0, 1), t, hit.float()), (ref_c, ref_t, ref_hit))


def assert_matches_plain(kern, ref, bf16=False):
    """(color (3, h, w), t, hit float) of the kernel against its plain
    version. Grazing rays are chaotic (2e-3 on 99.9%); FMA contraction and
    rsqrtf move the bulk's rounding (1e-4 on 99%, not the CPU suite's 1e-5).
    ``bf16``: the bf16 march field's gates (chip_smoke.py:BF16_GATES: a
    last-bit difference in a sample point moves a bf16 field value by a bf16
    unit, and a grazing ray's end with it, more often)."""
    (kc, t, hit), (ref_c, ref_t, ref_hit) = kern, ref
    gates = (0.995, 0.99, 0.999, 0.995) if bf16 else (0.999, 0.99, 0.995, 0.999)
    assert torch.isfinite(kc).all() and torch.isfinite(t).all()
    assert frac_within(kc, ref_c, 2e-3) >= gates[0]
    assert frac_within(kc, ref_c, 1e-4) >= gates[1]
    assert (hit == ref_hit).float().mean().item() > gates[2]
    both = (hit > 0.5) & (ref_hit > 0.5)
    assert frac_within(t[both], ref_t[both], 5e-2) >= gates[3]
    if bf16:
        assert (kc - ref_c).abs().mean().item() < 2e-4


@pytest.mark.cuda
@pytest.mark.parametrize("volumetric", [False, True], ids=["heightfield", "volumetric"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["chunked", "fixed", "lod"])
def test_cuda_variant_matches_plain_version(cuda, mode, bf16, volumetric):
    """Every instantiation of the forward kernel (march mode x bf16 march field
    x step counter) against the plain version, unprimed as fixed and lod
    frames are: the counter changes no output bit, the kernel's per-lane
    count agrees with the plain version's on 99% of lanes (a lane that
    rounds its way to another step count is a grazing ray), and fixed mode
    counts max_steps and gives chunked's output bit for bit."""
    cfg = dataclasses.replace(CFG, march_mode=mode, march_bf16=bf16, volumetric=volumetric,
                              step_relax=None, prime_ds=0)
    scene = default_scene(3, volumetric=volumetric, device=cuda)
    packed, _, seed = pack_frames(scene, scene.camera, cfg.height, cfg.width)
    packed = packed.detach()
    name = ktrace.variant_name(cfg, debug_steps=True)
    before = ktrace.trace_frames.launches[name]
    with torch.no_grad():
        *out, steps = ktrace.trace_frames(packed, seed, cfg, cfg.height, debug_steps=True)
        uncounted = ktrace.trace_frames(packed, seed, cfg, cfg.height)
        *ref, ref_steps = ktrace.trace_frames_reference(packed, seed, cfg, cfg.height,
                                                        debug_steps=True)
    torch.cuda.synchronize()
    assert ktrace.trace_frames.launches[name] == before + 1
    for a, b in zip(out, uncounted):
        assert torch.equal(a, b)
    assert_matches_plain(out, ref)
    assert (steps == ref_steps).float().mean().item() >= 0.99
    if mode == "fixed":
        assert (steps == cfg.max_steps).all()
        with torch.no_grad():
            chunked = ktrace.trace_frames(packed, seed,
                                          dataclasses.replace(cfg, march_mode="chunked"),
                                          cfg.height)
        for a, b in zip(out, chunked):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("volumetric", [False, True], ids=["heightfield", "volumetric"])
@pytest.mark.parametrize("h, w, row0", [(37, 100, 5), (1, 128, 40), (66, 64, 0), (3, 5, 60)])
def test_cuda_ragged_frames(cuda, h, w, row0, volumetric):
    """Bands that are not whole 4x8 warp tiles: the band equals the same
    rows of the whole frame bit for bit (a pixel's arithmetic does not depend
    on the launch), its counted steps reduce per tile as the kernel's warps
    run them, and the band matches the plain version."""
    cfg = dataclasses.replace(CFG, height=128, width=w, volumetric=volumetric,
                              step_relax=None, prime_ds=0)
    scene = default_scene(3, volumetric=volumetric, device=cuda)
    packed, _, seed = pack_frames(scene, scene.camera, cfg.height, w, float(row0))
    packed = packed.detach()
    full_packed = pack_frames(scene, scene.camera, cfg.height, w)[0].detach()
    with torch.no_grad():
        *band, (steps,) = ktrace.trace_frames(packed, seed, cfg, h, debug_steps=True)
        full = ktrace.trace_frames(full_packed, seed, cfg, cfg.height)
        ref = ktrace.trace_frames_reference(packed, seed, cfg, h)
    torch.cuda.synchronize()
    for a, b in zip(band, full):
        assert torch.equal(a, b[..., row0:row0 + h, :])
    ids = ktrace.warp_tile_pixels(h, w).to(cuda)
    assert torch.equal(ktrace.warp_steps(steps),
                       torch.where(ids >= 0, steps.reshape(-1)[ids.clamp(min=0)], 0).amax(dim=1))
    (kc, t, hit), (rc, rt, rhit) = band, ref
    assert torch.isfinite(kc).all() and (hit == rhit).float().mean().item() > 0.99
    assert frac_within(kc, rc, 2e-3) >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("octaves", [3, 6])
def test_cuda_tile_scratch_across_streams_and_graphs(cuda, octaves):
    """The tile scratch is left at 0 by every launch: launches back to back
    on the default stream, on a second stream, and replayed from a CUDA graph
    (the main path's 6 octaves too) give the first launch's frame bit for
    bit, and every kept scratch reads 0 afterwards."""
    cfg = dataclasses.replace(CFG, num_octaves=octaves, prime_ds=0)
    scene = default_scene(octaves, device=cuda)
    packed, _, seed = pack_frames(scene, scene.camera, cfg.height, cfg.width)
    packed = packed.detach()

    def trace():
        return ktrace.trace_frames(packed, seed, cfg, cfg.height)

    with torch.no_grad():
        first = trace()
        runs = [trace() for _ in range(3)]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            runs += [trace() for _ in range(2)]
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = trace()
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            runs.append(tuple(x.clone() for x in captured))
    torch.cuda.synchronize()
    for out in runs:
        for a, b in zip(out, first):
            assert torch.equal(a, b)
    assert all(int(s.abs().sum()) == 0 for s in ktrace._TILE_SCRATCH.values())


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("octaves", [2, 3, 6])
def test_cuda_bwd_scratch_across_streams_and_graphs(cuda, octaves, bf16):
    """The backward's scratch (its second stage's counter, left at 0 by
    every launch, and the partial sums): launches back to back on the
    default stream, the cotangent as the (1, h, W, 3) view, launches on a
    second stream, and replays of a CUDA graph give the first launch's
    gradient bit for bit, at 2, 3 and the main path's 6 octaves, float32
    and bf16 march channel."""
    cfg = dataclasses.replace(CFG, num_octaves=octaves, march_bf16=bf16)
    scene = default_scene(octaves, device=cuda)
    _, t, hit = ktrace.render_kernel_raw(scene, cfg)
    packed, _, seed = pack_frames(scene, scene.camera, cfg.height, cfg.width)
    packed = packed.detach()
    g = torch.randn(1, 3, cfg.height, cfg.width, generator=torch.Generator().manual_seed(0))
    g = g.to(cuda)

    def bwd(cotangent=g):
        return ktrace.trace_frames_bwd(packed, seed, cfg, cfg.height, t[None], hit.float()[None],
                                       cotangent)

    first = bwd()
    runs = [bwd() for _ in range(2)]
    runs.append(bwd(g.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        runs += [bwd() for _ in range(2)]
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = bwd()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        runs.append(captured.clone())
    torch.cuda.synchronize()
    assert first.abs().max() > 0
    for out in runs:
        assert torch.equal(out, first)
    assert all(int(s[:1].view(torch.int32)) == 0 for s in ktrace._BWD_SCRATCH.values())


@pytest.mark.cuda
def test_cuda_wrapper_rejects_cpu_mix(cuda):
    scene = default_scene(3, device=cuda)
    packed, _, seed = pack_frames(scene, scene.camera, CFG.height, CFG.width)
    cfg = dataclasses.replace(CFG, prime_ds=0)
    with pytest.raises(ValueError, match="inputs on"):
        ktrace.trace_frames(packed.detach(), seed.cpu(), cfg, CFG.height)


def within_bwd_tolerance(got, ref):
    """Every entry within rtol 1e-3 plus 1e-4 of the largest: the sums run
    over the pixels in another order, and the kernel's rsqrtf, expf and FMA
    contraction round differently from torch."""
    return bool(((got - ref).abs() <= 1e-3 * ref.abs() + 1e-4 * ref.abs().max()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"prime_ds": 0}, VOL, {**VOL, "prime_ds": 0}],
                         ids=["primed", "unprimed", "volumetric", "volumetric_unprimed"])
def test_cuda_bwd_kernel_matches_plain_version(cuda, kw):
    cfg = dataclasses.replace(CFG, **kw)
    scene = default_scene(3, volumetric=cfg.volumetric, device=cuda)
    _, t, hit = ktrace.render_kernel_raw(scene, cfg)
    packed, _, seed = pack_frames(scene, scene.camera, cfg.height, cfg.width)
    packed, t, hit = packed.detach(), t[None], hit.float()[None]
    g = torch.randn(1, 3, cfg.height, cfg.width, generator=torch.Generator().manual_seed(0))
    g = g.to(cuda)
    before = ktrace.trace_frames_bwd.launches["bwd"]
    a = ktrace.trace_frames_bwd(packed, seed, cfg, cfg.height, t, hit, g)
    b = ktrace.trace_frames_bwd(packed, seed, cfg, cfg.height, t, hit, g)
    ref = ktrace.trace_frames_bwd_reference(packed, seed, cfg, cfg.height, t, hit, g)
    torch.cuda.synchronize()
    assert ktrace.trace_frames_bwd.launches["bwd"] == before + 2
    assert torch.equal(a, b)  # no atomics: bitwise repeatable
    assert torch.isfinite(a).all() and within_bwd_tolerance(a, ref)
    if cfg.volumetric:  # the warp amplitude and frequency get gradients
        assert (a[0, pk.WARP_AMP:pk.WARP_FREQ + 1] != 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("volumetric", [False, True], ids=["heightfield", "volumetric"])
def test_cuda_kernel_bwd_matches_plain_reshade(cuda, volumetric):
    cfg = dataclasses.replace(CFG, volumetric=volumetric, step_relax=None)
    grads = []
    for kernel_bwd in (True, False):
        scene = default_scene(3, volumetric=volumetric, device=cuda)
        img = ktrace.render_kernel(scene, dataclasses.replace(cfg, kernel_bwd=kernel_bwd))
        torch.mean(img * torch.cos(img)).backward()
        grads.append({n: p.grad for n, p in scene.named_parameters() if p.grad is not None})
    assert grads[0].keys() >= grads[1].keys() >= {"noise.amplitudes", "camera.yaw"}
    for name, ref in grads[1].items():
        assert within_bwd_tolerance(grads[0][name], ref), name


@pytest.fixture(scope="module")
def probe_lib(tmp_path_factory):
    """tests/csrc/noise2_probe.cu, built apart from the kernel library."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    import noise_probe

    return noise_probe.load(noise_probe.build(tmp_path_factory.mktemp("probe")))


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cuda_noise_arithmetic_matches_torch(cuda, probe_lib, bf16):
    """The march field's 2D noise by the kernel's own device function
    (kernels/csrc/field.cuh, through the test-only tests/csrc/noise2_probe.cu)
    against torch's on the card. bf16: every operation rounds to bf16 on both
    sides (a product or sum of two bf16 values is exact in float), so they
    agree bit for bit. float32: FMA contraction moves the last bits only."""
    import noise_probe

    gen = torch.Generator().manual_seed(5)
    x = ((torch.rand(100_000, generator=gen) - 0.5) * 120.0).to(cuda)
    z = ((torch.rand(100_000, generator=gen) - 0.5) * 120.0).to(cuda)
    got = noise_probe.noise2_probe(probe_lib, x, z, 7, bf16=bf16)
    ref = (tn.noise2_value_bf16 if bf16 else tn.noise2_value)(
        x, z, torch.tensor(7, dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()
    if bf16:
        assert torch.equal(got, ref)
    else:
        assert (got - ref).abs().max().item() < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("volumetric", [False, True], ids=["heightfield", "volumetric"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cuda_compact_phases_match_plain_versions(cuda, bf16, volumetric):
    """Compaction's two kernels: phase 1 against its plain version (its alive
    flags and its list of survivors exactly, the list in any order), phase 2
    in place from the same phase-1 outputs against its plain version on the
    survivors' pixels (the only ones it writes), one launch each and no host
    sync inside the compact trace; the compact frame against the unprimed
    chunked kernel's with JAX's exactness contract (no hit flip, every colour
    value within 1e-4)."""
    cfg = dataclasses.replace(CFG, march_mode="compact", compact_budget=16, march_bf16=bf16,
                              volumetric=volumetric, step_relax=None)
    scene = default_scene(3, volumetric=volumetric, device=cuda)
    packed, _, seed = pack_frames(scene, scene.camera, cfg.height, cfg.width)
    packed, h = packed.detach(), cfg.height
    with torch.no_grad():
        p1 = ktrace.trace_phase1s(packed, seed, cfg, h)
        r1 = ktrace.trace_phase1s_reference(packed, seed, cfg, h)
        assert_matches_plain(p1[:3], r1[:3])
        assert torch.equal(p1[3], r1[3])
        prev, ids, n_alive = p1[4:]
        n = int(n_alive)
        assert n == int(r1[6]) and torch.equal(ids[0, :n].sort().values, r1[5][0, :n])
        k2 = [x.clone() for x in p1[:3]]
        ktrace.trace_phase2s(packed, seed, cfg, h, n_alive, ids, prev, *k2)
        r2 = [x.clone() for x in p1[:3]]
        ktrace.trace_phase2s_reference(packed, seed, cfg, h, n_alive, ids, prev, *r2)
        sel = ids[0, :n].long()
        assert_matches_plain(*([c.view(3, -1)[:, sel], t.view(-1)[sel], hit.view(-1)[sel]]
                               for c, t, hit in (k2, r2)))
        ktrace.trace_frames.launches.clear()
        torch.cuda.set_sync_debug_mode("error")
        try:
            frame = ktrace.trace_frames(packed, seed, cfg, h)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        chunked = ktrace.trace_frames(packed, seed, dataclasses.replace(
            cfg, march_mode="chunked", prime_ds=0), h)
    torch.cuda.synchronize()
    assert ktrace.trace_frames.launches[ktrace.phase_name(cfg, 1)] == 1
    assert ktrace.trace_frames.launches[ktrace.phase_name(cfg, 2)] == 1
    assert n > 0
    assert torch.equal(frame[2], chunked[2])
    assert (frame[0] - chunked[0]).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("volumetric", [False, True], ids=["heightfield", "volumetric"])
def test_cuda_bf16_bwd_kernel_matches_plain_version(cuda, volumetric):
    """The backward kernel's bf16 instantiation (its march channel through
    noise2_value_bf16's adjoint) against its plain version on the bf16
    frame's (t, hit): within the backward gates, bitwise repeatable, and apart
    from the float32 instantiation on the same inputs."""
    cfg = dataclasses.replace(CFG, march_bf16=True, volumetric=volumetric, step_relax=None)
    scene = default_scene(3, volumetric=volumetric, device=cuda)
    _, t, hit = ktrace.render_kernel_raw(scene, cfg)
    packed, _, seed = pack_frames(scene, scene.camera, cfg.height, cfg.width)
    packed, t, hit = packed.detach(), t[None], hit.float()[None]
    g = torch.randn(1, 3, cfg.height, cfg.width, generator=torch.Generator().manual_seed(0))
    args = (packed, seed, cfg, cfg.height, t, hit, g.to(cuda))
    a, b = ktrace.trace_frames_bwd(*args), ktrace.trace_frames_bwd(*args)
    ref = ktrace.trace_frames_bwd_reference(*args)
    f32_args = (packed, seed, dataclasses.replace(cfg, march_bf16=False), *args[3:])
    f32 = ktrace.trace_frames_bwd(*f32_args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.isfinite(a).all() and within_bwd_tolerance(a, ref)
    assert not within_bwd_tolerance(f32, ref)


def compact_frames(cuda, cfg, h=None, row0=0):
    """(packed, seed, h) of a band and its compact frame and unprimed chunked
    frame through the kernels."""
    h = cfg.height if h is None else h
    scene = default_scene(cfg.num_octaves, volumetric=cfg.volumetric, device=cuda)
    packed, _, seed = pack_frames(scene, scene.camera, cfg.height, cfg.width, float(row0))
    packed = packed.detach()
    with torch.no_grad():
        frame = ktrace.trace_frames(packed, seed, cfg, h)
        chunked = ktrace.trace_frames(
            packed, seed, dataclasses.replace(cfg, march_mode="chunked", prime_ds=0), h)
    return packed, seed, h, frame, chunked


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("octaves, volumetric, warp_octaves", [
    (2, False, 2), (3, False, 2), (6, False, 2), (9, False, 2),
    (2, True, 1), (3, True, 3), (6, True, 1), (6, True, 3), (9, True, 2)])
def test_cuda_compact_groups_equal_unprimed_chunked(cuda, octaves, volumetric, warp_octaves,
                                                    bf16):
    """Phase 2's ray groups at 2, 3, 6 and 9 octaves (3 and 9 on the
    volumetric terrain: a round of the group's lanes mixes the last
    heightfield octave with the warp's first; 6: its own instantiation) and
    1 to 3 warp octaves: the compact frame equals the unprimed chunked kernel's bit for
    bit, and each phase's frame keeps phase 3's gates against its plain
    version (the bf16 gates under march_bf16), phase 2's from the same
    phase-1 outputs (it writes the survivors' pixels only). The bf16 gates
    were read at the main path's 6 octaves: at 9, the kernels' bf16 gap to
    their plain versions on this frame is past them (99.1% of t within 5e-2,
    a mean colour error of 2.5e-4), so there the bit for bit equality alone
    is held."""
    cfg = dataclasses.replace(CFG, march_mode="compact", compact_budget=16, march_bf16=bf16,
                              num_octaves=octaves, volumetric=volumetric,
                              warp_octaves=warp_octaves, step_relax=None)
    packed, seed, h, frame, chunked = compact_frames(cuda, cfg)
    with torch.no_grad():
        p1 = ktrace.trace_phase1s(packed, seed, cfg, h)
        r1 = ktrace.trace_phase1s_reference(packed, seed, cfg, h)
        n = int(p1[6])
        k2 = [x.clone() for x in p1[:3]]
        ktrace.trace_phase2s(packed, seed, cfg, h, p1[6], p1[5], p1[4], *k2)
        r2 = [x.clone() for x in p1[:3]]
        ktrace.trace_phase2s_reference(packed, seed, cfg, h, p1[6], p1[5], p1[4], *r2)
    torch.cuda.synchronize()
    assert n > 0
    for a, b in zip(frame, chunked):
        assert torch.equal(a, b)
    if not (bf16 and octaves > 6):
        assert_matches_plain(p1[:3], r1[:3], bf16)
        assert_matches_plain(k2, r2, bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("volumetric", [False, True], ids=["heightfield", "volumetric"])
def test_cuda_compact_ragged_band(cuda, volumetric):
    """A 37x100 band at row 5 of a 128-row frame: not whole warp tiles, and
    survivors in whatever slots phase 1's warps reach: bit for bit unprimed
    chunked's band."""
    cfg = dataclasses.replace(CFG, height=128, width=100, march_mode="compact",
                              compact_budget=16, volumetric=volumetric, step_relax=None)
    _, _, _, frame, chunked = compact_frames(cuda, cfg, h=37, row0=5)
    torch.cuda.synchronize()
    for a, b in zip(frame, chunked):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("volumetric", [False, True], ids=["heightfield", "volumetric"])
@pytest.mark.parametrize("listing", ["none", "one", "thirteen", "shuffled"])
def test_cuda_phase2_slot_lists(cuda, listing, volumetric):
    """Phase 2 on lists the groups' schedule has edges at: no survivor, one,
    13 (not a multiple of 4 or 8) and all of them in shuffled slot order:
    each listed pixel gets the unprimed chunked kernel's result bit for bit,
    every other pixel keeps phase 1's."""
    cfg = dataclasses.replace(CFG, march_mode="compact", compact_budget=16,
                              volumetric=volumetric, step_relax=None)
    packed, seed, h, _, chunked = compact_frames(cuda, cfg)
    with torch.no_grad():
        color, t, hit, _, prev, ids, n_alive = ktrace.trace_phase1s(packed, seed, cfg, h)
        listed = ids[0, :int(n_alive)]
        gen = torch.Generator().manual_seed(3)
        listed = {"none": listed[:0], "one": listed[:1], "thirteen": listed[:13],
                  "shuffled": listed[torch.randperm(listed.numel(), generator=gen).to(cuda)]
                  }[listing]
        slots = torch.full_like(ids, -1)
        slots[0, :listed.numel()] = listed  # past n_alive: never read
        before = [x.clone() for x in (color, t, hit)]
        ktrace.trace_phase2s(packed, seed, cfg, h,
                             torch.tensor([listed.numel()], dtype=torch.int32, device=cuda),
                             slots, prev, color, t, hit)
    torch.cuda.synchronize()
    mask = torch.zeros(h * cfg.width, dtype=torch.bool, device=cuda)
    mask[listed.long()] = True
    for got, old, ref in zip((color.view(3, -1), t.view(-1), hit.view(-1)),
                             (x.view(3, -1) if x.dim() == 4 else x.view(-1) for x in before),
                             (chunked[0].view(3, -1), chunked[1].view(-1),
                              chunked[2].view(-1))):
        assert torch.equal(got[..., mask], ref[..., mask])
        assert torch.equal(got[..., ~mask], old[..., ~mask])
    assert all(int(s.abs().sum()) == 0 for s in ktrace._TILE_SCRATCH.values())


@pytest.mark.cuda
@pytest.mark.parametrize("volumetric", [False, True], ids=["heightfield", "volumetric"])
def test_cuda_compact_scratch_across_streams_and_graphs(cuda, volumetric):
    """Phase 2's slot counter (in the per-stream scratch, left at 0): compact
    frames back to back, on a second stream and replayed from a CUDA graph
    equal the first bit for bit, and every kept scratch reads 0 after."""
    cfg = dataclasses.replace(CFG, march_mode="compact", compact_budget=16, num_octaves=6,
                              volumetric=volumetric, step_relax=None)
    packed, seed, h, first, _ = compact_frames(cuda, cfg)

    def trace():
        return ktrace.trace_frames(packed, seed, cfg, h)

    with torch.no_grad():
        runs = [trace() for _ in range(2)]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            runs += [trace() for _ in range(2)]
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = trace()
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            runs.append(tuple(x.clone() for x in captured))
    torch.cuda.synchronize()
    for out in runs:
        for a, b in zip(out, first):
            assert torch.equal(a, b)
    assert all(int(s.abs().sum()) == 0 for s in ktrace._TILE_SCRATCH.values())


def fly_batch(cuda, cfg, frames, row0=-1.0, height=None, width=None):
    """(packed (frames, n), seed) of the fly path's first ``frames``
    cameras at (height, width) from ``row0``, and each frame's packed row
    alone, (1, n)."""
    from gpgpuraytrace_tpu_torch.ops.flythrough import flythrough_camera, flythrough_cameras

    height, width = height or cfg.height, width or cfg.width
    scene = default_scene(cfg.num_octaves, volumetric=cfg.volumetric, device=cuda)
    times = torch.arange(frames, dtype=torch.float32) / 30.0
    packed, _, seed = pack_frames(scene, flythrough_cameras(scene, times), height, width, row0)
    ones = [pack_frames(scene, flythrough_camera(scene, t), height, width, row0)[0].detach()
            for t in times]
    return packed.detach(), seed, ones


@pytest.mark.cuda
@pytest.mark.parametrize("volumetric", [False, True], ids=["heightfield", "volumetric"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("octaves", [3, 6])
@pytest.mark.parametrize("kind", ["coarse", "primed", "unprimed", "counted", "fixed", "lod"])
def test_cuda_frame_axis_equals_one_frame_launches(cuda, kind, octaves, bf16, volumetric):
    """Every forward instantiation's frame axis (6 octaves: the unrolled
    twins too): batches of 1, 2 and 4 frames along the fly path, each frame
    bit for bit its own batch of one, one launch per batch (a batch of one
    runs the one-frame kernel): the coarse prime pass (66x64 of 512 rows:
    fewer tiles than warps), the primed fine pass, unprimed, counted, fixed
    and lod."""
    mode = kind if kind in ("fixed", "lod") else "chunked"
    cfg = dataclasses.replace(CFG, height=512 if kind == "coarse" else CFG.height,
                              width=512 if kind == "coarse" else CFG.width, march_mode=mode,
                              march_bf16=bf16, num_octaves=octaves, volumetric=volumetric,
                              step_relax=None, prime_ds=8 if kind in ("coarse", "primed") else 0)
    if kind == "coarse":
        cfg = coarse_prime_cfg(cfg)
    h = cfg.height + 2 if kind == "coarse" else cfg.height
    row0 = -1.0 if kind == "coarse" else 0.0
    debug = kind == "counted"
    packed, seed, ones = fly_batch(cuda, cfg, 4, row0)
    with torch.no_grad():
        prime = None
        if kind == "primed":
            gen = torch.Generator().manual_seed(1)
            prime = (torch.rand(4, h, cfg.width, generator=gen) * 40.0).to(cuda)
        singles = [ktrace.trace_frames(p, seed, cfg, h,
                                       None if prime is None else prime[k:k + 1], debug)
                   for k, p in enumerate(ones)]
        for frames in (1, 2, 4):
            name = ktrace.variant_name(cfg, debug, frames)
            before = ktrace.trace_frames.launches[name]
            got = ktrace.trace_frames(packed[:frames], seed, cfg, h,
                                      None if prime is None else prime[:frames], debug)
            torch.cuda.synchronize()
            assert ktrace.trace_frames.launches[name] == before + 1
            for k in range(frames):
                for a, b in zip(got, singles[k]):
                    assert torch.equal(a[k:k + 1], b), (frames, k)
    assert all(int(s.abs().sum()) == 0 for s in ktrace._TILE_SCRATCH.values())


@pytest.mark.cuda
@pytest.mark.parametrize("volumetric", [False, True], ids=["heightfield", "volumetric"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("octaves", [3, 6])
def test_cuda_compact_frame_axis_equals_one_frame_launches(cuda, octaves, bf16, volumetric):
    """Compaction's two phases over batches of 1, 2 and 4 frames: each
    frame's phase 1 outputs bit for bit its own batch of one's (its
    survivors' list as a set, in its own row, its count in its own slot of
    n_alive), then each frame's phase 2 outputs, one launch per phase."""
    cfg = dataclasses.replace(CFG, march_mode="compact", compact_budget=16, march_bf16=bf16,
                              num_octaves=octaves, volumetric=volumetric, step_relax=None)
    h = cfg.height
    packed, seed, ones = fly_batch(cuda, cfg, 4, 0.0)
    with torch.no_grad():
        singles = []
        for p in ones:
            p1 = ktrace.trace_phase1s(p, seed, cfg, h)
            n = int(p1[6])
            first = (*(x.clone() for x in p1[:5]), p1[5][0, :n].sort().values, p1[6].clone())
            ktrace.trace_phase2s(p, seed, cfg, h, p1[6], p1[5], p1[4], *p1[:3])
            singles.append((first, p1[:3]))
        for frames in (1, 2, 4):
            p1 = ktrace.trace_phase1s(packed[:frames], seed, cfg, h)
            assert p1[5].shape == (frames, h * cfg.width) and p1[6].shape == (frames,)
            for k in range(frames):
                n = int(p1[6][k])
                got = (*(x[k:k + 1] for x in p1[:5]), p1[5][k][:n].sort().values,
                       p1[6][k:k + 1])
                for a, b in zip(got, singles[k][0]):
                    assert torch.equal(a, b), (frames, k)
            ktrace.trace_phase2s(packed[:frames], seed, cfg, h, p1[6], p1[5], p1[4], *p1[:3])
            for k in range(frames):
                for a, b in zip(p1[:3], singles[k][1]):
                    assert torch.equal(a[k:k + 1], b), (frames, k)
    torch.cuda.synchronize()
    assert all(int(s.abs().sum()) == 0 for s in ktrace._TILE_SCRATCH.values())


@pytest.mark.cuda
def test_cuda_frame_axis_across_streams_and_graphs(cuda):
    """A batch of 4 (coarse pass, fine pass, compaction) back to back, on a
    second stream and replayed from a CUDA graph equals the first bit for
    bit; every kept scratch (two counters per frame) reads 0 after."""
    cfg = dataclasses.replace(CFG, num_octaves=6, prime_ds=0)
    cmp = dataclasses.replace(cfg, march_mode="compact", compact_budget=16)
    packed, seed, _ = fly_batch(cuda, cfg, 4, 0.0)

    def trace():
        return (*ktrace.trace_frames(packed, seed, cfg, cfg.height),
                *ktrace.trace_frames(packed, seed, cmp, cfg.height))

    with torch.no_grad():
        first = trace()
        runs = [trace()]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            runs.append(trace())
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = trace()
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            runs.append(tuple(x.clone() for x in captured))
    torch.cuda.synchronize()
    for out in runs:
        for a, b in zip(out, first):
            assert torch.equal(a, b)
    assert all(int(s.abs().sum()) == 0 for s in ktrace._TILE_SCRATCH.values())


@pytest.mark.cuda
def test_cuda_batch_over_the_grid_raises(cuda):
    cfg = dataclasses.replace(CFG, prime_ds=0)
    packed, seed, _ = fly_batch(cuda, cfg, 1, 0.0)
    with pytest.raises(ValueError, match=str(ktrace.MAX_FRAMES)):
        ktrace.trace_frames(packed.expand(ktrace.MAX_FRAMES + 1, -1).contiguous(), seed, cfg,
                            cfg.height)


def colour_batch(cuda, frames, h, w, seed=0):
    """Seeded linear colours as the trace hands them over: (frames, h, w, 3),
    the view of contiguous (frames, 3, h, w) planes; with zeros, large
    values and values near the levels' rounding edges."""
    gen = torch.Generator().manual_seed(seed)
    planes = torch.rand(frames, 3, h, w, generator=gen) * 4.0
    flat = planes.view(-1)
    k = torch.arange(256, dtype=torch.float64)
    c = (k / 255.0) ** 2.2
    edges = torch.where(c < 1.0, c / (1.0 - c), torch.full_like(c, 1e30)).float()
    flat[:256] = edges
    flat[256:512] = torch.nextafter(edges, torch.full_like(edges, float("inf")))
    flat[512:768] = torch.nextafter(edges, torch.zeros_like(edges))
    flat[768:776] = torch.tensor([0.0, 1e-30, 1e-7, 1.0, 1e3, 1e6, 1e30, 3e38])
    return planes.to(cuda).permute(0, 2, 3, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["planar_batch", "contiguous_frame", "planar_frame",
                                    "width_not_4", "unaligned", "tall", "many_frames"])
def test_cuda_tonemap_quantize_matches_plain_version(cuda, layout):
    """The kernel against its plain version (eight torch passes) on the card,
    byte for byte: the batch's planar view read in place (the 16-byte path),
    a contiguous frame (channels interleaved) and one frame's planar view; a
    width that is not a multiple of 4 and planes 4 bytes off 16-byte
    alignment (the scalar path); 70000 rows of one frame and 70000 frames of
    one row, which the grid of one block per row and frame refused; one
    launch per call."""
    from gpgpuraytrace_tpu_torch.kernels.quantize import (
        tonemap_quantize, tonemap_quantize_reference,
    )

    x = colour_batch(cuda, 3, 48, 200)
    if layout == "contiguous_frame":
        x = x[1].contiguous()
    elif layout == "planar_frame":
        x = x[2]
    elif layout == "width_not_4":
        x = colour_batch(cuda, 2, 16, 202)
    elif layout == "unaligned":
        flat = torch.empty(1 + x.numel(), device=cuda)
        flat[1:] = x.permute(0, 3, 1, 2).flatten()
        x = flat[1:].view(3, 3, 48, 200).permute(0, 2, 3, 1)
        assert x.data_ptr() % 16 == 4
    elif layout == "tall":
        x = colour_batch(cuda, 1, 70000, 4)
    elif layout == "many_frames":
        x = colour_batch(cuda, 70000, 1, 4)
    before = tonemap_quantize.launches
    got = tonemap_quantize(x)
    torch.cuda.synchronize()
    assert tonemap_quantize.launches == before + 1
    assert got.shape == x.shape and got.dtype == torch.uint8 and got.is_contiguous()
    assert torch.equal(got, tonemap_quantize_reference(x))
    with pytest.raises(ValueError):
        tonemap_quantize(x.double())
    with pytest.raises(ValueError):
        tonemap_quantize(x[..., :2])


@pytest.mark.cuda
def test_cuda_level_table_made_once_and_reused_in_a_fly_graph(cuda):
    """The quantize kernel's table of level edges: never made inside a CUDA
    graph capture (a capture without it raises), made once on the device by
    FlyBatch's eager first batch (255 rising edges, each in a piece of its
    own) and reused by its capture and replays, each batch bit for bit the
    eager render_batch_uint8."""
    from gpgpuraytrace_tpu_torch.kernels import quantize as kq
    from gpgpuraytrace_tpu_torch.ops.flythrough import render_batch_uint8

    index = torch.cuda.current_device() if cuda.index is None else cuda.index
    kq._TABLES.pop(index, None)
    x = colour_batch(cuda, 1, 16, 64)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="outside a CUDA graph capture"):
        with torch.cuda.graph(graph):
            kq.tonemap_quantize(x)
    made = kq.level_table.made
    scene, cfg, program = fly_program(cuda, False, "default", 4)
    tables = []
    for call in range(3):
        times = torch.arange(4 * call, 4 * call + 4, dtype=torch.float32) / 30.0
        got = program.frames(scene, times).clone()
        tables.append(kq._TABLES[index])
        assert torch.equal(got, render_batch_uint8(scene, cfg, times)), call
    assert program.replays == 2 and kq.level_table.made == made + 1
    assert tables[0] is tables[1] is tables[2]
    edges = tables[0].edges
    assert edges[0] == 0 and all(a < b for a, b in zip(edges[1:], edges[2:]))
    assert len({e >> kq.PIECE_SHIFT for e in edges[1:]}) == kq.LEVELS - 1


def fly_program(cuda, volumetric, mode, batch, size=(64, 128)):
    from gpgpuraytrace_tpu_torch.ops.flythrough import FlyBatch

    kw = {"march_mode": "compact", "compact_budget": 16} if mode == "compact" else {}
    cfg = RenderConfig(height=size[0], width=size[1], max_steps=64, num_octaves=6,
                       volumetric=volumetric, **kw)
    scene = default_scene(6, volumetric=volumetric, device=cuda)
    return scene, cfg, FlyBatch(scene, cfg, batch)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["default", "compact"])
@pytest.mark.parametrize("volumetric", [False, True], ids=["heightfield", "volumetric"])
def test_cuda_fly_graph_replays_equal_eager_batches(cuda, volumetric, mode):
    """FlyBatch: the warm-up, the capture and later replays, each batch bit
    for bit eager render_batch_uint8 of its times; the launches of a batch
    read at the capture, the load's too; replays under sync debug mode
    "error", each counting only the load's launch."""
    from gpgpuraytrace_tpu_torch.ops.flythrough import launch_counts, render_batch_uint8

    scene, cfg, program = fly_program(cuda, volumetric, mode, 4)
    assert program.graphed
    for call in range(4):
        times = torch.arange(4 * call, 4 * call + 4, dtype=torch.float32) / 30.0
        want = render_batch_uint8(scene, cfg, times).clone()
        if call >= 2:
            before = launch_counts()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = program.frames(scene, times)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            # a replay counts only the load, which runs outside the graph
            assert launch_counts() - before == collections.Counter(fly_load=1)
        else:
            got = program.frames(scene, times)
        assert torch.equal(got, want), call
    assert program.calls == 4 and program.replays == 3
    passes = {"tonemap_quantize": 1, "fly_load": 1}
    assert program.launches == collections.Counter(
        passes | ({ktrace.phase_name(cfg, 1, 4): 1, ktrace.phase_name(cfg, 2, 4): 1}
                  if mode == "compact" else {ktrace.variant_name(cfg, frames=4): 2}))


@pytest.mark.cuda
@pytest.mark.parametrize("volumetric", [False, True], ids=["heightfield", "volumetric"])
def test_cuda_fly_frames_tweak_short_batch_and_kept_frames(cuda, volumetric):
    """fly_frames on the graph: 10 frames in batches of 4, a tweak (a deep
    copy, as utils/tweak.py hands over) before batch 2 and an edit in place
    before batch 3, each frame bit for bit render_frame_uint8 of the scene it
    was rendered from; the short last batch; the caller's scene untouched;
    frames handed out unchanged once every batch is done."""
    from gpgpuraytrace_tpu_torch.ops.flythrough import fly_frames, render_frame_uint8
    from gpgpuraytrace_tpu_torch.utils.tweak import apply_tweaks

    scene, cfg, program = fly_program(cuda, volumetric, "default", 4)
    scenes = []

    def on_batch(s):
        if len(scenes) == 1:
            s = apply_tweaks(s, {"noise.height_scale": 4.5, "materials.fog_density": 0.03})[0]
        elif len(scenes) == 2:
            with torch.no_grad():
                s.camera.pitch.add_(0.05)
        scenes.append(copy.deepcopy(s))
        return s

    kept = [(i, f, f.copy()) for i, f in fly_frames(scene, cfg, 10, batch=4,
                                                     on_batch=on_batch, program=program)]
    assert [i for i, _, _ in kept] == list(range(10))
    assert program.calls == 3 and program.replays == 2
    assert float(scene.noise.height_scale) == 6.0
    times = torch.arange(10, dtype=torch.float32) / 30.0
    for i, frame, first in kept:
        assert np.array_equal(frame, first), i
        want = render_frame_uint8(scenes[i // 4], cfg, times[i]).cpu().numpy()
        assert np.array_equal(frame, want), i
    assert not np.array_equal(kept[4][1], render_frame_uint8(scene, cfg, times[4]).cpu().numpy())


@pytest.mark.cuda
def test_cuda_fly_spans_share_the_device_clock(cuda, tmp_path):
    """Three FlyBatch batches under the profiler: one graph.warmup, one
    graph.capture and two graph.replay spans (utils/profiling.py:span); each
    replay's device operations, found by its cudaGraphLaunch's correlation
    id, start after its span starts; each batch's copy to the host, found by
    the correlation id of the copy enqueued in its fly.to_host, ends before
    its fly.wait ends."""
    import json

    from torch.profiler import ProfilerActivity, profile

    p = "gpgpuraytrace_tpu_torch."
    scene, cfg, program = fly_program(cuda, False, "default", 4)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for call in range(3):
            times = torch.arange(4 * call, 4 * call + 4, dtype=torch.float32) / 30.0
            program.host_frames(scene, times, 4)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    spans = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith(p):
            spans[e["name"][len(p):]].append((e["ts"], e["ts"] + e["dur"]))
    counts = {k: len(v) for k, v in spans.items()}
    assert counts == {"graph.warmup": 1, "graph.capture": 1, "graph.replay": 2, "fly.batch": 3,
                      "fly.load": 3, "fly.to_host": 3, "fly.wait": 3}
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"]
    device = collections.defaultdict(list)
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            device[e["args"].get("correlation")].append(e)

    def correlated(a, b, needle):
        """The device operations of the runtime calls named ``needle`` in (a, b)."""
        ids = [e["args"]["correlation"] for e in runtime
               if needle in e["name"] and a <= e["ts"] and e["ts"] + e["dur"] <= b]
        assert len(ids) == 1, (needle, ids)
        return device[ids[0]]

    for a, b in spans["graph.replay"]:
        ops = correlated(a, b, "GraphLaunch")
        assert ops and all(o["ts"] >= a for o in ops)
    for (a, b), (_, w1) in zip(sorted(spans["fly.to_host"]), sorted(spans["fly.wait"])):
        copies = [o for o in correlated(a, b, "Memcpy") if "DtoH" in o["name"]]
        assert len(copies) == 1 and copies[0]["ts"] + copies[0]["dur"] <= w1


def jittered(scene, seed):
    """A deep copy of ``scene`` (new leaf addresses), each float leaf scaled
    by 1 + 0.05 N(0, 1) (numpy, seeded), the lattice seed moved by 1 + seed."""
    out = copy.deepcopy(scene)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for _, x in out.named_parameters():
            scale = np.asarray(1.0 + 0.05 * rng.standard_normal(x.shape), np.float32)
            x.mul_(torch.from_numpy(scale).to(x.device))
        out.noise.seed.add_(1 + seed)
    return out


def fly_times(k, batch=4):
    return torch.arange(batch * k, batch * k + batch, dtype=torch.float32) / 30.0


@pytest.mark.cuda
def test_cuda_fly_load_copies_leaves_and_times_bit_for_bit(cuda):
    """FlyBatch's load (kernels/load.py:FlyLoad, one launch): after it every
    leaf of the private copy and its times hold the caller's bits (a NaN's
    payload, -0.0 and the int32 seed too); the caller's scene is unchanged."""
    import operator

    from gpgpuraytrace_tpu_torch.utils.convert import LEAF_NAMES

    def bits(x):
        return x.detach().reshape(-1).view(torch.int32).cpu()

    scene, _, program = fly_program(cuda, False, "default", 4)
    other = jittered(scene, 1)
    with torch.no_grad():
        other.materials.fog_density.view(torch.int32).fill_(0x7FC00123)
    before = {n: bits(operator.attrgetter(n)(other)) for n in LEAF_NAMES}
    times = torch.tensor([0.1, -0.0, 3.7, 1e-30], dtype=torch.float32)
    program.load(other, times)
    torch.cuda.synchronize()
    for name in LEAF_NAMES:
        assert torch.equal(bits(operator.attrgetter(name)(program.scene)), before[name]), name
        assert torch.equal(bits(operator.attrgetter(name)(other)), before[name]), name
    assert torch.equal(bits(program.times), bits(times))


@pytest.mark.cuda
def test_cuda_fly_load_shows_a_new_scene_and_an_edit_in_place_in_the_next_batch(cuda):
    """FlyBatch after its warm-up and capture: a deep copy with other values
    (new leaf addresses) and then an in-place edit of its amplitudes (as the
    fly1080 cell edits them) each show in the very next batch, bit for bit
    render_batch_uint8 of that scene."""
    from gpgpuraytrace_tpu_torch.ops.flythrough import render_batch_uint8

    scene, cfg, program = fly_program(cuda, False, "default", 4)
    for k in range(2):
        program.frames(scene, fly_times(k))
    new = jittered(scene, 2)
    got = program.frames(new, fly_times(2))
    assert torch.equal(got, render_batch_uint8(new, cfg, fly_times(2)))
    unedited = render_batch_uint8(new, cfg, fly_times(3)).clone()
    with torch.no_grad():
        new.noise.amplitudes.mul_(1.05)
    got = program.frames(new, fly_times(3))
    assert torch.equal(got, render_batch_uint8(new, cfg, fly_times(3)))
    assert not torch.equal(got, unedited)
    assert program.replays == 3


@pytest.mark.cuda
def test_cuda_fly_two_batches_without_a_host_wait(cuda):
    """Two FlyBatch calls with other times and scenes, the second enqueued
    right after the first with no host wait (sync debug mode "error"): each
    batch bit for bit render_batch_uint8 of its own scene and times."""
    from gpgpuraytrace_tpu_torch.ops.flythrough import render_batch_uint8

    scene, cfg, program = fly_program(cuda, False, "default", 4)
    for k in range(2):
        program.frames(scene, fly_times(k))
    s1, s2 = jittered(scene, 3), jittered(scene, 4)
    want = [render_batch_uint8(s, cfg, fly_times(k)).clone() for s, k in ((s1, 5), (s2, 9))]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [program.frames(s1, fly_times(5)).clone(), program.frames(s2, fly_times(9))]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["float64", "shape", "strided", "on_cpu"])
def test_cuda_fly_load_refuses_a_leaf_unlike_the_copy(cuda, case):
    """A caller's leaf of float64, of another shape, not contiguous or on the
    CPU raises ValueError naming it, and nothing is launched."""
    from gpgpuraytrace_tpu_torch.kernels.load import FlyLoad

    scene, _, program = fly_program(cuda, False, "default", 4)
    other = copy.deepcopy(scene)
    amps = other.noise.amplitudes.detach()
    if case == "float64":
        other.noise.amplitudes = torch.nn.Parameter(amps.double())
    elif case == "shape":
        other.noise.amplitudes = torch.nn.Parameter(amps[:5].clone())
    elif case == "strided":
        other.noise.amplitudes = torch.nn.Parameter(amps.repeat_interleave(2)[::2])
    else:
        other.noise.amplitudes = torch.nn.Parameter(amps.cpu())
    before = FlyLoad.launches
    with pytest.raises(ValueError, match=r"noise\.amplitudes"):
        program.frames(other, fly_times(0))
    assert FlyLoad.launches == before


@pytest.mark.cuda
def test_cuda_fly_load_counts_one_launch_a_call(cuda):
    """FlyLoad.launches rises by one for every FlyBatch call on the card:
    the eager warm-up, the capture's call and each replay, through frames
    and through host_frames; launch_counts and FlyBatch.launches count it."""
    from gpgpuraytrace_tpu_torch.kernels.load import FlyLoad
    from gpgpuraytrace_tpu_torch.ops.flythrough import launch_counts

    scene, _, program = fly_program(cuda, False, "default", 4)
    before = FlyLoad.launches
    for k in range(4):
        program.frames(scene, fly_times(k))
        assert FlyLoad.launches == before + k + 1
        assert launch_counts()["fly_load"] == FlyLoad.launches
    program.host_frames(scene, fly_times(4), 4)
    assert FlyLoad.launches == before + 5 and program.calls == 5
    assert program.launches["fly_load"] == 1


@pytest.mark.cuda
def test_cuda_sharded_fit_step_graph_on_two_nccl_ranks(cuda):
    """2 NCCL ranks of ``parallel/worker.py``, one per card: on each rank the
    sharded fit step's CUDA graph replays (band forward and backward, the
    all-reduces, Adam) equal its eager steps of a copy bit for bit, every
    rank prints one loss hex and one fit loss hex, and the timed mode's
    graphs of 1 and K steps hold their all-reduces (one per parameter and
    one for the loss, counted at capture) and equal the eager loop."""
    import json
    import re

    from gpgpuraytrace_tpu_torch.parallel import launch

    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 cards: NCCL puts one rank on each card")
    outputs = launch.launch_local_processes(
        "gpgpuraytrace_tpu_torch.parallel.worker", 2,
        ["--device", "cuda", "--size", "128x64", "--octaves", "3", "--max-steps", "64",
         "--fit-steps", "3", "--time-k", "4"], timeout_s=600)
    for key in ("losshex", "fithex"):
        hexes = {re.search(key + r"=(\S+?),", out).group(1) for out in outputs}
        assert len(hexes) == 1, (key, hexes)
    assert all("(2 of them CUDA graph replays, bit for bit 3 eager steps)" in out
               for out in outputs), outputs
    timed = [json.loads(line[len("TIMED "):]) for out in outputs
             for line in out.splitlines() if line.startswith("TIMED ")]
    n_params = len(list(default_scene(3, device="cpu").parameters()))
    assert [t["rank"] for t in timed] == [0, 1]
    for t in timed:
        assert t["timing"] == "cuda_graph" and t["backend"] == "nccl"
        assert t["graph_check"]["ok"], t["graph_check"]
        assert t["launches_per_step"] == {"forward": {"chunked": 2.0},
                                          "backward": {"bwd": 1.0},
                                          "all_reduce": {"sum": float(n_params + 1)}}
    assert timed[0]["acchex"] == timed[1]["acchex"]


def ulps(a, b):
    """Units in the last place between float32 tensors, elementwise."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return (ordered(a) - ordered(b)).abs()


def posed_scenes(octaves, volumetric, n, seed):
    """``n`` CPU scenes at seeded yaw, pitch, fov_y and sun direction."""
    gen = torch.Generator().manual_seed(seed)
    for _ in range(n):
        scene = default_scene(octaves, volumetric=volumetric, device="cpu")
        u = torch.rand(3, generator=gen)
        with torch.no_grad():
            scene.camera.yaw.fill_(float(u[0]) * 6.2 - 3.1)
            scene.camera.pitch.fill_(float(u[1]) * 1.2 - 0.6)
            scene.camera.fov_y.fill_(0.5 + float(u[2]))
            scene.materials.sun_dir.copy_(torch.randn(3, generator=gen))
        yield scene


@pytest.mark.cuda
@pytest.mark.parametrize("row0", [0.0, 128.0], ids=["frame", "band"])
@pytest.mark.parametrize("octaves, volumetric", [(3, False), (6, False), (6, True)])
def test_cuda_pack_kernel_matches_plain_version(cuda, octaves, volumetric, row0):
    """The pack kernel's rows of a 512x512 frame or of the band at row 128,
    and of its coarse prime pass, over 16 seeded poses and sun directions,
    one launch per call: bit for bit the plain packing's ops run on the card
    (``utils/packing.py:_pack_scenes``, what the port ran before the kernel),
    and within 6 ulp of the plain version on the leaves' CPU copies: CUDA's
    sinf, cosf and rsqrtf are within 2 ulp and tanf 4, and a slot is at most
    a product of three of them (up's y component, cos(pitch) cos(yaw)^2 +
    cos(pitch) sin(yaw)^2); 3 read on the card. A batch of 4 fly cameras
    (pitch shared, then per frame): row b bit for bit the launch of camera b
    alone."""
    from gpgpuraytrace_tpu_torch.kernels import pack as kpack
    from gpgpuraytrace_tpu_torch.ops.camera import Cameras
    from gpgpuraytrace_tpu_torch.ops.flythrough import flythrough_cameras

    cfg = RenderConfig(height=512, width=512, num_octaves=octaves, volumetric=volumetric,
                       step_relax=None)
    ccfg = coarse_prime_cfg(cfg)
    worst = torch.zeros(pk.AMPS + octaves, dtype=torch.int64)
    for scene in posed_scenes(octaves, volumetric, 16, octaves + int(row0)):
        want = ktrace._packs(scene, scene.camera, cfg, row0)
        card = copy.deepcopy(scene).to(cuda)
        before = kpack.pack_frames.launches
        got = ktrace._packs(card, card.camera, cfg, row0)
        assert kpack.pack_frames.launches == before + 1
        with torch.no_grad():
            ops = [pk._pack_scenes(card, card.camera, *dims)[0].reshape(1, -1)
                   for dims in ((cfg.height, cfg.width, row0),
                                (ccfg.height, ccfg.width, row0 / cfg.prime_ds - 1.0))]
        for a, b, c in zip(got[:2], want[:2], ops):
            assert torch.equal(a, c)
            worst = torch.maximum(worst, ulps(a.detach().cpu(), b)[0])
    print("ulps by slot", worst.tolist())
    assert int(worst.max()) <= 6, worst.tolist()
    card = copy.deepcopy(scene).to(cuda)
    cams = flythrough_cameras(card, torch.arange(4, dtype=torch.float32) / 30.0)
    for pitch in (cams.pitch, cams.pitch + 0.01 * torch.arange(4, device=cuda)):
        cams = Cameras(cams.position, cams.yaw, pitch, cams.fov_y)
        rows = ktrace._packs(card, cams, cfg, row0)
        for b in range(4):
            one = Cameras(cams.position[b:b + 1], cams.yaw[b:b + 1],
                          pitch[b:b + 1] if pitch.dim() else pitch, cams.fov_y)
            for a, c in zip(rows[:2], ktrace._packs(card, one, cfg, row0)[:2]):
                assert torch.equal(a[b], c[0]), b


@pytest.mark.cuda
@pytest.mark.parametrize("row0", [0.0, 128.0], ids=["frame", "band"])
def test_cuda_pack_vjp_matches_autograd_of_plain_packing(cuda, row0):
    """The VJP kernel against autograd through the plain packing on the
    leaves' CPU copies, every float leaf requiring grad, seeded cotangents
    of the 512x512 frame's (or the band's) rows over 8 poses: relative error
    at most 1e-6 per leaf, one launch per backward; and a batch of 3
    cameras, yaw and position per frame, pitch and fov_y shared, whose
    shared leaves sum their frames' terms (3.7e-7 and 2.6e-7 read on the
    card)."""
    from gpgpuraytrace_tpu_torch.kernels import pack as kpack
    from gpgpuraytrace_tpu_torch.ops.camera import Cameras

    def batch(camera):
        fields = [x.detach() for x in (camera.position, camera.yaw, camera.pitch, camera.fov_y)]
        fields[:2] = [torch.stack([x + 0.1 * i for i in range(3)]) for x in fields[:2]]
        return Cameras(*(x.requires_grad_(True) for x in fields))

    def rel(a, b):
        return float((a.cpu() - b).norm() / b.norm())

    cfg = RenderConfig(height=512, width=512, num_octaves=6)
    errs = collections.defaultdict(float)
    for k, scene in enumerate(posed_scenes(6, False, 8, 100 + int(row0))):
        card = copy.deepcopy(scene).to(cuda)
        for s in (scene, card):
            for p in s.parameters():
                p.requires_grad_(True)
        for kind, want_cam, got_cam in (("one", scene.camera, card.camera),
                                         ("batch", batch(scene.camera), batch(card.camera))):
            want_leaves = kpack._leaves(scene, want_cam)
            got_leaves = kpack._leaves(card, got_cam)
            want_rows = ktrace._packs(scene, want_cam, cfg, row0)[0]
            g = torch.randn(want_rows.shape, generator=torch.Generator().manual_seed(k))
            want = torch.autograd.grad(want_rows, want_leaves, g)
            before = kpack.pack_vjp.launches
            got = torch.autograd.grad(ktrace._packs(card, got_cam, cfg, row0)[0], got_leaves,
                                      g.to(cuda))
            assert kpack.pack_vjp.launches == before + 1
            for name, a, b in zip(kpack.FLOAT_LEAVES, got, want):
                assert a.shape == b.shape, name
                errs[kind] = max(errs[kind], rel(a, b))
    print(dict(errs))
    assert errs["one"] <= 1e-6 and errs["batch"] <= 1e-6, errs


@pytest.mark.cuda
def test_cuda_pack_kernels_in_a_graph_read_leaves_updated_in_place(cuda):
    """Both pack kernels captured in one CUDA graph (the rows, and the
    gradients of every float leaf): three replays, each after the leaves
    were changed in place, equal eager calls bit for bit; the capture counts
    one launch of each, the replays none."""
    from gpgpuraytrace_tpu_torch.kernels import pack as kpack

    cfg = RenderConfig(height=512, width=512, num_octaves=6)
    scene = default_scene(6, device=cuda)
    for p in scene.parameters():
        p.requires_grad_(True)
    leaves = kpack._leaves(scene, scene.camera)
    g = torch.randn(1, pk.AMPS + 6, generator=torch.Generator().manual_seed(0)).to(cuda)

    def step():
        packed, coarse, _ = ktrace._packs(scene, scene.camera, cfg, 0.0)
        return (packed.detach(), coarse, *torch.autograd.grad(packed, leaves, g))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = (kpack.pack_frames.launches, kpack.pack_vjp.launches)
    with torch.cuda.graph(graph):
        captured = step()
    assert (kpack.pack_frames.launches, kpack.pack_vjp.launches) == (before[0] + 1,
                                                                      before[1] + 1)
    for k in range(3):
        with torch.no_grad():
            scene.camera.yaw.add_(0.1)
            scene.camera.pitch.sub_(0.05)
            scene.camera.fov_y.add_(0.02)
            scene.noise.amplitudes.mul_(1.1)
            scene.materials.sun_dir.add_(torch.tensor([0.1, -0.05, 0.02], device=cuda))
        counts = (kpack.pack_frames.launches, kpack.pack_vjp.launches)
        graph.replay()
        torch.cuda.synchronize()
        assert (kpack.pack_frames.launches, kpack.pack_vjp.launches) == counts
        for a, b in zip(captured, step()):
            assert torch.equal(a, b), k


@pytest.mark.cuda
def test_cuda_step_chunk_packs_and_pulls_back_once_a_step(cuda):
    """A StepChunk of 4 steps: its eager warm-up and its capture raise the
    pack and VJP launch counters by exactly 4 each (one of each per step),
    its replays by nothing; a FlyBatch of 4 frames packs once a batch and
    never pulls back."""
    from gpgpuraytrace_tpu_torch.kernels import pack as kpack
    from gpgpuraytrace_tpu_torch.ops.fit import (
        StepChunk, make_optimizer, partition_scene, perturb_scene,
    )
    from gpgpuraytrace_tpu_torch.ops.render import render

    def counts():
        return kpack.pack_frames.launches, kpack.pack_vjp.launches

    cfg = RenderConfig(height=64, width=64, max_steps=32, num_octaves=3)
    scene = default_scene(3, device=cuda)
    with torch.no_grad():
        target = render(scene, cfg)
    start = perturb_scene(scene, torch.Generator().manual_seed(0), 0.15)
    chunk = StepChunk(start, cfg, target, make_optimizer(partition_scene(start), 5e-3), 4)
    for call, rise in enumerate((4, 4, 0, 0)):
        before = counts()
        chunk()
        torch.cuda.synchronize()
        assert counts() == (before[0] + rise, before[1] + rise), call
    scene, cfg, program = fly_program(cuda, False, "default", 4)
    for call, rise in enumerate((1, 1, 0)):
        before = counts()
        program.frames(scene, torch.arange(4 * call, 4 * call + 4, dtype=torch.float32) / 30.0)
        torch.cuda.synchronize()
        assert counts() == (before[0] + rise, before[1]), call


# A row-band rank's stripes: 4 stripes of 32 rows of a 256x128 frame
# (prime_ds 8), rank 1's of 2 ranks at S = 32.
STRIPE_CFG = RenderConfig(height=256, width=128, max_steps=64, num_octaves=3)
STRIPE_ROW0S = (32.0, 96.0, 160.0, 224.0)


def stripe_inputs(cuda, cfg):
    """A scene on the card and its stripes' (packed, seed, t, hit): the
    batch's packing, coarse passes and fine passes through the kernels."""
    scene = default_scene(cfg.num_octaves, volumetric=cfg.volumetric, device=cuda)
    with torch.no_grad():
        packed, coarse, seed = ktrace._packs(scene, scene.camera, cfg, STRIPE_ROW0S)
        prime = ktrace._prime(coarse, seed, cfg, STRIPE_ROW0S, 32)
        _, t, hit = ktrace.trace_frames(packed, seed, cfg, 32, prime)
    return scene, packed, seed, t, hit


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"march_bf16": True}, VOL],
                         ids=["heightfield", "bf16", "volumetric"])
def test_cuda_frames_bwd_equals_one_frame_launches(cuda, kw):
    """A batch of 4 stripes' backward, one launch pair, bit for bit 4
    batches of one on the same (t, hit, g), the cotangent in either layout;
    against its plain version with the backward's tolerance; bitwise
    repeatable; counted as "+frames"."""
    cfg = dataclasses.replace(STRIPE_CFG, **kw)
    assert cfg.prime_ds == 8
    _, packed, seed, t, hit = stripe_inputs(cuda, cfg)
    g = torch.randn((4, 32, cfg.width, 3), generator=torch.Generator().manual_seed(1)).to(cuda)
    view = g.permute(0, 3, 1, 2)
    key = "bwd+bf16+frames" if cfg.march_bf16 else "bwd+frames"
    before = ktrace.trace_frames_bwd.launches[key]
    a = ktrace.trace_frames_bwd(packed, seed, cfg, 32, t, hit, view)
    b = ktrace.trace_frames_bwd(packed, seed, cfg, 32, t, hit, view.contiguous())
    ones = torch.cat([ktrace.trace_frames_bwd(packed[i:i + 1], seed, cfg, 32, t[i:i + 1],
                                              hit[i:i + 1], view[i:i + 1]) for i in range(4)])
    ref = ktrace.trace_frames_bwd_reference(packed, seed, cfg, 32, t, hit, view)
    torch.cuda.synchronize()
    assert ktrace.trace_frames_bwd.launches[key] == before + 2
    assert torch.equal(a, b) and torch.equal(a, ones)
    assert torch.isfinite(a).all()
    if not cfg.march_bf16:  # the bf16 march channel: phase 22's gates, in chip_smoke.py
        assert within_bwd_tolerance(a, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("octaves, volumetric", [(3, False), (6, True)])
def test_cuda_pack_kernel_rows_of_stripes_match_plain_packing(cuda, octaves, volumetric):
    """A ROW0 per frame, one launch: the fine and coarse rows of 4K stripes
    over 8 seeded poses bit for bit the plain packing's ops run on the card,
    and each row the one-stripe launch's."""
    from gpgpuraytrace_tpu_torch.kernels import pack as kpack

    cfg = RenderConfig(height=2160, width=3840, num_octaves=octaves, volumetric=volumetric,
                       prime_ds=4, step_relax=None)
    ccfg = coarse_prime_cfg(cfg)
    row0s = tuple(float((4 * j + 3) * 36) for j in range(15))
    for scene in posed_scenes(octaves, volumetric, 8, 40 + octaves):
        card = copy.deepcopy(scene).to(cuda)
        before = kpack.pack_frames.launches
        with torch.no_grad():
            got = ktrace._packs(card, card.camera, cfg, row0s)[:2]
            ops = [pk._pack_scenes(card, card.camera, h, w, r)[0]
                   for h, w, r in ((cfg.height, cfg.width, row0s),
                                   (ccfg.height, ccfg.width, tuple(x / 4 - 1.0 for x in row0s)))]
            ones = [ktrace._packs(card, card.camera, cfg, r)[:2] for r in row0s]
        assert kpack.pack_frames.launches == before + 1 + len(row0s)
        for i, (a, c) in enumerate(zip(got, ops)):
            assert torch.equal(a, c)
            assert torch.equal(a, torch.cat([o[i] for o in ones]))


@pytest.mark.cuda
def test_cuda_stripes_cotangent_through_pack_vjp_matches_autograd(cuda):
    """The batch's packed cotangent (its backward's rows) through the VJP
    kernel, one launch: every leaf within 1e-6 (relative) of autograd through
    the plain packing on the leaves' CPU copies, the frames' terms summed
    into the leaves they share; the striped render's gradient the stripes'
    summed (the backward kernel's tolerance)."""
    from gpgpuraytrace_tpu_torch.kernels import pack as kpack

    scene, packed, seed, t, hit = stripe_inputs(cuda, STRIPE_CFG)
    g = torch.randn((4, 32, STRIPE_CFG.width, 3),
                    generator=torch.Generator().manual_seed(2)).to(cuda)
    pbar = ktrace.trace_frames_bwd(packed, seed, STRIPE_CFG, 32, t, hit, g.permute(0, 3, 1, 2))
    host = copy.deepcopy(scene).to("cpu")
    for s in (scene, host):
        for p in s.parameters():
            p.requires_grad_(True)
    leaves, host_leaves = kpack._leaves(scene, scene.camera), kpack._leaves(host, host.camera)
    before = kpack.pack_vjp.launches
    got = torch.autograd.grad(ktrace._packs(scene, scene.camera, STRIPE_CFG, STRIPE_ROW0S)[0],
                              leaves, pbar)
    want = torch.autograd.grad(ktrace._packs(host, host.camera, STRIPE_CFG, STRIPE_ROW0S)[0],
                               host_leaves, pbar.cpu())
    assert kpack.pack_vjp.launches == before + 1
    for name, a, b in zip(kpack.FLOAT_LEAVES, got, want):
        assert float((a.cpu() - b).norm()) <= 1e-6 * max(float(b.norm()), 1e-30), name
    params = [scene.noise.amplitudes, scene.camera.yaw, scene.camera.pitch]
    img = ktrace.render_kernel(scene, STRIPE_CFG, STRIPE_ROW0S, 128)
    gi = g.reshape(-1, STRIPE_CFG.width, 3)
    striped = torch.autograd.grad(img, params, gi)
    parts = [torch.autograd.grad(ktrace.render_kernel(scene, STRIPE_CFG, r, 32), params,
                                 gi[32 * i:32 * i + 32]) for i, r in enumerate(STRIPE_ROW0S)]
    for a, *b in zip(striped, *parts):
        assert within_bwd_tolerance(a, sum(b))
