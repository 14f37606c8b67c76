"""The CUDA trace kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and nvcc; skips without CUDA. Imports nothing of JAX, so
on a machine without jax run it without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

chip_smoke.py makes the same comparisons at 512x512.
"""

import dataclasses

import pytest
import torch

from gpgpuraytrace_tpu_torch.kernels import trace as ktrace
from gpgpuraytrace_tpu_torch.models.scene import RenderConfig, default_scene
from gpgpuraytrace_tpu_torch.ops import noise as tn
from gpgpuraytrace_tpu_torch.ops.march import coarse_prime_cfg, prime_from_coarse
from gpgpuraytrace_tpu_torch.utils import packing as pk
from gpgpuraytrace_tpu_torch.utils.packing import pack_scene

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
    before = ktrace.trace_frame.launches.total()
    color, t, hit = ktrace.render_kernel_raw(scene, cfg)
    torch.cuda.synchronize()
    assert ktrace.trace_frame.launches.total() == before + (2 if cfg.prime_ds else 1)
    with torch.no_grad():
        prime = None
        if cfg.prime_ds:
            ccfg = coarse_prime_cfg(cfg)
            pc, seed = pack_scene(scene, ccfg.height, ccfg.width, -1.0)
            _, t_c, _ = ktrace.trace_frame(pc, seed, ccfg, cfg.height // cfg.prime_ds + 2)
            prime = prime_from_coarse(t_c, cfg)
        packed, seed = pack_scene(scene, cfg.height, cfg.width)
        ref_c, ref_t, ref_hit = ktrace.trace_frame_reference(packed, seed, cfg, cfg.height, prime)
    assert_matches_plain((color.permute(2, 0, 1), t, hit.float()), (ref_c, ref_t, ref_hit))


def assert_matches_plain(kern, ref):
    """(color (3, h, w), t, hit float) of the kernel against its plain
    version. Grazing rays are chaotic (2e-3 on 99.9%); FMA contraction and
    rsqrtf move the bulk's rounding (1e-4 on 99%, not the CPU suite's 1e-5)."""
    (kc, t, hit), (ref_c, ref_t, ref_hit) = kern, ref
    assert torch.isfinite(kc).all() and torch.isfinite(t).all()
    assert frac_within(kc, ref_c, 2e-3) >= 0.999
    assert frac_within(kc, ref_c, 1e-4) >= 0.99
    assert (hit == ref_hit).float().mean().item() > 0.995
    both = (hit > 0.5) & (ref_hit > 0.5)
    assert frac_within(t[both], ref_t[both], 5e-2) >= 0.999


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
    packed, seed = pack_scene(scene, cfg.height, cfg.width)
    packed = packed.detach()
    name = ktrace.variant_name(cfg, debug_steps=True)
    before = ktrace.trace_frame.launches[name]
    with torch.no_grad():
        *out, steps = ktrace.trace_frame(packed, seed, cfg, cfg.height, debug_steps=True)
        uncounted = ktrace.trace_frame(packed, seed, cfg, cfg.height)
        *ref, ref_steps = ktrace.trace_frame_reference(packed, seed, cfg, cfg.height,
                                                       debug_steps=True)
    torch.cuda.synchronize()
    assert ktrace.trace_frame.launches[name] == before + 1
    for a, b in zip(out, uncounted):
        assert torch.equal(a, b)
    assert_matches_plain(out, ref)
    assert (steps == ref_steps).float().mean().item() >= 0.99
    if mode == "fixed":
        assert (steps == cfg.max_steps).all()
        with torch.no_grad():
            chunked = ktrace.trace_frame(packed, seed,
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
    packed, seed = (x.detach() for x in pack_scene(scene, cfg.height, w, float(row0)))
    full_packed = pack_scene(scene, cfg.height, w)[0].detach()
    with torch.no_grad():
        *band, steps = ktrace.trace_frame(packed, seed, cfg, h, debug_steps=True)
        full = ktrace.trace_frame(full_packed, seed, cfg, cfg.height)
        ref = ktrace.trace_frame_reference(packed, seed, cfg, h)
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
    packed, seed = (x.detach() for x in pack_scene(scene, cfg.height, cfg.width))

    def trace():
        return ktrace.trace_frame(packed, seed, cfg, cfg.height)

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
    default stream, the cotangent as the (h, W, 3) view, launches on a
    second stream, and replays of a CUDA graph give the first launch's
    gradient bit for bit, at 2, 3 and the main path's 6 octaves, float32
    and bf16 march channel."""
    cfg = dataclasses.replace(CFG, num_octaves=octaves, march_bf16=bf16)
    scene = default_scene(octaves, device=cuda)
    _, t, hit = ktrace.render_kernel_raw(scene, cfg)
    packed, seed = (x.detach() for x in pack_scene(scene, cfg.height, cfg.width))
    g = torch.randn(3, cfg.height, cfg.width, generator=torch.Generator().manual_seed(0))
    g = g.to(cuda)

    def bwd(cotangent=g):
        return ktrace.trace_frame_bwd(packed, seed, cfg, cfg.height, t, hit.float(), cotangent)

    first = bwd()
    runs = [bwd() for _ in range(2)]
    runs.append(bwd(g.permute(1, 2, 0).contiguous().permute(2, 0, 1)))
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
    packed, seed = pack_scene(scene, CFG.height, CFG.width)
    cfg = dataclasses.replace(CFG, prime_ds=0)
    with pytest.raises(ValueError, match="inputs on"):
        ktrace.trace_frame(packed.detach(), seed.cpu(), cfg, CFG.height)


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
    packed, seed = pack_scene(scene, cfg.height, cfg.width)
    packed, hit = packed.detach(), hit.float()
    g = torch.randn(3, cfg.height, cfg.width, generator=torch.Generator().manual_seed(0))
    g = g.to(cuda)
    before = ktrace.trace_frame_bwd.launches["bwd"]
    a = ktrace.trace_frame_bwd(packed, seed, cfg, cfg.height, t, hit, g)
    b = ktrace.trace_frame_bwd(packed, seed, cfg, cfg.height, t, hit, g)
    ref = ktrace.trace_bwd_reference(packed, seed, cfg, cfg.height, t, hit, g)
    torch.cuda.synchronize()
    assert ktrace.trace_frame_bwd.launches["bwd"] == before + 2
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
    packed, seed = pack_scene(scene, cfg.height, cfg.width)
    packed, h = packed.detach(), cfg.height
    with torch.no_grad():
        p1 = ktrace.trace_phase1(packed, seed, cfg, h)
        r1 = ktrace.trace_phase1_reference(packed, seed, cfg, h)
        assert_matches_plain(p1[:3], r1[:3])
        assert torch.equal(p1[3], r1[3])
        prev, ids, n_alive = p1[4:]
        n = int(n_alive)
        assert n == int(r1[6]) and torch.equal(ids[:n].sort().values, r1[5][:n])
        k2 = [x.clone() for x in p1[:3]]
        ktrace.trace_phase2(packed, seed, cfg, h, n_alive, ids, prev, *k2)
        r2 = [x.clone() for x in p1[:3]]
        ktrace.trace_phase2_reference(packed, seed, cfg, h, n_alive, ids, prev, *r2)
        sel = ids[:n].long()
        assert_matches_plain(*([c.view(3, -1)[:, sel], t.view(-1)[sel], hit.view(-1)[sel]]
                               for c, t, hit in (k2, r2)))
        ktrace.trace_frame.launches.clear()
        torch.cuda.set_sync_debug_mode("error")
        try:
            frame = ktrace.trace_frame(packed, seed, cfg, h)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        chunked = ktrace.trace_frame(packed, seed, dataclasses.replace(
            cfg, march_mode="chunked", prime_ds=0), h)
    torch.cuda.synchronize()
    assert ktrace.trace_frame.launches[ktrace.phase_name(cfg, 1)] == 1
    assert ktrace.trace_frame.launches[ktrace.phase_name(cfg, 2)] == 1
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
    packed, seed = pack_scene(scene, cfg.height, cfg.width)
    packed, hit = packed.detach(), hit.float()
    g = torch.randn(3, cfg.height, cfg.width, generator=torch.Generator().manual_seed(0))
    args = (packed, seed, cfg, cfg.height, t, hit, g.to(cuda))
    a, b = ktrace.trace_frame_bwd(*args), ktrace.trace_frame_bwd(*args)
    ref = ktrace.trace_bwd_reference(*args)
    f32_args = (packed, seed, dataclasses.replace(cfg, march_bf16=False), *args[3:])
    f32 = ktrace.trace_frame_bwd(*f32_args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.isfinite(a).all() and within_bwd_tolerance(a, ref)
    assert not within_bwd_tolerance(f32, ref)
