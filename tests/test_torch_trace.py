"""The trace kernel module of the PyTorch port.

On a CPU the wrapper runs the kernel's plain PyTorch version, which is held
here to the JAX package's Pallas kernel run in interpret mode, with the JAX
suite's own contracts (tests/test_pallas.py): at least 99.9% of colour values
within 2e-3 and 99% within 1e-5, hit masks agreeing on more than 99.5% of
pixels, and t within 5e-2 on 99.9% of the pixels both sides hit. The CUDA
kernel itself is compared with the plain version by tests/test_torch_cuda.py
(on a GPU) and by chip_smoke.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from gpgpuraytrace_tpu.kernels.trace import _render_pallas_raw
from gpgpuraytrace_tpu.models.scene import RenderConfig as JaxConfig
from gpgpuraytrace_tpu.models.scene import default_scene as jax_default_scene
from gpgpuraytrace_tpu_torch import cli
from gpgpuraytrace_tpu_torch.kernels import build
from gpgpuraytrace_tpu_torch.kernels import trace as ktrace
from gpgpuraytrace_tpu_torch.models.scene import RenderConfig
from gpgpuraytrace_tpu_torch.utils.convert import scene_from_numpy
from gpgpuraytrace_tpu_torch.utils.packing import pack_scene

torch.set_num_threads(2)

CFG = RenderConfig(height=64, width=128, max_steps=64, num_octaves=3)
JCFG = JaxConfig(height=64, width=128, max_steps=64, num_octaves=3,
                 use_pallas=True, interpret=True)


def jax_scene_dict(scene):
    flat, _ = jax.tree_util.tree_flatten_with_path(scene)
    return {".".join(p.name for p in path): np.asarray(leaf) for path, leaf in flat}


def assert_mostly_close(a, b, atol, frac, msg):
    close = np.abs(np.asarray(a) - np.asarray(b)) <= atol
    got = close.mean()
    assert got >= frac, f"{msg}: only {100 * got:.3f}% within {atol} (need {100 * frac}%)"


@pytest.fixture(scope="module")
def scene():
    return scene_from_numpy(jax_scene_dict(jax_default_scene(num_octaves=3)), device="cpu")


@pytest.fixture(scope="module")
def port_full(scene):
    return ktrace.render_kernel_raw(scene, CFG)


@pytest.mark.parametrize(
    "kw", [{}, {"march_eps_scale": 4.0}], ids=["default", "residual_verdict"]
)
def test_render_kernel_raw_matches_pallas_interpret(scene, kw):
    launches = ktrace.trace_frames.launches.total()
    color, t, hit = ktrace.render_kernel_raw(scene, dataclasses.replace(CFG, **kw))
    j_color, j_t, j_hit = _render_pallas_raw(
        jax_default_scene(num_octaves=3), dataclasses.replace(JCFG, **kw)
    )
    # The plain version ran: a CPU tensor never launches the CUDA kernel.
    assert ktrace.trace_frames.launches.total() == launches == 0
    assert tuple(color.shape) == (64, 128, 3) and hit.dtype == torch.bool
    assert_mostly_close(color, j_color, 2e-3, 0.999, "image")
    assert_mostly_close(color, j_color, 1e-5, 0.99, "image-exact")
    hit, j_hit = hit.numpy(), np.asarray(j_hit)
    agree = (hit == j_hit).mean()
    assert agree > 0.995, f"hit masks differ on {100 * (1 - agree):.2f}% px"
    both = hit & j_hit
    assert_mostly_close(t.numpy()[both], np.asarray(j_t)[both], 5e-2, 0.999, "hit t")


def test_row_band_equals_frame_slice(scene, port_full):
    """A row band rendered with row0 != 0 equals that slice of the full frame
    (its coarse pass renders the band's own halo rows)."""
    band, t_band, _ = ktrace.render_kernel_raw(scene, CFG, row0=32.0, local_height=32)
    np.testing.assert_allclose(band.numpy(), port_full[0].numpy()[32:64],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t_band.numpy(), port_full[1].numpy()[32:64],
                               rtol=1e-4, atol=1e-5)


def _inputs(scene, cfg=CFG):
    packed, seed = pack_scene(scene, cfg.height, cfg.width)
    prime = torch.full((1, cfg.height, cfg.width), cfg.t_min)
    return packed.detach(), seed, prime


@pytest.mark.parametrize(
    "case",
    ["dtype", "shape", "seed_dtype", "noncontig", "prime_shape", "prime_missing",
     "prime_unexpected"],
)
def test_trace_frame_rejects_bad_inputs(scene, case):
    packed, seed, prime = _inputs(scene)
    cfg = CFG
    if case == "dtype":
        packed = packed.double()
    elif case == "shape":
        packed = packed[:, :-1].contiguous()
    elif case == "seed_dtype":
        seed = seed.long()
    elif case == "noncontig":
        prime = torch.full((1, CFG.width, CFG.height), CFG.t_min).transpose(1, 2)
    elif case == "prime_shape":
        prime = prime[:, :-1]
    elif case == "prime_missing":
        prime = None
    else:
        cfg = dataclasses.replace(CFG, prime_ds=0)
    with pytest.raises(ValueError):
        ktrace.trace_frames(packed, seed, cfg, CFG.height, prime)


def test_trace_frame_is_forward_only(scene):
    packed, seed, prime = _inputs(scene)
    with pytest.raises(RuntimeError, match="forward only.*render_kernel"):
        ktrace.trace_frames(packed.requires_grad_(), seed, CFG, CFG.height, prime)


@pytest.mark.parametrize("case", ["t_shape", "hit_dtype", "g_shape", "g_noncontig"])
def test_trace_frame_bwd_rejects_bad_inputs(scene, case):
    packed, seed, _ = _inputs(scene)
    t = torch.ones(1, CFG.height, CFG.width)
    hit = torch.zeros(1, CFG.height, CFG.width)
    g = torch.zeros(1, 3, CFG.height, CFG.width)
    if case == "t_shape":
        t = t[:, :-1]
    elif case == "hit_dtype":
        hit = hit.bool()
    elif case == "g_shape":
        g = g[:, :2]
    else:
        # Neither contiguous nor the (B, h, W, 3) view the kernel also reads.
        g = torch.zeros(1, 3, CFG.width, CFG.height).transpose(2, 3)
    with pytest.raises(ValueError):
        ktrace.trace_frames_bwd(packed, seed, CFG, CFG.height, t, hit, g)


@pytest.mark.parametrize("debug_steps", [False, True], ids=["compact", "compact_debug_steps"])
def test_unported_variants_raise(scene, debug_steps):
    """Compaction runs through both wrappers (its frame equals the unprimed
    chunked frame, tests/test_torch_compact.py); its step counter is refused
    as the JAX package refuses it."""
    cfg = dataclasses.replace(CFG, march_mode="compact")
    packed, seed, _ = _inputs(scene)
    if debug_steps:
        with pytest.raises(ValueError, match="debug_steps"):
            ktrace.trace_frames(packed, seed, cfg, CFG.height, debug_steps=True)
        with pytest.raises(ValueError, match="debug_steps"):
            ktrace.trace_frames_reference(packed, seed, cfg, CFG.height, debug_steps=True)
        return
    color, t, hit = ktrace.trace_frames(packed, seed, cfg, CFG.height)
    ref = ktrace.trace_frames_reference(packed, seed, cfg, CFG.height)
    assert color.shape == (1, 3, CFG.height, CFG.width) and torch.isfinite(color).all()
    for a, b in zip((color, t, hit), ref):
        assert torch.equal(a, b)
    assert 0.3 < hit.mean().item() < 1.0


@pytest.mark.parametrize("warp_octaves", [0, ktrace.MAX_WARP_OCTAVES + 1])
def test_volumetric_warp_octaves_out_of_range_raise(scene, warp_octaves):
    cfg = dataclasses.replace(CFG, prime_ds=0, volumetric=True, warp_octaves=warp_octaves)
    packed, seed, _ = _inputs(scene)
    with pytest.raises(ValueError, match="warp_octaves"):
        ktrace.trace_frames(packed, seed, cfg, CFG.height)
    t = torch.ones(1, CFG.height, CFG.width)
    hit = torch.zeros(1, CFG.height, CFG.width)
    g = torch.zeros(1, 3, CFG.height, CFG.width)
    with pytest.raises(ValueError, match="warp_octaves"):
        ktrace.trace_frames_bwd(packed, seed, cfg, CFG.height, t, hit, g)


def test_no_fallback_without_cuda(monkeypatch, tmp_path):
    # No CUDA here: building the kernel library raises, it never falls back.
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build.build_library()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build.load_library()
    # With CUDA but no nvcc, the build raises too.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_library()


def test_a_built_library_returns_its_compiler_log(monkeypatch, tmp_path):
    """A library built earlier comes back with the ptxas report that its
    build kept beside it, so a later run can still read the registers."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    out = build.build_dir()
    out.mkdir(parents=True)
    (out / build.LIB_NAME).write_bytes(b"")
    (out / build.LOG_NAME).write_text("ptxas info    : Used 117 registers")
    assert build.build_library() == (out / build.LIB_NAME,
                                     "ptxas info    : Used 117 registers")


def test_editing_a_header_changes_the_build_directory(monkeypatch, tmp_path):
    """The build hash covers every file in csrc/, headers too, but only the
    .cu files are compiled: an edited header must not load a stale library."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in build.CSRC.iterdir():
        (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    assert [p.name for p in build._sources()] == [
        "pack.cu", "quantize.cu", "trace_bwd.cu", "trace_compact.cu", "trace_fwd.cu"]
    before = build.build_dir()
    assert build.build_dir() == before  # stable for the same sources
    header = csrc / "field.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert build.build_dir() != before


def test_cli_render_on_cuda_raises_without_cuda(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["render", "--device", "cuda", "--size", "64",
                  "-o", str(tmp_path / "f.png")])


@pytest.mark.parametrize("local_height, width", [(512, 512), (66, 64), (37, 100), (1, 512),
                                                 (3, 5)])
def test_warp_tiles_cover_every_pixel_once(local_height, width):
    """The forward kernel's tile -> pixel map (kernels/trace.py mirrors
    csrc/trace_fwd.cu): every pixel of the band in exactly one lane of one
    tile, each tile a WARP_TILE block of the band, the lanes past its edge
    masked."""
    ids = ktrace.warp_tile_pixels(local_height, width)
    rows, cols = ktrace.WARP_TILE
    assert ids.shape == (-(-local_height // rows) * -(-width // cols), ktrace.WARP)
    listed = ids[ids >= 0]
    assert torch.equal(listed.sort().values, torch.arange(local_height * width))
    for tile in ids:
        r, c = tile[tile >= 0] // width, tile[tile >= 0] % width
        assert r.max() - r.min() < rows and c.max() - c.min() < cols


def test_warp_tiles_of_row_bands_make_the_frame(scene):
    """Row bands (row0, local_height), as trace_frames takes them for sharding:
    each band's tiles cover its own rows once, the bands together the frame,
    and the counter's warp reduction runs per band."""
    cfg = dataclasses.replace(CFG, prime_ds=0)
    covered = torch.zeros(cfg.height * cfg.width, dtype=torch.int32)
    for row0, h in ((0, 13), (13, 37), (50, 14)):
        ids = ktrace.warp_tile_pixels(h, cfg.width)
        covered[ids[ids >= 0] + row0 * cfg.width] += 1
        packed, seed = pack_scene(scene, cfg.height, cfg.width, float(row0))
        *_, (steps,) = ktrace.trace_frames(packed.detach(), seed, cfg, h, debug_steps=True)
        warps = ktrace.warp_steps(steps)
        assert warps.shape == (ids.shape[0],)
        assert (warps == torch.where(ids >= 0, steps.reshape(-1)[ids.clamp(min=0)], 0)
                .amax(dim=1)).all()
    assert (covered == 1).all()

