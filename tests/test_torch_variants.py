"""The march variants of the trace kernel in the PyTorch port:
``march_mode`` "fixed" (no early exit) and "lod" (a certified coarse-field
phase before the fine march), and ``march_bf16`` (bf16 blend math in the
march field), on the heightfield and on the volumetric terrain, against the
JAX package's Pallas kernel in interpret mode. On the CPU ``trace_frame``
runs its plain version; the CUDA kernel is held to that plain version by
tests/test_torch_cuda.py (on a GPU) and chip_smoke.py.

Contracts, at 64x128, 3 octaves, 64 steps:

* fixed and lod against JAX: the image contract of tests/test_torch_trace.py
  (99.9% of colour values within 2e-3, 99% within 1e-5, hit masks agreeing on
  more than 99.5% of pixels, t within 5e-2 on 99.9% of the pixels both hit).
* fixed equals chunked (unprimed) bit for bit: a finished lane never changes
  state, so running on changes nothing.
* lod against chunked: the JAX variant contract (tests/test_pallas.py: 97%
  within 5e-2, 95% within 1e-3); f_coarse - margin <= f_full at 10^4 points.
* bf16: ``noise2_value_bf16`` equals JAX's run op by op bit for bit; the
  image against the float32 march and against JAX's bf16 march has a mean
  error under 5e-3 and flips under 1% of hit verdicts (tests/test_pallas.py).
* Gradients: the one backward serves every variant: fixed gives chunked's
  gradients exactly, and under every variant the backward kernel's plain
  version agrees with autograd through the plain re-shade at rtol 2e-4,
  atol 1e-6 (tests/test_torch_bwd.py). Against JAX: lod's (and chunked's)
  leaf gradients against ``jax.grad`` of ``render_pallas``, each side on its
  own march; bf16's backward (its march channel through the bf16 field) at
  JAX's own bf16 frame against ``_backward_pallas``, and the re-shade
  backward (float32 field) against JAX's ``pallas_bwd=False``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpgpuraytrace_tpu.kernels.trace import _backward_pallas, _render_pallas_raw, render_pallas
from gpgpuraytrace_tpu.models.scene import RenderConfig as JaxConfig
from gpgpuraytrace_tpu.models.scene import default_scene as jax_default_scene
from gpgpuraytrace_tpu.ops.fit import partition_scene as jax_partition_scene
from gpgpuraytrace_tpu.ops import noise as jn
from gpgpuraytrace_tpu_torch.kernels import trace as ktrace
from gpgpuraytrace_tpu_torch.models.scene import RenderConfig, default_scene
from gpgpuraytrace_tpu_torch.ops import noise as tn
from gpgpuraytrace_tpu_torch.utils.convert import scene_from_numpy
from gpgpuraytrace_tpu_torch.utils.packing import pack_scene

torch.set_num_threads(2)

H, W, OCT, STEPS = 64, 128, 3, 64
TERRAINS = ("heightfield", "volumetric")
VARIANTS = {
    "chunked": {},
    "unprimed": {"prime_ds": 0},
    "fixed": {"march_mode": "fixed"},
    "lod": {"march_mode": "lod"},
    "bf16": {"march_bf16": True},
}


def configs(terrain: str, variant: str):
    kw = dict(height=H, width=W, max_steps=STEPS, num_octaves=OCT,
              volumetric=terrain == "volumetric", **VARIANTS[variant])
    return RenderConfig(**kw), JaxConfig(**kw, use_pallas=True, interpret=True)


def jax_scene_dict(scene):
    flat, _ = jax.tree_util.tree_flatten_with_path(scene)
    return {".".join(p.name for p in path): np.asarray(leaf) for path, leaf in flat}


def assert_mostly_close(a, b, atol, frac, msg):
    close = np.abs(np.asarray(a) - np.asarray(b)) <= atol
    got = close.mean()
    assert got >= frac, f"{msg}: only {100 * got:.3f}% within {atol} (need {100 * frac}%)"


@pytest.fixture(scope="module")
def frames():
    """frames(side, terrain, variant) -> (color (h, w, 3), t, hit bool) as
    numpy, rendered once per module: side "port" through ``render_kernel_raw``
    (the plain version), side "jax" through ``_render_pallas_raw``."""
    cache = {}

    def get(side, terrain, variant):
        key = (side, terrain, variant)
        if key not in cache:
            cfg, jcfg = configs(terrain, variant)
            js = jax_default_scene(OCT, volumetric=cfg.volumetric)
            if side == "jax":
                out = _render_pallas_raw(js, jcfg)
            else:
                scene = scene_from_numpy(jax_scene_dict(js), device="cpu")
                out = ktrace.render_kernel_raw(scene, cfg)
            cache[key] = tuple(np.asarray(x) for x in out)
        return cache[key]

    return get


def assert_image_contract(got, ref, msg):
    """tests/test_torch_trace.py's contract between the port and JAX."""
    (color, t, hit), (j_color, j_t, j_hit) = got, ref
    assert_mostly_close(color, j_color, 2e-3, 0.999, f"{msg} image")
    assert_mostly_close(color, j_color, 1e-5, 0.99, f"{msg} image-exact")
    agree = (hit == j_hit).mean()
    assert agree > 0.995, f"{msg}: hit masks differ on {100 * (1 - agree):.2f}% px"
    both = hit & j_hit
    assert both.mean() > 0.3  # the frame really hits terrain
    assert_mostly_close(t[both], j_t[both], 5e-2, 0.999, f"{msg} hit t")


@pytest.mark.parametrize("terrain", TERRAINS)
@pytest.mark.parametrize("variant", ["fixed", "lod"])
def test_variant_matches_pallas_interpret(frames, variant, terrain):
    assert_image_contract(frames("port", terrain, variant), frames("jax", terrain, variant),
                          f"{terrain} {variant}")


@pytest.mark.parametrize("terrain", TERRAINS)
def test_fixed_equals_chunked_bitwise(frames, terrain):
    for got, ref in zip(frames("port", terrain, "fixed"), frames("port", terrain, "unprimed")):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("terrain", TERRAINS)
def test_lod_close_to_chunked(frames, terrain):
    """tests/test_pallas.py's variant contract: lod parks rays on the coarse
    field and then marches the full one, so grazing hits may bracket
    differently; the bulk of the image is identical to 1e-3."""
    lod, base = frames("port", terrain, "lod")[0], frames("port", terrain, "chunked")[0]
    assert_mostly_close(lod, base, 5e-2, 0.97, f"{terrain} lod vs chunked")
    assert_mostly_close(lod, base, 1e-3, 0.95, f"{terrain} lod vs chunked bulk")


@pytest.mark.parametrize("terrain", TERRAINS)
def test_lod_coarse_field_is_a_lower_bound(terrain):
    """f_coarse - margin <= f_full at 10^4 seeded points: the certificate that
    lets lod's phase 1 step on the coarse field without passing a surface."""
    cfg, _ = configs(terrain, "lod")
    scene = default_scene(OCT, volumetric=cfg.volumetric, device="cpu")
    packed, seed = pack_scene(scene, H, W)
    packed = packed.detach()
    rng = np.random.default_rng(11)
    n = 10_000
    o = tuple(torch.from_numpy(rng.uniform(lo, hi, n).astype(np.float32))
              for lo, hi in ((-80.0, 80.0), (-10.0, 12.0), (-80.0, 80.0)))
    d = (torch.zeros(n), -torch.ones(n), torch.zeros(n))
    t = torch.zeros(n)

    def sc(k):
        return packed[0, k]

    with torch.no_grad():
        _, field_at = ktrace._field_fns(sc, packed, seed[0, 0], cfg, o, d)
        coarse_at, margin = ktrace._coarse_field(sc, packed, seed[0, 0], cfg, o, d)
        f_full, f_coarse = field_at(t), coarse_at(t)
    assert margin.item() > 0.0
    assert (f_coarse - margin <= f_full).all()
    # The bound is not vacuous: the coarse field is within the margin.
    assert ((f_coarse - f_full).abs() <= margin).all()


def test_noise2_value_bf16_matches_jax():
    """Port and JAX round the bf16 blend after every operation in the same
    order, so they agree bit for bit with JAX run op by op. Under jit, XLA's
    CPU fusion keeps the chain in float32 and rounds once, which moves a
    result by at most one bf16 unit of the blend (2^-8 for blends in
    [0.5, 1)) times 1/sqrt(5): under 2e-3 here."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-60.0, 60.0, 20_000).astype(np.float32)
    z = rng.uniform(-60.0, 60.0, 20_000).astype(np.float32)
    got = tn.noise2_value_bf16(torch.from_numpy(x), torch.from_numpy(z),
                               torch.tensor(7, dtype=torch.int32)).numpy()
    with jax.disable_jit():
        eager = np.asarray(jn.noise2_value_bf16(jnp.asarray(x), jnp.asarray(z), jnp.int32(7)))
    np.testing.assert_array_equal(got, eager)
    fused = np.asarray(jax.jit(jn.noise2_value_bf16)(jnp.asarray(x), jnp.asarray(z),
                                                      jnp.int32(7)))
    assert np.abs(got - fused).max() < 2e-3
    f32 = tn.noise2_value(torch.from_numpy(x), torch.from_numpy(z),
                          torch.tensor(7, dtype=torch.int32)).numpy()
    assert 0.0 < np.abs(got - f32).max() < 0.1  # bf16 really rounds


@pytest.mark.parametrize("terrain", TERRAINS)
@pytest.mark.parametrize("ref", ["port_f32", "jax_bf16"])
def test_bf16_march_contract(frames, terrain, ref):
    color, _, hit = frames("port", terrain, "bf16")
    if ref == "port_f32":
        r_color, _, r_hit = frames("port", terrain, "chunked")
    else:
        r_color, _, r_hit = frames("jax", terrain, "bf16")
    err = np.abs(color - r_color).mean()
    flips = (hit != r_hit).mean()
    assert err < 5e-3, f"bf16 march mean image error {err:.2e} vs {ref}"
    assert flips < 0.01, f"bf16 march flipped {flips:.3%} of hit verdicts vs {ref}"


def _leaf_grads(cfg, scene=None):
    if scene is None:
        scene = default_scene(OCT, volumetric=cfg.volumetric, device="cpu")
    img = ktrace.render_kernel(scene, cfg)
    torch.mean(img * torch.cos(img)).backward()
    return {n: p.grad for n, p in scene.named_parameters() if p.grad is not None}


def grad_configs(terrain: str, variant: str):
    """The gradient tests' configs: 32 rows, 32 steps, unprimed."""
    return tuple(dataclasses.replace(c, height=32, max_steps=32, prime_ds=0)
                 for c in configs(terrain, variant))


def _f32_field_kernel_grads(cfg):
    """The backward kernel's plain version with the float32 march channel
    (``march_bf16`` off) at the bf16 frame's own (t, hit) and loss cotangent:
    what the plain re-shade differentiates under ``march_bf16``."""
    scene = default_scene(OCT, volumetric=cfg.volumetric, device="cpu")
    img, t, hit = ktrace.render_kernel_raw(scene, cfg)
    img = img.requires_grad_()
    (g,) = torch.autograd.grad(torch.mean(img * torch.cos(img)), img)
    packed, seed = pack_scene(scene, cfg.height, cfg.width)
    pbar = ktrace.trace_frame_bwd(packed.detach(), seed, dataclasses.replace(cfg, march_bf16=False),
                                  cfg.height, t, hit.float(), g.permute(2, 0, 1).contiguous())
    packed.backward(pbar)
    return {n: p.grad for n, p in scene.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("terrain", TERRAINS)
@pytest.mark.parametrize("variant", ["fixed", "lod", "bf16"])
def test_variant_gradients(variant, terrain):
    """The backward takes the saved (t, hit), whatever march found them.
    fixed marches to the same (t, hit) as chunked and so gets its gradients
    exactly. lod and bf16 end some grazing rays elsewhere (tests above), so
    their gradients are held to the other backward route on the same frame:
    the backward kernel's plain version against autograd through the plain
    re-shade at rtol 2e-4, atol 1e-6. Under bf16 the kernel route pulls its
    march channel through the bf16 field and the re-shade through the
    float32 field (as JAX's two routes do), so the re-shade is held to the
    kernel route with the float32 field on the same frame, and the bf16
    kernel route must differ from it."""
    cfg = grad_configs(terrain, variant)[0]
    by_kernel = _leaf_grads(cfg)
    by_reshade = _leaf_grads(dataclasses.replace(cfg, kernel_bwd=False))
    assert by_kernel.keys() >= {"noise.amplitudes", "camera.yaw"}
    if variant == "bf16":
        bf16_route, by_kernel = by_kernel, _f32_field_kernel_grads(cfg)
        amps = "noise.amplitudes"
        gap = (bf16_route[amps] - by_kernel[amps]).abs().max() / by_kernel[amps].abs().max()
        assert gap > 1e-3, f"the bf16 march channel moved amplitudes by only {gap:.2e}"
    for name, ref in by_reshade.items():
        np.testing.assert_allclose(by_kernel[name].numpy(), ref.numpy(), rtol=2e-4,
                                   atol=1e-6, err_msg=name)
    if variant == "fixed":
        chunked = _leaf_grads(dataclasses.replace(cfg, march_mode="chunked"))
        assert chunked.keys() == by_kernel.keys()
        for name, ref in chunked.items():
            assert torch.equal(by_kernel[name], ref), name


@pytest.mark.parametrize("terrain", TERRAINS)
@pytest.mark.parametrize("variant", ["unprimed", "lod"])
def test_variant_gradients_match_pallas_interpret(variant, terrain):
    """render_kernel's leaf gradients against jax.grad of render_pallas in
    interpret mode under the same march. Each side marches its own (t, hit);
    they agree to the last bits (lod's t within 1e-2 where both hit, no hit
    flips at this size), which moves a leaf's gradient by up to 1.2e-3 of its
    largest component under lod and 6.6e-4 under chunked. So: every entry
    within rtol 2e-4 plus 2e-3 of the leaf's largest, where the JAX suite's
    rtol 2e-4, atol 1e-6 (which holds on a shared (t, hit),
    tests/test_torch_bwd.py) does not hold for chunked either."""
    cfg, jcfg = grad_configs(terrain, variant)
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


def _bf16_saved(frames, terrain):
    """JAX's own bf16 frame's (t, hit), a seeded colour cotangent, the JAX
    scene and the configs."""
    cfg, jcfg = configs(terrain, "bf16")
    _, t, hit = (np.array(x) for x in frames("jax", terrain, "bf16"))
    g = np.random.default_rng(13).standard_normal((H, W, 3)).astype(np.float32)
    return cfg, jcfg, t, hit, g, jax_default_scene(OCT, volumetric=cfg.volumetric)


def _port_bwd_grads(js, cfg, t, hit, g):
    """The port's backward kernel (its plain version here) at (t, hit, g),
    pulled back to the scene's leaves."""
    scene = scene_from_numpy(jax_scene_dict(js), device="cpu")
    packed, seed = pack_scene(scene, H, W)
    pbar = ktrace.trace_frame_bwd(
        packed.detach(), seed, cfg, H, torch.from_numpy(t),
        torch.from_numpy(hit.astype(np.float32)),
        torch.from_numpy(np.ascontiguousarray(np.moveaxis(g, -1, 0))))
    packed.backward(pbar)
    return {n: p.grad.numpy() for n, p in scene.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("terrain", TERRAINS)
def test_bf16_backward_matches_backward_pallas(frames, terrain):
    """Under march_bf16 the backward's march channel pulls back through the
    bf16 value field, as JAX's _trace_bwd_kernel does (``field_at``), with
    the rounded bf16 cotangents of ``ops/noise.py:noise2_value_bf16``. On
    JAX's own bf16 frame's (t, hit) and a seeded cotangent, against
    _backward_pallas with march_bf16: every entry within 2.5e-2 of its
    leaf's largest (measured: at most 1.8e-2, camera.yaw). The rest is
    rounding: JAX's interpret mode runs the kernel under jit, where XLA's
    fusion rounds the bf16 chain once (ROADMAP.md C), and a grazing ray's
    1/(grad f . d) magnifies a bf16 unit. The float32-field backward, which
    the port ran before, misses JAX's by up to 64% of a leaf's largest (8-25%
    on the noise leaves), so on every leaf where that gap exceeds 1e-3 of
    the largest the bf16 backward must be at least 5x closer (measured: 7x to
    1170x). Leaves the march channel does not reach (materials, height
    offset, the warp) are equal either way."""
    cfg, jcfg, t, hit, g, js = _bf16_saved(frames, terrain)
    ref = jax_scene_dict(_backward_pallas(js, jcfg, jnp.asarray(t), jnp.asarray(hit),
                                          jnp.asarray(g), 0.0, None))
    got = _port_bwd_grads(js, cfg, t, hit, g)
    f32 = _port_bwd_grads(js, dataclasses.replace(cfg, march_bf16=False), t, hit, g)
    assert got.keys() >= {"noise.amplitudes", "camera.yaw"}
    for name, value in got.items():
        scale = float(np.abs(ref[name]).max())
        np.testing.assert_allclose(value, ref[name], rtol=0, atol=2.5e-2 * scale, err_msg=name)
        if scale == 0.0:
            continue
        gap = np.abs(value - ref[name]).max() / scale
        gap_f32 = np.abs(f32[name] - ref[name]).max() / scale
        if gap_f32 > 1e-3:
            assert gap_f32 >= 5.0 * gap, (
                f"{name}: bf16 backward {gap:.2e} of the largest entry from JAX's, the "
                f"float32-field one {gap_f32:.2e}: less than 5x closer")


@pytest.mark.parametrize("terrain", TERRAINS)
def test_bf16_reshade_backward_matches_pallas_bwd_false(frames, terrain):
    """``kernel_bwd=False`` differentiates the float32 field whatever the
    march's field, as JAX's ``pallas_bwd=False`` (``render_from_checkpoint``)
    does; so under march_bf16 the port's re-shade backward equals JAX's on a
    shared (t, hit): every entry within rtol 2e-4 plus 2e-4 of its leaf's
    largest (the bf16 frame's grazing rays magnify summation order)."""
    from gpgpuraytrace_tpu.ops.render import render_from_checkpoint as jax_from_checkpoint
    from gpgpuraytrace_tpu_torch.ops.render import render_from_checkpoint

    cfg, jcfg, t, hit, g, js = _bf16_saved(frames, terrain)
    jcfg = dataclasses.replace(jcfg, pallas_bwd=False)
    _, pull = jax.vjp(lambda s: jax_from_checkpoint(s, jcfg, jnp.asarray(t), jnp.asarray(hit),
                                                    0.0, None), js)
    ref = jax_scene_dict(pull(jnp.asarray(g))[0])
    scene = scene_from_numpy(jax_scene_dict(js), device="cpu")
    img = render_from_checkpoint(scene, dataclasses.replace(cfg, kernel_bwd=False),
                                 torch.from_numpy(t), torch.from_numpy(hit))
    img.backward(torch.from_numpy(g))
    grads = {n: p.grad.numpy() for n, p in scene.named_parameters() if p.grad is not None}
    assert grads.keys() >= {"noise.amplitudes", "camera.yaw"}
    for name, value in grads.items():
        scale = float(np.abs(ref[name]).max())
        np.testing.assert_allclose(value, ref[name], rtol=2e-4, atol=2e-4 * scale, err_msg=name)
