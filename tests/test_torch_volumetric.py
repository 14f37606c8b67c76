"""The volumetric terrain of the PyTorch port (the 3D fBm warp) against the
JAX package, on the CPU, where the trace kernels' wrappers run their plain
versions. Sizes as in tests/test_volumetric.py: 32x64, 2 octaves, 64 steps,
the default RenderConfig otherwise (step relax 0.9).

* 3D hash equal as integers; noise3/fbm3 values and derivatives to 1e-6 (as
  tests/test_torch_noise.py); the hand-derived noise3 Hessian the CUDA
  backward uses against autograd at rtol 1e-5, atol 2e-5.
* Field, envelope, normal and shading against the JAX package to 1e-5.
* Images: 99.9% of values within 2e-3 and 99% within 1e-5, primed and
  unprimed, for both routes (tests/test_pallas.py's contract).
* ``trace_frames_bwd`` against ``_backward_pallas`` (interpret) on every leaf
  at rtol 2e-4, atol 1e-6 (tests/test_volumetric.py); render gradients
  against ``jax.grad`` of ``render_jax`` as tests/test_torch_bwd.py holds
  them. The warp leaves' gradients are non-zero.
* Per-pixel dt/d(warp_amplitude): the implicit-function VJP against central
  differences at rtol 0.01 (tests/test_volumetric.py).
The CUDA kernels themselves are held to the plain versions by
tests/test_torch_cuda.py (on a GPU) and chip_smoke.py.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpgpuraytrace_tpu.kernels.trace import _backward_pallas, _render_pallas_raw
from gpgpuraytrace_tpu.models.scene import RenderConfig as JaxConfig
from gpgpuraytrace_tpu.models.scene import default_scene as jax_default_scene
from gpgpuraytrace_tpu.ops import camera as jcam
from gpgpuraytrace_tpu.ops import field as jfield
from gpgpuraytrace_tpu.ops import noise as jn
from gpgpuraytrace_tpu.ops import shade as jshade
from gpgpuraytrace_tpu.ops.fit import partition_scene as jax_partition_scene
from gpgpuraytrace_tpu.ops.render import render_jax
from gpgpuraytrace_tpu_torch import RenderConfig, cli, default_scene, render
from gpgpuraytrace_tpu_torch.kernels import trace as ktrace
from gpgpuraytrace_tpu_torch.ops import field as tfield
from gpgpuraytrace_tpu_torch.ops import march as tmarch
from gpgpuraytrace_tpu_torch.ops import noise as tn
from gpgpuraytrace_tpu_torch.ops import shade as tshade
from gpgpuraytrace_tpu_torch.ops.camera import generate_rays
from gpgpuraytrace_tpu_torch.ops.fd_check import scene_with
from gpgpuraytrace_tpu_torch.utils.convert import scene_from_numpy
from gpgpuraytrace_tpu_torch.utils.packing import pack_scene

torch.set_num_threads(2)

H, W, OCT = 32, 64, 2
CFG = RenderConfig(height=H, width=W, max_steps=64, num_octaves=OCT, volumetric=True)
JCFG = JaxConfig(height=H, width=W, max_steps=64, num_octaves=OCT, volumetric=True,
                 use_pallas=False)
# 32 rows are below the automatic prime rule's 64, so the primed cases set
# prime_ds 4 (coarse pass 10x16) on both sides.
PRIME = {"unprimed": 0, "primed": 4}
WARP_LEAVES = ("noise.warp_amplitude", "noise.warp_frequency")


def jax_scene_dict(scene):
    flat, _ = jax.tree_util.tree_flatten_with_path(scene)
    return {".".join(p.name for p in path): np.asarray(leaf) for path, leaf in flat}


def port_scene():
    return scene_from_numpy(jax_scene_dict(jax_default_scene(OCT, volumetric=True)),
                            device="cpu")


def leaf_grads(scene):
    return {n: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
            for n, p in scene.named_parameters()}


def assert_mostly_close(a, b, atol, frac, msg):
    close = np.abs(np.asarray(a) - np.asarray(b)) <= atol
    got = close.mean()
    assert got >= frac, f"{msg}: only {100 * got:.3f}% within {atol} (need {100 * frac}%)"


def assert_image_close(a, b, msg):
    assert_mostly_close(a, b, 2e-3, 0.999, msg)
    assert_mostly_close(a, b, 1e-5, 0.99, f"{msg} (exact)")


# --- 3D noise -------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, -3, 2**31 - 1])
def test_corner_hashes3_equal_as_integers(seed):
    rng = np.random.default_rng(0)
    ix, iy, iz = (rng.integers(-300, 300, 2048).astype(np.int32) for _ in range(3))
    s = np.int32(seed)
    ref = jn._corner_hashes3(jnp.asarray(ix), jnp.asarray(iy), jnp.asarray(iz), jnp.int32(s))
    got = tn._corner_hashes3(torch.from_numpy(ix), torch.from_numpy(iy),
                             torch.from_numpy(iz), torch.tensor(s))
    assert len(got) == len(ref) == 8
    for r, g in zip(ref, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_array_equal(
            np.stack(tn._grad3_raw(g)), np.stack([np.asarray(x) for x in jn._grad3_raw(r)])
        )


def _points3(seed, n=4096, scale=20.0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-scale, scale, n).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("fn", ["noise3", "noise3_value", "fbm3", "fbm3_value"])
def test_noise3_values_and_derivatives_match(fn):
    pts = _points3(1)
    tp = [torch.from_numpy(p) for p in pts]
    jp = [jnp.asarray(p) for p in pts]
    seed = np.int32(7)
    if fn.startswith("noise3"):
        ref = getattr(jn, fn)(*jp, jnp.int32(seed))
        got = getattr(tn, fn)(*tp, torch.tensor(seed))
    else:  # the warp's octave stack: 2 octaves, lacunarity 2, gain 0.5
        ref = getattr(jn, fn)(*jp, 2, 2.0, 0.5, jnp.int32(seed))
        got = getattr(tn, fn)(*tp, 2, 2.0, 0.5, torch.tensor(seed))
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-6)


def test_noise3_hessian_matches_autograd():
    pts = [torch.from_numpy(p) for p in _points3(3)]
    req = [p.clone().requires_grad_() for p in pts]
    _, *grads = tn.noise3(*req, 7)
    rows = [torch.autograd.grad(gk.sum(), req, retain_graph=True) for gk in grads]
    hess = tn.noise3_hessian(*pts, 7)
    pairs = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    # float32 rounding of two formulas for the same polynomial; each mixed
    # entry against both of autograd's (symmetric) entries.
    for got, (a, b) in zip(hess, pairs):
        for want in (rows[a][b], rows[b][a]):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=2e-5)
    assert max(h.abs().max() for h in hess) > 1.0  # the lattice really curves


# --- field and shading ---------------------------------------------------------------


@pytest.fixture(scope="module")
def scenes():
    js = jax_default_scene(num_octaves=3, volumetric=True)
    return js, scene_from_numpy(jax_scene_dict(js), device="cpu")


def close(got, ref, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(ref), rtol=0, atol=atol)


def test_field_grad_envelope_and_normal(scenes):
    js, ts = scenes
    rng = np.random.default_rng(3)
    p = np.stack([rng.uniform(-60, 60, 2048), rng.uniform(-4, 10, 2048),
                  rng.uniform(-60, 60, 2048)], axis=-1).astype(np.float32)
    tp, jp = torch.from_numpy(p), jnp.asarray(p)
    tf, tg = tfield.field_and_grad(tp, ts.noise, True, 2)
    jf, jg = jfield.field_and_grad(jp, js.noise, True, 2)
    close(tf, jf)
    close(tg, jg)
    close(tfield.field(tp, ts.noise, True, 2), jfield.field(jp, js.noise, True, 2))
    close(tfield.surface_normal(tp, ts.noise, True, 2),
          jfield.surface_normal(jp, js.noise, True, 2))
    # The warp really bends the field: its y-gradient is no longer 1.
    assert np.abs(tg[..., 1].detach().numpy() - 1.0).max() > 0.1
    for octaves in (1, 2, 3):
        close(tfield.envelope_height(ts.noise, True, octaves),
              jfield.envelope_height(js.noise, True, octaves), 1e-6)


def test_shade_volumetric(scenes):
    js, ts = scenes
    rng = np.random.default_rng(4)
    jo, jd = jcam.generate_rays(js.camera, 32, 48)
    t = rng.uniform(0.05, 120.0, jd.shape[:-1]).astype(np.float32)
    hit = rng.random(jd.shape[:-1]) < 0.6
    ref = jshade.shade(jo, jd, jnp.asarray(t), jnp.asarray(hit), js.noise, js.materials,
                       True, 2)
    got = tshade.shade(torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jd)),
                       torch.from_numpy(t), torch.from_numpy(hit), ts.noise, ts.materials,
                       True, 2)
    close(got, ref)


# --- images ----------------------------------------------------------------------------


@pytest.mark.parametrize("prime", list(PRIME))
def test_render_torch_matches_render_jax(prime):
    cfg = dataclasses.replace(CFG, prime_ds=PRIME[prime], use_kernel=False)
    jcfg = dataclasses.replace(JCFG, prime_ds=PRIME[prime])
    ref = np.asarray(render_jax(jax_default_scene(OCT, volumetric=True), jcfg))
    img = render(port_scene(), cfg)
    assert tuple(img.shape) == (H, W, 3) and img.requires_grad
    assert_image_close(img.detach(), ref, f"render_torch {prime}")


@pytest.mark.parametrize("prime", list(PRIME))
def test_render_kernel_raw_matches_pallas_interpret(prime):
    cfg = dataclasses.replace(CFG, prime_ds=PRIME[prime])
    jcfg = dataclasses.replace(JCFG, prime_ds=PRIME[prime], use_pallas=True, interpret=True)
    launches = ktrace.trace_frames.launches.total()
    color, t, hit = ktrace.render_kernel_raw(port_scene(), cfg)
    j_color, j_t, j_hit = _render_pallas_raw(jax_default_scene(OCT, volumetric=True), jcfg)
    # The plain version ran: a CPU tensor never launches the CUDA kernel.
    assert ktrace.trace_frames.launches.total() == launches == 0
    assert_image_close(color, j_color, f"render_kernel_raw {prime}")
    hit, j_hit = hit.numpy(), np.asarray(j_hit)
    assert (hit == j_hit).mean() > 0.995
    both = hit & j_hit
    assert both.mean() > 0.3  # the frame really hits terrain
    assert_mostly_close(t.numpy()[both], np.asarray(j_t)[both], 5e-2, 0.999, "hit t")


def test_zero_warp_matches_heightfield():
    """With warp_amplitude 0 the volumetric config gives the heightfield
    image (tests/test_volumetric.py), on both routes."""
    scene = default_scene(OCT, device="cpu")  # warp_amplitude 0
    for use_kernel in (True, False):
        cfg = dataclasses.replace(CFG, use_kernel=use_kernel)
        img_v = render(scene, cfg).detach().numpy()
        img_h = render(scene, dataclasses.replace(cfg, volumetric=False)).detach().numpy()
        assert (np.abs(img_v - img_h) < 1e-4).mean() > 0.999, use_kernel


# --- backward ----------------------------------------------------------------------------


def test_trace_frame_bwd_matches_backward_pallas():
    rng = np.random.default_rng(11)
    t = rng.uniform(0.05, 80.0, (H, W)).astype(np.float32)
    hit = rng.random((H, W)) < 0.6
    g = rng.standard_normal((H, W, 3)).astype(np.float32)
    jcfg = dataclasses.replace(JCFG, use_pallas=True, interpret=True)
    ref = jax_scene_dict(_backward_pallas(
        jax_default_scene(OCT, volumetric=True), jcfg, jnp.asarray(t), jnp.asarray(hit),
        jnp.asarray(g), 0.0, None,
    ))
    scene = port_scene()
    packed, seed = pack_scene(scene, H, W)
    pbar = ktrace.trace_frames_bwd(
        packed.detach(), seed, CFG, H, torch.from_numpy(t)[None],
        torch.from_numpy(hit.astype(np.float32))[None],
        torch.from_numpy(np.ascontiguousarray(np.moveaxis(g, -1, 0)))[None],
    )
    assert ktrace.trace_frames_bwd.launches.total() == 0
    packed.backward(pbar)
    got = leaf_grads(scene)
    for name, value in got.items():
        np.testing.assert_allclose(value, ref[name], rtol=2e-4, atol=1e-6, err_msg=name)
    for name in WARP_LEAVES:
        assert got[name] != 0.0, name


@pytest.fixture(scope="module")
def jax_grads():
    scene = jax_default_scene(OCT, volumetric=True)
    leaves, merge = jax_partition_scene(scene, trainable=lambda name: True)

    def loss(lv):
        img = render_jax(merge(lv), JCFG)
        return jnp.mean(img * jnp.cos(img))  # a non-symmetric cotangent

    return jax_scene_dict(merge(jax.grad(loss)(leaves)))


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel_path", "plain_path"])
def test_render_grads_match_render_jax(jax_grads, use_kernel):
    scene = port_scene()
    img = render(scene, dataclasses.replace(CFG, use_kernel=use_kernel))
    torch.mean(img * torch.cos(img)).backward()
    got = leaf_grads(scene)
    for name, value in got.items():
        scale = float(np.max(np.abs(jax_grads[name])))
        np.testing.assert_allclose(value, jax_grads[name], rtol=2.5e-2, atol=1e-3 * scale,
                                   err_msg=name)
    for name in WARP_LEAVES:
        assert got[name] != 0.0, name


def test_warp_amplitude_ad_vs_fd():
    """Per-pixel dt/d(warp_amplitude) through the port's march: the
    implicit-function VJP against central differences on converged,
    hit-stable pixels (tests/test_volumetric.py's check and config: a
    whole-image loss gradient is FD-noise dominated here)."""
    cfg = dataclasses.replace(CFG, step_relax=0.4, prime_ds=0, use_kernel=False)
    scene = default_scene(OCT, volumetric=True, device="cpu")
    with torch.no_grad():
        o, d = generate_rays(scene.camera, H, W)

    def noise_at(theta):
        return scene_with(scene, "noise.warp_amplitude", theta).noise

    def residual(theta, t):
        with torch.no_grad():
            f = tfield.field(o + t[..., None] * d, noise_at(theta), True, cfg.warp_octaves)
        return f.abs().numpy()

    th0 = scene.noise.warp_amplitude.detach()
    eps = 2e-3
    with torch.no_grad():
        (tp, hp), (tm, hm), (t0, h0) = (tmarch.march(cfg, o, d, noise_at(th0 + s))
                                        for s in (eps, -eps, 0.0))
    converged = ((residual(th0 + eps, tp) < 1e-4) & (residual(th0 - eps, tm) < 1e-4)
                 & (residual(th0, t0) < 1e-4))
    stable = (hp & hm & h0).numpy() & ((tp - tm).abs() < 0.05).numpy() & converged
    assert stable.sum() > 100
    fd_sum = float(((tp - tm) / (2 * eps)).numpy()[stable].sum())
    theta = th0.clone().requires_grad_()
    t, _ = tmarch.march(cfg, o, d, noise_at(theta))
    (ad_sum,) = torch.autograd.grad((torch.from_numpy(stable.astype(np.float32)) * t).sum(),
                                    theta)
    assert np.isfinite(float(ad_sum)) and fd_sum != 0.0
    np.testing.assert_allclose(float(ad_sum), fd_sum, rtol=0.01)


# --- command line ----------------------------------------------------------------------


def test_cli_render_volumetric_writes_png(tmp_path, capsys):
    out = tmp_path / "frame.png"
    cli.main(["render", "--device", "cpu", "--volumetric", "--size", "64", "--octaves", "3",
              "-o", str(out)])
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and b"IEND" in data[-12:]
    assert "rendered 64x64 (3 octaves, volumetric" in capsys.readouterr().out


def test_cli_fit_volumetric(capsys):
    cli.main(["fit", "--device", "cpu", "--volumetric", "--size", "64x32", "--octaves", "2",
              "--max-steps", "64", "--steps", "4"])
    out = capsys.readouterr().out
    first, last = map(float, re.search(r"fit: loss (\S+) -> (\S+) over 4 steps", out).groups())
    assert last < first
