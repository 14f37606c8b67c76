"""The plain PyTorch march of the port against the JAX package's march, on
the same rays and the same prime map, with the JAX suite's own contracts
(tests/test_pallas.py): hit masks agree on more than 99.5% of pixels and t
agrees within 5e-2 on 99.9% of the pixels both sides hit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpgpuraytrace_tpu.models.scene import RenderConfig as JaxConfig
from gpgpuraytrace_tpu.models.scene import default_scene as jax_default_scene
from gpgpuraytrace_tpu.ops import march as jmarch
from gpgpuraytrace_tpu.ops.camera import generate_rays
from gpgpuraytrace_tpu.ops.render import prime_map_jax
from gpgpuraytrace_tpu_torch.models.scene import RenderConfig
from gpgpuraytrace_tpu_torch.ops import march as tmarch
from gpgpuraytrace_tpu_torch.utils.convert import scene_from_numpy

torch.set_num_threads(2)

CFG = RenderConfig(height=64, width=128, max_steps=64, num_octaves=3, use_kernel=False)
JCFG = JaxConfig(height=64, width=128, max_steps=64, num_octaves=3, use_pallas=False)


def jax_scene_dict(scene):
    flat, _ = jax.tree_util.tree_flatten_with_path(scene)
    return {".".join(p.name for p in path): np.asarray(leaf) for path, leaf in flat}


@pytest.fixture(scope="module")
def setup():
    js = jax_default_scene(num_octaves=3)
    o, d = generate_rays(js.camera, JCFG.height, JCFG.width)
    t0p = prime_map_jax(js, JCFG)
    ts = scene_from_numpy(jax_scene_dict(js), device="cpu")
    return js, ts, (o, d, t0p)


def check_march(t, hit, t_ref, hit_ref):
    t, hit = t.detach().numpy(), hit.numpy()
    t_ref, hit_ref = np.asarray(t_ref), np.asarray(hit_ref)
    agree = (hit == hit_ref).mean()
    assert agree > 0.995, f"hit masks differ on {100 * (1 - agree):.2f}% px"
    both = hit & hit_ref
    assert both.mean() > 0.3  # the frame really hits terrain
    close = np.abs(t[both] - t_ref[both]) <= 5e-2
    assert close.mean() >= 0.999, f"hit t: {100 * close.mean():.3f}% within 5e-2"


@pytest.mark.parametrize("primed", [False, True], ids=["march", "march_primed"])
def test_march_matches_jax(setup, primed):
    js, ts, (o, d, t0p) = setup
    to, td = torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d))
    if primed:
        t_ref, hit_ref = jmarch.march_primed(JCFG, o, d, js.noise, t0p)
        t, hit = tmarch.march_primed(CFG, to, td, ts.noise, torch.from_numpy(np.array(t0p)))
    else:
        cfg0 = dataclasses.replace(CFG, prime_ds=0)
        t_ref, hit_ref = jmarch.march(dataclasses.replace(JCFG, prime_ds=0), o, d, js.noise)
        t, hit = tmarch.march(cfg0, to, td, ts.noise)
    # The march is differentiable: t carries the implicit-function gradient
    # back to the noise parameters.
    assert t.requires_grad
    check_march(t, hit, t_ref, hit_ref)


def test_march_residual_verdict_matches_jax(setup):
    """march_eps_scale > 1: loosened stop, then the strict residual verdict."""
    js, ts, (o, d, _) = setup
    cfg = dataclasses.replace(CFG, prime_ds=0, march_eps_scale=4.0)
    jcfg = dataclasses.replace(JCFG, prime_ds=0, march_eps_scale=4.0)
    t_ref, hit_ref = jmarch.march(jcfg, o, d, js.noise)
    t, hit = tmarch.march(cfg, torch.from_numpy(np.array(o)),
                          torch.from_numpy(np.array(d)), ts.noise)
    check_march(t, hit, t_ref, hit_ref)


def test_prime_from_coarse_matches_jax():
    rng = np.random.default_rng(5)
    cfg = RenderConfig(height=64, width=128)
    jcfg = JaxConfig(height=64, width=128)
    assert cfg.prime_ds == jcfg.prime_ds == 8
    t_c = rng.uniform(0.05, 150.0, (64 // 8 + 2, 128 // 8)).astype(np.float32)
    t_c[2:5, 3:9] = cfg.t_max  # a sky region: all-miss neighbourhoods
    t_c[0, :] = cfg.t_max  # halo row
    t_c[7:, 12:] = cfg.t_max
    got = tmarch.prime_from_coarse(torch.from_numpy(t_c), cfg)
    ref = jmarch.prime_from_coarse(jnp.asarray(t_c), jcfg)
    assert tuple(got.shape) == ref.shape == (64, 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got.numpy() == cfg.t_max).any()


def test_coarse_prime_cfg_matches_jax():
    for cfg in (CFG, RenderConfig(), RenderConfig(height=128, width=64, step_floor_t=0.0)):
        jkw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
        jkw["use_pallas"] = jkw.pop("use_kernel")
        jkw["pallas_bwd"] = jkw.pop("kernel_bwd")
        ref = jmarch.coarse_prime_cfg(JaxConfig(**jkw))
        got = tmarch.coarse_prime_cfg(cfg)
        renamed = {"use_kernel": "use_pallas", "kernel_bwd": "pallas_bwd"}
        for f in dataclasses.fields(got):
            jname = renamed.get(f.name, f.name)
            assert getattr(got, f.name) == getattr(ref, jname), f.name


def test_primed_band_must_be_whole_coarse_rows():
    cfg = RenderConfig(height=64, width=128)
    tmarch.check_prime_band(cfg, 16.0, 32)
    with pytest.raises(ValueError, match="whole coarse rows"):
        tmarch.check_prime_band(cfg, 16.0, 20)
    with pytest.raises(ValueError, match="whole coarse rows"):
        tmarch.check_prime_band(cfg, 4.0, 32)
