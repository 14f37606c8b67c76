"""Camera, field, shading and scalar packing of the PyTorch port against the
JAX package, on the same inputs made from a seed with numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpgpuraytrace_tpu.models.scene import default_scene as jax_default_scene
from gpgpuraytrace_tpu.ops import camera as jcam
from gpgpuraytrace_tpu.ops import field as jfield
from gpgpuraytrace_tpu.ops import shade as jshade
from gpgpuraytrace_tpu.utils import packing as jpk
from gpgpuraytrace_tpu_torch.ops import camera as tcam
from gpgpuraytrace_tpu_torch.ops import field as tfield
from gpgpuraytrace_tpu_torch.ops import shade as tshade
from gpgpuraytrace_tpu_torch.utils import packing as tpk
from gpgpuraytrace_tpu_torch.utils.convert import scene_from_numpy

torch.set_num_threads(2)

ATOL = 1e-5  # float32 values of order 1; transcendentals differ by ulps


def jax_scene_dict(scene):
    flat, _ = jax.tree_util.tree_flatten_with_path(scene)
    return {".".join(p.name for p in path): np.asarray(leaf) for path, leaf in flat}


@pytest.fixture(scope="module")
def scenes():
    js = jax_default_scene(num_octaves=3)
    # A non-default camera so yaw and the basis cross products matter.
    js = js.replace(camera=js.camera.replace(yaw=jnp.float32(0.4),
                                             pitch=jnp.float32(-0.2)))
    return js, scene_from_numpy(jax_scene_dict(js), device="cpu")


def close(got, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(ref), rtol=0, atol=atol)


def test_camera_basis(scenes):
    js, ts = scenes
    for g, r in zip(tcam.camera_basis(ts.camera), jcam.camera_basis(js.camera)):
        close(g, r, 1e-6)


@pytest.mark.parametrize(
    "band", [(0.0, None), (-1.0, 10), (32.0, 16)], ids=["full", "halo_row", "band"]
)
def test_generate_rays(scenes, band):
    # row0 = -1 is the depth-prime coarse pass's virtual halo row.
    js, ts = scenes
    row0, lh = band
    to, td = tcam.generate_rays(ts.camera, 64, 48, row0, lh)
    jo, jd = jcam.generate_rays(js.camera, 64, 48, row0, lh)
    assert tuple(td.shape) == jd.shape
    close(to, jo, 0.0)
    close(td, jd, 1e-6)


def _points(seed, n=2048):
    rng = np.random.default_rng(seed)
    p = np.stack([rng.uniform(-60, 60, n), rng.uniform(-4, 10, n),
                  rng.uniform(-60, 60, n)], axis=-1)
    return p.astype(np.float32)


def test_field_and_grad(scenes):
    js, ts = scenes
    p = _points(3)
    tf, tg = tfield.field_and_grad(torch.from_numpy(p), ts.noise)
    jf, jg = jfield.field_and_grad(jnp.asarray(p), js.noise)
    close(tf, jf)
    close(tg, jg)
    close(tfield.field(torch.from_numpy(p), ts.noise), jfield.field(jnp.asarray(p), js.noise))
    close(tfield.envelope_height(ts.noise), jfield.envelope_height(js.noise), 1e-6)


def test_shade_and_tonemap(scenes):
    js, ts = scenes
    rng = np.random.default_rng(4)
    jo, jd = jcam.generate_rays(js.camera, 32, 48)
    o, d = np.array(jo), np.array(jd)
    t = rng.uniform(0.05, 120.0, d.shape[:-1]).astype(np.float32)
    hit = rng.random(d.shape[:-1]) < 0.6
    ref = jshade.shade(jo, jd, jnp.asarray(t), jnp.asarray(hit), js.noise, js.materials)
    got = tshade.shade(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t),
                       torch.from_numpy(hit), ts.noise, ts.materials)
    close(got, ref)
    close(tshade.tonemap(got.detach()), jshade.tonemap(ref))


def test_pack_scene(scenes):
    js, ts = scenes
    for row0 in (0.0, -1.0, 32.0):
        tp, tseed = tpk.pack_scene(ts, 512, 384, row0)
        jp, jseed = jpk.pack_scene(js, 512, 384, row0)
        assert tp.shape == jp.shape and tp.dtype == torch.float32
        # Equal up to one float32 ulp of the transcendentals (tan, sin, cos).
        close(tp, jp, 1e-7)
        np.testing.assert_array_equal(tseed.numpy(), np.asarray(jseed))
    assert tpk.AMPS == jpk.AMPS and tpk.ROW0 == jpk.ROW0 and tpk.SUN_DIR == jpk.SUN_DIR
