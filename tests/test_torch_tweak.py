"""Live tweak variables in the PyTorch port (``utils/tweak.py``): the cases
of tests/test_tweak.py, and the port against the JAX package on the same
dict: the same keys and values, the same rejected names and the same packed
scalar vector after the tweaks."""

import json
import os

import numpy as np
import torch

from gpgpuraytrace_tpu.models.scene import default_scene as jax_default_scene
from gpgpuraytrace_tpu.utils import packing as jax_packing
from gpgpuraytrace_tpu.utils.tweak import apply_tweaks as jax_apply_tweaks
from gpgpuraytrace_tpu.utils.tweak import scene_variables as jax_scene_variables
from gpgpuraytrace_tpu_torch.models.scene import RenderConfig, default_scene
from gpgpuraytrace_tpu_torch.ops.render import render
from gpgpuraytrace_tpu_torch.utils.packing import pack_scene
from gpgpuraytrace_tpu_torch.utils.tweak import (
    TweakWatcher, apply_tweaks, scene_variables, write_template,
)

TWEAKS = {
    "noise.height_scale": 9.5,
    "materials.sun_dir": [0.1, 0.9, 0.2],
    "camera.yaw": 0.4,
    "noise.amplitudes": [0.6, 0.2],
    "noise.seed": 11,
    "noise.no_such_leaf": 1.0,
    "materials.fog_color": [1.0, 2.0],  # wrong shape
    "camera.position": "up",  # not a number
    "bogus": 3,
}


def test_apply_tweaks_sets_leaves():
    scene = default_scene(num_octaves=2, device="cpu")
    scene2, rejected = apply_tweaks(
        scene,
        {"noise.height_scale": 9.5, "materials.sun_dir": [0.1, 0.9, 0.2], "camera.yaw": 0.4},
    )
    assert rejected == []
    assert float(scene2.noise.height_scale.detach()) == 9.5
    np.testing.assert_allclose(scene2.materials.sun_dir.detach().numpy(), [0.1, 0.9, 0.2])
    assert float(scene2.camera.yaw.detach()) == np.float32(0.4)
    # untouched leaves survive, and the caller's scene is left as it was
    assert torch.equal(scene2.noise.amplitudes, scene.noise.amplitudes)
    assert float(scene.noise.height_scale.detach()) == 6.0
    assert scene2.noise.height_scale is not scene.noise.height_scale


def test_apply_tweaks_rejects_bad_entries():
    scene = default_scene(num_octaves=2, device="cpu")
    scene2, rejected = apply_tweaks(
        scene,
        {
            "noise.no_such_leaf": 1.0,
            "materials.sun_dir": [1.0, 2.0],  # wrong shape
            "bogus": 3,
            "noise.height_offset": 1.25,  # valid: must still apply
        },
    )
    assert set(rejected) == {"noise.no_such_leaf", "materials.sun_dir", "bogus"}
    assert float(scene2.noise.height_offset.detach()) == 1.25


def test_template_roundtrip(tmp_path):
    scene = default_scene(num_octaves=3, device="cpu")
    path = tmp_path / "tweaks.json"
    write_template(str(path), scene)
    loaded = json.loads(path.read_text())
    assert loaded == scene_variables(scene)
    # The full template applies cleanly back onto the scene.
    scene2, rejected = apply_tweaks(scene, loaded)
    assert rejected == []
    for (name, a), b in zip(scene.state_dict().items(), scene2.state_dict().values()):
        assert torch.equal(a, b), name


def test_watcher_detects_change(tmp_path):
    path = tmp_path / "live.json"
    w = TweakWatcher(str(path))
    assert w.poll() is None  # a missing file is fine
    path.write_text('{"noise.height_scale": 7.0}')
    assert w.poll() == {"noise.height_scale": 7.0}
    assert w.poll() is None  # unchanged: no re-read
    path.write_text('{"noise.height_scale": 8.0}')
    os.utime(path, (os.stat(path).st_atime, os.stat(path).st_mtime + 2))
    assert w.poll() == {"noise.height_scale": 8.0}
    # malformed JSON: skipped, read again after the next change
    path.write_text('{"broken"')
    os.utime(path, (os.stat(path).st_atime, os.stat(path).st_mtime + 4))
    assert w.poll() is None


def test_tweaked_scene_renders_a_different_image():
    """Tweaks change parameter values only: the same config renders the
    tweaked scene, and the image moves."""
    cfg = RenderConfig(height=16, width=32, max_steps=8, num_octaves=2)
    scene = default_scene(num_octaves=2, device="cpu")
    with torch.no_grad():
        img0 = render(scene, cfg)
        scene2, _ = apply_tweaks(scene, {"noise.height_scale": 9.0, "camera.pitch": -0.5})
        img1 = render(scene2, cfg)
    assert not torch.allclose(img0, img1)


def test_tweaks_match_jax():
    js = jax_default_scene(num_octaves=2)
    scene = default_scene(num_octaves=2, device="cpu")
    assert scene_variables(scene) == jax_scene_variables(js)
    got, rejected = apply_tweaks(scene, TWEAKS)
    ref, j_rejected = jax_apply_tweaks(js, TWEAKS)
    assert rejected == j_rejected
    assert scene_variables(got) == jax_scene_variables(ref)
    packed, seed = pack_scene(got, 32, 64)
    j_packed, j_seed = jax_packing.pack_scene(ref, 32, 64)
    # The camera's trigonometry may round a last bit apart (torch vs XLA).
    np.testing.assert_allclose(packed.detach().numpy(), np.asarray(j_packed), rtol=1e-6,
                               atol=1e-7)
    assert np.array_equal(seed.numpy(), np.asarray(j_seed))
