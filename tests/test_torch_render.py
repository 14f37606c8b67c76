"""The PyTorch port's render entry point end to end against the JAX package:
both routes against ``render_jax``, the frozen golden image, the scene
converter, the command line, and the rule that the port never imports jax."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gpgpuraytrace_tpu.models.scene import RenderConfig as JaxConfig
from gpgpuraytrace_tpu.models.scene import default_scene as jax_default_scene
from gpgpuraytrace_tpu.ops import render as jrender
from gpgpuraytrace_tpu_torch import RenderConfig, cli, default_scene, render
from gpgpuraytrace_tpu_torch.utils.convert import scene_from_numpy, scene_to_numpy

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "config1_128.npy")

CFG = RenderConfig(height=64, width=128, max_steps=64, num_octaves=3)
JCFG = JaxConfig(height=64, width=128, max_steps=64, num_octaves=3, use_pallas=False)
# The golden's pinned config (tests/test_render.py).
CFG1 = RenderConfig(height=128, width=128, max_steps=96, num_octaves=1,
                    step_floor_t=0.0, step_relax=0.7, newton_iters=4, prime_ds=0)


def jax_scene_dict(scene):
    flat, _ = jax.tree_util.tree_flatten_with_path(scene)
    return {".".join(p.name for p in path): np.asarray(leaf) for path, leaf in flat}


def assert_mostly_close(a, b, atol, frac, msg):
    close = np.abs(np.asarray(a) - np.asarray(b)) <= atol
    got = close.mean()
    assert got >= frac, f"{msg}: only {100 * got:.3f}% within {atol} (need {100 * frac}%)"


@pytest.fixture(scope="module")
def jax_image():
    return np.asarray(jrender.render_jax(jax_default_scene(num_octaves=3), JCFG))


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel_path", "plain_path"])
def test_render_matches_render_jax(jax_image, use_kernel):
    scene = scene_from_numpy(jax_scene_dict(jax_default_scene(num_octaves=3)))
    img = render(scene, dataclasses.replace(CFG, use_kernel=use_kernel))
    # Differentiable: the scene's parameters require grad.
    assert tuple(img.shape) == (64, 128, 3) and img.requires_grad
    img = img.detach()
    assert_mostly_close(img, jax_image, 2e-3, 0.999, "image")
    assert_mostly_close(img, jax_image, 1e-5, 0.99, "image-exact")


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel_path", "plain_path"])
def test_golden_image(use_kernel):
    """The JAX package's frozen golden, at its tolerance (tests/test_render.py)."""
    img = render(default_scene(num_octaves=1),
                 dataclasses.replace(CFG1, use_kernel=use_kernel)).detach()
    golden = np.load(GOLDEN)
    np.testing.assert_allclose(img.numpy(), golden, rtol=1e-3, atol=2e-3)
    top = img[:8].mean(dim=(0, 1))
    assert top[2] > top[0], "sky should be blue-dominant"


def test_supersample_matches_jax():
    cfg = RenderConfig(height=32, width=32, max_steps=48, num_octaves=1, supersample=2)
    jcfg = JaxConfig(height=32, width=32, max_steps=48, num_octaves=1,
                     use_pallas=False, supersample=2)
    ref = np.asarray(jrender.render(jax_default_scene(num_octaves=1), jcfg))
    for use_kernel in (True, False):
        img = render(default_scene(num_octaves=1),
                     dataclasses.replace(cfg, use_kernel=use_kernel)).detach()
        assert tuple(img.shape) == (32, 32, 3)
        assert_mostly_close(img, ref, 2e-3, 0.999, f"ssaa use_kernel={use_kernel}")


def test_scene_converter_round_trip():
    named = jax_scene_dict(jax_default_scene(num_octaves=4, volumetric=True))
    scene = scene_from_numpy(named)
    back = scene_to_numpy(scene)
    assert back.keys() == named.keys()
    for k, v in named.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # The port's own default scene carries the same values.
    ported = scene_to_numpy(default_scene(num_octaves=4, volumetric=True))
    for k, v in named.items():
        np.testing.assert_array_equal(ported[k], v, err_msg=k)
    with pytest.raises(ValueError, match="missing"):
        scene_from_numpy({k: v for k, v in named.items() if k != "camera.yaw"})


def test_cli_render_cpu_writes_png(tmp_path, capsys):
    out = tmp_path / "frame.png"
    cli.main(["render", "--device", "cpu", "--size", "64", "--octaves", "3",
              "--max-steps", "64", "-o", str(out)])
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert b"IHDR" in data[:16] and b"IEND" in data[-12:]
    assert "rendered 64x64" in capsys.readouterr().out


def test_cli_volumetric_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(["render", "--device", "cpu", "--volumetric", "--size", "64",
                  "-o", str(tmp_path / "f.png")])


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import gpgpuraytrace_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'gpgpuraytrace_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith(p.__name__)]))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15  # every module was imported
