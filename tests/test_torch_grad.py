"""The judged gradient metric for the PyTorch port: pixel-loss gradients
against central finite differences through the port's ``fd_check_scalar``,
with the six checks, eps, rtol and t_cap of tests/test_grad.py. Each runs on
the kernel path (on the CPU, the plain versions of both trace kernels) and on
the plain op-by-op path."""

import dataclasses

import numpy as np
import pytest
import torch

from gpgpuraytrace_tpu_torch import RenderConfig, default_scene, render
from gpgpuraytrace_tpu_torch.ops.fd_check import fd_check_scalar, scene_with

torch.set_num_threads(2)

CFG = RenderConfig(height=48, width=64, max_steps=96, num_octaves=2)


@pytest.fixture(scope="module")
def setup():
    scene = default_scene(num_octaves=2)
    bright = default_scene(num_octaves=2)
    with torch.no_grad():
        bright.noise.amplitudes.mul_(1.1)
        target = render(bright, CFG)
    return scene, target


# (leaf, component, eps, rtol, t_cap, gradient must be nonzero), as
# tests/test_grad.py sets them (its comments give the reasons).
CHECKS = {
    "amplitude": ("noise.amplitudes", 0, 3e-3, 5e-2, 0.03, True),
    "camera_yaw": ("camera.yaw", None, 3e-3, 5e-2, 0.1, True),
    "camera_height": ("camera.position", 1, 1e-2, 5e-2, 0.1, False),
    "height_scale": ("noise.height_scale", None, 3e-3, 5e-2, 0.01, False),
    "fog_density": ("materials.fog_density", None, 1e-4, 1e-2, 0.1, False),
    "sun_color": ("materials.sun_color", 0, 1e-3, 1e-2, 0.1, False),
}


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel_path", "plain_path"])
@pytest.mark.parametrize("check", list(CHECKS))
def test_gradient_matches_finite_difference(setup, check, use_kernel):
    scene, target = setup
    name, index, eps, rtol, t_cap, nonzero = CHECKS[check]
    cfg = dataclasses.replace(CFG, use_kernel=use_kernel)
    leaf = dict(scene.named_parameters())[name].detach()
    theta0 = leaf if index is None else leaf[index]
    ad, fd = fd_check_scalar(lambda th: scene_with(scene, name, th, index), theta0,
                             cfg, target, eps=eps, t_cap=t_cap)
    assert np.isfinite(ad) and np.isfinite(fd)
    assert abs(ad - fd) <= rtol * max(abs(fd), 1e-5), f"ad={ad} fd={fd}"
    if nonzero:
        assert ad != 0.0
