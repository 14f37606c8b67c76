"""The PyTorch port's fit loop against the JAX package's: 3 Adam steps at
48x64 with 2 octaves from the same JAX-perturbed start, on the kernel path
(on the CPU, the plain versions of both trace kernels) and the plain path.
Losses agree at rtol 1e-4 at every step; every trainable component agrees
within 0.1·lr, except components whose step-0 gradient is below 1e-3 of
their leaf's largest (Adam moves a component by about lr·sign(g), so a
near-zero gradient may flip sign between two implementations): EXEMPT lists
them. Also partition_scene, perturb_scene and the command line."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from gpgpuraytrace_tpu.models.scene import RenderConfig as JaxConfig
from gpgpuraytrace_tpu.models.scene import default_scene as jax_default_scene
from gpgpuraytrace_tpu.ops import fit as jfit
from gpgpuraytrace_tpu.ops.render import render_jax
from gpgpuraytrace_tpu_torch import RenderConfig, cli, default_scene
from gpgpuraytrace_tpu_torch.ops import fit as tfit
from gpgpuraytrace_tpu_torch.utils.convert import scene_from_numpy

torch.set_num_threads(2)

LR, STEPS = 1e-2, 3
CFG = RenderConfig(height=48, width=64, max_steps=64, num_octaves=2)
JCFG = JaxConfig(height=48, width=64, max_steps=64, num_octaves=2, use_pallas=False)
# (leaf, flat index) pairs exempt from the 0.1·lr check; at this start every
# step-0 gradient component is above 1e-3 of its leaf's largest.
EXEMPT = ()


def jax_scene_dict(scene):
    flat, _ = jax.tree_util.tree_flatten_with_path(scene)
    return {".".join(p.name for p in path): np.asarray(leaf) for path, leaf in flat}


@pytest.fixture(scope="module")
def jax_run():
    target = render_jax(jax_default_scene(num_octaves=2), JCFG)
    start = jfit.perturb_scene(jax_default_scene(num_octaves=2), jax.random.PRNGKey(0),
                               rel=0.15)
    leaves, merge = jfit.partition_scene(start)
    grad0 = jax.grad(lambda lv: jfit.pixel_loss(merge(lv), JCFG, target))(leaves)
    fitted, losses = jfit.fit(start, JCFG, target, steps=STEPS, learning_rate=LR,
                              log_every=0)
    return (np.array(target), jax_scene_dict(start), jax_scene_dict(merge(grad0)),
            jax_scene_dict(fitted), losses)


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel_path", "plain_path"])
def test_fit_matches_jax(jax_run, use_kernel):
    target, start, grad0, ref, ref_losses = jax_run
    scene, losses = tfit.fit(
        scene_from_numpy(start, device="cpu"), dataclasses.replace(CFG, use_kernel=use_kernel),
        torch.from_numpy(target), steps=STEPS, learning_rate=LR, log_every=0,
    )
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert losses[-1] < losses[0]
    small = set()
    for name, p in scene.named_parameters():
        if not tfit.default_trainable(name):
            # Frozen leaves stay exactly where they started.
            np.testing.assert_array_equal(p.detach().numpy(), start[name], err_msg=name)
            continue
        g = np.abs(grad0[name]).reshape(-1)
        small |= {(name, i) for i in np.flatnonzero(g < 1e-3 * g.max())}
        got, want = p.detach().numpy().reshape(-1), ref[name].reshape(-1)
        for i in range(got.size):
            if (name, i) not in EXEMPT:
                assert abs(got[i] - want[i]) <= 0.1 * LR, (name, i, got[i], want[i])
    assert small == set(EXEMPT)


def test_partition_scene_marks_trainables():
    scene = default_scene(num_octaves=2, device="cpu")
    params = tfit.partition_scene(scene)
    names = [n for n, p in scene.named_parameters() if p.requires_grad]
    assert names == ["noise.amplitudes", "camera.position", "camera.yaw",
                     "camera.pitch", "camera.fov_y"]
    assert [id(p) for p in params] == [id(dict(scene.named_parameters())[n]) for n in names]
    assert not scene.materials.sun_color.requires_grad
    assert scene.noise.seed.dtype == torch.int32  # a buffer, never trained
    only = tfit.partition_scene(scene, lambda n: n == "materials.fog_density")
    assert [p is scene.materials.fog_density for p in only] == [True]
    assert not scene.noise.amplitudes.requires_grad


def test_perturb_scene_is_seeded():
    scene = default_scene(num_octaves=3, device="cpu")
    a = tfit.perturb_scene(scene, torch.Generator().manual_seed(1))
    b = tfit.perturb_scene(scene, torch.Generator().manual_seed(1))
    c = tfit.perturb_scene(scene, torch.Generator().manual_seed(2))
    for name in ("noise.amplitudes", "camera.yaw", "camera.pitch"):
        pa, pb, pc, p0 = (dict(s.named_parameters())[name].detach()
                          for s in (a, b, c, scene))
        assert torch.equal(pa, pb), name
        assert not torch.equal(pa, p0) and not torch.equal(pa, pc), name
    # The original is untouched and everything else is copied as it was.
    assert torch.equal(scene.noise.amplitudes.detach(),
                       default_scene(num_octaves=3, device="cpu").noise.amplitudes.detach())
    assert torch.equal(a.materials.sun_color, scene.materials.sun_color)
    rel = (a.noise.amplitudes / scene.noise.amplitudes - 1.0).abs()
    assert rel.max() <= 0.25


def test_cli_fit_cpu(capsys):
    cli.main(["fit", "--device", "cpu", "--size", "32", "--octaves", "2",
              "--max-steps", "32", "--steps", "3"])
    out = capsys.readouterr().out
    assert "fit step    0" in out and "over 3 steps" in out
    assert "max |amplitude error|" in out


def test_cli_fit_on_cuda_raises_without_cuda():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["fit", "--device", "cuda", "--size", "32", "--steps", "1"])
