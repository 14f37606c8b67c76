"""The backward trace kernel module of the PyTorch port against the JAX
package, on the CPU, where ``trace_frames_bwd`` runs its plain version.

* ``trace_frames_bwd`` against the JAX package's ``_backward_pallas`` in
  interpret mode, on the same seeded (t, hit, g), every scene leaf after the
  pull through ``pack_scene``: rtol 2e-4, atol 1e-6 (the JAX suite's own
  kernel-vs-XLA backward tolerance, tests/test_pallas.py).
* ``kernel_bwd`` True against False on every leaf, same tolerance.
* ``render`` gradients end to end against autodiff of ``render_jax``:
  amplitudes at rtol 5e-3, atol 1e-5 (tests/test_pallas.py); every leaf at
  2.5% plus 1e-3 of the leaf's largest component, because each side primes
  from its own coarse pass (__graft_entry__.py).
* Supersampled render gradients against the JAX package's, amplitudes at
  rtol 5e-3, atol 1e-5.
* The hand-derived noise Hessian the CUDA kernel uses, against autograd.
The CUDA kernel itself is held to the plain version by
tests/test_torch_cuda.py (on a GPU) and chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpgpuraytrace_tpu.kernels.trace import _backward_pallas
from gpgpuraytrace_tpu.models.scene import RenderConfig as JaxConfig
from gpgpuraytrace_tpu.models.scene import default_scene as jax_default_scene
from gpgpuraytrace_tpu.ops.fit import partition_scene as jax_partition_scene
from gpgpuraytrace_tpu.ops.render import render as jax_render
from gpgpuraytrace_tpu.ops.render import render_jax
from gpgpuraytrace_tpu_torch import RenderConfig, render
from gpgpuraytrace_tpu_torch.kernels import trace as ktrace
from gpgpuraytrace_tpu_torch.ops.noise import noise2, noise2_hessian
from gpgpuraytrace_tpu_torch.utils.convert import scene_from_numpy
from gpgpuraytrace_tpu_torch.utils.packing import pack_scene

torch.set_num_threads(2)

H, W, OCT = 64, 128, 3
CFG = RenderConfig(height=H, width=W, max_steps=64, num_octaves=OCT)
JCFG = JaxConfig(height=H, width=W, max_steps=64, num_octaves=OCT,
                 use_pallas=True, interpret=True)


def jax_scene_dict(scene):
    flat, _ = jax.tree_util.tree_flatten_with_path(scene)
    return {".".join(p.name for p in path): np.asarray(leaf) for path, leaf in flat}


def port_scene():
    return scene_from_numpy(jax_scene_dict(jax_default_scene(num_octaves=OCT)), device="cpu")


def leaf_grads(scene):
    """{dotted name: gradient}; a leaf the loss does not reach (the warp
    parameters of a heightfield) has zero gradient, as in JAX."""
    return {n: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
            for n, p in scene.named_parameters()}


@pytest.fixture(scope="module")
def saved():
    """A seeded (t, hit, g): t anywhere along the rays, 60% hits, normal g."""
    rng = np.random.default_rng(11)
    t = rng.uniform(0.05, 80.0, (H, W)).astype(np.float32)
    hit = rng.random((H, W)) < 0.6
    g = rng.standard_normal((H, W, 3)).astype(np.float32)
    return t, hit, g


def test_trace_frame_bwd_matches_backward_pallas(saved):
    t, hit, g = saved
    ref = jax_scene_dict(_backward_pallas(
        jax_default_scene(num_octaves=OCT), JCFG, jnp.asarray(t), jnp.asarray(hit),
        jnp.asarray(g), 0.0, None,
    ))
    scene = port_scene()
    packed, seed = pack_scene(scene, H, W)
    launches = ktrace.trace_frames_bwd.launches.total()
    pbar = ktrace.trace_frames_bwd(
        packed.detach(), seed, CFG, H, torch.from_numpy(t)[None],
        torch.from_numpy(hit.astype(np.float32))[None],
        torch.from_numpy(np.ascontiguousarray(np.moveaxis(g, -1, 0)))[None],
    )
    # The plain version ran: a CPU tensor never launches the CUDA kernel.
    assert ktrace.trace_frames_bwd.launches.total() == launches == 0
    assert tuple(pbar.shape) == (1, packed.shape[1]) and not pbar.requires_grad
    packed.backward(pbar)
    got = leaf_grads(scene)
    for name, value in got.items():
        np.testing.assert_allclose(value, ref[name], rtol=2e-4, atol=1e-6, err_msg=name)
    assert np.abs(got["noise.amplitudes"]).min() > 0.0


def _loss(img):
    return torch.mean(img * torch.cos(img))  # a non-symmetric cotangent


def test_kernel_bwd_matches_plain_reshade():
    grads = []
    for kernel_bwd in (True, False):
        scene = port_scene()
        _loss(render(scene, dataclasses.replace(CFG, kernel_bwd=kernel_bwd))).backward()
        grads.append(leaf_grads(scene))
    for name, value in grads[0].items():
        np.testing.assert_allclose(value, grads[1][name], rtol=2e-4, atol=1e-6,
                                   err_msg=name)


LOSSES = {
    "amplitudes": lambda img: jnp.mean(img * img),
    "all_leaves": lambda img: jnp.mean(img * jnp.cos(img)),
}


@pytest.fixture(scope="module")
def jax_grads():
    scene = jax_default_scene(num_octaves=OCT)
    leaves, merge = jax_partition_scene(scene, trainable=lambda name: True)
    cfg = dataclasses.replace(JCFG, use_pallas=False, interpret=False)
    out = {}
    for kind, loss in LOSSES.items():
        grads = jax.grad(lambda lv: loss(render_jax(merge(lv), cfg)))(leaves)
        out[kind] = jax_scene_dict(merge(grads))
    return out


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel_path", "plain_path"])
@pytest.mark.parametrize("kind", list(LOSSES))
def test_render_grads_match_render_jax(jax_grads, use_kernel, kind):
    scene = port_scene()
    img = render(scene, dataclasses.replace(CFG, use_kernel=use_kernel))
    loss = torch.mean(img * img) if kind == "amplitudes" else _loss(img)
    loss.backward()
    got, ref = leaf_grads(scene), jax_grads[kind]
    if kind == "amplitudes":
        np.testing.assert_allclose(got["noise.amplitudes"], ref["noise.amplitudes"],
                                   rtol=5e-3, atol=1e-5)
        return
    for name, value in got.items():
        scale = float(np.max(np.abs(ref[name])))
        np.testing.assert_allclose(value, ref[name], rtol=2.5e-2, atol=1e-3 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel_path", "plain_path"])
def test_supersample_grads_match_jax(use_kernel):
    """2x supersampling: the box filter over a 64x64 render, primed."""
    cfg = RenderConfig(height=32, width=32, max_steps=48, num_octaves=2, supersample=2,
                       use_kernel=use_kernel)
    jcfg = JaxConfig(height=32, width=32, max_steps=48, num_octaves=2, supersample=2,
                     use_pallas=False)
    js = jax_default_scene(num_octaves=2)
    ref = jax.grad(lambda a: jnp.mean(jax_render(dataclasses.replace(
        js, noise=dataclasses.replace(js.noise, amplitudes=a)), jcfg) ** 2))(
        js.noise.amplitudes)
    scene = scene_from_numpy(jax_scene_dict(js), device="cpu")
    torch.mean(render(scene, cfg) ** 2).backward()
    np.testing.assert_allclose(scene.noise.amplitudes.grad.numpy(), np.asarray(ref),
                               rtol=5e-3, atol=1e-5)


def test_noise_hessian_matches_autograd():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(-40.0, 40.0, 4096).astype(np.float32))
    z = torch.from_numpy(rng.uniform(-40.0, 40.0, 4096).astype(np.float32))
    xr, zr = x.clone().requires_grad_(), z.clone().requires_grad_()
    _, nx, nz = noise2(xr, zr, 7)
    d_nx = torch.autograd.grad(nx.sum(), (xr, zr), retain_graph=True)
    d_nz = torch.autograd.grad(nz.sum(), (xr, zr))
    hxx, hxz, hzz = noise2_hessian(x, z, 7)
    # float32 rounding of two formulas for the same polynomial.
    for got, want in ((hxx, d_nx[0]), (hxz, d_nx[1]), (hxz, d_nz[0]), (hzz, d_nz[1])):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=2e-5)
    assert hxx.abs().max() > 1.0  # the lattice really curves
