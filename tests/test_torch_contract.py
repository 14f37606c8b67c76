"""Contract config 5 (``scripts/torch_contract_configs.py``) against the JAX
package's (``scripts/contract_configs.py:config5``), on the CPU, at a 16:9
frame of 128x72, 2 octaves, ``max_steps`` 128, primed (``prime_ds`` 8: 72
and 128 are multiples of 8 and at least 64).

* The frame: the port's ``sharded_render`` against the JAX package's
  ``sharded_render`` on a 1-device mesh (``use_pallas=False``), at
  tests/test_pallas.py:36-55's image tolerance: 99.9% of values within 2e-3,
  99% within 1e-5.
* The fwd+bwd steps: ``parallel/worker.py:sharded_steps`` (salted
  ``sharded_loss_and_grad`` steps toward a zero target, every float
  parameter trainable) against the JAX package's
  ``_sharded_loss_and_grad_body`` on a 1-device mesh in config 5's salted
  ``fori_loop``, at tests/test_torch_sharding.py's gradient tolerances:
  the amplitudes at rtol 5e-3, atol 1e-5, every leaf at rtol 2.5e-2 plus 1e-3
  of its largest component, the loss at rtol 1e-4; the accumulator of 1 and
  of 2 steps within the sum of those per-entry bounds per step.
* The script's config 5 runs at that size on the CPU (a gloo group of one)
  and prints its JSON line.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpgpuraytrace_tpu.models.scene import RenderConfig as JaxConfig
from gpgpuraytrace_tpu.models.scene import default_scene as jax_default_scene
from gpgpuraytrace_tpu.ops.fit import partition_scene as jax_partition_scene
from gpgpuraytrace_tpu.parallel.mesh import make_mesh
from gpgpuraytrace_tpu.parallel.sharded import (
    _sharded_loss_and_grad_body, sharded_render as jax_sharded_render,
)
from gpgpuraytrace_tpu.parallel.sharded import shard_target as jax_shard_target
from gpgpuraytrace_tpu_torch.models.scene import RenderConfig
from gpgpuraytrace_tpu_torch.parallel.launch import REPO
from gpgpuraytrace_tpu_torch.parallel.sharded import sharded_render
from gpgpuraytrace_tpu_torch.parallel.worker import sharded_steps
from gpgpuraytrace_tpu_torch.utils.convert import scene_from_numpy

torch.set_num_threads(2)

H, W, OCT, MAX_STEPS = 72, 128, 2, 128
SALT = 37.0
CFG = RenderConfig(height=H, width=W, max_steps=MAX_STEPS, num_octaves=OCT)
JCFG = JaxConfig(height=H, width=W, max_steps=MAX_STEPS, num_octaves=OCT, use_pallas=False)


def jax_scene_dict(scene):
    flat, _ = jax.tree_util.tree_flatten_with_path(scene)
    return {".".join(p.name for p in path): np.asarray(leaf) for path, leaf in flat}


@pytest.fixture(scope="module")
def jax_config5():
    """Config 5's frame and its salted fwd+bwd body in the JAX package:
    the frame, the accumulator of 1 and of 2 steps, step 0's loss and
    gradients by leaf name, and the scene."""
    assert CFG.prime_ds == 8 and JCFG.prime_ds == 8
    scene = jax_default_scene(num_octaves=OCT)
    mesh = make_mesh(jax.devices()[:1])
    frame = np.asarray(jax_sharded_render(scene, JCFG, mesh))
    leaves, merge = jax_partition_scene(scene, trainable=lambda name: True)
    body_fn = _sharded_loss_and_grad_body(merge, JCFG, mesh)
    target = jax_shard_target(jnp.zeros((H, W, 3), jnp.float32), mesh)

    @jax.jit
    def run_fb(leaves, target, n, salt):
        def body(i, acc):
            eps = 1e-6 * (salt + i.astype(jnp.float32))
            loss, grads = body_fn([leaf + eps for leaf in leaves], target)
            return acc + loss + sum(jnp.sum(g) for g in jax.tree_util.tree_leaves(grads))
        return jax.lax.fori_loop(0, n, body, jnp.float32(0.0))

    acc = {n: float(run_fb(leaves, target, n, jnp.float32(SALT))) for n in (1, 2)}
    eps = 1e-6 * jnp.float32(SALT)
    loss, grads = jax.jit(body_fn)([leaf + eps for leaf in leaves], target)
    grads = {n: g for n, g in jax_scene_dict(merge(grads)).items() if n != "noise.seed"}
    return frame, acc, float(loss), grads, jax_scene_dict(scene)


def _entry_bound(name: str, ref: np.ndarray) -> np.ndarray:
    if name == "noise.amplitudes":
        return 1e-5 + 5e-3 * np.abs(ref)
    return 1e-3 * np.abs(ref).max() + 2.5e-2 * np.abs(ref)


def test_config5_frame_matches_jax(jax_config5):
    frame_ref, *_, scene_dict = jax_config5
    img = sharded_render(scene_from_numpy(scene_dict, device="cpu"), CFG).numpy()
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    for atol, frac in ((2e-3, 0.999), (1e-5, 0.99)):
        got = (np.abs(img - frame_ref) <= atol).mean()
        assert got >= frac, f"{100 * got:.3f}% within {atol} (need {100 * frac}%)"


@pytest.mark.parametrize("n", [1, 2])
def test_config5_fwd_bwd_matches_jax(jax_config5, n):
    _, acc_ref, loss_ref, grads_ref, scene_dict = jax_config5
    scene = scene_from_numpy(scene_dict, device="cpu")
    steps = sharded_steps(scene, CFG)
    steps.salt.fill_(SALT)
    acc = steps.run(n).item()
    # Step 0's parameters back, then its loss and gradients by name.
    steps.step_i.zero_()
    loss, grads = steps.terms()
    names = [name for name, _ in scene.named_parameters()]
    assert sorted(names) == sorted(grads_ref)
    np.testing.assert_allclose(loss.item(), loss_ref, rtol=1e-4)
    bound = 1e-4 * abs(loss_ref)
    for name, g in zip(names, grads):
        ref = grads_ref[name]
        got = g.detach().numpy()
        if name == "noise.amplitudes":
            np.testing.assert_allclose(got, ref, rtol=5e-3, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(got, ref, rtol=2.5e-2, atol=1e-3 * np.abs(ref).max(),
                                   err_msg=name)
        bound += _entry_bound(name, ref).sum()
    assert abs(acc - acc_ref[n]) <= n * bound, (acc, acc_ref[n], n * bound)


def test_config5_script_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, os.path.join("scripts", "torch_contract_configs.py"), "--config", "5",
         "--device", "cpu", "--size", f"{W}x{H}", "--octaves", str(OCT), "--k", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    [line] = proc.stdout.strip().splitlines()
    out = json.loads(line)
    assert out["config"] == 5 and out["ok"] is True
    assert out["shape"] == [H, W, 3] and out["sharded_bitwise"] and out["finite"]
    assert 0.0 < out["mean_pixel"] < 1.0
    assert out["group"] == {"backend": "gloo", "world": 1}
    assert out["device"] == {"name": "cpu", "power_limit": None, "count": 1}
    assert out["frame_timing"] == out["fwd_bwd_timing"] == "eager" and out["K"] == 2
    assert out["frame_ms"] > 0 and out["fwd_bwd_ms_per_step"] > 0
    assert out["frame_graph_check"] is None and out["fwd_bwd_graph_check"] is None
    assert out["frame_peak_memory_bytes"] is None and out["fwd_bwd_peak_memory_bytes"] is None
    # A group of one: no all-reduce (sharded_loss_and_grad skips them).
    assert out["fwd_bwd_launches"]["all_reduce"] == {}
