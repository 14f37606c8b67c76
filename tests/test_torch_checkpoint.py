"""The port's checkpoint module and the rest of its fit loop (save_path,
save_every, resume, steps_per_call) against the JAX package, on the CPU
(ports tests/test_fit.py's checkpoint and chunking cases).

Within the port, on the CPU: a scene round-trips bit for bit; a fit state
(parameters, Adam's state with its ``step`` tensor's dtype and device, step,
losses) round-trips bit for bit; kill-and-resume equals the unbroken run bit
for bit, logs included; ``steps_per_call=3`` over 7 steps equals k = 1 bit
for bit (on the CPU a chunk is a plain loop of steps).

Against the JAX package, from the same JAX-perturbed start, at
tests/test_torch_fit.py's tolerances: losses at rtol 1e-4 and every
trainable component within 0.1·lr, for the port's resumed 12-step run
against JAX's straight one, the port's ``steps_per_call=3`` run against
JAX's, and a fit that JAX started (3 steps, saved by its ``save_fit_state``),
read through ``utils/convert.py:fit_state_from_jax`` and resumed in the port
for 3 more, against JAX's straight 6-step run. Scene files cross between the
two packages bit for bit.
"""

import os

import jax
import numpy as np
import pytest
import torch

from gpgpuraytrace_tpu.models.scene import RenderConfig as JaxConfig
from gpgpuraytrace_tpu.models.scene import default_scene as jax_default_scene
from gpgpuraytrace_tpu.ops import fit as jfit
from gpgpuraytrace_tpu.ops.render import render_jax
from gpgpuraytrace_tpu.utils import checkpoint as jckpt
from gpgpuraytrace_tpu_torch import RenderConfig, cli, default_scene
from gpgpuraytrace_tpu_torch.ops import fit as tfit
from gpgpuraytrace_tpu_torch.utils import checkpoint as ckpt
from gpgpuraytrace_tpu_torch.utils.convert import (
    LEAF_NAMES, fit_state_from_jax, scene_from_numpy,
)

torch.set_num_threads(2)

LR = 1e-2
# tests/test_fit.py's configs: kill-and-resume at 16x32, chunking at 24x32.
SMALL = RenderConfig(height=16, width=32, max_steps=16, num_octaves=2)
JSMALL = JaxConfig(height=16, width=32, max_steps=16, num_octaves=2, use_pallas=False)
CHUNK = RenderConfig(height=24, width=32, max_steps=32, num_octaves=2)
JCHUNK = JaxConfig(height=24, width=32, max_steps=32, num_octaves=2, use_pallas=False)


def jax_scene_dict(scene):
    flat, _ = jax.tree_util.tree_flatten_with_path(scene)
    return {".".join(p.name for p in path): np.asarray(leaf) for path, leaf in flat}


def assert_matches_jax(scene, losses, ref_scene, ref_losses):
    """tests/test_torch_fit.py's tolerances."""
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    for name, p in scene.named_parameters():
        if tfit.default_trainable(name):
            np.testing.assert_allclose(p.detach().numpy(), ref_scene[name], rtol=0,
                                       atol=0.1 * LR, err_msg=name)


def assert_same_scene(a, b):
    for (name, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), name


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's runs: from tests/test_fit.py's starts, 12 straight steps at 16x32,
    3 steps saved by save_fit_state and 6 straight, and 7 steps in chunks
    of 3 at 24x32."""
    out = {}
    small_target = render_jax(jax_default_scene(num_octaves=2), JSMALL)
    bad = jfit.perturb_scene(jax_default_scene(num_octaves=2), jax.random.PRNGKey(5), rel=0.2)
    out["small"] = (np.array(small_target), jax_scene_dict(bad))
    for steps in (12, 6):
        fitted, losses = jfit.fit(bad, JSMALL, small_target, steps=steps, learning_rate=LR,
                                  log_every=0)
        out[steps] = (jax_scene_dict(fitted), losses)
    path = str(tmp_path_factory.mktemp("jax") / "fit3.npz")
    jfit.fit(bad, JSMALL, small_target, steps=3, learning_rate=LR, log_every=0,
             save_path=path, save_every=3)
    out["saved3"] = path
    chunk_target = render_jax(jax_default_scene(num_octaves=2), JCHUNK)
    bad = jfit.perturb_scene(jax_default_scene(num_octaves=2), jax.random.PRNGKey(3), rel=0.1)
    fitted, losses = jfit.fit(bad, JCHUNK, chunk_target, steps=7, learning_rate=LR,
                              log_every=0, steps_per_call=3)
    out["chunk"] = (np.array(chunk_target), jax_scene_dict(bad), jax_scene_dict(fitted),
                    losses)
    return out


def test_checkpoint_roundtrip(tmp_path):
    scene = default_scene(num_octaves=3, device="cpu")
    path = os.path.join(tmp_path, "scene.npz")
    ckpt.save_pytree(path, scene)
    other = tfit.perturb_scene(scene, torch.Generator().manual_seed(3))
    restored = ckpt.load_pytree(path, other)
    assert torch.equal(restored.noise.amplitudes, scene.noise.amplitudes)
    assert restored.camera.yaw.item() == scene.camera.yaw.item()
    assert restored.noise.seed.dtype == torch.int32
    assert restored.noise.seed.item() == scene.noise.seed.item()
    assert not torch.equal(other.noise.amplitudes, scene.noise.amplitudes)  # left as it was
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_pytree(path, default_scene(num_octaves=2, device="cpu"))


def test_scene_checkpoint_crosses_with_jax(tmp_path):
    """The port writes the JAX package's keys for a scene: each reads the
    other's file bit for bit."""
    jscene = jfit.perturb_scene(jax_default_scene(num_octaves=3), jax.random.PRNGKey(1))
    jpath, tpath = (os.path.join(tmp_path, f"{k}.npz") for k in ("jax", "port"))
    jckpt.save_pytree(jpath, jscene)
    port = ckpt.load_pytree(jpath, default_scene(num_octaves=3, device="cpu"))
    want = jax_scene_dict(jscene)
    got = {n: x.detach().numpy() for n, x in ckpt._scene_tensors(port).items()}
    assert list(got) == list(LEAF_NAMES)
    for name in LEAF_NAMES:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    ckpt.save_pytree(tpath, port)
    assert sorted(np.load(tpath).files) == sorted(np.load(jpath).files)
    back = jckpt.load_pytree(tpath, jax_default_scene(num_octaves=3))
    for name, value in jax_scene_dict(back).items():
        np.testing.assert_array_equal(value, want[name], err_msg=name)


def test_fit_state_roundtrip_is_bitwise(tmp_path):
    """Parameters, Adam's state (``step`` a CPU float32 tensor, as Adam
    makes it there) and the meta entries come back bit for bit; the write
    leaves no .tmp file; another trainable set is refused."""
    target = torch.zeros(SMALL.height, SMALL.width, 3)
    scene = default_scene(num_octaves=2, device="cpu")
    params = dict(zip(("noise.amplitudes", "camera.position", "camera.yaw", "camera.pitch",
                       "camera.fov_y"), tfit.partition_scene(scene)))
    opt = tfit.make_optimizer(params.values(), LR)
    for _ in range(2):
        tfit.fit_step(scene, SMALL, target, opt)
    path = os.path.join(tmp_path, "state.npz")
    ckpt.save_fit_state(path, params, opt, 2, [0.5, 0.25])
    assert os.listdir(tmp_path) == ["state.npz"]
    keys = sorted(np.load(path).files)
    assert "s0000|noise.amplitudes" in keys and "s0005|adam.noise.amplitudes.step" in keys
    assert "s0019|adam.camera.fov_y.exp_avg_sq" in keys

    fresh = default_scene(num_octaves=2, device="cpu")
    fparams = dict(zip(params, tfit.partition_scene(fresh)))
    fopt = tfit.make_optimizer(fparams.values(), LR)
    step, losses = ckpt.load_fit_state(path, fparams, fopt)
    assert (step, losses) == (2, [0.5, 0.25])
    for name in params:
        assert torch.equal(fparams[name], params[name]), name
        got, want = fopt.state[fparams[name]], opt.state[params[name]]
        for field in ckpt.ADAM_FIELDS:
            assert got[field].dtype == want[field].dtype, (name, field)
            assert got[field].device == want[field].device, (name, field)
            assert torch.equal(got[field], want[field]), (name, field)
    assert fopt.state[fparams["camera.yaw"]]["step"].dtype == torch.float32
    # A step from the restored state equals a step from the saved one.
    assert torch.equal(tfit.fit_step(fresh, SMALL, target, fopt),
                       tfit.fit_step(scene, SMALL, target, opt))
    assert_same_scene(fresh, scene)
    with pytest.raises(ValueError, match="keys"):
        other = default_scene(num_octaves=2, device="cpu")
        only = {"noise.amplitudes": tfit.partition_scene(
            other, lambda n: n == "noise.amplitudes")[0]}
        ckpt.load_fit_state(path, only, tfit.make_optimizer(only.values(), LR))


def test_fit_kill_and_resume_is_exact(tmp_path, jax_runs):
    """A fit checkpointed at step 6 and resumed for 6 more lands on the
    12-step run's parameters and losses bit for bit, and logs the same lines
    from the resume on; both agree with JAX's 12-step run."""
    target, start = jax_runs["small"]
    target = torch.from_numpy(target)
    path = os.path.join(tmp_path, "fit.npz")

    def run(steps, **kw):
        lines = []
        out = tfit.fit(scene_from_numpy(start, device="cpu"), SMALL, target, steps=steps,
                       learning_rate=LR, log_every=4, log_fn=lines.append, **kw)
        return out, lines

    (full, losses_full), lines_full = run(12)
    run(6, save_path=path, save_every=6)  # "killed" after step 6's checkpoint
    (resumed, losses_resumed), lines = run(12, save_path=path, save_every=6, resume=True)
    assert losses_resumed == losses_full
    assert_same_scene(resumed, full)
    assert lines[0] == f"fit: resumed from {path} at step 6"
    assert lines[1:] == [ln for ln in lines_full if int(ln.split()[2]) >= 6]
    assert_matches_jax(resumed, losses_resumed, *jax_runs[12])


def test_fit_resume_without_checkpoint_starts_fresh(tmp_path, jax_runs):
    target, start = jax_runs["small"]
    path = os.path.join(tmp_path, "missing.npz")
    _, losses = tfit.fit(scene_from_numpy(start, device="cpu"), SMALL,
                         torch.from_numpy(target), steps=3, learning_rate=LR, log_every=0,
                         save_path=path, save_every=2, resume=True)
    assert len(losses) == 3
    assert ckpt.load_fit_state(path, *_fresh_state())[0] == 3


def _fresh_state():
    scene = default_scene(num_octaves=2, device="cpu")
    tfit.partition_scene(scene)
    params = {n: p for n, p in scene.named_parameters() if p.requires_grad}
    return params, tfit.make_optimizer(params.values(), LR)


def test_fit_steps_per_call_identical_trajectory(jax_runs):
    """7 steps in chunks of 3 (a tail chunk of 1) equal 7 single steps bit
    for bit on the CPU, and JAX's chunked run at its tolerances."""
    target, start, ref, ref_losses = jax_runs["chunk"]
    target = torch.from_numpy(target)
    fit1, losses1 = tfit.fit(scene_from_numpy(start, device="cpu"), CHUNK, target, steps=7,
                             learning_rate=LR, log_every=0)
    fitk, lossesk = tfit.fit(scene_from_numpy(start, device="cpu"), CHUNK, target, steps=7,
                             learning_rate=LR, log_every=0, steps_per_call=3)
    assert len(lossesk) == 7 and lossesk == losses1
    assert_same_scene(fitk, fit1)
    assert_matches_jax(fitk, lossesk, ref, ref_losses)


def test_fit_steps_per_call_logs_at_chunk_boundaries(jax_runs):
    target, start = jax_runs["small"]
    lines = []
    tfit.fit(scene_from_numpy(start, device="cpu"), SMALL, torch.from_numpy(target),
             steps=12, learning_rate=LR, log_every=5, log_fn=lines.append, steps_per_call=5)
    assert [int(ln.split()[2]) for ln in lines] == [4, 9, 11]


def test_resume_from_jax_checkpoint(tmp_path, jax_runs):
    """JAX's 3 steps, saved by its save_fit_state, resumed in the port for 3
    more: JAX's straight 6-step run at tests/test_torch_fit.py's tolerances.
    The converted file carries JAX's values bit for bit."""
    target, start = jax_runs["small"]
    jdata = np.load(jax_runs["saved3"])
    arrays = fit_state_from_jax(jax_runs["saved3"])
    assert arrays["meta_step"] == 3 and len(arrays["meta_losses"]) == 3
    np.testing.assert_array_equal(arrays["s0000|noise.amplitudes"], jdata["s0000|0.0"])
    np.testing.assert_array_equal(arrays["s0006|adam.noise.amplitudes.exp_avg"],
                                  jdata["s0006|1.0.mu.0"])
    assert arrays["s0008|adam.camera.position.step"].dtype == np.float32
    assert arrays["s0008|adam.camera.position.step"] == 3.0
    path = os.path.join(tmp_path, "from_jax.npz")
    np.savez(path, **arrays)
    scene, losses = tfit.fit(scene_from_numpy(start, device="cpu"), SMALL,
                             torch.from_numpy(target), steps=6, learning_rate=LR,
                             log_every=0, save_path=path, resume=True)
    assert losses[:3] == list(jdata["meta_losses"])
    assert_matches_jax(scene, losses, *jax_runs[6])
    with pytest.raises(ValueError, match="trainable"):
        fit_state_from_jax(jax_runs["saved3"], lambda n: n == "noise.amplitudes")


def test_cli_fit_save_resume_steps_per_call(tmp_path, capsys):
    """``fit --save --save-every --resume --steps-per-call -o``: 4 steps in
    chunks of 2, resumed to 6, write the losses an unbroken 6-step run
    writes, bit for bit."""
    ckpt_path, out, straight = (os.path.join(tmp_path, n) for n in
                                ("fit.npz", "losses.npz", "straight.npz"))
    common = ["fit", "--device", "cpu", "--size", "32x16", "--octaves", "2",
              "--max-steps", "16", "--lr", "1e-2"]
    cli.main(common + ["--steps", "4", "--save", ckpt_path, "--save-every", "2",
                       "--steps-per-call", "2", "-o", out])
    assert len(np.load(out)["losses"]) == 4
    cli.main(common + ["--steps", "6", "--save", ckpt_path, "--resume",
                       "--steps-per-call", "2", "-o", out])
    text = capsys.readouterr().out
    assert f"fit: resumed from {ckpt_path} at step 4" in text
    assert "over 6 steps" in text
    cli.main(common + ["--steps", "6", "-o", straight])
    got, want = np.load(out), np.load(straight)
    assert got["amplitudes"].shape == (2,)
    np.testing.assert_array_equal(got["losses"], want["losses"])
    np.testing.assert_array_equal(got["amplitudes"], want["amplitudes"])


def test_step_chunk_loops_on_the_cpu():
    """On the CPU a chunk is a plain loop: no graph, k losses per call."""
    scene = default_scene(num_octaves=2, device="cpu")
    opt = tfit.make_optimizer(tfit.partition_scene(scene), LR)
    assert opt.param_groups[0]["capturable"] is False
    run = tfit.StepChunk(scene, SMALL, torch.zeros(16, 32, 3), opt, 3)
    assert not run.graphed
    losses = [run(), run.eager(1)]
    assert [tuple(x.shape) for x in losses] == [(3,), (1,)]
    assert run.graph is None and opt.state[scene.noise.amplitudes]["step"].item() == 4.0
