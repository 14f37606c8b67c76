"""Noise of the PyTorch port against the JAX package: the integer lattice
hash bit for bit, and noise/fBm values and analytic derivatives to 1e-6.
Then the statistics of tests/test_noise.py on the port's noise alone, with
its bounds: zero mean and a non-degenerate spread, the gradient set's
isotropy and adjacent-cell decorrelation, distinct octave rotations, and the
amplitude-fit landscape with and without the per-octave rotation."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpgpuraytrace_tpu.kernels import trace as jtrace
from gpgpuraytrace_tpu.ops import noise as jn
from gpgpuraytrace_tpu_torch.models.scene import RenderConfig
from gpgpuraytrace_tpu_torch.ops import noise as tn

torch.set_num_threads(2)

ATOL = 1e-6


@pytest.mark.parametrize("seed", [0, 7, -3, 2**31 - 1])
def test_corner_hashes_equal_as_integers(seed):
    # Negative lattice coordinates give negative int32 bases, where an
    # arithmetic >> would differ from the JAX package's logical shift.
    ix, iz = np.meshgrid(np.arange(-300, 300, 7, dtype=np.int32),
                         np.arange(-260, 340, 11, dtype=np.int32))
    s = np.int32(seed)
    ref = jn._corner_hashes2(jnp.asarray(ix), jnp.asarray(iz), jnp.int32(s))
    got = tn._corner_hashes2(torch.from_numpy(ix), torch.from_numpy(iz),
                             torch.tensor(s))
    for r, g in zip(ref, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(
            np.stack(tn._grad2_raw(g)), np.stack([np.asarray(x) for x in jn._grad2_raw(r)])
        )


def test_octave_rotation_matches():
    for i in range(8):
        assert tn.octave_rotation(i) == jn.octave_rotation(i)


def _points(seed, n=4096, scale=40.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-scale, scale, n).astype(np.float32),
            rng.uniform(-scale, scale, n).astype(np.float32))


AMPS = np.asarray([1.0, 0.5, 0.25], np.float32)
LAC = np.float32(2.0)


@pytest.mark.parametrize("fn", ["noise2", "noise2_value", "fbm2", "fbm2_value"])
def test_noise_values_and_derivatives_match(fn):
    x, z = _points(1)
    tx, tz = torch.from_numpy(x), torch.from_numpy(z)
    jx, jz = jnp.asarray(x), jnp.asarray(z)
    seed = np.int32(7)
    if fn == "noise2":
        ref = jn.noise2(jx, jz, jnp.int32(seed))
        got = tn.noise2(tx, tz, torch.tensor(seed))
    elif fn == "noise2_value":
        ref = (jn.noise2_value(jx, jz, jnp.int32(seed)),)
        got = (tn.noise2_value(tx, tz, torch.tensor(seed)),)
    elif fn == "fbm2":
        ref = jn.fbm2(jx, jz, jnp.asarray(AMPS), jnp.float32(LAC), jnp.int32(seed))
        got = tn.fbm2(tx, tz, torch.from_numpy(AMPS), torch.tensor(LAC), torch.tensor(seed))
    else:
        # The TPU kernel's value-only fBm (amplitudes as scalars).
        ref = (jtrace._fbm_scalar_amps_value(
            jx, jz, tuple(jnp.float32(a) for a in AMPS), jnp.float32(LAC),
            jnp.int32(seed)),)
        got = (tn.fbm2_value(tx, tz, torch.from_numpy(AMPS), torch.tensor(LAC),
                             torch.tensor(seed)),)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=ATOL)


def test_fbm2_value_equals_fbm2_value_part():
    x, z = _points(2)
    tx, tz = torch.from_numpy(x), torch.from_numpy(z)
    amps, lac, seed = torch.from_numpy(AMPS), torch.tensor(LAC), torch.tensor(11)
    v, _, _ = tn.fbm2(tx, tz, amps, lac, seed)
    np.testing.assert_allclose(
        tn.fbm2_value(tx, tz, amps, lac, seed).numpy(), v.numpy(), rtol=0, atol=ATOL
    )


# --- The statistics of tests/test_noise.py, on the port's noise -------------
# (test_noise.py:40, :134, :174, :246, :253), with the reference's bounds.


def _grid(n=64, lo=-10.0, hi=10.0):
    xs = torch.linspace(lo, hi, n)
    zs = torch.linspace(lo, hi, n) + 0.317
    return torch.meshgrid(xs, zs, indexing="ij")


def test_noise2_statistics():
    x, z = _grid(n=256, lo=-50, hi=50)
    v = tn.noise2(x, z, torch.tensor(11, dtype=torch.int32))[0].numpy()
    assert abs(v.mean()) < 0.05  # zero-mean
    assert 0.05 < v.std() < 0.5  # non-degenerate


def test_grad2_isotropy_statistics():
    """The 8-direction gradient set over 256x256 cells (``_grad2`` of the
    reference is ``_grad2_raw`` times 1/sqrt(5), of the cell's own hash, the
    first of ``_corner_hashes2``): exactly unit, the 8 directions within 15%
    of a uniform share, isotropic second moment, and adjacent cells sharing
    a direction near 1/8 of the time."""
    ix, iz = torch.meshgrid(torch.arange(-128, 128, dtype=torch.int32),
                            torch.arange(-128, 128, dtype=torch.int32), indexing="ij")
    h = tn._corner_hashes2(ix, iz, torch.tensor(7, dtype=torch.int32))[0]
    gx, gz = (g.numpy().ravel() * tn._INV_SQRT5 for g in tn._grad2_raw(h))
    np.testing.assert_allclose(np.hypot(gx, gz), 1.0, atol=1e-6)
    ang = np.round(np.arctan2(gz, gx), 4)
    vals, counts = np.unique(ang, return_counts=True)
    assert len(vals) == 8, f"expected 8 distinct directions, got {len(vals)}"
    freq = counts / gx.size
    assert freq.min() > 0.125 * 0.85 and freq.max() < 0.125 * 1.15, freq
    assert abs(gx.mean()) < 0.02 and abs(gz.mean()) < 0.02
    np.testing.assert_allclose((gx * gx).mean(), 0.5, atol=0.01)
    np.testing.assert_allclose((gz * gz).mean(), 0.5, atol=0.01)
    assert abs((gx * gz).mean()) < 0.01
    code = ang.reshape(256, 256)
    for axis in (0, 1):
        agree = float((np.take(code, range(255), axis=axis)
                       == np.take(code, range(1, 256), axis=axis)).mean())
        assert 0.10 < agree < 0.15, f"adjacent-cell gradient agreement {agree:.3f} (axis {axis})"


def test_octave_rotation_angles_distinct():
    angles = [np.arctan2(tn.octave_rotation(i)[1], tn.octave_rotation(i)[0]) for i in range(8)]
    for i in range(8):
        for j in range(i + 1, 8):
            d = abs(angles[i] - angles[j]) % (2 * np.pi)
            d = min(d, 2 * np.pi - d)
            assert d > 0.3, f"octaves {i},{j} nearly aligned ({d:.3f} rad)"


def _amp_fit_from_trap_start(monkeypatch, rotation_fn=None, round3_hash=False, steps=80):
    """test_noise.py:_amp_fit_from_trap_start on the port: Adam on the
    amplitudes alone from amplitudes x 0.5, 2 octaves at 96x96, the plain
    path at the reference's pinned march (relax 0.7, 4 Newton steps,
    unprimed); returns the largest relative amplitude error. ``rotation_fn``
    replaces ``octave_rotation``; ``round3_hash`` restores the full murmur
    finalizer and the low-bit gradient decode of the older terrain."""
    from gpgpuraytrace_tpu_torch import default_scene, render
    from gpgpuraytrace_tpu_torch.ops.fit import fit

    if rotation_fn is not None:
        monkeypatch.setattr(tn, "octave_rotation", rotation_fn)
    if round3_hash:
        def full_mix(h):
            h = h ^ tn._lsr(h, 16)
            h = h * tn._C1
            h = h ^ tn._lsr(h, 13)
            h = h * tn._C2
            return h ^ tn._lsr(h, 16)

        monkeypatch.setattr(tn, "_mix", full_mix)
        monkeypatch.setattr(tn, "_GRAD_SHIFT", 0)
    cfg = RenderConfig(height=96, width=96, max_steps=48, num_octaves=2, use_kernel=False,
                       step_relax=0.7, newton_iters=4, prime_ds=0)
    scene = default_scene(num_octaves=2, device="cpu")
    with torch.no_grad():
        target = render(scene, cfg)
    start = copy.deepcopy(scene)
    with torch.no_grad():
        start.noise.amplitudes.mul_(0.5)
    out, _ = fit(start, cfg, target, steps=steps, learning_rate=2e-2,
                 trainable=lambda n: n == "noise.amplitudes", steps_per_call=10, log_every=0)
    want = scene.noise.amplitudes.detach()
    return float(((out.noise.amplitudes.detach() - want).abs() / want).max())


def test_rotation_repairs_amplitude_fit_landscape(monkeypatch):
    assert _amp_fit_from_trap_start(monkeypatch) < 0.02


def test_rotation_guard_is_sensitive(monkeypatch):
    err = _amp_fit_from_trap_start(monkeypatch, rotation_fn=lambda i: (1.0, 0.0),
                                   round3_hash=True)
    assert err > 0.04, f"identity-rotation fit on the round-3 noise reached {err:.4f}"
    monkeypatch.undo()
    assert _amp_fit_from_trap_start(monkeypatch, round3_hash=True) < 0.02
