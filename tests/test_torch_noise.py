"""Noise of the PyTorch port against the JAX package: the integer lattice
hash bit for bit, and noise/fBm values and analytic derivatives to 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpgpuraytrace_tpu.kernels import trace as jtrace
from gpgpuraytrace_tpu.ops import noise as jn
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
