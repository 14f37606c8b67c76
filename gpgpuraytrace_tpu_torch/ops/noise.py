"""Hash-based 2D gradient noise and fBm with analytic derivatives.

Counterpart of ``gpgpuraytrace_tpu/ops/noise.py`` (heightfield subset): the
same int32 lattice hash, 8-direction unit gradients, quintic fade and
per-octave lattice rotation, so both packages produce the same terrain.

The hash runs in int32. Multiplication and addition wrap in two's complement
exactly as the JAX hash does, but torch's ``>>`` on int32 is an arithmetic
shift; ``_lsr`` masks off the sign-extended bits to give the logical shift
the JAX package takes from ``lax.shift_right_logical``.

All functions broadcast over leading dimensions.
"""

from __future__ import annotations

import numpy as np
import torch


def _i32(v: int) -> int:
    """A 32-bit pattern as the signed int32 value with the same bits."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


# murmur3-inspired mixing constants, as int32 values (same bit patterns as
# the uint32 literals).
_C1 = _i32(0x85EBCA6B)
_KX = _i32(0x8DA6B343)
_KZ = _i32(0xD8163841)
_KY = _i32(0xCB1AB31F)
# Corner-offset key sum: the 2x2 cell corners share one linear base.
_KXZ = _i32(_KX + _KZ)

# Gradient decoders read hash bits from here up (only the high half of the
# 2-stage finalizer's product is mixed).
_GRAD_SHIFT = 16
_INV_SQRT5 = 0.4472135954999579
_OCTAVE_ROT = 2.3999632297286535  # golden angle, radians


def _lsr(h: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32 ``h`` by ``k`` (0 < k < 32)."""
    return (h >> k) & ((1 << (32 - k)) - 1)


def _mix(h: torch.Tensor) -> torch.Tensor:
    """2-stage int32 finalizer (xorshift + multiply)."""
    h = h ^ _lsr(h, 16)
    return h * _C1


def _corner_hashes2(ix, iz, seed):
    """Hashes of the 2x2 cell corners (order h00, h10, h01, h11) from int32
    lattice coordinates and an int32 seed."""
    base = ix * _KX + iz * _KZ + torch.as_tensor(seed, dtype=torch.int32) * _KY
    return _mix(base), _mix(base + _KX), _mix(base + _KZ), _mix(base + _KXZ)


def _grad2_raw(h: torch.Tensor):
    """Unnormalized 8-direction gradient (±1, ±2) / (±2, ±1) from a hash;
    the 1/√5 is applied once to the blended result."""
    h = _lsr(h, _GRAD_SHIFT)
    s1 = ((h & 1) * 2 - 1).to(torch.float32)
    s2 = (((h >> 1) & 1) * 2 - 1).to(torch.float32)
    c = ((h >> 2) & 1).to(torch.float32)
    return s1 * (1.0 + c), s2 * (2.0 - c)


def _fade(f: torch.Tensor):
    """Quintic fade u(f) = 6f^5 - 15f^4 + 10f^3 and its derivative."""
    u = f * f * f * (f * (f * 6.0 - 15.0) + 10.0)
    du = 30.0 * f * f * (f * (f - 2.0) + 1.0)
    return u, du


def _cell(x, z, seed):
    x0 = torch.floor(x)
    z0 = torch.floor(z)
    fx = x - x0
    fz = z - z0
    hs = _corner_hashes2(x0.to(torch.int32), z0.to(torch.int32), seed)
    g = [_grad2_raw(h) for h in hs]
    (g00x, g00z), (g10x, g10z), (g01x, g01z), (g11x, g11z) = g
    n00 = g00x * fx + g00z * fz
    n10 = g10x * (fx - 1.0) + g10z * fz
    n01 = g01x * fx + g01z * (fz - 1.0)
    n11 = g11x * (fx - 1.0) + g11z * (fz - 1.0)
    return fx, fz, g, (n00, n10, n01, n11)


def noise2_value(x: torch.Tensor, z: torch.Tensor, seed) -> torch.Tensor:
    """Value-only 2D gradient noise (the march's fast path)."""
    fx, fz, _, (n00, n10, n01, n11) = _cell(x, z, seed)
    u, _ = _fade(fx)
    v, _ = _fade(fz)
    k1 = n10 - n00
    k2 = n01 - n00
    k3 = n00 - n10 - n01 + n11
    return (n00 + u * k1 + v * k2 + u * v * k3) * _INV_SQRT5


def noise2(x: torch.Tensor, z: torch.Tensor, seed):
    """2D gradient noise: (value, d/dx, d/dz), all analytic."""
    fx, fz, g, (n00, n10, n01, n11) = _cell(x, z, seed)
    (g00x, g00z), (g10x, g10z), (g01x, g01z), (g11x, g11z) = g
    u, du = _fade(fx)
    v, dv = _fade(fz)
    k1 = n10 - n00
    k2 = n01 - n00
    k3 = n00 - n10 - n01 + n11
    value = n00 + u * k1 + v * k2 + u * v * k3
    gx_blend = (
        g00x
        + u * (g10x - g00x)
        + v * (g01x - g00x)
        + u * v * (g00x - g10x - g01x + g11x)
    )
    gz_blend = (
        g00z
        + u * (g10z - g00z)
        + v * (g01z - g00z)
        + u * v * (g00z - g10z - g01z + g11z)
    )
    d_dx = gx_blend + du * (k1 + k3 * v)
    d_dz = gz_blend + dv * (k2 + k3 * u)
    return value * _INV_SQRT5, d_dx * _INV_SQRT5, d_dz * _INV_SQRT5


def octave_rotation(i: int) -> tuple[float, float]:
    """(cos, sin) of octave ``i``'s static lattice rotation."""
    return float(np.cos(_OCTAVE_ROT * i)), float(np.sin(_OCTAVE_ROT * i))


def _octaves(amplitudes, lacunarity):
    """Per octave: (i, cos, sin, amp, freq) with freq = lacunarity**i kept
    as a float32 running product, as the JAX package computes it."""
    freq = torch.ones((), dtype=torch.float32, device=amplitudes.device)
    lac = torch.as_tensor(lacunarity, dtype=torch.float32)
    for i in range(amplitudes.shape[0]):
        c, s = octave_rotation(i)
        yield i, c, s, amplitudes[i], freq
        freq = freq * lac


def fbm2(x, z, amplitudes, lacunarity, seed):
    """fBm octave sum: value(p) = Σ amp[i]·noise2(R_i p·lacunarity^i, seed+i),
    with R_i the per-octave lattice rotation. Returns (value, d/dx, d/dz)."""
    value = torch.zeros_like(x, dtype=torch.float32)
    d_dx = torch.zeros_like(value)
    d_dz = torch.zeros_like(value)
    seed = torch.as_tensor(seed, dtype=torch.int32)
    for i, c, s, amp, freq in _octaves(amplitudes, lacunarity):
        cf, sf = c * freq, s * freq
        n, nx, nz = noise2(cf * x - sf * z, sf * x + cf * z, seed + i)
        af = amp * freq
        value = value + amp * n
        d_dx = d_dx + af * (c * nx + s * nz)
        d_dz = d_dz + af * (-s * nx + c * nz)
    return value, d_dx, d_dz


def fbm2_value(x, z, amplitudes, lacunarity, seed):
    """Value-only fBm (the march's fast path; counterpart of the TPU
    kernel's ``_fbm_scalar_amps_value``)."""
    value = torch.zeros_like(x, dtype=torch.float32)
    seed = torch.as_tensor(seed, dtype=torch.int32)
    for i, c, s, amp, freq in _octaves(amplitudes, lacunarity):
        cf, sf = c * freq, s * freq
        value = value + amp * noise2_value(cf * x - sf * z, sf * x + cf * z, seed + i)
    return value
