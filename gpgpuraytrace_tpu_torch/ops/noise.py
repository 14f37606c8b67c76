"""Hash-based 2D and 3D gradient noise and fBm with analytic derivatives.

Counterpart of ``gpgpuraytrace_tpu/ops/noise.py``: the same int32 lattice
hashes, 8-direction (2D) and 12 cube-edge (3D) gradients, quintic fade and
per-octave lattice rotation, so both packages produce the same terrain. The
3D noise drives the volumetric warp.

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
_C2 = _i32(0xC2B2AE35)  # the 3D hash's seed key
_KX = _i32(0x8DA6B343)
_KZ = _i32(0xD8163841)
_KY = _i32(0xCB1AB31F)
# Corner-offset key sums: the 2x2 (2x2x2) cell corners share one linear base.
_KXZ = _i32(_KX + _KZ)
_KXY = _i32(_KX + _KY)
_KYZ = _i32(_KY + _KZ)
_KXYZ = _i32(_KX + _KY + _KZ)

# Gradient decoders read hash bits from here up (only the high half of the
# 2-stage finalizer's product is mixed).
_GRAD_SHIFT = 16
_INV_SQRT5 = 0.4472135954999579
_INV_SQRT2 = 0.7071067811865476
_OCTAVE_ROT = 2.3999632297286535  # golden angle, radians
# Lattice-seed offset of the 3D fBm's octaves: octave i hashes seed + 101 + i.
_WARP_SEED_OFFSET = 101


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


def _fade_dd(f: torch.Tensor) -> torch.Tensor:
    """Second derivative of the quintic fade."""
    return 60.0 * f * (f * (2.0 * f - 3.0) + 1.0)


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


def noise2_value_bf16(x: torch.Tensor, z: torch.Tensor, seed) -> torch.Tensor:
    """``noise2_value`` with its blend math in bfloat16 (the
    ``RenderConfig.march_bf16`` march field; JAX ``noise2_value_bf16``).

    The floor, the cell fractions and the int32 hash stay in float32 and
    int32 (world coordinates reach O(100), where bf16 resolves half a
    lattice cell); the fractions, the raw ±1/±2 corner gradients, the dot
    products, the quintic fades and the lerps are bfloat16, each operation
    rounded, in the JAX operation order; the 1/√5 scale is float32. Returns
    float32."""
    bf = torch.bfloat16
    x0 = torch.floor(x)
    z0 = torch.floor(z)
    fx = (x - x0).to(bf)
    fz = (z - z0).to(bf)
    hs = _corner_hashes2(x0.to(torch.int32), z0.to(torch.int32), seed)
    (g00x, g00z), (g10x, g10z), (g01x, g01z), (g11x, g11z) = (
        tuple(g.to(bf) for g in _grad2_raw(h)) for h in hs)
    fx1, fz1 = fx - 1.0, fz - 1.0
    n00 = g00x * fx + g00z * fz
    n10 = g10x * fx1 + g10z * fz
    n01 = g01x * fx + g01z * fz1
    n11 = g11x * fx1 + g11z * fz1
    u = fx * fx * fx * (fx * (fx * 6.0 - 15.0) + 10.0)
    v = fz * fz * fz * (fz * (fz * 6.0 - 15.0) + 10.0)
    k1 = n10 - n00
    k2 = n01 - n00
    k3 = n00 - n10 - n01 + n11
    blended = n00 + u * k1 + v * k2 + u * v * k3
    return blended.to(torch.float32) * _INV_SQRT5


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


def noise2_hessian(x: torch.Tensor, z: torch.Tensor, seed):
    """Second derivatives (d2/dx2, d2/dxdz, d2/dz2) of ``noise2``'s value,
    by hand: the formula the backward kernel (csrc/field.cuh:noise2_hess)
    evaluates, kept here so the CPU tests can hold it to autograd.

    With the corner gradients' differences A = g10 - g00, C = g01 - g00,
    B = g00 - g10 - g01 + g11 (per component) and the fade's derivatives
    du, ddu (dv, ddv):
      xx = 2·du·(Ax + Bx·v) + ddu·(k1 + k3·v)
      xz = du·(Az + Bz·v) + dv·(Cx + Bx·u) + du·dv·k3
      zz = 2·dv·(Cz + Bz·u) + ddv·(k2 + k3·u)
    """
    fx, fz, g, (n00, n10, n01, n11) = _cell(x, z, seed)
    (g00x, g00z), (g10x, g10z), (g01x, g01z), (g11x, g11z) = g
    u, du = _fade(fx)
    v, dv = _fade(fz)
    ddu, ddv = _fade_dd(fx), _fade_dd(fz)
    k1 = n10 - n00
    k2 = n01 - n00
    k3 = n00 - n10 - n01 + n11
    ax, az = g10x - g00x, g10z - g00z
    cx, cz = g01x - g00x, g01z - g00z
    bx, bz = g00x - g10x - g01x + g11x, g00z - g10z - g01z + g11z
    hxx = 2.0 * du * (ax + bx * v) + ddu * (k1 + k3 * v)
    hxz = du * (az + bz * v) + dv * (cx + bx * u) + du * dv * k3
    hzz = 2.0 * dv * (cz + bz * u) + ddv * (k2 + k3 * u)
    return hxx * _INV_SQRT5, hxz * _INV_SQRT5, hzz * _INV_SQRT5


def _corner_hashes3(ix, iy, iz, seed):
    """Hashes of the 2x2x2 cell corners from int32 lattice coordinates and an
    int32 seed (keyed by _C2). Corner c is bit-packed: c & 1 -> +x,
    (c >> 1) & 1 -> +y, c >> 2 -> +z."""
    base = (ix * _KX + iy * _KY + iz * _KZ
            + torch.as_tensor(seed, dtype=torch.int32) * _C2)
    return tuple(_mix(base + k) for k in (0, _KX, _KY, _KXY, _KZ, _KXZ, _KYZ, _KXYZ))


def _grad3_raw(h: torch.Tensor):
    """Unnormalized cube-edge gradient (components 0/±1) from a hash: bits
    4-5 pick the zero component, with 3 remapped to axis 0; the 1/√2 is
    applied once to the blended result."""
    h = _lsr(h, _GRAD_SHIFT)
    zsel = (h >> 4) & 3
    zero = torch.where(zsel == 3, 0, zsel)
    s1 = ((h & 1) * 2 - 1).to(torch.float32)
    s2 = (((h >> 1) & 1) * 2 - 1).to(torch.float32)
    gx = torch.where(zero == 0, 0.0, s1)
    gy = torch.where(zero == 1, 0.0, torch.where(zero == 0, s1, s2))
    gz = torch.where(zero == 2, 0.0, s2)
    return gx, gy, gz


def _cell3(x, y, z, seed):
    """Per axis: the cell fractions (fx, fy, fz); per corner c: the raw
    gradient components g[axis][c] and the dot products n[c]."""
    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    frac = (x - x0, y - y0, z - z0)
    hs = _corner_hashes3(x0.to(torch.int32), y0.to(torch.int32), z0.to(torch.int32), seed)
    g = ([], [], [])
    n = []
    for c, h in enumerate(hs):
        gxc, gyc, gzc = _grad3_raw(h)
        i, j, k = c & 1, (c >> 1) & 1, (c >> 2) & 1
        n.append(gxc * (frac[0] - i) + gyc * (frac[1] - j) + gzc * (frac[2] - k))
        for axis, gc in enumerate((gxc, gyc, gzc)):
            g[axis].append(gc)
    return frac, g, n


def _trilerp(q, u, v, w):
    q00 = q[0] + u * (q[1] - q[0])
    q10 = q[2] + u * (q[3] - q[2])
    q01 = q[4] + u * (q[5] - q[4])
    q11 = q[6] + u * (q[7] - q[6])
    q0 = q00 + v * (q10 - q00)
    q1 = q01 + v * (q11 - q01)
    return q0 + w * (q1 - q0)


def _axis_diff(q, a: int):
    """q[c + 2^a] - q[c] over the four corners c with bit a clear, in
    increasing c (so the lower of the other two axes varies fastest)."""
    bit = 1 << a
    return [q[c | bit] - q[c] for c in range(8) if not c & bit]


def _bilerp_without(q, a: int, fades):
    """Blend four values ordered as ``_axis_diff`` orders them over the two
    axes other than ``a``, the lower axis first."""
    b, c = (k for k in range(3) if k != a)
    q0 = q[0] + fades[b] * (q[1] - q[0])
    q1 = q[2] + fades[b] * (q[3] - q[2])
    return q0 + fades[c] * (q1 - q0)


def noise3_value(x, y, z, seed) -> torch.Tensor:
    """Value-only 3D gradient noise (the march's fast path)."""
    (fx, fy, fz), _, n = _cell3(x, y, z, seed)
    u, _ = _fade(fx)
    v, _ = _fade(fy)
    w, _ = _fade(fz)
    return _trilerp(n, u, v, w) * _INV_SQRT2


def noise3(x, y, z, seed):
    """3D gradient noise: (value, d/dx, d/dy, d/dz), all analytic."""
    frac, g, n = _cell3(x, y, z, seed)
    fades, dfades = zip(*(_fade(f) for f in frac))
    value = _trilerp(n, *fades)
    # Chain rule: fade-weight term plus the blended corner gradients.
    grads = [dfades[a] * _bilerp_without(_axis_diff(n, a), a, fades) + _trilerp(g[a], *fades)
             for a in range(3)]
    return (value * _INV_SQRT2, *(d * _INV_SQRT2 for d in grads))


def noise3_hessian(x, y, z, seed):
    """Second derivatives (xx, xy, xz, yy, yz, zz) of ``noise3``'s value,
    by hand: the formula the backward kernel (csrc/field.cuh:noise3_hess)
    evaluates, kept here so the CPU tests can hold it to autograd.

    With fades w_a, their derivatives dw_a and ddw_a, D_a the difference
    along axis a (``_axis_diff``), B_a the blend over the other two axes
    (``_bilerp_without``) and M_ab the blend along the third axis of the
    mixed difference n[+a+b] - n[+a] - n[+b] + n[0]:
      aa = ddw_a·B_a(D_a n) + 2·dw_a·B_a(D_a g_a)
      ab = dw_a·dw_b·M_ab + dw_a·B_a(D_a g_b) + dw_b·B_b(D_b g_a)
    """
    frac, g, n = _cell3(x, y, z, seed)
    fades, dfades = zip(*(_fade(f) for f in frac))
    ddfades = [_fade_dd(f) for f in frac]

    def mixed(a, b):
        c = 3 - a - b
        ba, bb, bc = 1 << a, 1 << b, 1 << c
        e = [n[k | ba | bb] - n[k | ba] - n[k | bb] + n[k] for k in (0, bc)]
        return e[0] + fades[c] * (e[1] - e[0])

    def blend_diff(q, a):
        return _bilerp_without(_axis_diff(q, a), a, fades)

    out = []
    for a in range(3):
        for b in range(a, 3):
            if a == b:
                hab = ddfades[a] * blend_diff(n, a) + 2.0 * dfades[a] * blend_diff(g[a], a)
            else:
                hab = (dfades[a] * dfades[b] * mixed(a, b) + dfades[a] * blend_diff(g[b], a)
                       + dfades[b] * blend_diff(g[a], b))
            out.append(hab * _INV_SQRT2)
    return tuple(out)


def _fbm3_octaves(num_octaves: int, lacunarity, gain, seed):
    """Per octave of the 3D fBm: (seed_i, freq_i, amp_i), with freq and amp
    Python floats (``lacunarity**i``, ``gain**i``), as the JAX package keeps
    them."""
    seed = torch.as_tensor(seed, dtype=torch.int32)
    freq, amp = 1.0, 1.0
    for i in range(num_octaves):
        yield seed + _WARP_SEED_OFFSET + i, freq, amp
        freq = freq * lacunarity
        amp = amp * gain


def fbm3_value(x, y, z, num_octaves: int, lacunarity, gain, seed) -> torch.Tensor:
    """Value-only 3D fBm (the march's fast path)."""
    value = torch.zeros_like(x, dtype=torch.float32)
    for s, freq, amp in _fbm3_octaves(num_octaves, lacunarity, gain, seed):
        value = value + amp * noise3_value(x * freq, y * freq, z * freq, s)
    return value


def fbm3(x, y, z, num_octaves: int, lacunarity, gain, seed):
    """3D fBm with amplitude gain**i at frequency lacunarity**i (the
    volumetric warp's octave stack): (value, d/dx, d/dy, d/dz)."""
    value = torch.zeros_like(x, dtype=torch.float32)
    d_dx = torch.zeros_like(value)
    d_dy = torch.zeros_like(value)
    d_dz = torch.zeros_like(value)
    for s, freq, amp in _fbm3_octaves(num_octaves, lacunarity, gain, seed):
        n, nx, ny, nz = noise3(x * freq, y * freq, z * freq, s)
        value = value + amp * n
        d_dx = d_dx + amp * freq * nx
        d_dy = d_dy + amp * freq * ny
        d_dz = d_dz + amp * freq * nz
    return value, d_dx, d_dy, d_dz


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


def fbm2_value(x, z, amplitudes, lacunarity, seed, bf16: bool = False):
    """Value-only fBm (the march's fast path; counterpart of the TPU
    kernel's ``_fbm_scalar_amps_value``). ``bf16`` blends each octave with
    ``noise2_value_bf16``; the rotation, the frequencies and the amplitude
    sum stay float32."""
    nv = noise2_value_bf16 if bf16 else noise2_value
    value = torch.zeros_like(x, dtype=torch.float32)
    seed = torch.as_tensor(seed, dtype=torch.int32)
    for i, c, s, amp, freq in _octaves(amplitudes, lacunarity):
        cf, sf = c * freq, s * freq
        value = value + amp * nv(cf * x - sf * z, sf * x + cf * z, seed + i)
    return value
