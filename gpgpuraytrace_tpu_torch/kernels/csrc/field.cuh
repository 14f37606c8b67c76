// Device code shared by the trace kernels (trace_fwd.cu, trace_bwd.cu): the
// packed-vector layout, the lattice hashes, 2D and 3D gradient noise with
// their first and second derivatives (and the 2D value with bf16 blend
// math), the terrain field along a ray (the fBm heightfield, plus the 3D fBm
// warp in volumetric mode), and camera rays.
//
// Everything lives in an anonymous namespace, so each kernel source compiles
// its own copy and the library needs no device linking.
//
// The lattice hash runs in uint32: multiplication wraps exactly as the JAX
// int32 hash does, and >> on unsigned values is the logical shift it takes
// from lax.shift_right_logical.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Packed-vector offsets: gpgpuraytrace_tpu_torch/utils/packing.py.
constexpr int kPos = 0, kFwd = 3, kRight = 6, kUp = 9, kTanFov = 12,
              kAspect = 13, kLacunarity = 14, kHeightScale = 15,
              kHeightOffset = 16, kHorizontalScale = 17, kSunDir = 18,
              kSunColor = 21, kAmbient = 24, kAlbedoLow = 27,
              kAlbedoHigh = 30, kSnowColor = 33, kSnowHeight = 36,
              kFogColor = 37, kFogDensity = 40, kSkyZenith = 41,
              kSkyHorizon = 44, kRow0 = 47, kWarpAmp = 48, kWarpFreq = 49,
              kAmps = 50;
constexpr int kMaxOctaves = 16;  // keep in sync with kernels/trace.py

constexpr uint32_t kC1 = 0x85EBCA6Bu;
constexpr uint32_t kKX = 0x8DA6B343u;
constexpr uint32_t kKZ = 0xD8163841u;
constexpr uint32_t kKY = 0xCB1AB31Fu;
constexpr uint32_t kC2 = 0xC2B2AE35u;  // the 3D hash's seed key
constexpr uint32_t kKXZ = kKX + kKZ;  // wraps, as the JAX constant does
constexpr uint32_t kKXY = kKX + kKY;
constexpr uint32_t kKYZ = kKY + kKZ;
constexpr uint32_t kKXYZ = kKX + kKY + kKZ;
constexpr float kInvSqrt5 = 0.4472135954999579f;
constexpr float kInvSqrt2 = 0.7071067811865476f;
// The volumetric warp: octave i of the 3D fBm hashes seed + 101 + i at
// frequency 2^i with amplitude 0.5^i (ops/field.py:WARP_LACUNARITY, WARP_GAIN).
constexpr uint32_t kWarpSeedOffset = 101u;
constexpr float kWarpLacunarity = 2.f, kWarpGain = 0.5f;
constexpr double kOctaveRot = 2.3999632297286535;  // golden angle

constexpr float kDenomEps = 1e-4f;
constexpr float kDenomMin = 1e-2f;
constexpr float kPrimePullback = 0.9f;
constexpr float kResidualSlack = 2.0f;

// Per-octave coefficients, the same for every pixel of a frame.
struct Octaves {
  float cf[kMaxOctaves];    // cos_i * freq_i
  float sf[kMaxOctaves];    // sin_i * freq_i
  float c[kMaxOctaves];     // cos_i
  float s[kMaxOctaves];     // sin_i
  float amp[kMaxOctaves];   // amplitude_i
  float af[kMaxOctaves];    // amplitude_i * freq_i
  float freq[kMaxOctaves];  // freq_i = lacunarity^i
};

// Fills ``oct`` from the packed scalars ``sc`` (one thread): freq_i as a
// float32 running product, and the octave's static lattice rotation, rounded
// to float as the JAX package does.
__device__ __forceinline__ void load_octaves(const float* sc, int num_octaves,
                                             Octaves& oct) {
  float freq = 1.f;
  for (int i = 0; i < num_octaves; ++i) {
    double s, c;
    sincos(kOctaveRot * i, &s, &c);
    const float cf = static_cast<float>(c), sf = static_cast<float>(s);
    oct.c[i] = cf;
    oct.s[i] = sf;
    oct.cf[i] = cf * freq;
    oct.sf[i] = sf * freq;
    oct.amp[i] = sc[kAmps + i];
    oct.af[i] = sc[kAmps + i] * freq;
    oct.freq[i] = freq;
    freq = freq * sc[kLacunarity];
  }
}

__device__ __forceinline__ uint32_t mix(uint32_t h) {
  h ^= h >> 16;
  return h * kC1;
}

// Raw 8-direction gradient (+-1, +-2) / (+-2, +-1) from hash bits 16+.
__device__ __forceinline__ void grad2(uint32_t h, float& gx, float& gz) {
  const uint32_t g = h >> 16;
  const float s1 = (g & 1u) ? 1.f : -1.f;
  const float s2 = (g & 2u) ? 1.f : -1.f;
  const float c = static_cast<float>((g >> 2) & 1u);
  gx = s1 * (1.f + c);
  gz = s2 * (2.f - c);
}

struct Cell {
  float fx, fz;
  float g00x, g00z, g10x, g10z, g01x, g01z, g11x, g11z;
  float n00, n10, n01, n11;
};

__device__ __forceinline__ Cell cell(float x, float z, uint32_t seed) {
  Cell k;
  const float x0 = floorf(x);
  const float z0 = floorf(z);
  k.fx = x - x0;
  k.fz = z - z0;
  const uint32_t ix = static_cast<uint32_t>(static_cast<int>(x0));
  const uint32_t iz = static_cast<uint32_t>(static_cast<int>(z0));
  const uint32_t base = ix * kKX + iz * kKZ + seed * kKY;
  grad2(mix(base), k.g00x, k.g00z);
  grad2(mix(base + kKX), k.g10x, k.g10z);
  grad2(mix(base + kKZ), k.g01x, k.g01z);
  grad2(mix(base + kKXZ), k.g11x, k.g11z);
  k.n00 = k.g00x * k.fx + k.g00z * k.fz;
  k.n10 = k.g10x * (k.fx - 1.f) + k.g10z * k.fz;
  k.n01 = k.g01x * k.fx + k.g01z * (k.fz - 1.f);
  k.n11 = k.g11x * (k.fx - 1.f) + k.g11z * (k.fz - 1.f);
  return k;
}

__device__ __forceinline__ float fade(float f) {
  return f * f * f * (f * (f * 6.f - 15.f) + 10.f);
}

__device__ __forceinline__ float fade_d(float f) {
  return 30.f * f * f * (f * (f - 2.f) + 1.f);
}

__device__ __forceinline__ float fade_dd(float f) {
  return 60.f * f * (f * (2.f * f - 3.f) + 1.f);
}

__device__ __forceinline__ float noise2_value(float x, float z, uint32_t seed) {
  const Cell k = cell(x, z, seed);
  const float u = fade(k.fx);
  const float v = fade(k.fz);
  const float k1 = k.n10 - k.n00;
  const float k2 = k.n01 - k.n00;
  const float k3 = k.n00 - k.n10 - k.n01 + k.n11;
  return (k.n00 + u * k1 + v * k2 + u * v * k3) * kInvSqrt5;
}

// bf16 arithmetic rounded after every operation: the _rn intrinsics are
// never contracted into an FMA, and a product or sum of two bf16 values is
// exact in float, so this rounds as torch's bf16 ops do (float, then round).
__device__ __forceinline__ __nv_bfloat16 bf_dot(__nv_bfloat16 a, __nv_bfloat16 b,
                                                __nv_bfloat16 c, __nv_bfloat16 d) {
  return __hadd_rn(__hmul_rn(a, b), __hmul_rn(c, d));
}

__device__ __forceinline__ __nv_bfloat16 fade_bf16(__nv_bfloat16 f) {
  const __nv_bfloat16 six = __float2bfloat16_rn(6.f);
  const __nv_bfloat16 fifteen = __float2bfloat16_rn(15.f);
  const __nv_bfloat16 ten = __float2bfloat16_rn(10.f);
  return __hmul_rn(__hmul_rn(__hmul_rn(f, f), f),
                   __hadd_rn(__hmul_rn(f, __hsub_rn(__hmul_rn(f, six), fifteen)), ten));
}

// noise2_value with its blend math in bf16 (ops/noise.py:noise2_value_bf16,
// the march field of RenderConfig.march_bf16): the floor, the fractions and
// the hash in float and uint32; the fractions, the raw corner gradients, the
// dot products, the fades and the lerps in bf16, in the JAX operation order;
// the 1/sqrt(5) in float.
__device__ __forceinline__ float noise2_value_bf16(float x, float z, uint32_t seed) {
  const float x0 = floorf(x);
  const float z0 = floorf(z);
  const __nv_bfloat16 fx = __float2bfloat16_rn(x - x0);
  const __nv_bfloat16 fz = __float2bfloat16_rn(z - z0);
  const uint32_t ix = static_cast<uint32_t>(static_cast<int>(x0));
  const uint32_t iz = static_cast<uint32_t>(static_cast<int>(z0));
  const uint32_t base = ix * kKX + iz * kKZ + seed * kKY;
  const uint32_t off[4] = {0u, kKX, kKZ, kKXZ};
  __nv_bfloat16 gx[4], gz[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float fgx, fgz;
    grad2(mix(base + off[c]), fgx, fgz);
    gx[c] = __float2bfloat16_rn(fgx);  // +-1, +-2: exact
    gz[c] = __float2bfloat16_rn(fgz);
  }
  const __nv_bfloat16 one = __float2bfloat16_rn(1.f);
  const __nv_bfloat16 fx1 = __hsub_rn(fx, one), fz1 = __hsub_rn(fz, one);
  const __nv_bfloat16 n00 = bf_dot(gx[0], fx, gz[0], fz);
  const __nv_bfloat16 n10 = bf_dot(gx[1], fx1, gz[1], fz);
  const __nv_bfloat16 n01 = bf_dot(gx[2], fx, gz[2], fz1);
  const __nv_bfloat16 n11 = bf_dot(gx[3], fx1, gz[3], fz1);
  const __nv_bfloat16 u = fade_bf16(fx);
  const __nv_bfloat16 v = fade_bf16(fz);
  const __nv_bfloat16 k1 = __hsub_rn(n10, n00);
  const __nv_bfloat16 k2 = __hsub_rn(n01, n00);
  const __nv_bfloat16 k3 = __hadd_rn(__hsub_rn(__hsub_rn(n00, n10), n01), n11);
  const __nv_bfloat16 blended =
      __hadd_rn(__hadd_rn(__hadd_rn(n00, __hmul_rn(u, k1)), __hmul_rn(v, k2)),
                __hmul_rn(__hmul_rn(u, v), k3));
  return __bfloat162float(blended) * kInvSqrt5;
}

// The adjoint of noise2_value_bf16 (the march channel of the backward under
// march_bf16): its value, and the cotangents of x and z for an output
// cotangent out_bar, derived by hand and rounded to bf16 after every
// operation in the order torch's autograd rounds ops/noise.py:
// noise2_value_bf16's (a product's two cotangents in its operands' order, a
// value used k times summing its k cotangents in the order autograd's engine
// delivers them: the node made last runs first). The floor and the hash have
// no cotangent; multiplying by a corner gradient (+-1, +-2) is exact.
__device__ __forceinline__ void noise2_value_bf16_bwd(float x, float z, uint32_t seed,
                                                      float out_bar, float& value,
                                                      float& x_bar, float& z_bar) {
  const float x0 = floorf(x);
  const float z0 = floorf(z);
  const __nv_bfloat16 fx = __float2bfloat16_rn(x - x0);
  const __nv_bfloat16 fz = __float2bfloat16_rn(z - z0);
  const uint32_t ix = static_cast<uint32_t>(static_cast<int>(x0));
  const uint32_t iz = static_cast<uint32_t>(static_cast<int>(z0));
  const uint32_t base = ix * kKX + iz * kKZ + seed * kKY;
  const uint32_t off[4] = {0u, kKX, kKZ, kKXZ};
  __nv_bfloat16 gx[4], gz[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float fgx, fgz;
    grad2(mix(base + off[c]), fgx, fgz);
    gx[c] = __float2bfloat16_rn(fgx);
    gz[c] = __float2bfloat16_rn(fgz);
  }
  const __nv_bfloat16 one = __float2bfloat16_rn(1.f);
  const __nv_bfloat16 six = __float2bfloat16_rn(6.f);
  const __nv_bfloat16 fifteen = __float2bfloat16_rn(15.f);
  const __nv_bfloat16 ten = __float2bfloat16_rn(10.f);
  const __nv_bfloat16 fx1 = __hsub_rn(fx, one), fz1 = __hsub_rn(fz, one);
  const __nv_bfloat16 n00 = bf_dot(gx[0], fx, gz[0], fz);
  const __nv_bfloat16 n10 = bf_dot(gx[1], fx1, gz[1], fz);
  const __nv_bfloat16 n01 = bf_dot(gx[2], fx, gz[2], fz1);
  const __nv_bfloat16 n11 = bf_dot(gx[3], fx1, gz[3], fz1);
  // The fades' intermediates: a = f f, b = a f, d = f 6 - 15, e = f d,
  // ff = e + 10, fade = b ff.
  const __nv_bfloat16 ua = __hmul_rn(fx, fx), ub = __hmul_rn(ua, fx);
  const __nv_bfloat16 ud = __hsub_rn(__hmul_rn(fx, six), fifteen);
  const __nv_bfloat16 uf = __hadd_rn(__hmul_rn(fx, ud), ten);
  const __nv_bfloat16 u = __hmul_rn(ub, uf);
  const __nv_bfloat16 va = __hmul_rn(fz, fz), vb = __hmul_rn(va, fz);
  const __nv_bfloat16 vd = __hsub_rn(__hmul_rn(fz, six), fifteen);
  const __nv_bfloat16 vf = __hadd_rn(__hmul_rn(fz, vd), ten);
  const __nv_bfloat16 v = __hmul_rn(vb, vf);
  const __nv_bfloat16 k1 = __hsub_rn(n10, n00);
  const __nv_bfloat16 k2 = __hsub_rn(n01, n00);
  const __nv_bfloat16 k3 = __hadd_rn(__hsub_rn(__hsub_rn(n00, n10), n01), n11);
  const __nv_bfloat16 uv = __hmul_rn(u, v);
  const __nv_bfloat16 blended =
      __hadd_rn(__hadd_rn(__hadd_rn(n00, __hmul_rn(u, k1)), __hmul_rn(v, k2)),
                __hmul_rn(uv, k3));
  value = __bfloat162float(blended) * kInvSqrt5;

  // --- reverse: blended = ((n00 + u k1) + v k2) + uv k3 ------------------
  const __nv_bfloat16 bb = __float2bfloat16_rn(__fmul_rn(out_bar, kInvSqrt5));
  const __nv_bfloat16 uvb = __hmul_rn(bb, k3), k3b = __hmul_rn(bb, uv);
  const __nv_bfloat16 k2b = __hmul_rn(bb, v), k1b = __hmul_rn(bb, u);
  const __nv_bfloat16 u_bar = __hadd_rn(__hmul_rn(uvb, v), __hmul_rn(bb, k1));
  const __nv_bfloat16 v_bar = __hadd_rn(__hmul_rn(uvb, u), __hmul_rn(bb, k2));
  // n00 feeds the blend, k3, k2 and k1, delivered in that order.
  const __nv_bfloat16 n00b = __hsub_rn(__hsub_rn(__hadd_rn(bb, k3b), k2b), k1b);
  const __nv_bfloat16 n10b = __hsub_rn(k1b, k3b);
  const __nv_bfloat16 n01b = __hsub_rn(k2b, k3b);
  const __nv_bfloat16 n11b = k3b;
  // A fade's cotangent of f, in delivery order: e's, c's, b's, then a's two.
  auto fade_bar = [six](__nv_bfloat16 f, __nv_bfloat16 fb, __nv_bfloat16 a,
                        __nv_bfloat16 b, __nv_bfloat16 d, __nv_bfloat16 ff) {
    const __nv_bfloat16 b_bar = __hmul_rn(fb, ff), ff_bar = __hmul_rn(fb, b);
    __nv_bfloat16 acc = __hmul_rn(ff_bar, d);
    const __nv_bfloat16 d_bar = __hmul_rn(ff_bar, f);
    acc = __hadd_rn(acc, __hmul_rn(d_bar, six));
    const __nv_bfloat16 a_bar = __hmul_rn(b_bar, f);
    acc = __hadd_rn(acc, __hmul_rn(b_bar, a));
    acc = __hadd_rn(acc, __hmul_rn(a_bar, f));
    return __hadd_rn(acc, __hmul_rn(a_bar, f));
  };
  __nv_bfloat16 fxb = fade_bar(fx, u_bar, ua, ub, ud, uf);
  __nv_bfloat16 fzb = fade_bar(fz, v_bar, va, vb, vd, vf);
  const __nv_bfloat16 fx1b = bf_dot(n11b, gx[3], n10b, gx[1]);
  const __nv_bfloat16 fz1b = bf_dot(n11b, gz[3], n01b, gz[2]);
  fxb = __hadd_rn(__hadd_rn(__hadd_rn(fxb, __hmul_rn(n01b, gx[2])), __hmul_rn(n00b, gx[0])),
                  fx1b);
  fzb = __hadd_rn(__hadd_rn(__hadd_rn(fzb, __hmul_rn(n10b, gz[1])), __hmul_rn(n00b, gz[0])),
                  fz1b);
  x_bar = __bfloat162float(fxb);
  z_bar = __bfloat162float(fzb);
}

__device__ __forceinline__ void noise2(float x, float z, uint32_t seed,
                                       float& value, float& d_dx, float& d_dz) {
  const Cell k = cell(x, z, seed);
  const float u = fade(k.fx), du = fade_d(k.fx);
  const float v = fade(k.fz), dv = fade_d(k.fz);
  const float k1 = k.n10 - k.n00;
  const float k2 = k.n01 - k.n00;
  const float k3 = k.n00 - k.n10 - k.n01 + k.n11;
  const float val = k.n00 + u * k1 + v * k2 + u * v * k3;
  const float gx = k.g00x + u * (k.g10x - k.g00x) + v * (k.g01x - k.g00x) +
                   u * v * (k.g00x - k.g10x - k.g01x + k.g11x);
  const float gz = k.g00z + u * (k.g10z - k.g00z) + v * (k.g01z - k.g00z) +
                   u * v * (k.g00z - k.g10z - k.g01z + k.g11z);
  value = val * kInvSqrt5;
  d_dx = (gx + du * (k1 + k3 * v)) * kInvSqrt5;
  d_dz = (gz + dv * (k2 + k3 * u)) * kInvSqrt5;
}

// noise2 plus its Hessian (hxx, hxz, hzz), derived by hand
// (ops/noise.py:noise2_hessian states the formula; the CPU tests hold it to
// autograd). A = g10 - g00, C = g01 - g00, B = g00 - g10 - g01 + g11.
__device__ __forceinline__ void noise2_hess(float x, float z, uint32_t seed,
                                            float& value, float& d_dx,
                                            float& d_dz, float& hxx,
                                            float& hxz, float& hzz) {
  const Cell k = cell(x, z, seed);
  const float u = fade(k.fx), du = fade_d(k.fx), ddu = fade_dd(k.fx);
  const float v = fade(k.fz), dv = fade_d(k.fz), ddv = fade_dd(k.fz);
  const float k1 = k.n10 - k.n00;
  const float k2 = k.n01 - k.n00;
  const float k3 = k.n00 - k.n10 - k.n01 + k.n11;
  const float ax = k.g10x - k.g00x, az = k.g10z - k.g00z;
  const float cx = k.g01x - k.g00x, cz = k.g01z - k.g00z;
  const float bx = k.g00x - k.g10x - k.g01x + k.g11x;
  const float bz = k.g00z - k.g10z - k.g01z + k.g11z;
  const float val = k.n00 + u * k1 + v * k2 + u * v * k3;
  const float gx = k.g00x + u * ax + v * cx + u * v * bx;
  const float gz = k.g00z + u * az + v * cz + u * v * bz;
  value = val * kInvSqrt5;
  d_dx = (gx + du * (k1 + k3 * v)) * kInvSqrt5;
  d_dz = (gz + dv * (k2 + k3 * u)) * kInvSqrt5;
  hxx = (2.f * du * (ax + bx * v) + ddu * (k1 + k3 * v)) * kInvSqrt5;
  hxz = (du * (az + bz * v) + dv * (cx + bx * u) + du * dv * k3) * kInvSqrt5;
  hzz = (2.f * dv * (cz + bz * u) + ddv * (k2 + k3 * u)) * kInvSqrt5;
}

// Raw cube-edge gradient (components 0/+-1) from hash bits 16+: bits 4-5 pick
// the zero component (3 remaps to axis 0), bits 0 and 1 the signs.
__device__ __forceinline__ void grad3(uint32_t h, float& gx, float& gy, float& gz) {
  const uint32_t g = h >> 16;
  uint32_t zero = (g >> 4) & 3u;
  if (zero == 3u) zero = 0u;
  const float s1 = (g & 1u) ? 1.f : -1.f;
  const float s2 = (g & 2u) ? 1.f : -1.f;
  gx = zero == 0u ? 0.f : s1;
  gy = zero == 1u ? 0.f : (zero == 0u ? s1 : s2);
  gz = zero == 2u ? 0.f : s2;
}

// One 3D lattice cell. Corner c is bit-packed (bit a set: the +1 corner along
// axis a); per axis the fraction f[a], per corner the raw gradient g[a][c]
// and the dot product n[c] = g[c] . (f - c).
struct Cell3 {
  float f[3];
  float g[3][8];
  float n[8];
};

__device__ __forceinline__ void cell3(float x, float y, float z, uint32_t seed,
                                      Cell3& k) {
  const float x0 = floorf(x), y0 = floorf(y), z0 = floorf(z);
  k.f[0] = x - x0;
  k.f[1] = y - y0;
  k.f[2] = z - z0;
  const uint32_t ix = static_cast<uint32_t>(static_cast<int>(x0));
  const uint32_t iy = static_cast<uint32_t>(static_cast<int>(y0));
  const uint32_t iz = static_cast<uint32_t>(static_cast<int>(z0));
  const uint32_t base = ix * kKX + iy * kKY + iz * kKZ + seed * kC2;
  const uint32_t off[8] = {0u, kKX, kKY, kKXY, kKZ, kKXZ, kKYZ, kKXYZ};
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    grad3(mix(base + off[c]), k.g[0][c], k.g[1][c], k.g[2][c]);
    k.n[c] = k.g[0][c] * (k.f[0] - static_cast<float>(c & 1)) +
             k.g[1][c] * (k.f[1] - static_cast<float>((c >> 1) & 1)) +
             k.g[2][c] * (k.f[2] - static_cast<float>(c >> 2));
  }
}

__device__ __forceinline__ float trilerp(const float (&q)[8], const float (&w)[3]) {
  const float q00 = q[0] + w[0] * (q[1] - q[0]);
  const float q10 = q[2] + w[0] * (q[3] - q[2]);
  const float q01 = q[4] + w[0] * (q[5] - q[4]);
  const float q11 = q[6] + w[0] * (q[7] - q[6]);
  const float q0 = q00 + w[1] * (q10 - q00);
  const float q1 = q01 + w[1] * (q11 - q01);
  return q0 + w[2] * (q1 - q0);
}

// B_A(D_A q) of ops/noise.py:noise3_hessian: the differences q[c + 2^A] - q[c]
// over the four corners c with bit A clear, blended over the two other axes,
// the lower one first.
template <int A>
__device__ __forceinline__ float blend_diff(const float (&q)[8], const float (&w)[3]) {
  constexpr int b = A == 0 ? 1 : 0, c = A == 2 ? 1 : 2;
  float d[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int k = ((m >> A) << (A + 1)) | (m & ((1 << A) - 1));
    d[m] = q[k | (1 << A)] - q[k];
  }
  const float q0 = d[0] + w[b] * (d[1] - d[0]);
  const float q1 = d[2] + w[b] * (d[3] - d[2]);
  return q0 + w[c] * (q1 - q0);
}

// M_AB: the mixed difference n[+A+B] - n[+A] - n[+B] + n[0], blended along
// the third axis.
template <int A, int B>
__device__ __forceinline__ float mixed_diff(const float (&n)[8], const float (&w)[3]) {
  constexpr int c = 3 - A - B, ba = 1 << A, bb = 1 << B, bc = 1 << c;
  const float e0 = n[ba | bb] - n[ba] - n[bb] + n[0];
  const float e1 = n[bc | ba | bb] - n[bc | ba] - n[bc | bb] + n[bc];
  return e0 + w[c] * (e1 - e0);
}

__device__ __forceinline__ float noise3_value(float x, float y, float z, uint32_t seed) {
  Cell3 k;
  cell3(x, y, z, seed, k);
  const float w[3] = {fade(k.f[0]), fade(k.f[1]), fade(k.f[2])};
  return trilerp(k.n, w) * kInvSqrt2;
}

// 3D noise, its gradient d (ops/noise.py:noise3) and its Hessian
// hs = (xx, xy, xz, yy, yz, zz), derived by hand (ops/noise.py:noise3_hessian
// states the formula; the CPU tests hold it to autograd). A caller that
// ignores hs leaves it to dead-code elimination.
__device__ __forceinline__ void noise3_hess(float x, float y, float z, uint32_t seed,
                                            float& value, float (&d)[3],
                                            float (&hs)[6]) {
  Cell3 k;
  cell3(x, y, z, seed, k);
  const float w[3] = {fade(k.f[0]), fade(k.f[1]), fade(k.f[2])};
  const float dw[3] = {fade_d(k.f[0]), fade_d(k.f[1]), fade_d(k.f[2])};
  const float ddw[3] = {fade_dd(k.f[0]), fade_dd(k.f[1]), fade_dd(k.f[2])};
  const float bn[3] = {blend_diff<0>(k.n, w), blend_diff<1>(k.n, w), blend_diff<2>(k.n, w)};
  value = trilerp(k.n, w) * kInvSqrt2;
  d[0] = (dw[0] * bn[0] + trilerp(k.g[0], w)) * kInvSqrt2;
  d[1] = (dw[1] * bn[1] + trilerp(k.g[1], w)) * kInvSqrt2;
  d[2] = (dw[2] * bn[2] + trilerp(k.g[2], w)) * kInvSqrt2;
  hs[0] = (ddw[0] * bn[0] + 2.f * dw[0] * blend_diff<0>(k.g[0], w)) * kInvSqrt2;
  hs[1] = (dw[0] * dw[1] * mixed_diff<0, 1>(k.n, w) + dw[0] * blend_diff<0>(k.g[1], w) +
           dw[1] * blend_diff<1>(k.g[0], w)) * kInvSqrt2;
  hs[2] = (dw[0] * dw[2] * mixed_diff<0, 2>(k.n, w) + dw[0] * blend_diff<0>(k.g[2], w) +
           dw[2] * blend_diff<2>(k.g[0], w)) * kInvSqrt2;
  hs[3] = (ddw[1] * bn[1] + 2.f * dw[1] * blend_diff<1>(k.g[1], w)) * kInvSqrt2;
  hs[4] = (dw[1] * dw[2] * mixed_diff<1, 2>(k.n, w) + dw[1] * blend_diff<1>(k.g[2], w) +
           dw[2] * blend_diff<2>(k.g[1], w)) * kInvSqrt2;
  hs[5] = (ddw[2] * bn[2] + 2.f * dw[2] * blend_diff<2>(k.g[2], w)) * kInvSqrt2;
}

// The volumetric warp's 3D fBm at q (ops/noise.py:fbm3_value, fbm3): octave i
// at frequency 2^i, amplitude 0.5^i, seed + 101 + i; both exact in float.
__device__ __forceinline__ float fbm3_value(float x, float y, float z, int octaves,
                                            uint32_t seed) {
  float value = 0.f, freq = 1.f, amp = 1.f;
  for (int i = 0; i < octaves; ++i) {
    value = value + amp * noise3_value(x * freq, y * freq, z * freq,
                                       seed + kWarpSeedOffset + static_cast<uint32_t>(i));
    freq = freq * kWarpLacunarity;
    amp = amp * kWarpGain;
  }
  return value;
}

// The 3D fBm's value, gradient d and Hessian hs = (xx, xy, xz, yy, yz, zz)
// in q.
__device__ __forceinline__ void fbm3_hess(float x, float y, float z, int octaves,
                                          uint32_t seed, float& value, float (&d)[3],
                                          float (&hs)[6]) {
  value = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) d[a] = 0.f;
#pragma unroll
  for (int a = 0; a < 6; ++a) hs[a] = 0.f;
  float freq = 1.f, amp = 1.f;
  for (int i = 0; i < octaves; ++i) {
    float n, nd[3], nh[6];
    noise3_hess(x * freq, y * freq, z * freq,
                seed + kWarpSeedOffset + static_cast<uint32_t>(i), n, nd, nh);
    value = value + amp * n;
    const float af = amp * freq, aff = af * freq;
#pragma unroll
    for (int a = 0; a < 3; ++a) d[a] = d[a] + af * nd[a];
#pragma unroll
    for (int a = 0; a < 6; ++a) hs[a] = hs[a] + aff * nh[a];
    freq = freq * kWarpLacunarity;
    amp = amp * kWarpGain;
  }
}

// Σ gain^i over the warp octaves: |fbm3| never exceeds it, so the envelope
// adds |warp_amplitude| times it (ops/field.py:warp_tail).
__device__ __forceinline__ float warp_tail(int octaves) {
  float tail = 0.f, amp = 1.f;
  for (int i = 0; i < octaves; ++i) {
    tail += amp;
    amp = amp * kWarpGain;
  }
  return tail;
}

// One primary ray (kernels/trace.py:_raygen_rc), with the intermediates the
// backward pulls back through: d = u / |u|, u = fwd + sx right + sy up.
struct CameraRay {
  float ndc_x, ndc_y, sx, sy;
  float ux, uy, uz, inv;
  float dx, dy, dz;
};

__device__ __forceinline__ CameraRay camera_ray(const float* sc, int height,
                                                int width, int row, int col) {
  CameraRay r;
  const float rows = static_cast<float>(row) + sc[kRow0];
  r.ndc_x = (static_cast<float>(col) + 0.5f) * static_cast<float>(2.0 / width) - 1.f;
  r.ndc_y = 1.f - (rows + 0.5f) * static_cast<float>(2.0 / height);
  r.sx = sc[kTanFov] * sc[kAspect] * r.ndc_x;
  r.sy = sc[kTanFov] * r.ndc_y;
  r.ux = sc[kFwd + 0] + r.sx * sc[kRight + 0] + r.sy * sc[kUp + 0];
  r.uy = sc[kFwd + 1] + r.sx * sc[kRight + 1] + r.sy * sc[kUp + 1];
  r.uz = sc[kFwd + 2] + r.sx * sc[kRight + 2] + r.sy * sc[kUp + 2];
  r.inv = rsqrtf(r.ux * r.ux + r.uy * r.uy + r.uz * r.uz);
  r.dx = r.ux * r.inv;
  r.dy = r.uy * r.inv;
  r.dz = r.uz * r.inv;
  return r;
}

// The terrain along one ray: o + t d against the fBm heightfield, minus the
// 3D fBm warp wa * fbm3(wf p) in volumetric mode.
struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

struct Field {
  const float* sc;
  const Octaves* oct;
  int num_octaves;
  uint32_t seed;
  bool volumetric;
  int warp_octaves;

  // Octave i of the heightfield's fBm at (x, z), before its amplitude.
  template <bool kBf16>
  __device__ __forceinline__ float octave(float x, float z, int i) const {
    const float xi = oct->cf[i] * x - oct->sf[i] * z;
    const float zi = oct->sf[i] * x + oct->cf[i] * z;
    const uint32_t si = seed + static_cast<uint32_t>(i);
    if constexpr (kBf16) {
      return noise2_value_bf16(xi, zi, si);
    } else {
      return noise2_value(xi, zi, si);
    }
  }

  // Value-only field: the march's fast path; kBf16 blends each octave of
  // the heightfield in bf16 (the warp stays float). kOctaves > 0 unrolls
  // the octaves (it must equal num_octaves), so their independent noise
  // chains interleave; the sum keeps its order, octave 0 first, either way.
  template <bool kBf16 = false, int kOctaves = 0>
  __device__ __forceinline__ float value(const Ray& r, float t) const {
    const float px = r.ox + t * r.dx;
    const float py = r.oy + t * r.dy;
    const float pz = r.oz + t * r.dz;
    const float hs = sc[kHorizontalScale];
    const float x = px * hs, z = pz * hs;
    float n = 0.f;
    if constexpr (kOctaves > 0) {
#pragma unroll
      for (int i = 0; i < kOctaves; ++i) n = n + oct->amp[i] * octave<kBf16>(x, z, i);
    } else {
      for (int i = 0; i < num_octaves; ++i) n = n + oct->amp[i] * octave<kBf16>(x, z, i);
    }
    float f = py - (sc[kHeightOffset] + sc[kHeightScale] * n);
    if (volumetric) {
      const float wf = sc[kWarpFreq];
      f = f - sc[kWarpAmp] * fbm3_value(px * wf, py * wf, pz * wf, warp_octaves, seed);
    }
    return f;
  }

  // f, its spatial gradient (gx, gy, gz) and the terrain height h at o + t d.
  __device__ __forceinline__ void value_grad(const Ray& r, float t, float& f,
                                             float& gx, float& gy, float& gz,
                                             float& h) const {
    const float px = r.ox + t * r.dx;
    const float py = r.oy + t * r.dy;
    const float pz = r.oz + t * r.dz;
    const float hs = sc[kHorizontalScale];
    const float x = px * hs, z = pz * hs;
    float n = 0.f, nxs = 0.f, nzs = 0.f;
    for (int i = 0; i < num_octaves; ++i) {
      float v, nx, nz;
      noise2(oct->cf[i] * x - oct->sf[i] * z, oct->sf[i] * x + oct->cf[i] * z,
             seed + static_cast<uint32_t>(i), v, nx, nz);
      n = n + oct->amp[i] * v;
      nxs = nxs + oct->af[i] * (oct->c[i] * nx + oct->s[i] * nz);
      nzs = nzs + oct->af[i] * (-oct->s[i] * nx + oct->c[i] * nz);
    }
    h = sc[kHeightOffset] + sc[kHeightScale] * n;
    const float scale = sc[kHeightScale] * hs;
    f = py - h;
    gx = -scale * nxs;
    gy = 1.f;
    gz = -scale * nzs;
    if (volumetric) {
      const float wa = sc[kWarpAmp], wf = sc[kWarpFreq];
      float n3, d3[3], h3[6];
      fbm3_hess(px * wf, py * wf, pz * wf, warp_octaves, seed, n3, d3, h3);
      f = f - wa * n3;
      const float waf = wa * wf;
      gx = gx - waf * d3[0];
      gy = gy - waf * d3[1];
      gz = gz - waf * d3[2];
    }
  }
};

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float smoothstep(float lo, float hi_minus_lo,
                                            float x) {
  const float u = clip((x - lo) / hi_minus_lo, 0.f, 1.f);
  return u * u * (3.f - 2.f * u);
}

}  // namespace
