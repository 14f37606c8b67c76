// Device code shared by the trace kernels (trace_fwd.cu, trace_bwd.cu): the
// packed-vector layout, the lattice hash, 2D gradient noise with its first
// and second derivatives, the fBm heightfield along a ray, and camera rays.
//
// Everything lives in an anonymous namespace, so each kernel source compiles
// its own copy and the library needs no device linking.
//
// The lattice hash runs in uint32: multiplication wraps exactly as the JAX
// int32 hash does, and >> on unsigned values is the logical shift it takes
// from lax.shift_right_logical.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Packed-vector offsets: gpgpuraytrace_tpu_torch/utils/packing.py.
constexpr int kPos = 0, kFwd = 3, kRight = 6, kUp = 9, kTanFov = 12,
              kAspect = 13, kLacunarity = 14, kHeightScale = 15,
              kHeightOffset = 16, kHorizontalScale = 17, kSunDir = 18,
              kSunColor = 21, kAmbient = 24, kAlbedoLow = 27,
              kAlbedoHigh = 30, kSnowColor = 33, kSnowHeight = 36,
              kFogColor = 37, kFogDensity = 40, kSkyZenith = 41,
              kSkyHorizon = 44, kRow0 = 47, kAmps = 50;
constexpr int kMaxOctaves = 16;  // keep in sync with kernels/trace.py

constexpr uint32_t kC1 = 0x85EBCA6Bu;
constexpr uint32_t kKX = 0x8DA6B343u;
constexpr uint32_t kKZ = 0xD8163841u;
constexpr uint32_t kKY = 0xCB1AB31Fu;
constexpr uint32_t kKXZ = kKX + kKZ;  // wraps, as the JAX constant does
constexpr float kInvSqrt5 = 0.4472135954999579f;
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

// The terrain along one ray: o + t d against the fBm heightfield.
struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

struct Field {
  const float* sc;
  const Octaves* oct;
  int num_octaves;
  uint32_t seed;

  // Value-only field: the march's fast path.
  __device__ __forceinline__ float value(const Ray& r, float t) const {
    const float px = r.ox + t * r.dx;
    const float py = r.oy + t * r.dy;
    const float pz = r.oz + t * r.dz;
    const float hs = sc[kHorizontalScale];
    const float x = px * hs, z = pz * hs;
    float n = 0.f;
    for (int i = 0; i < num_octaves; ++i) {
      n = n + oct->amp[i] * noise2_value(oct->cf[i] * x - oct->sf[i] * z,
                                         oct->sf[i] * x + oct->cf[i] * z,
                                         seed + static_cast<uint32_t>(i));
    }
    return py - (sc[kHeightOffset] + sc[kHeightScale] * n);
  }

  // f, its spatial gradient (gy = 1) and the terrain height h at o + t d.
  __device__ __forceinline__ void value_grad(const Ray& r, float t, float& f,
                                             float& gx, float& gz,
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
    gz = -scale * nzs;
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
