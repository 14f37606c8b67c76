// Forward trace kernel: raygen -> primed, envelope-skipping sphere-trace
// march -> bracketed Newton polish -> shade, one thread per pixel.
//
// Replaces gpgpuraytrace_tpu/kernels/trace.py:_trace_kernel (chunked march,
// heightfield, optionally primed), which computes the same per pixel over
// (16, 128) tiles of a sequential TPU grid. Its plain PyTorch version is
// gpgpuraytrace_tpu_torch/kernels/trace.py:trace_frame_reference, line for
// line the same arithmetic.
//
// What bounds it on the H100: FP32/INT32 issue. Each march step evaluates
// the value-only fBm, about octaves x 60 integer and float operations, and a
// pixel marches tens of steps, while it reads one prime value and writes
// five floats (about 20 bytes). So the design keeps all per-ray state in
// registers and uses shared memory only for the packed scene scalars and the
// per-octave coefficients every thread of the block reads. Each thread stops
// marching as soon as its own ray is done; the TPU kernel instead checks for
// a whole-tile exit every march_chunk steps, which gives the same result
// because a finished lane never changes state, and RenderConfig makes the
// chunk divide max_steps.
//
// The lattice hash runs in uint32: multiplication wraps exactly as the JAX
// int32 hash does, and >> on unsigned values is the logical shift it takes
// from lax.shift_right_logical.

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
constexpr int kThreads = 256;

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

}  // namespace

// Must match kernels/trace.py:TraceConfig field for field.
struct TraceConfig {
  int height;  // full image height (NDC scale)
  int width;
  int local_h;  // rows rendered by this launch
  int max_steps;
  int num_octaves;
  int newton_iters;
  float t_min;
  float t_max;
  float hit_eps;
  float march_eps_scale;
  float step_relax;
  float step_floor_t;
  int primed;  // 1: prime holds a (local_h, width) march-start map
};

namespace {

struct Octaves {
  float cf[kMaxOctaves];   // cos_i * freq_i
  float sf[kMaxOctaves];   // sin_i * freq_i
  float c[kMaxOctaves];    // cos_i
  float s[kMaxOctaves];    // sin_i
  float amp[kMaxOctaves];  // amplitude_i
  float af[kMaxOctaves];   // amplitude_i * freq_i
};

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

__global__ void __launch_bounds__(kThreads)
trace_fwd_kernel(const float* __restrict__ packed, const int* __restrict__ seed_ptr,
                 const float* __restrict__ prime, float* __restrict__ color,
                 float* __restrict__ t_out, float* __restrict__ hit_out,
                 TraceConfig cfg) {
  __shared__ float sc[kAmps + kMaxOctaves];
  __shared__ Octaves oct;
  const int n_params = kAmps + cfg.num_octaves;
  for (int k = threadIdx.x; k < n_params; k += blockDim.x) sc[k] = packed[k];
  __syncthreads();
  if (threadIdx.x == 0) {
    // freq_i = lacunarity^i as a float32 running product, and the octave's
    // static lattice rotation, rounded to float as the JAX package does.
    float freq = 1.f;
    for (int i = 0; i < cfg.num_octaves; ++i) {
      double s, c;
      sincos(kOctaveRot * i, &s, &c);
      const float cf = static_cast<float>(c), sf = static_cast<float>(s);
      oct.c[i] = cf;
      oct.s[i] = sf;
      oct.cf[i] = cf * freq;
      oct.sf[i] = sf * freq;
      oct.amp[i] = sc[kAmps + i];
      oct.af[i] = sc[kAmps + i] * freq;
      freq = freq * sc[kLacunarity];
    }
  }
  __syncthreads();

  const int n_pix = cfg.local_h * cfg.width;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_pix) return;
  const int row = idx / cfg.width;
  const int col = idx - row * cfg.width;

  // --- raygen (kernels/trace.py:_raygen_rc) ------------------------------
  const float rows = static_cast<float>(row) + sc[kRow0];
  const float ndc_x =
      (static_cast<float>(col) + 0.5f) * static_cast<float>(2.0 / cfg.width) - 1.f;
  const float ndc_y =
      1.f - (rows + 0.5f) * static_cast<float>(2.0 / cfg.height);
  const float sx = sc[kTanFov] * sc[kAspect] * ndc_x;
  const float sy = sc[kTanFov] * ndc_y;
  float dx = sc[kFwd + 0] + sx * sc[kRight + 0] + sy * sc[kUp + 0];
  float dy = sc[kFwd + 1] + sx * sc[kRight + 1] + sy * sc[kUp + 1];
  float dz = sc[kFwd + 2] + sx * sc[kRight + 2] + sy * sc[kUp + 2];
  const float inv = rsqrtf(dx * dx + dy * dy + dz * dz);
  dx *= inv;
  dy *= inv;
  dz *= inv;
  const Ray ray{sc[kPos + 0], sc[kPos + 1], sc[kPos + 2], dx, dy, dz};
  const Field field{sc, &oct, cfg.num_octaves, static_cast<uint32_t>(*seed_ptr)};

  // --- sky-envelope entry (_envelope, _envelope_entry) -------------------
  float amps_abs = 0.f;
  for (int k = 0; k < cfg.num_octaves; ++k) amps_abs += fabsf(sc[kAmps + k]);
  const float env =
      (sc[kHeightOffset] + fabsf(sc[kHeightScale]) * amps_abs) + cfg.hit_eps;
  const float oy = ray.oy;
  float t = cfg.t_min;
  if (oy > env) {
    t = dy < 0.f ? clip((env - oy) / dy, cfg.t_min, cfg.t_max) : cfg.t_max;
  }
  bool active = t < cfg.t_max;
  float prev_t = t;
  if (cfg.primed) {
    t = fmaxf(t, prime[idx]);
    active = active && t < cfg.t_max;
    prev_t = fmaxf(t * kPrimePullback, cfg.t_min);
  }

  // --- march (_tile_trace march_step), per-thread exit ------------------
  const float eps_m = cfg.hit_eps * cfg.march_eps_scale;
  bool hit = false;
  for (int s = 0; s < cfg.max_steps && active; ++s) {
    const float f = field.value(ray, t);
    if (f < eps_m * t) {
      hit = true;
      break;
    }
    if (oy + t * dy > env && dy >= 0.f) {  // envelope escape: certain miss
      t = cfg.t_max;
      break;
    }
    float step = fmaxf(cfg.step_relax * f, cfg.hit_eps);
    if (cfg.step_floor_t > 0.f) step = fmaxf(step, cfg.step_floor_t * t);
    const float t_new = fminf(t + step, cfg.t_max);
    prev_t = t;
    t = t_new;
    active = t_new < cfg.t_max;
  }

  float gx = 0.f, gz = 0.f, h = 0.f;
  if (hit) {
    // --- bracketed safeguarded-Newton polish --------------------------
    float f0;
    field.value_grad(ray, t, f0, gx, gz, h);
    const float denom0 = gx * dx + dy + gz * dz;
    const float down0 = fmaxf(-denom0, kDenomMin);
    float hi = t + fmaxf(f0, 0.f) / down0 * 1.25f + cfg.hit_eps;
    float lo = prev_t;
    const bool safe0 = fabsf(denom0) > kDenomEps;
    const float newton0 = t - (safe0 ? f0 / denom0 : 0.f);
    if (f0 > 0.f) lo = t;
    if (f0 <= 0.f) hi = t;
    float x = safe0 ? fmaxf(clip(newton0, lo, fminf(hi, cfg.t_max)), cfg.t_min) : t;
    for (int k = 1; k < cfg.newton_iters; ++k) {
      float f;
      field.value_grad(ray, x, f, gx, gz, h);
      const float denom = gx * dx + dy + gz * dz;
      const bool safe = fabsf(denom) > kDenomEps;
      const float newton = x - (safe ? f / denom : 0.f);
      if (f > 0.f) lo = x;
      if (f <= 0.f) hi = x;
      if (safe) x = fmaxf(clip(newton, lo, fminf(hi, cfg.t_max)), cfg.t_min);
    }
    t = x;
    // --- final evaluation: shading normal and residual verdict --------
    float f_fin;
    field.value_grad(ray, t, f_fin, gx, gz, h);
    if (cfg.march_eps_scale != 1.f) {
      hit = f_fin < kResidualSlack * cfg.hit_eps * t;
    }
  }

  // --- shade (_shade_from_grads) ----------------------------------------
  const float lx = sc[kSunDir + 0], ly = sc[kSunDir + 1], lz = sc[kSunDir + 2];
  const float up_amount = clip(dy, 0.f, 1.f);
  const float cos_sun = clip(dx * lx + dy * ly + dz * lz, 0.f, 1.f);
  const float c2 = cos_sun * cos_sun;
  const float c4 = c2 * c2;
  const float c8 = c4 * c4;
  const float c16 = c8 * c8;
  const float c64 = c16 * c16 * c16 * c16;
  const float c512 = c64 * c64 * c64 * c64 * c64 * c64 * c64 * c64;
  const float sun_term = 0.25f * c64 + 1.5f * c512;

  float steep = 0.f, snow = 0.f, diffuse = 0.f, sky_fill = 0.f, fog = 0.f;
  if (hit) {
    const float gy = 1.f;
    const float ninv = rsqrtf(gx * gx + gy * gy + gz * gz + 1e-12f);
    const float nx = gx * ninv, ny = gy * ninv, nz = gz * ninv;
    steep = smoothstep(0.85f, static_cast<float>(0.55 - 0.85), ny);
    const float snow_h = sc[kSnowHeight];
    snow = smoothstep(snow_h, (snow_h + 1.f) - snow_h, h) * (1.f - steep);
    diffuse = clip(nx * lx + ny * ly + nz * lz, 0.f, 1.f);
    sky_fill = 0.5f + 0.5f * ny;
    fog = 1.f - expf(-sc[kFogDensity] * t);
  }
  const int n = n_pix;
  for (int ch = 0; ch < 3; ++ch) {
    const float horizon = sc[kSkyHorizon + ch];
    const float sky = horizon + (sc[kSkyZenith + ch] - horizon) * up_amount +
                      sun_term * sc[kSunColor + ch];
    float out = sky;
    if (hit) {
      const float low = sc[kAlbedoLow + ch];
      float albedo = low + (sc[kAlbedoHigh + ch] - low) * steep;
      albedo = albedo + (sc[kSnowColor + ch] - albedo) * snow;
      const float light =
          sc[kSunColor + ch] * diffuse + sc[kAmbient + ch] * sky_fill;
      float surf = albedo * light;
      const float fog_tint = 0.5f * (sc[kFogColor + ch] + sky);
      surf = surf + (fog_tint - surf) * fog;
      out = surf;
    }
    color[ch * n + idx] = out;
  }
  t_out[idx] = t;
  hit_out[idx] = hit ? 1.f : 0.f;
}

}  // namespace

extern "C" {

// Launches the kernel on ``stream`` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers; ``prime`` is null unless
// cfg.primed. The caller validates shapes, dtypes and contiguity.
int trace_fwd_launch(const float* packed, const int* seed, const float* prime,
                     float* color, float* t, float* hit, TraceConfig cfg,
                     void* stream) {
  const int n_pix = cfg.local_h * cfg.width;
  const int blocks = (n_pix + kThreads - 1) / kThreads;
  trace_fwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      packed, seed, prime, color, t, hit, cfg);
  return static_cast<int>(cudaGetLastError());
}

const char* trace_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
