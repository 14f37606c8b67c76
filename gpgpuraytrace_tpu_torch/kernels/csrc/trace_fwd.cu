// Forward trace kernel: raygen -> primed, envelope-skipping sphere-trace
// march -> bracketed Newton polish -> shade, one thread per pixel.
//
// Replaces gpgpuraytrace_tpu/kernels/trace.py:_trace_kernel (heightfield or
// volumetric, optionally primed) with every variant of its march: chunked,
// fixed (no early exit), lod (a certified coarse-field phase, then the fine
// march), the bf16 march field, and the debug_steps executed-step counter.
// The TPU kernel computes the same per pixel over (16, 128) tiles of a
// sequential TPU grid. Its plain PyTorch version is
// gpgpuraytrace_tpu_torch/kernels/trace.py:trace_frame_reference, line for
// line the same arithmetic.
//
// The variants are template parameters (mode, bf16, debug), dispatched by
// trace_fwd_launch, so each instantiation carries only its own march and the
// default (chunked, float, no counter) compiles as it did alone.
//
// What bounds it on the H100: INT32 and FP32 issue. Each march step
// evaluates the value-only fBm, about 77 FP32 and 49 INT32 operations per
// octave (the lattice hash is integer work; plus about 150 and 125 per warp
// octave of the volumetric 3D noise; chip_smoke.py:OPS counts them), and a
// pixel marches a few to tens of steps, while it reads one prime value and
// writes five floats (about 20 bytes). So the design keeps all per-ray state in
// registers and uses shared memory only for the packed scene scalars and the
// per-octave coefficients every thread of the block reads. Each thread stops
// marching as soon as its own ray is done; the TPU kernel instead checks for
// a whole-tile exit every march_chunk steps, which gives the same result
// because a finished lane never changes state, and RenderConfig makes the
// chunk divide max_steps.

#include "field.cuh"

namespace {
constexpr int kThreads = 256;
// Must match kernels/trace.py:MARCH_MODES.
enum MarchMode : int { kChunked = 0, kFixed = 1, kLod = 2 };
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
  int volumetric;  // 1: the field subtracts the 3D fBm warp
  int warp_octaves;
  int march_mode;  // MarchMode
  int bf16;  // 1: bf16 blend math in the march's value-only field
};

namespace {

// The lod march's certified margin (kernels/trace.py:_coarse_field): what
// the octaves past the first k, and the warp octaves past the first wo, can
// add to the field, summed in float in JAX's order.
__device__ __forceinline__ float lod_margin(const float* sc, int num_octaves, int k,
                                            bool volumetric, int warp_octaves, int wo) {
  float skipped = 0.f;
  for (int i = k; i < num_octaves; ++i) skipped = __fadd_rn(skipped, fabsf(sc[kAmps + i]));
  float margin = __fmul_rn(fabsf(sc[kHeightScale]), skipped);
  if (volumetric) {
    float tail = 0.f, amp = 1.f;
    for (int i = 0; i < warp_octaves; ++i) {
      if (i >= wo) tail += amp;
      amp = amp * kWarpGain;
    }
    margin = __fadd_rn(margin, __fmul_rn(fabsf(sc[kWarpAmp]), tail));
  }
  return margin;
}

template <int kMode, bool kBf16, bool kDebug>
__global__ void __launch_bounds__(kThreads)
trace_fwd_kernel(const float* __restrict__ packed, const int* __restrict__ seed_ptr,
                 const float* __restrict__ prime, float* __restrict__ color,
                 float* __restrict__ t_out, float* __restrict__ hit_out,
                 int* __restrict__ steps_out, TraceConfig cfg) {
  __shared__ float sc[kAmps + kMaxOctaves];
  __shared__ Octaves oct;
  __shared__ float margin;  // lod only
  const int n_params = kAmps + cfg.num_octaves;
  const int k_coarse = max(1, (cfg.num_octaves + 1) / 2);
  const int wo_coarse = max(1, cfg.warp_octaves - 1);
  for (int k = threadIdx.x; k < n_params; k += blockDim.x) sc[k] = packed[k];
  __syncthreads();
  if (threadIdx.x == 0) {
    load_octaves(sc, cfg.num_octaves, oct);
    if constexpr (kMode == kLod) {
      margin = lod_margin(sc, cfg.num_octaves, k_coarse, cfg.volumetric != 0,
                          cfg.warp_octaves, wo_coarse);
    }
  }
  __syncthreads();

  const int n_pix = cfg.local_h * cfg.width;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_pix) return;
  const int row = idx / cfg.width;
  const int col = idx - row * cfg.width;

  // --- raygen (kernels/trace.py:_raygen_rc) ------------------------------
  const CameraRay cr = camera_ray(sc, cfg.height, cfg.width, row, col);
  const float dx = cr.dx, dy = cr.dy, dz = cr.dz;
  const Ray ray{sc[kPos + 0], sc[kPos + 1], sc[kPos + 2], dx, dy, dz};
  const uint32_t seed = static_cast<uint32_t>(*seed_ptr);
  const Field field{sc, &oct, cfg.num_octaves, seed, cfg.volumetric != 0,
                    cfg.warp_octaves};

  // --- sky-envelope entry (_envelope, _envelope_entry) -------------------
  float amps_abs = 0.f;
  for (int k = 0; k < cfg.num_octaves; ++k) amps_abs += fabsf(sc[kAmps + k]);
  float env = sc[kHeightOffset] + fabsf(sc[kHeightScale]) * amps_abs;
  if (cfg.volumetric) env = env + fabsf(sc[kWarpAmp]) * warp_tail(cfg.warp_octaves);
  env = env + cfg.hit_eps;  // the entry below and the escape test in the march
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

  if constexpr (kMode == kLod) {
    // --- lod phase 1 (_trace_kernel lod branch, _coarse_field_fn) -------
    // Step on f_coarse - margin <= f while it exceeds max(margin/2,
    // hit_eps t): no step can pass a surface of the full field. A parked
    // lane never changes state again, so the per-thread exit is exact.
    const Field coarse{sc, &oct, k_coarse, seed, cfg.volumetric != 0, wo_coarse};
    const float park_eps = 0.5f * margin;
    for (int s = 0; s < cfg.max_steps && active; ++s) {
      const float fl = coarse.value(ray, t) - margin;
      if (!(fl > fmaxf(park_eps, cfg.hit_eps * t))) break;  // parked
      if (oy + t * dy > env && dy >= 0.f) {  // envelope escape: certain miss
        t = cfg.t_max;
        break;
      }
      t = fminf(__fadd_rn(t, __fmul_rn(cfg.step_relax, fl)), cfg.t_max);
      active = t < cfg.t_max;
    }
    // Phase 2 is the standard march from the parked t.
    active = t < cfg.t_max;
    prev_t = t;
  }

  // --- march (_tile_trace march_step) --------------------------------------
  const float eps_m = cfg.hit_eps * cfg.march_eps_scale;
  bool hit = false;
  int executed = 0;  // iterations run while active (the debug_steps count)
  if constexpr (kMode == kFixed) {
    // No early exit: every thread runs all max_steps iterations and
    // evaluates f in each; a finished lane's updates are masked, so it
    // changes no state and the result equals the chunked march's.
    for (int s = 0; s < cfg.max_steps; ++s) {
      const float f = field.value<kBf16>(ray, t);
      const bool is_hit = active & (f < eps_m * t);
      const bool escape = active & !is_hit & (oy + t * dy > env) & (dy >= 0.f);
      const bool advance = active & !is_hit & !escape;
      float step = fmaxf(cfg.step_relax * f, cfg.hit_eps);
      if (cfg.step_floor_t > 0.f) step = fmaxf(step, cfg.step_floor_t * t);
      const float t_new = escape ? cfg.t_max : (advance ? fminf(t + step, cfg.t_max) : t);
      prev_t = advance ? t : prev_t;
      hit = hit | is_hit;
      active = advance & (t_new < cfg.t_max);
      t = t_new;
    }
    executed = cfg.max_steps;
  } else {
    // Per-thread exit: a finished lane never changes state, so stopping it
    // early gives what the TPU kernel's whole-tile chunked exit gives.
    for (int s = 0; s < cfg.max_steps && active; ++s) {
      if constexpr (kDebug) ++executed;
      const float f = field.value<kBf16>(ray, t);
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
  }
  if constexpr (kDebug) steps_out[idx] = executed;

  float gx = 0.f, gy = 1.f, gz = 0.f, h = 0.f;
  if (hit) {
    // --- bracketed safeguarded-Newton polish --------------------------
    float f0;
    field.value_grad(ray, t, f0, gx, gy, gz, h);
    const float denom0 = gx * dx + gy * dy + gz * dz;
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
      field.value_grad(ray, x, f, gx, gy, gz, h);
      const float denom = gx * dx + gy * dy + gz * dz;
      const bool safe = fabsf(denom) > kDenomEps;
      const float newton = x - (safe ? f / denom : 0.f);
      if (f > 0.f) lo = x;
      if (f <= 0.f) hi = x;
      if (safe) x = fmaxf(clip(newton, lo, fminf(hi, cfg.t_max)), cfg.t_min);
    }
    t = x;
    // --- final evaluation: shading normal and residual verdict --------
    float f_fin;
    field.value_grad(ray, t, f_fin, gx, gy, gz, h);
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

template <int kMode, bool kBf16, bool kDebug>
void launch_variant(const float* packed, const int* seed, const float* prime, float* color,
                    float* t, float* hit, int* steps, const TraceConfig& cfg,
                    cudaStream_t stream) {
  const int n_pix = cfg.local_h * cfg.width;
  const int blocks = (n_pix + kThreads - 1) / kThreads;
  trace_fwd_kernel<kMode, kBf16, kDebug><<<blocks, kThreads, 0, stream>>>(
      packed, seed, prime, color, t, hit, steps, cfg);
}

template <int kMode>
void launch_mode(const float* packed, const int* seed, const float* prime, float* color,
                 float* t, float* hit, int* steps, const TraceConfig& cfg,
                 cudaStream_t stream) {
  const bool bf16 = cfg.bf16 != 0, debug = steps != nullptr;
  if (bf16 && debug) {
    launch_variant<kMode, true, true>(packed, seed, prime, color, t, hit, steps, cfg, stream);
  } else if (bf16) {
    launch_variant<kMode, true, false>(packed, seed, prime, color, t, hit, steps, cfg, stream);
  } else if (debug) {
    launch_variant<kMode, false, true>(packed, seed, prime, color, t, hit, steps, cfg, stream);
  } else {
    launch_variant<kMode, false, false>(packed, seed, prime, color, t, hit, steps, cfg, stream);
  }
}

}  // namespace

extern "C" {

// Launches the kernel instantiation that cfg.march_mode, cfg.bf16 and
// ``steps`` select on ``stream`` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers; ``prime`` is null unless
// cfg.primed, ``steps`` (an int32 per pixel) null unless the counter is
// wanted. The caller validates shapes, dtypes and contiguity.
int trace_fwd_launch(const float* packed, const int* seed, const float* prime,
                     float* color, float* t, float* hit, int* steps, TraceConfig cfg,
                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cfg.march_mode) {
    case kChunked:
      launch_mode<kChunked>(packed, seed, prime, color, t, hit, steps, cfg, s);
      break;
    case kFixed:
      launch_mode<kFixed>(packed, seed, prime, color, t, hit, steps, cfg, s);
      break;
    case kLod:
      launch_mode<kLod>(packed, seed, prime, color, t, hit, steps, cfg, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* trace_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
