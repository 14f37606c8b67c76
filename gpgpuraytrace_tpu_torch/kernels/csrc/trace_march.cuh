// Device code shared by the forward trace kernels (trace_fwd.cu: the one-pass
// kernel and compaction's phase 1; trace_compact.cu: compaction's phase 2):
// the launch config, the sky envelope, the march, the bracketed Newton polish
// with the residual verdict, and the shade. Phase 2 takes march()'s chunked
// step one per iteration of its loop and evaluates the field over a ray's
// group of lanes, summing in the same order; the polish and the shade are
// these. So a ray that phase 2 resumes runs the arithmetic the one-pass
// kernel runs, operation for operation.

#pragma once

#include "field.cuh"

namespace {
// Must match kernels/trace.py:MARCH_MODES.
enum MarchMode : int { kChunked = 0, kFixed = 1, kLod = 2, kCompact = 3 };
// The most frames one launch takes (its grid's y): kernels/trace.py:MAX_FRAMES.
constexpr int kMaxFrames = 65535;
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
  int budget;  // compact: the march steps of this phase
  int phase;  // compact: 1 or 2; 0 for the one-pass kernel
};

namespace {

// Certified terrain upper bound (plus the volumetric warp's tail) plus
// hit_eps (kernels/trace.py:_envelope): rays above it heading up miss.
__device__ __forceinline__ float envelope(const float* sc, const TraceConfig& cfg) {
  float amps_abs = 0.f;
  for (int k = 0; k < cfg.num_octaves; ++k) amps_abs += fabsf(sc[kAmps + k]);
  float env = sc[kHeightOffset] + fabsf(sc[kHeightScale]) * amps_abs;
  if (cfg.volumetric) env = env + fabsf(sc[kWarpAmp]) * warp_tail(cfg.warp_octaves);
  return env + cfg.hit_eps;
}

// One ray's march state: t, the last advancing sample prev_t (the polish's
// bracket), still marching, hit.
struct March {
  float t, prev_t;
  bool active, hit;
};

// Up to n_steps march steps (_tile_trace march_step); returns the
// iterations run while active (the debug_steps count; fixed: n_steps).
// Chunked: a per-thread exit, exact because a finished lane never changes
// state, where the TPU kernel checks for a whole-tile exit every march_chunk
// steps. A hit or an envelope escape ends the march with active false, so
// after the loop active means "still marching" (compaction's alive flag).
// Fixed: no exit; every iteration evaluates f and masks its updates.
// kOctaves: Field::value's unrolled octave count (0: num_octaves' loop).
template <bool kFixedLoop, bool kBf16, bool kDebug, int kOctaves = 0>
__device__ __forceinline__ int march(const Field& field, const Ray& ray, float env,
                                     const TraceConfig& cfg, int n_steps, March& m) {
  const float eps_m = cfg.hit_eps * cfg.march_eps_scale;
  const float oy = ray.oy, dy = ray.dy;
  int executed = 0;
  if constexpr (kFixedLoop) {
    for (int s = 0; s < n_steps; ++s) {
      const float f = field.value<kBf16, kOctaves>(ray, m.t);
      const bool is_hit = m.active & (f < eps_m * m.t);
      const bool escape = m.active & !is_hit & (oy + m.t * dy > env) & (dy >= 0.f);
      const bool advance = m.active & !is_hit & !escape;
      float step = fmaxf(cfg.step_relax * f, cfg.hit_eps);
      if (cfg.step_floor_t > 0.f) step = fmaxf(step, cfg.step_floor_t * m.t);
      const float t_new =
          escape ? cfg.t_max : (advance ? fminf(m.t + step, cfg.t_max) : m.t);
      m.prev_t = advance ? m.t : m.prev_t;
      m.hit = m.hit | is_hit;
      m.active = advance & (t_new < cfg.t_max);
      m.t = t_new;
    }
    executed = n_steps;
  } else {
    for (int s = 0; s < n_steps && m.active; ++s) {
      if constexpr (kDebug) ++executed;
      const float f = field.value<kBf16, kOctaves>(ray, m.t);
      if (f < eps_m * m.t) {
        m.hit = true;
        m.active = false;
        break;
      }
      if (oy + m.t * dy > env && dy >= 0.f) {  // envelope escape: certain miss
        m.t = cfg.t_max;
        m.active = false;
        break;
      }
      float step = fmaxf(cfg.step_relax * f, cfg.hit_eps);
      if (cfg.step_floor_t > 0.f) step = fmaxf(step, cfg.step_floor_t * m.t);
      const float t_new = fminf(m.t + step, cfg.t_max);
      m.prev_t = m.t;
      m.t = t_new;
      m.active = t_new < cfg.t_max;
    }
  }
  return executed;
}

// The bracketed safeguarded-Newton polish of a hit (from its march bracket
// [prev_t, t]), the final field evaluation with the residual verdict, and
// the shade (_shade_from_grads): writes pixel idx of color (3 planes of n),
// t_out and hit_out. ``field`` is a Field, or anything with its value_grad
// (phase 2's, split over a ray's group of lanes).
template <class F>
__device__ __forceinline__ void polish_and_shade(const F& field, const Ray& ray,
                                                 const float* sc, const TraceConfig& cfg,
                                                 float t, float prev_t, bool hit, int idx,
                                                 int n, float* __restrict__ color,
                                                 float* __restrict__ t_out,
                                                 float* __restrict__ hit_out) {
  const float dx = ray.dx, dy = ray.dy, dz = ray.dz;
  float gx = 0.f, gy = 1.f, gz = 0.f, h = 0.f;
  if (hit) {
    // --- bracketed safeguarded-Newton polish ------------------------------
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
    // --- final evaluation: shading normal and residual verdict ------------
    float f_fin;
    field.value_grad(ray, t, f_fin, gx, gy, gz, h);
    if (cfg.march_eps_scale != 1.f) {
      hit = f_fin < kResidualSlack * cfg.hit_eps * t;
    }
  }

  // --- shade (_shade_from_grads) ------------------------------------------
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
  for (int ch = 0; ch < 3; ++ch) {
    const float horizon = sc[kSkyHorizon + ch];
    const float sky = horizon + (sc[kSkyZenith + ch] - horizon) * up_amount +
                      sun_term * sc[kSunColor + ch];
    float out = sky;
    if (hit) {
      const float low = sc[kAlbedoLow + ch];
      float albedo = low + (sc[kAlbedoHigh + ch] - low) * steep;
      albedo = albedo + (sc[kSnowColor + ch] - albedo) * snow;
      const float light = sc[kSunColor + ch] * diffuse + sc[kAmbient + ch] * sky_fill;
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
