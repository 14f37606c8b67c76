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

#include "field.cuh"

namespace {
constexpr int kThreads = 256;
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
  if (threadIdx.x == 0) load_octaves(sc, cfg.num_octaves, oct);
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

const char* trace_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
