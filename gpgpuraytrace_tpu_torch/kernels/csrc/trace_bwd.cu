// Backward trace kernel: output-colour cotangent -> packed scene-parameter
// cotangent, one thread per pixel, then a deterministic two-step reduction.
//
// Replaces gpgpuraytrace_tpu/kernels/trace.py:_trace_bwd_kernel (launched by
// _backward_pallas; heightfield and volumetric; its march channel in float32,
// or through the bf16 march field under march_bf16), which gets its adjoint from
// jax.vjp inside the kernel and accumulates it in one SMEM block across a
// sequential TPU grid. Its
// plain PyTorch version is
// gpgpuraytrace_tpu_torch/kernels/trace.py:trace_bwd_reference (autograd of
// the forward's own helpers).
//
// Per pixel, at the saved hit distance t, the adjoint is derived by hand, in
// reverse order: recompute raygen, the fBm value, gradient and Hessian
// (noise2_hess; in volumetric mode also the 3D warp's, noise3_hess) and
// shade; reverse through shade, the normal, the heightfield and the warp;
// add the implicit-function march channel at hits,
// scale = -t_bar / min(grad f . d, -1e-2), pulled back through f at fixed t;
// reverse the ray direction's normalisation onto the camera scalars. The
// per-octave frequency cotangents are reduced like the others and folded
// into the lacunarity's once, by the second launch (freq_i = lac^i is the
// same for every pixel).
//
// What bounds it on the H100: FP32 issue, about octaves x 2 noise-and-Hessian
// evaluations per pixel (plus warp_octaves 3D ones), against 24 bytes read
// per pixel. Each thread keeps its own cotangents in its own column of shared
// memory (no bank conflicts,
// and the octave-indexed entries need no dynamically indexed registers);
// the block then sums each column in a fixed order (sequential over four
// slots, then a warp shuffle tree) into one row per block of a scratch
// buffer, and a second launch sums each column over the blocks in a fixed
// order. No atomics: the gradient is bitwise the same from run to run.
// Threads past the frame's last pixel leave their column at exact zeros.

#include "field.cuh"

namespace {
constexpr int kBwdThreads = 128;
constexpr int kReduceThreads = 1024;
}  // namespace

// Must match kernels/trace.py:TraceBwdConfig field for field.
struct TraceBwdConfig {
  int height;  // full image height (NDC scale)
  int width;
  int local_h;  // rows of this launch's band
  int num_octaves;
  int volumetric;  // 1: the field subtracts the 3D fBm warp
  int warp_octaves;
  int bf16;  // 1: the march channel pulls back through the bf16 value field
};

namespace {

__device__ __forceinline__ bool in_unit(float x) {  // clip(x, 0, 1) passes x
  return x >= 0.f && x <= 1.f;
}

// One pixel's cotangents into column ``a`` (entry k at a[k * kBwdThreads]):
// the packed entries, then one frequency entry per octave. kBf16: the march
// channel's heightfield term pulls back through noise2_value_bf16's adjoint
// (march_bf16, as JAX's backward differentiates its march field); the shade
// channel stays float32.
template <bool kBf16>
__device__ __forceinline__ void pixel_bwd(const float* sc, const Octaves& oct,
                                          uint32_t seed,
                                          const TraceBwdConfig& cfg, int row,
                                          int col, float t, bool hit,
                                          const float (&G)[3], float* a) {
  auto A = [a](int k) -> float& { return a[k * kBwdThreads]; };
  const int n_params = kAmps + cfg.num_octaves;
  const CameraRay cr = camera_ray(sc, cfg.height, cfg.width, row, col);
  const float dx = cr.dx, dy = cr.dy, dz = cr.dz;
  float dbx = 0.f, dby = 0.f, dbz = 0.f;  // cotangent of the ray direction

  // --- sky, every pixel ---------------------------------------------------
  const float lx = sc[kSunDir + 0], ly = sc[kSunDir + 1], lz = sc[kSunDir + 2];
  const float up = clip(dy, 0.f, 1.f);
  const float cdot = dx * lx + dy * ly + dz * lz;
  const float cos_sun = clip(cdot, 0.f, 1.f);
  const float c2 = cos_sun * cos_sun;
  const float c4 = c2 * c2;
  const float c8 = c4 * c4;
  const float c16 = c8 * c8;
  const float c64 = c16 * c16 * c16 * c16;
  const float c512 = c64 * c64 * c64 * c64 * c64 * c64 * c64 * c64;
  const float sun_term = 0.25f * c64 + 1.5f * c512;
  // d sun_term / d cos = 16 cos^63 + 768 cos^511 from stored powers: cos is
  // 0 on half the sky, so never divide by it.
  const float c32 = c16 * c16;
  const float p63 = c32 * c16 * c8 * c4 * c2 * cos_sun;
  const float p511 = c64 * c64 * c64 * c64 * c64 * c64 * c64 * p63;
  const float fog_e = hit ? expf(-sc[kFogDensity] * t) : 0.f;
  const float fog = hit ? 1.f - fog_e : 0.f;

  float up_bar = 0.f, sun_bar = 0.f;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    // A hit shows the sky only through the fog tint 0.5 (fog_color + sky).
    const float sky_bar = hit ? G[ch] * fog * 0.5f : G[ch];
    const float horizon = sc[kSkyHorizon + ch], zenith = sc[kSkyZenith + ch];
    A(kSkyHorizon + ch) = sky_bar * (1.f - up);
    A(kSkyZenith + ch) = sky_bar * up;
    A(kSunColor + ch) = sky_bar * sun_term;
    up_bar += sky_bar * (zenith - horizon);
    sun_bar += sky_bar * sc[kSunColor + ch];
  }
  if (in_unit(dy)) dby += up_bar;
  if (in_unit(cdot)) {
    const float cos_bar = sun_bar * (16.f * p63 + 768.f * p511);
    dbx += cos_bar * lx;
    dby += cos_bar * ly;
    dbz += cos_bar * lz;
    A(kSunDir + 0) = cos_bar * dx;
    A(kSunDir + 1) = cos_bar * dy;
    A(kSunDir + 2) = cos_bar * dz;
  }

  if (hit) {
    // --- recompute the field at p = o + t d: value, gradient, Hessian ----
    const float px = sc[kPos + 0] + t * dx;
    const float py = sc[kPos + 1] + t * dy;
    const float pz = sc[kPos + 2] + t * dz;
    const float hs = sc[kHorizontalScale];
    const float x = px * hs, z = pz * hs;
    float N = 0.f, NX = 0.f, NZ = 0.f, HXX = 0.f, HXZ = 0.f, HZZ = 0.f;
    for (int i = 0; i < cfg.num_octaves; ++i) {
      const float c = oct.c[i], s = oct.s[i], cf = oct.cf[i], sf = oct.sf[i];
      const float amp = oct.amp[i], af = oct.af[i];
      float n, nx, nz, hxx, hxz, hzz;
      noise2_hess(cf * x - sf * z, sf * x + cf * z, seed + static_cast<uint32_t>(i),
                  n, nx, nz, hxx, hxz, hzz);
      N = N + amp * n;
      NX = NX + af * (c * nx + s * nz);
      NZ = NZ + af * (-s * nx + c * nz);
      // The octave's Hessian in (x, z): J^T H J with J = [[cf, -sf], [sf, cf]].
      HXX += amp * (cf * cf * hxx + 2.f * cf * sf * hxz + sf * sf * hzz);
      HXZ += amp * (-cf * sf * hxx + (cf * cf - sf * sf) * hxz + cf * sf * hzz);
      HZZ += amp * (sf * sf * hxx - 2.f * cf * sf * hxz + cf * cf * hzz);
    }
    const float hscale = sc[kHeightScale];
    const float h = sc[kHeightOffset] + hscale * N;
    const float gsc = hscale * hs;
    float gx = -gsc * NX, gy = 1.f, gz = -gsc * NZ;
    // The warp wa F(q), q = wf p: F, its gradient FD and Hessian FH in q.
    const float wa = sc[kWarpAmp], wf = sc[kWarpFreq], waf = wa * wf;
    float F = 0.f, FD[3] = {0.f, 0.f, 0.f}, FH[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (cfg.volumetric) {
      fbm3_hess(px * wf, py * wf, pz * wf, cfg.warp_octaves, seed, F, FD, FH);
      gx = gx - waf * FD[0];
      gy = gy - waf * FD[1];
      gz = gz - waf * FD[2];
    }

    // --- recompute shade -------------------------------------------------
    const float ninv = rsqrtf(gx * gx + gy * gy + gz * gz + 1e-12f);
    const float nxn = gx * ninv, nyn = gy * ninv, nzn = gz * ninv;
    const float w_steep = static_cast<float>(0.55 - 0.85);
    const float us_raw = (nyn - 0.85f) / w_steep;
    const float us = clip(us_raw, 0.f, 1.f);
    const float steep = us * us * (3.f - 2.f * us);
    const float snow_h = sc[kSnowHeight];
    const float w_snow = (snow_h + 1.f) - snow_h;
    const float uh_raw = (h - snow_h) / w_snow;
    const float uh = clip(uh_raw, 0.f, 1.f);
    const float ss = uh * uh * (3.f - 2.f * uh);
    const float snow = ss * (1.f - steep);
    const float ndot = nxn * lx + nyn * ly + nzn * lz;
    const float diffuse = clip(ndot, 0.f, 1.f);
    const float sky_fill = 0.5f + 0.5f * nyn;

    // --- reverse shade ---------------------------------------------------
    float steep_bar = 0.f, snow_bar = 0.f, diffuse_bar = 0.f, fill_bar = 0.f;
    float fog_bar = 0.f;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float gc = G[ch];
      const float horizon = sc[kSkyHorizon + ch];
      const float sun_c = sc[kSunColor + ch], amb = sc[kAmbient + ch];
      const float sky = horizon + (sc[kSkyZenith + ch] - horizon) * up + sun_term * sun_c;
      const float low = sc[kAlbedoLow + ch], high = sc[kAlbedoHigh + ch];
      const float snc = sc[kSnowColor + ch];
      const float alb0 = low + (high - low) * steep;
      const float alb = alb0 + (snc - alb0) * snow;
      const float light = sun_c * diffuse + amb * sky_fill;
      const float surf0 = alb * light;
      const float tint = 0.5f * (sc[kFogColor + ch] + sky);
      A(kFogColor + ch) = gc * fog * 0.5f;
      fog_bar += gc * (tint - surf0);
      const float surf0_bar = gc * (1.f - fog);
      const float alb_bar = surf0_bar * light, light_bar = surf0_bar * alb;
      A(kSunColor + ch) += light_bar * diffuse;
      diffuse_bar += light_bar * sun_c;
      A(kAmbient + ch) = light_bar * sky_fill;
      fill_bar += light_bar * amb;
      const float alb0_bar = alb_bar * (1.f - snow);
      A(kSnowColor + ch) = alb_bar * snow;
      snow_bar += alb_bar * (snc - alb0);
      A(kAlbedoLow + ch) = alb0_bar * (1.f - steep);
      A(kAlbedoHigh + ch) = alb0_bar * steep;
      steep_bar += alb0_bar * (high - low);
    }
    A(kFogDensity) = fog_bar * t * fog_e;
    float t_bar = fog_bar * sc[kFogDensity] * fog_e;
    steep_bar -= snow_bar * ss;
    float h_bar = 0.f;
    if (in_unit(uh_raw)) {
      const float uh_bar = snow_bar * (1.f - steep) * 6.f * uh * (1.f - uh);
      h_bar = uh_bar / w_snow;
      A(kSnowHeight) = -uh_bar / w_snow;
    }
    float nyn_bar = 0.5f * fill_bar;
    if (in_unit(us_raw)) nyn_bar += steep_bar * 6.f * us * (1.f - us) / w_steep;
    float nxn_bar = 0.f, nzn_bar = 0.f;
    if (in_unit(ndot)) {
      nxn_bar = diffuse_bar * lx;
      nyn_bar += diffuse_bar * ly;
      nzn_bar = diffuse_bar * lz;
      A(kSunDir + 0) += diffuse_bar * nxn;
      A(kSunDir + 1) += diffuse_bar * nyn;
      A(kSunDir + 2) += diffuse_bar * nzn;
    }
    // n = g / |g|.
    const float ndg = nxn_bar * gx + nyn_bar * gy + nzn_bar * gz;
    const float gx_bar = ninv * (nxn_bar - ninv * ninv * ndg * gx);
    const float gy_bar = ninv * (nyn_bar - ninv * ninv * ndg * gy);
    const float gz_bar = ninv * (nzn_bar - ninv * ninv * ndg * gz);

    // --- reverse the heightfield: h, (gx, gz) -> N, (NX, NZ), (x, z) ------
    const float NX_bar = -gsc * gx_bar, NZ_bar = -gsc * gz_bar;
    const float gsc_bar = -(gx_bar * NX + gz_bar * NZ);
    float N_bar = h_bar * hscale;
    float hoff_bar = h_bar;
    float hscale_bar = h_bar * N + gsc_bar * hs;
    float hs_bar = gsc_bar * hscale;
    const float x_bar = N_bar * NX + NX_bar * HXX + NZ_bar * HXZ;
    const float z_bar = N_bar * NZ + NX_bar * HXZ + NZ_bar * HZZ;
    float px_bar = x_bar * hs, py_bar = 0.f, pz_bar = z_bar * hs;
    hs_bar += x_bar * px + z_bar * pz;

    // --- reverse the warp's gradient: g -= waf FD(q), q = wf p ----------
    // q_bar = FH (-waf g_bar); wf collects q_bar . p and waf_bar wa.
    float wa_bar = 0.f, wf_bar = 0.f;
    if (cfg.volumetric) {
      const float fxb = -waf * gx_bar, fyb = -waf * gy_bar, fzb = -waf * gz_bar;
      const float waf_bar = -(gx_bar * FD[0] + gy_bar * FD[1] + gz_bar * FD[2]);
      wa_bar = waf_bar * wf;
      wf_bar = waf_bar * wa;
      const float qx_bar = FH[0] * fxb + FH[1] * fyb + FH[2] * fzb;
      const float qy_bar = FH[1] * fxb + FH[3] * fyb + FH[4] * fzb;
      const float qz_bar = FH[2] * fxb + FH[4] * fyb + FH[5] * fzb;
      px_bar += wf * qx_bar;
      py_bar += wf * qy_bar;
      pz_bar += wf * qz_bar;
      wf_bar += qx_bar * px + qy_bar * py + qz_bar * pz;
    }
    t_bar += px_bar * dx + py_bar * dy + pz_bar * dz;

    // --- march channel: f(o + t d) = 0 at fixed t ------------------------
    const float denom = fminf(gx * dx + gy * dy + gz * dz, -kDenomMin);
    const float ms = -t_bar / denom;
    hoff_bar -= ms;
    if constexpr (!kBf16) hscale_bar -= ms * N;
    const float Nm_bar = -ms * hscale;
    if constexpr (kBf16) {
      // f's heightfield term through the bf16 value field, octave by octave
      // (ops/noise.py:fbm2_value with bf16): each octave's cotangent
      // Nm_bar amp_i runs through the rounded adjoint, so the octaves'
      // amplitude and frequency entries get their march parts here.
      float Nb = 0.f, xm_bar = 0.f, zm_bar = 0.f;
      for (int i = 0; i < cfg.num_octaves; ++i) {
        const float c = oct.c[i], s = oct.s[i], cf = oct.cf[i], sf = oct.sf[i];
        const float amp = oct.amp[i];
        float nv, X_bar, Z_bar;
        noise2_value_bf16_bwd(cf * x - sf * z, sf * x + cf * z,
                              seed + static_cast<uint32_t>(i), Nm_bar * amp, nv, X_bar,
                              Z_bar);
        Nb = Nb + amp * nv;
        A(kAmps + i) = Nm_bar * nv;
        xm_bar += cf * X_bar + sf * Z_bar;
        zm_bar += -sf * X_bar + cf * Z_bar;
        A(n_params + i) = c * (X_bar * x + Z_bar * z) + s * (-X_bar * z + Z_bar * x);
      }
      hscale_bar -= ms * Nb;
      px_bar += xm_bar * hs;
      pz_bar += zm_bar * hs;
      hs_bar += xm_bar * px + zm_bar * pz;
    } else {
      px_bar += Nm_bar * NX * hs;
      pz_bar += Nm_bar * NZ * hs;
      hs_bar += Nm_bar * NX * px + Nm_bar * NZ * pz;
    }
    py_bar += ms;
    if (cfg.volumetric) {  // f -= wa F(q): F_bar = -ms wa
      wa_bar -= ms * F;
      const float Fm_bar = -ms * wa;
      const float qx_bar = Fm_bar * FD[0], qy_bar = Fm_bar * FD[1], qz_bar = Fm_bar * FD[2];
      px_bar += wf * qx_bar;
      py_bar += wf * qy_bar;
      pz_bar += wf * qz_bar;
      wf_bar += qx_bar * px + qy_bar * py + qz_bar * pz;
    }
    A(kWarpAmp) = wa_bar;
    A(kWarpFreq) = wf_bar;
    A(kPos + 0) = px_bar;
    A(kPos + 1) = py_bar;
    A(kPos + 2) = pz_bar;
    dbx += t * px_bar;
    dby += t * py_bar;
    dbz += t * pz_bar;
    A(kHeightOffset) = hoff_bar;
    A(kHeightScale) = hscale_bar;
    A(kHorizontalScale) = hs_bar;
    if constexpr (!kBf16) N_bar += Nm_bar;

    // --- per octave: amplitude and frequency cotangents ------------------
    for (int i = 0; i < cfg.num_octaves; ++i) {
      const float c = oct.c[i], s = oct.s[i], cf = oct.cf[i], sf = oct.sf[i];
      const float amp = oct.amp[i], af = oct.af[i];
      float n, nx, nz, hxx, hxz, hzz;
      noise2_hess(cf * x - sf * z, sf * x + cf * z, seed + static_cast<uint32_t>(i),
                  n, nx, nz, hxx, hxz, hzz);
      const float af_bar = NX_bar * (c * nx + s * nz) + NZ_bar * (-s * nx + c * nz);
      const float amp_bar = N_bar * n + af_bar * oct.freq[i];
      const float n_bar = N_bar * amp;
      const float nx_bar = af * (c * NX_bar - s * NZ_bar);
      const float nz_bar = af * (s * NX_bar + c * NZ_bar);
      const float X_bar = n_bar * nx + nx_bar * hxx + nz_bar * hxz;
      const float Z_bar = n_bar * nz + nx_bar * hxz + nz_bar * hzz;
      const float cf_bar = X_bar * x + Z_bar * z, sf_bar = -X_bar * z + Z_bar * x;
      const float freq_bar = af_bar * amp + c * cf_bar + s * sf_bar;
      if constexpr (kBf16) {
        A(kAmps + i) += amp_bar;
        A(n_params + i) += freq_bar;
      } else {
        A(kAmps + i) = amp_bar;
        A(n_params + i) = freq_bar;
      }
    }
  }

  // --- reverse raygen: d = u / |u|, u = fwd + sx right + sy up ------------
  const float ddot = dbx * dx + dby * dy + dbz * dz;
  const float ubx = cr.inv * (dbx - ddot * dx);
  const float uby = cr.inv * (dby - ddot * dy);
  const float ubz = cr.inv * (dbz - ddot * dz);
  A(kFwd + 0) = ubx;
  A(kFwd + 1) = uby;
  A(kFwd + 2) = ubz;
  A(kRight + 0) = ubx * cr.sx;
  A(kRight + 1) = uby * cr.sx;
  A(kRight + 2) = ubz * cr.sx;
  A(kUp + 0) = ubx * cr.sy;
  A(kUp + 1) = uby * cr.sy;
  A(kUp + 2) = ubz * cr.sy;
  const float sx_bar = ubx * sc[kRight + 0] + uby * sc[kRight + 1] + ubz * sc[kRight + 2];
  const float sy_bar = ubx * sc[kUp + 0] + uby * sc[kUp + 1] + ubz * sc[kUp + 2];
  A(kTanFov) = sx_bar * sc[kAspect] * cr.ndc_x + sy_bar * cr.ndc_y;
  A(kAspect) = sx_bar * sc[kTanFov] * cr.ndc_x;
  A(kRow0) = sy_bar * sc[kTanFov] * -static_cast<float>(2.0 / cfg.height);
}

template <bool kBf16>
__global__ void __launch_bounds__(kBwdThreads)
trace_bwd_kernel(const float* __restrict__ packed, const int* __restrict__ seed_ptr,
                 const float* __restrict__ t_in, const float* __restrict__ hit_in,
                 const float* __restrict__ g, float* __restrict__ partial,
                 TraceBwdConfig cfg) {
  extern __shared__ float acc[];  // column k of thread i at k * kBwdThreads + i
  __shared__ float sc[kAmps + kMaxOctaves];
  __shared__ Octaves oct;
  const int n_params = kAmps + cfg.num_octaves;
  const int n_cols = n_params + cfg.num_octaves;
  const int tid = threadIdx.x;
  for (int k = tid; k < n_params; k += kBwdThreads) sc[k] = packed[k];
  float* a = acc + tid;
  for (int k = 0; k < n_cols; ++k) a[k * kBwdThreads] = 0.f;
  __syncthreads();
  if (tid == 0) load_octaves(sc, cfg.num_octaves, oct);
  __syncthreads();

  const int n_pix = cfg.local_h * cfg.width;
  const int idx = blockIdx.x * kBwdThreads + tid;
  if (idx < n_pix) {
    const int row = idx / cfg.width;
    const int col = idx - row * cfg.width;
    const float G[3] = {g[idx], g[n_pix + idx], g[2 * n_pix + idx]};
    pixel_bwd<kBf16>(sc, oct, static_cast<uint32_t>(*seed_ptr), cfg, row, col, t_in[idx],
              hit_in[idx] > 0.5f, G, a);
  }
  __syncthreads();

  // Block sum of each column, in a fixed order, into row-major scratch
  // partial[k][block].
  const int warp = tid >> 5, lane = tid & 31;
  for (int k = warp; k < n_cols; k += kBwdThreads / 32) {
    const float* colk = acc + k * kBwdThreads;
    float v = colk[lane];
    for (int j = lane + 32; j < kBwdThreads; j += 32) v += colk[j];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) partial[k * gridDim.x + blockIdx.x] = v;
  }
}

// Sums each column of partial over the blocks in a fixed order, folds the
// frequency cotangents into the lacunarity's and writes pbar (n_params).
__global__ void __launch_bounds__(kReduceThreads)
trace_bwd_reduce(const float* __restrict__ partial, int n_blocks, int num_octaves,
                 const float* __restrict__ packed, float* __restrict__ pbar) {
  __shared__ float col_sum[kAmps + 2 * kMaxOctaves];
  const int n_params = kAmps + num_octaves;
  const int n_cols = n_params + num_octaves;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k = warp; k < n_cols; k += kReduceThreads / 32) {
    const float* colk = partial + static_cast<size_t>(k) * n_blocks;
    float v = 0.f;
    for (int b = lane; b < n_blocks; b += 32) v += colk[b];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) col_sum[k] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // freq_i = freq_{i-1} * lac (float32 running product, freq_0 = 1):
    // reverse it, last octave first.
    const float lac = packed[kLacunarity];
    float freq[kMaxOctaves];
    freq[0] = 1.f;
    for (int i = 1; i < num_octaves; ++i) freq[i] = freq[i - 1] * lac;
    float lac_bar = col_sum[kLacunarity];
    float f_bar = col_sum[n_params + num_octaves - 1];
    for (int i = num_octaves - 1; i > 0; --i) {
      lac_bar += f_bar * freq[i - 1];
      f_bar = col_sum[n_params + i - 1] + f_bar * lac;
    }
    col_sum[kLacunarity] = lac_bar;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n_params; k += kReduceThreads) pbar[k] = col_sum[k];
}

int bwd_blocks(const TraceBwdConfig& cfg) {
  return (cfg.local_h * cfg.width + kBwdThreads - 1) / kBwdThreads;
}

int bwd_cols(const TraceBwdConfig& cfg) { return kAmps + 2 * cfg.num_octaves; }

}  // namespace

extern "C" {

// Floats of device scratch trace_bwd_launch needs (one row per block).
int trace_bwd_scratch_floats(TraceBwdConfig cfg) {
  return bwd_blocks(cfg) * bwd_cols(cfg);
}

// Launches the kernel and its reduction on ``stream`` and returns
// cudaGetLastError() (0 on success). Pointers are device pointers:
// ``t``, ``hit`` (local_h, width), ``g`` (3, local_h, width), ``partial``
// trace_bwd_scratch_floats(cfg) floats, ``pbar`` kAmps + octaves floats.
// The caller validates shapes, dtypes and contiguity.
int trace_bwd_launch(const float* packed, const int* seed, const float* t,
                     const float* hit, const float* g, float* partial, float* pbar,
                     TraceBwdConfig cfg, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = bwd_blocks(cfg);
  const size_t smem = static_cast<size_t>(bwd_cols(cfg)) * kBwdThreads * sizeof(float);
  if (cfg.bf16) {
    trace_bwd_kernel<true><<<blocks, kBwdThreads, smem, s>>>(packed, seed, t, hit, g,
                                                             partial, cfg);
  } else {
    trace_bwd_kernel<false><<<blocks, kBwdThreads, smem, s>>>(packed, seed, t, hit, g,
                                                              partial, cfg);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  trace_bwd_reduce<<<1, kReduceThreads, 0, s>>>(partial, blocks, cfg.num_octaves,
                                                packed, pbar);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
