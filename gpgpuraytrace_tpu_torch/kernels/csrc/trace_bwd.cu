// Backward trace kernel: output-colour cotangent -> packed scene-parameter
// cotangent, one thread per pixel, a warp per group of 128 pixels, then a
// deterministic second stage over the groups.
//
// Replaces gpgpuraytrace_tpu/kernels/trace.py:_trace_bwd_kernel (launched by
// _backward_pallas; heightfield and volumetric; its march channel in float32,
// or through the bf16 march field under march_bf16), which gets its adjoint from
// jax.vjp inside the kernel and accumulates it in one SMEM block across a
// sequential TPU grid. Its plain PyTorch version is
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
// into the lacunarity's once, by the second stage (freq_i = lac^i is the
// same for every pixel).
//
// What bounds it on the H100: FP32 issue, about octaves noise-and-Hessian
// evaluations per hit pixel (plus warp_octaves 3D ones; chip_smoke.py:OPS
// counts them), against 20 bytes read per pixel; at 16 warps per SM the
// latency of those chains. So the design spends no issue slot it need not
// and keeps 16 warps per SM:
// - Each octave's noise and Hessian are computed once per hit pixel: the
//   recompute loop leaves them in the thread's slice of shared memory for
//   the reverse loop (the octave loops stay rolled: unrolled, their chains
//   need more than the 128 registers that 16 warps per SM allow).
// - A warp takes a group of 128 consecutive pixels, lane l the pixels l,
//   l+32, l+64 and l+96 in turn, and adds each pixel's fully formed columns
//   (the packed entries, then one frequency entry per octave) to its own
//   accumulators in its warp's slice of shared memory: no block barrier, no
//   zeroing of the columns a pixel does not write.
// - Blocks of 4 warps, 4 per SM (launch bounds: 128 registers); a block's
//   warps take groups gridDim.x apart, so sky and terrain spread over them.
//   The preamble loads the packed scalars with every thread and the octave
//   table with one thread per octave (load_octave), behind one
//   __syncthreads.
// - The second stage is a launch of one 32-thread block per column, spread
//   over the SMs, its loads all in flight at once; the last block to finish
//   (a counter in the scratch, which it sets back to 0) folds the frequency
//   sums into the lacunarity's.
// - A batch of frames (a row-band rank's interleaved stripes of one camera,
//   parallel/sharded.py) is one launch of each stage, the frame as
//   blockIdx.y (kFrames, a template parameter: one frame runs the
//   instantiations without it, whose code and grid are the one-frame
//   design's): each frame's groups, partial sums, counter and column sums
//   are its own, into its row of pbar, so frame b's row is its one-frame
//   launch's bit for bit. kernels/pack.py's VJP sums the rows into the
//   leaves that the frames share.
//
// The summation order, fixed by the frame's shape alone and the same bit
// for bit as the design this one replaced (one 128-thread block per group,
// each thread a column of shared memory): a pixel's column is formed first
// (kSunColor, kSunDir and the bf16 octave entries in two parts); a lane adds
// its four pixels' columns in order; a shuffle tree of offsets 16, 8, 4, 2,
// 1 sums the lanes (a butterfly, whose every lane holds lane 0's sum of the
// parent's __shfl_down tree) into partial[column][group]; the second
// stage's lane l sums groups l, l+32, ... in order from +0, then the same
// tree; last the lacunarity fold. The parent added +0 for a column a pixel
// does not write; a lane here starts at +0 and skips those adds, which can
// change only the sign of a zero partial sum, and the second stage's +0
// start absorbs that. Every add is __fadd_rn, so none is contracted into an
// FMA with the product it adds, and X_bar and Z_bar are contracted by hand
// as the parent's compiler did. No atomics on values: the gradient is
// bitwise the same from run to run.

#include "field.cuh"

// Must match kernels/trace.py:TraceBwdConfig field for field.
struct TraceBwdConfig {
  int height;  // full image height (NDC scale)
  int width;
  int local_h;  // rows of this launch's band
  int num_octaves;
  int volumetric;  // 1: the field subtracts the 3D fBm warp
  int warp_octaves;
  int bf16;  // 1: the march channel pulls back through the bf16 value field
  int g_channel_stride;  // g[c][pixel] at c * g_channel_stride + pixel * g_pixel_stride
  int g_pixel_stride;
};

namespace {

constexpr int kGroup = 128;  // pixels a warp sums (the unit of partial)
constexpr int kWarps = 4;      // warps per block
constexpr int kMinBlocks = 4;  // blocks per SM the launch bounds ask for
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxCols = kAmps + 2 * kMaxOctaves;
// A thread's slice of shared memory, per octave: its noise (n, nx, nz, hxx,
// hxz, hzz) from the recompute loop, then under bf16 the march parts of its
// amplitude and frequency columns.
constexpr int kMarchAmp = 6, kMarchFreq = 7;
__host__ __device__ constexpr int octave_floats(bool bf16) { return bf16 ? 8 : 6; }
// The scratch of a launch over ``frames`` frames: the second stage's
// counters (an int per frame), from a 16-byte boundary its column sums
// (kMaxCols per frame), then from the next one each frame's
// partial[column][group], one frame after another. One frame's is the
// layout of the one-frame design: its counter, its sums from float 4.
__host__ __device__ constexpr int col_sum_offset(int frames) { return (frames + 3) / 4 * 4; }
__host__ __device__ constexpr int partial_offset(int frames) {
  return (col_sum_offset(frames) + frames * kMaxCols + 3) / 4 * 4;
}
constexpr int kMaxDevices = 64;
// The most frames one launch takes (its grids' y): kernels/trace.py:MAX_FRAMES.
constexpr int kMaxFrames = 65535;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool in_unit(float x) {  // clip(x, 0, 1) passes x
  return x >= 0.f && x <= 1.f;
}

// A lane's column sums in its warp's slice of shared memory: column k of
// lane l at s[k * 32 + l] (``s`` already offset by the lane).
struct Cols {
  float* s;
  int n_cols;
  __device__ __forceinline__ void reset() {
    for (int k = 0; k < n_cols; ++k) s[k * 32] = 0.f;
  }
  __device__ __forceinline__ void add(int k, float x) { s[k * 32] = __fadd_rn(s[k * 32], x); }
  __device__ __forceinline__ float get(int k) const { return s[k * 32]; }
};

// One pixel's cotangents, each column's value added once to ``acc``: the
// packed entries, then one frequency entry per octave. kBf16: the march
// channel's heightfield term pulls back through noise2_value_bf16's adjoint
// (march_bf16, as JAX's backward differentiates its march field); the shade
// channel stays float32. ``ot``: the thread's octave slice, value q of
// octave i at ot[(q num_octaves + i) kThreads].
template <bool kBf16>
__device__ __forceinline__ void pixel_bwd(const float* sc, const Octaves& oct,
                                          uint32_t seed, const TraceBwdConfig& cfg,
                                          int row, int col, float t, bool hit,
                                          const float (&G)[3], Cols& acc, float* ot) {
  // Value q of octave i in the thread's octave slice.
  auto O = [ot, &cfg](int i, int q) -> float& {
    return ot[(q * cfg.num_octaves + i) * kThreads];
  };
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
  float sun_color[3];  // kSunColor's column: the sky's part, then a hit's
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    // A hit shows the sky only through the fog tint 0.5 (fog_color + sky).
    const float sky_bar = hit ? G[ch] * fog * 0.5f : G[ch];
    const float horizon = sc[kSkyHorizon + ch], zenith = sc[kSkyZenith + ch];
    acc.add(kSkyHorizon + ch, sky_bar * (1.f - up));
    acc.add(kSkyZenith + ch, sky_bar * up);
    sun_color[ch] = sky_bar * sun_term;
    up_bar += sky_bar * (zenith - horizon);
    sun_bar += sky_bar * sc[kSunColor + ch];
  }
  if (in_unit(dy)) dby += up_bar;
  float sun_dir[3] = {0.f, 0.f, 0.f};  // kSunDir's column: the sky's part, a hit's
  if (in_unit(cdot)) {
    const float cos_bar = sun_bar * (16.f * p63 + 768.f * p511);
    dbx += cos_bar * lx;
    dby += cos_bar * ly;
    dbz += cos_bar * lz;
    sun_dir[0] = cos_bar * dx;
    sun_dir[1] = cos_bar * dy;
    sun_dir[2] = cos_bar * dz;
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
      O(i, 0) = n, O(i, 1) = nx, O(i, 2) = nz, O(i, 3) = hxx, O(i, 4) = hxz, O(i, 5) = hzz;
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
      acc.add(kFogColor + ch, gc * fog * 0.5f);
      fog_bar += gc * (tint - surf0);
      const float surf0_bar = gc * (1.f - fog);
      const float alb_bar = surf0_bar * light, light_bar = surf0_bar * alb;
      sun_color[ch] += light_bar * diffuse;
      diffuse_bar += light_bar * sun_c;
      acc.add(kAmbient + ch, light_bar * sky_fill);
      fill_bar += light_bar * amb;
      const float alb0_bar = alb_bar * (1.f - snow);
      acc.add(kSnowColor + ch, alb_bar * snow);
      snow_bar += alb_bar * (snc - alb0);
      acc.add(kAlbedoLow + ch, alb0_bar * (1.f - steep));
      acc.add(kAlbedoHigh + ch, alb0_bar * steep);
      steep_bar += alb0_bar * (high - low);
    }
    acc.add(kFogDensity, fog_bar * t * fog_e);
    float t_bar = fog_bar * sc[kFogDensity] * fog_e;
    steep_bar -= snow_bar * ss;
    float h_bar = 0.f, snow_height_bar = 0.f;
    if (in_unit(uh_raw)) {
      const float uh_bar = snow_bar * (1.f - steep) * 6.f * uh * (1.f - uh);
      h_bar = uh_bar / w_snow;
      snow_height_bar = -uh_bar / w_snow;
    }
    acc.add(kSnowHeight, snow_height_bar);
    float nyn_bar = 0.5f * fill_bar;
    if (in_unit(us_raw)) nyn_bar += steep_bar * 6.f * us * (1.f - us) / w_steep;
    float nxn_bar = 0.f, nzn_bar = 0.f;
    if (in_unit(ndot)) {
      nxn_bar = diffuse_bar * lx;
      nyn_bar += diffuse_bar * ly;
      nzn_bar = diffuse_bar * lz;
      sun_dir[0] += diffuse_bar * nxn;
      sun_dir[1] += diffuse_bar * nyn;
      sun_dir[2] += diffuse_bar * nzn;
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
      // amplitude and frequency columns get their march parts here (kept in
      // the octave slice until the reverse loop adds the rest).
      float Nb = 0.f, xm_bar = 0.f, zm_bar = 0.f;
      for (int i = 0; i < cfg.num_octaves; ++i) {
        const float c = oct.c[i], s = oct.s[i], cf = oct.cf[i], sf = oct.sf[i];
        const float amp = oct.amp[i];
        float nv, X_bar, Z_bar;
        noise2_value_bf16_bwd(cf * x - sf * z, sf * x + cf * z,
                              seed + static_cast<uint32_t>(i), Nm_bar * amp, nv, X_bar,
                              Z_bar);
        Nb = Nb + amp * nv;
        O(i, kMarchAmp) = Nm_bar * nv;
        xm_bar += cf * X_bar + sf * Z_bar;
        zm_bar += -sf * X_bar + cf * Z_bar;
        O(i, kMarchFreq) = c * (X_bar * x + Z_bar * z) + s * (-X_bar * z + Z_bar * x);
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
    acc.add(kWarpAmp, wa_bar);
    acc.add(kWarpFreq, wf_bar);
    acc.add(kPos + 0, px_bar);
    acc.add(kPos + 1, py_bar);
    acc.add(kPos + 2, pz_bar);
    dbx += t * px_bar;
    dby += t * py_bar;
    dbz += t * pz_bar;
    acc.add(kHeightOffset, hoff_bar);
    acc.add(kHeightScale, hscale_bar);
    acc.add(kHorizontalScale, hs_bar);
    if constexpr (!kBf16) N_bar += Nm_bar;

    // --- per octave: amplitude and frequency cotangents ------------------
    for (int i = 0; i < cfg.num_octaves; ++i) {
      const float c = oct.c[i], s = oct.s[i];
      const float amp = oct.amp[i], af = oct.af[i];
      const float n = O(i, 0), nx = O(i, 1), nz = O(i, 2);
      const float hxx = O(i, 3), hxz = O(i, 4), hzz = O(i, 5);
      const float af_bar = NX_bar * (c * nx + s * nz) + NZ_bar * (-s * nx + c * nz);
      const float amp_bar = N_bar * n + af_bar * oct.freq[i];
      const float n_bar = N_bar * amp;
      const float nx_bar = af * (c * NX_bar - s * NZ_bar);
      const float nz_bar = af * (s * NX_bar + c * NZ_bar);
      // X_bar = n_bar nx + nx_bar hxx + nz_bar hxz, and Z_bar likewise,
      // contracted as the design before the noise cache compiled them (its
      // SASS): left to the compiler, the cached noise makes it fuse the other
      // product of the first sum in X_bar, which moves the frequency columns
      // by an ulp.
      const float X_bar = __fmaf_rn(nz_bar, hxz, __fmaf_rn(n_bar, nx, __fmul_rn(nx_bar, hxx)));
      const float Z_bar = __fmaf_rn(nz_bar, hzz, __fmaf_rn(nx_bar, hxz, __fmul_rn(n_bar, nz)));
      const float cf_bar = X_bar * x + Z_bar * z, sf_bar = -X_bar * z + Z_bar * x;
      const float freq_bar = af_bar * amp + c * cf_bar + s * sf_bar;
      if constexpr (kBf16) {
        acc.add(kAmps + i, __fadd_rn(O(i, kMarchAmp), amp_bar));
        acc.add(n_params + i, __fadd_rn(O(i, kMarchFreq), freq_bar));
      } else {
        acc.add(kAmps + i, amp_bar);
        acc.add(n_params + i, freq_bar);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    acc.add(kSunColor + c, sun_color[c]);
    acc.add(kSunDir + c, sun_dir[c]);
  }

  // --- reverse raygen: d = u / |u|, u = fwd + sx right + sy up ------------
  const float ddot = dbx * dx + dby * dy + dbz * dz;
  const float ubx = cr.inv * (dbx - ddot * dx);
  const float uby = cr.inv * (dby - ddot * dy);
  const float ubz = cr.inv * (dbz - ddot * dz);
  acc.add(kFwd + 0, ubx);
  acc.add(kFwd + 1, uby);
  acc.add(kFwd + 2, ubz);
  acc.add(kRight + 0, ubx * cr.sx);
  acc.add(kRight + 1, uby * cr.sx);
  acc.add(kRight + 2, ubz * cr.sx);
  acc.add(kUp + 0, ubx * cr.sy);
  acc.add(kUp + 1, uby * cr.sy);
  acc.add(kUp + 2, ubz * cr.sy);
  const float sx_bar = ubx * sc[kRight + 0] + uby * sc[kRight + 1] + ubz * sc[kRight + 2];
  const float sy_bar = ubx * sc[kUp + 0] + uby * sc[kUp + 1] + ubz * sc[kUp + 2];
  acc.add(kTanFov, sx_bar * sc[kAspect] * cr.ndc_x + sy_bar * cr.ndc_y);
  acc.add(kAspect, sx_bar * sc[kTanFov] * cr.ndc_x);
  acc.add(kRow0, sy_bar * sc[kTanFov] * -static_cast<float>(2.0 / cfg.height));
}

// Lane 0's sum of v over the warp: offsets 16, 8, 4, 2, 1 (as a butterfly,
// every lane gets it).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, m));
  return v;
}

// One column of partial summed over its n_groups groups: lane l adds groups
// l, l+32, ... in order from +0 (a chunk of loads in flight at a time, each
// from a valid address, so none waits on a branch), then warp_sum.
__device__ __forceinline__ float column_sum(const float* col, int n_groups, int lane) {
  constexpr int kChunk = 64;
  float v = 0.f;
  for (int b0 = lane; b0 < n_groups; b0 += 32 * kChunk) {
    float x[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) x[j] = __ldcg(col + min(b0 + 32 * j, n_groups - 1));
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (b0 + 32 * j < n_groups) v = __fadd_rn(v, x[j]);
    }
  }
  return warp_sum(v);
}

// After every column's sum is in col_sum (the frequency columns and the
// lacunarity's at least): freq_i = freq_{i-1} * lac (float32 running
// product, freq_0 = 1), reversed last octave first, into pbar's lacunarity.
// The sums are loaded all at once, each from a valid address.
__device__ __forceinline__ void fold_lacunarity(const float* col_sum, int num_octaves,
                                                const float* packed, float* pbar) {
  const int n_params = kAmps + num_octaves;
  const float lac = packed[kLacunarity];
  float freq[kMaxOctaves], f_sum[kMaxOctaves];
#pragma unroll
  for (int i = 0; i < kMaxOctaves; ++i) {
    f_sum[i] = __ldcg(col_sum + n_params + min(i, num_octaves - 1));
  }
  freq[0] = 1.f;
#pragma unroll
  for (int i = 1; i < kMaxOctaves; ++i) freq[i] = freq[i - 1] * lac;
  float lac_bar = __ldcg(col_sum + kLacunarity);
  float f_bar = 0.f;
#pragma unroll
  for (int i = kMaxOctaves - 1; i > 0; --i) {
    if (i == num_octaves - 1) f_bar = f_sum[i];
    if (i < num_octaves) {
      lac_bar += f_bar * freq[i - 1];
      f_bar = f_sum[i - 1] + f_bar * lac;
    }
  }
  pbar[kLacunarity] = lac_bar;
}

// Column k's sum: straight to pbar if it is a packed entry other than the
// lacunarity, else into the scratch's col_sum for the fold.
__device__ __forceinline__ void put_column(int k, float v, int n_params, float* col_sum,
                                           float* pbar) {
  if (k < n_params && k != kLacunarity) {
    pbar[k] = v;
  } else {
    col_sum[k] = v;
  }
}

// Counts a finished block in ``counter`` (after its writes are visible);
// true in the last block of the grid's row, which sets it back to 0.
__device__ __forceinline__ bool last_block(int* counter) {
  __threadfence();
  const bool last = atomicAdd(counter, 1) == static_cast<int>(gridDim.x) - 1;
  if (last) {
    __threadfence();
    atomicExch(counter, 0);
  }
  return last;
}

// The main kernel's dynamic shared memory, in floats: the warps' column
// slices, then the threads' octave slices.
__host__ __device__ constexpr int smem_floats(int n_cols, int num_octaves, bool bf16) {
  return kWarps * n_cols * 32 + octave_floats(bf16) * num_octaves * kThreads;
}

// kFrames: a batch of frames as blockIdx.y = frame. Each block reads its own
// frame's packed scalars, t, hit and g and writes its frame's partial sums,
// each group the pixels of the one-frame launch's, so frame b's sums are its
// one-frame launch's bit for bit.
template <bool kBf16, bool kFrames>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
trace_bwd_kernel(const float* __restrict__ packed, const int* __restrict__ seed_ptr,
                 const float* __restrict__ t_in, const float* __restrict__ hit_in,
                 const float* __restrict__ g, float* __restrict__ scratch,
                 float* __restrict__ pbar, TraceBwdConfig cfg) {
  extern __shared__ float slices[];  // smem_floats
  __shared__ float sc[kAmps + kMaxOctaves];
  __shared__ Octaves oct;
  const int n_params = kAmps + cfg.num_octaves;
  const int n_cols = n_params + cfg.num_octaves;
  float* partial = scratch + partial_offset(1);
  if constexpr (kFrames) {
    const size_t frame = blockIdx.y;
    const size_t px = frame * static_cast<size_t>(cfg.local_h) * cfg.width;
    const size_t groups = (static_cast<size_t>(cfg.local_h) * cfg.width + kGroup - 1) / kGroup;
    packed += frame * n_params;
    t_in += px;
    hit_in += px;
    g += 3 * px;  // (B, 3, h, W), or the view of (B, h, W, 3): 3 px apart either way
    partial = scratch + partial_offset(gridDim.y) + frame * n_cols * groups;
  }
  for (int k = threadIdx.x; k < n_params; k += kThreads) sc[k] = packed[k];
  if (threadIdx.x < cfg.num_octaves) load_octave(packed, threadIdx.x, oct);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_pix = cfg.local_h * cfg.width;
  const int n_groups = (n_pix + kGroup - 1) / kGroup;
  // A block's warps take groups gridDim.x apart, so that every block gets
  // sky and terrain alike.
  const int group = blockIdx.x + warp * gridDim.x;
  if (group < n_groups) {  // the same for every lane of the warp
    Cols acc{slices + warp * n_cols * 32 + lane, n_cols};
    acc.reset();
    float* ot = slices + kWarps * n_cols * 32 + threadIdx.x;
    const uint32_t seed = static_cast<uint32_t>(*seed_ptr);
    for (int j = 0; j < kGroup / 32; ++j) {
      const int idx = group * kGroup + j * 32 + lane;
      if (idx < n_pix) {
        const int row = idx / cfg.width;
        const int col = idx - row * cfg.width;
        const float* gp = g + static_cast<size_t>(idx) * cfg.g_pixel_stride;
        const float G[3] = {gp[0], gp[cfg.g_channel_stride], gp[2 * cfg.g_channel_stride]};
        pixel_bwd<kBf16>(sc, oct, seed, cfg, row, col, t_in[idx], hit_in[idx] > 0.5f, G, acc,
                         ot);
      }
    }
    for (int k = 0; k < n_cols; ++k) {
      const float v = warp_sum(acc.get(k));
      if (lane == (k & 31)) partial[static_cast<size_t>(k) * n_groups + group] = v;
    }
  }
}

// The second stage: block k sums column k of partial over the groups; the
// last block to finish folds the frequency columns into the lacunarity's.
// kFrames: frame blockIdx.y's columns, counter and sums, into its row of pbar.
template <bool kFrames>
__global__ void __launch_bounds__(32)
trace_bwd_sum(float* __restrict__ scratch, int n_groups, int num_octaves,
              const float* __restrict__ packed, float* __restrict__ pbar) {
  const int k = blockIdx.x, lane = threadIdx.x;
  int* counter = reinterpret_cast<int*>(scratch);
  float* col_sum = scratch + col_sum_offset(1);
  const float* partial = scratch + partial_offset(1);
  if constexpr (kFrames) {
    const int frames = static_cast<int>(gridDim.y), frame = static_cast<int>(blockIdx.y);
    const int n_params = kAmps + num_octaves;
    counter += frame;
    col_sum = scratch + col_sum_offset(frames) + static_cast<size_t>(frame) * kMaxCols;
    partial = scratch + partial_offset(frames) +
              static_cast<size_t>(frame) * gridDim.x * n_groups;
    packed += static_cast<size_t>(frame) * n_params;
    pbar += static_cast<size_t>(frame) * n_params;
  }
  const float v = column_sum(partial + static_cast<size_t>(k) * n_groups, n_groups, lane);
  if (lane == 0) {
    put_column(k, v, kAmps + num_octaves, col_sum, pbar);
    if (last_block(counter)) fold_lacunarity(col_sum, num_octaves, packed, pbar);
  }
}

int bwd_groups(const TraceBwdConfig& cfg) {
  return (cfg.local_h * cfg.width + kGroup - 1) / kGroup;
}

int bwd_cols(const TraceBwdConfig& cfg) { return kAmps + 2 * cfg.num_octaves; }

// Launches the main kernel, then the second stage, over ``frames`` frames.
template <bool kBf16, bool kFrames>
cudaError_t launch(const float* packed, const int* seed, const float* t, const float* hit,
                   const float* g, float* scratch, float* pbar, const TraceBwdConfig& cfg,
                   int frames, cudaStream_t s) {
  const int n_groups = bwd_groups(cfg);
  const size_t smem = smem_floats(bwd_cols(cfg), cfg.num_octaves, kBf16) * sizeof(float);
  if (smem > 48 * 1024) {  // above the default: opt in, once per device
    static bool opted[kMaxDevices];
    int dev = 0;
    if (const cudaError_t err = cudaGetDevice(&dev)) return err;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!opted[dev]) {
      if (const cudaError_t err = cudaFuncSetAttribute(
              trace_bwd_kernel<kBf16, kFrames>, cudaFuncAttributeMaxDynamicSharedMemorySize,
              smem_floats(kMaxCols, kMaxOctaves, kBf16) * static_cast<int>(sizeof(float)))) {
        return err;
      }
      opted[dev] = true;
    }
  }
  trace_bwd_kernel<kBf16, kFrames>
      <<<dim3((n_groups + kWarps - 1) / kWarps, frames), kThreads, smem, s>>>(
          packed, seed, t, hit, g, scratch, pbar, cfg);
  if (const cudaError_t err = cudaGetLastError()) return err;
  trace_bwd_sum<kFrames><<<dim3(bwd_cols(cfg), frames), 32, 0, s>>>(
      scratch, n_groups, cfg.num_octaves, packed, pbar);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t launch_frames(const float* packed, const int* seed, const float* t,
                          const float* hit, const float* g, float* scratch, float* pbar,
                          const TraceBwdConfig& cfg, int frames, cudaStream_t s) {
  if (frames == 1) return launch<kBf16, false>(packed, seed, t, hit, g, scratch, pbar, cfg, 1, s);
  return launch<kBf16, true>(packed, seed, t, hit, g, scratch, pbar, cfg, frames, s);
}

}  // namespace

extern "C" {

// Floats of device scratch trace_bwd_launch needs over ``frames`` frames:
// the second stage's counters and column sums, then for each frame one row
// of partial sums per column and group.
int trace_bwd_scratch_floats(TraceBwdConfig cfg, int frames) {
  return partial_offset(frames) + frames * bwd_groups(cfg) * bwd_cols(cfg);
}

// Launches the backward over ``frames`` frames on ``stream`` and returns
// cudaGetLastError() (0 on success). Pointers are device pointers, each to
// ``frames`` consecutive frames of its data: ``packed`` (frames, kAmps +
// octaves), ``t``, ``hit`` (frames, local_h, width), ``g`` (frames, 3,
// local_h, width) at cfg's strides within a frame, ``scratch``
// trace_bwd_scratch_floats(cfg, frames) floats whose first ``frames`` (the
// counters, ints) must be 0 when the launch starts and are left at 0 by it
// (launches that may overlap, on different streams, need their own),
// ``pbar`` (frames, kAmps + octaves), frame b's row its one-frame launch's.
// ``frames`` is 1 to kMaxFrames (the grid's y). The caller validates shapes,
// dtypes and strides.
int trace_bwd_launch(const float* packed, const int* seed, const float* t,
                     const float* hit, const float* g, float* scratch, float* pbar,
                     TraceBwdConfig cfg, int frames, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (frames < 1 || frames > kMaxFrames) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cfg.bf16 ? launch_frames<true>(packed, seed, t, hit, g, scratch, pbar, cfg, frames, s)
               : launch_frames<false>(packed, seed, t, hit, g, scratch, pbar, cfg, frames, s));
}

}  // extern "C"
