// Compaction's phase 2: resume the march of the rays phase 1 left marching,
// a group of two lanes per ray, and write each result straight to its
// pixel's place in phase 1's outputs.
//
// Replaces gpgpuraytrace_tpu/kernels/trace.py:_trace_phase2_kernel with the
// unpack of its glue _render_compact_raw. The TPU kernel marches dense
// (16, 128) tiles of survivors, moved there and back by two payload sorts
// (scatter and gather were slow on the TPU). Here the slot's pixel id is
// enough: the group recomputes raygen from (row, col), reads the pixel's t
// and last advancing sample from phase 1's outputs, and writes colour, t and
// hit in place. Pixel ids are unique, so no two groups write one place.
// Phase 1 lists only rays still marching, so every listed ray resumes. Its
// plain PyTorch version is
// gpgpuraytrace_tpu_torch/kernels/trace.py:trace_phase2_reference.
//
// What bounds it on the H100: the survivors are few (6-8% of a 512x512
// frame) and their marches long and uneven (up to 65 more steps, a median
// of 9), so the time is the serial chain of steps of the longest rays, each
// step 6 octaves of 2D noise (and 2 of 3D noise on the volumetric terrain)
// and the step's own arithmetic. One thread per ray, the first design, took
// 0.8 us per step on such a ray alone on the card, and left most SMs idle
// (PERF.md, section 6). The design shortens the chain and spreads the rays:
// - Ray groups. A ray belongs to a group of kLanes (2) consecutive lanes. A
//   field evaluation is split into items: the heightfield's octaves 0 ..
//   num_octaves - 1, then, on the volumetric terrain, the 3D warp's octaves
//   0 .. warp_octaves - 1. In rounds of kLanes items, lane k of the group
//   evaluates items k, k + kLanes, k + 2 kLanes, ... (at 6 octaves and 2
//   warp octaves: octaves 0-1, 2-3, 4-5, then warp octaves 0-1), each
//   exactly as Field::octave and noise3_value (the march) or noise2 and
//   noise3_hess (the polish) compute it. The warp's octave w has frequency
//   2^w and weight 0.5^w, exact in float32, so a lane computes them
//   directly. The main path's 6 octaves have their own instantiation (kOct
//   6), whose rounds of heightfield octaves are straight-line code.
// - In-order sums. Every lane of the group gathers the round's items (by
//   __shfl_sync in the march, through the group's slots of shared memory in
//   the polish) and adds them in item order, in the first design's order,
//   each mul-add as the one FMA the first design's code compiles to
//   (__fmaf_rn):
//     march:  n = fma(amp_i, o_i, n), i = 0 .. num_octaves - 1, from 0;
//             n3 = fma(0.5^w, o_w, n3), w = 0 .. warp_octaves - 1, from 0;
//     polish: n as above, nxs = fma(af_i, c_i nx_i + s_i nz_i, nxs) and
//             nzs = fma(af_i, -s_i nx_i + c_i nz_i, nzs), in octave order
//             from 0; n3 and d3[a] = fma(0.5^w 2^w, nd_w[a], d3[a]) in warp
//             octave order from 0.
//   Then the rest of Field::value / Field::value_grad, verbatim. Every lane
//   of a group holds the same f, takes the same step and the same branch:
//   the group needs no broadcast and never diverges within itself.
// - Persistent groups with refill. The grid is what fits on the card at
//   once (the occupancy query x SMs, capped by the frame's pixels). Slot s
//   holds the pixel ids[n_alive - 1 - s] (phase 1's warps that march
//   longest list their survivors last, so they start first); group g of
//   block b takes slot g x blocks + b first (the first slots go round the
//   blocks, so every SM gets some), then the next slot from a counter in
//   the wrapper's two-int32 scratch, fetched ahead in stages while it
//   marches, until the slots reach n_alive, which is read on the device:
//   nothing syncs the host, and n_alive = 0 is no special case. The last
//   block to finish sets the scratch back to 0.
// - One loop for the whole warp. Each iteration every group with a ray
//   takes one march step (march()'s chunked step, its branches as selects)
//   and one stage of its fetch; a group whose ray is done puts it in the
//   warp's pool of finished rays and starts its next one. Every lane of the
//   warp evaluates the field together (a group without a ray on a stale
//   one), so its shuffles run on the whole warp.
// - Deferred polish. Once the pool holds a ray per group, or the warp has no
//   ray left, the warp polishes and shades the pool, a ray per group per
//   round: a group no longer polishes alone while the warp's other groups
//   wait.
// The polish and the shade are trace_march.cuh's polish_and_shade, through
// the group's field, so a resumed ray ends where the one-pass march ends it,
// bit for bit. Every lane of a group writes the group's pixel with the same
// values.
// - A batch of frames (trace_fwd.cu's frame axis) runs as blockIdx.y = frame:
//   each block reads its own frame's scalars, n_alive and list, takes slots
//   from its own frame's counter and writes its own frame's outputs; the
//   resident blocks are shared out among the frames. The frame axis is a
//   template parameter (kFrames), so a one-frame launch runs the one-frame
//   kernel's code as it was.

#include <algorithm>

#include "trace_march.cuh"

namespace {
constexpr int kLanes = 2;  // lanes per ray
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kGroupsPerBlock = kThreads / kLanes;
constexpr int kMinBlocks = 2;
constexpr int kGroupsPerWarp = 32 / kLanes;
// A warp polishes the rays its groups finished once it holds a round of
// them (one per group), or has no ray left; it holds fewer than two rounds.
constexpr int kPool = 2 * kGroupsPerWarp;
// The main path's octave count, known at compile time in its instantiation.
constexpr int kUnrolledOctaves = 6;
constexpr int kMaxDevices = 64;

// 2^k as a float, exact for k in [-126, 127].
__device__ __forceinline__ float pow2(int k) { return __int_as_float((127 + k) << 23); }

// Items of a field evaluation: the heightfield's octaves, then the warp's.
constexpr int kMaxItems = 32;  // kMaxOctaves + 8 warp octaves, and a round's overrun

// The weights of the items' sums, per block in shared memory: amp (the
// octave's amplitude; warp octave w: 0.5^w) and af (amplitude x frequency;
// warp octave w: 0.5^w 2^w = 1), 0 past the last item.
struct ItemWeights {
  float amp[kMaxItems];
  float af[kMaxItems];
};

// A field evaluation split over the kLanes lanes of a ray's group. kOct > 0
// is the octave count, known at compile time (the main path's 6): the first
// rounds' heightfield items are then fixed and their sums need no select.
template <int kOct>
struct GroupField {
  Field field;
  const ItemWeights* wt;
  float4* xch;    // the group's exchange slots in shared memory, kLanes of them
  int lane;       // this lane's rank in its group
  unsigned mask;  // the group's lanes in the warp
  int items;      // heightfield octaves, then the warp's

  // Rounds whose items are known at compile time to be heightfield octaves
  // or the warp's.
  static constexpr int kFixedRounds = (kOct + kLanes - 1) / kLanes;

  __device__ __forceinline__ int octaves() const { return kOct > 0 ? kOct : field.num_octaves; }

  // The point o + t d, and (x, z) scaled for the heightfield.
  struct Point {
    float px, py, pz, x, z;
  };
  __device__ __forceinline__ Point point(const Ray& r, float t) const {
    const float px = r.ox + t * r.dx;
    const float py = r.oy + t * r.dy;
    const float pz = r.oz + t * r.dz;
    const float hs = field.sc[kHorizontalScale];
    return Point{px, py, pz, px * hs, pz * hs};
  }

  // One round of Field::value: lane k evaluates item base + k (octave j of
  // the heightfield, or the warp's octave w at frequency 2^w), then every
  // lane adds the round's items to n and n3 in item order. The whole warp
  // runs it together: its shuffles take the whole warp's mask.
  template <bool kBf16>
  __device__ __forceinline__ void value_round(int base, const Point& p, float& n,
                                              float& n3) const {
    const int nh = octaves();
    const int j = base + lane;
    float v = 0.f;
    if (j < nh) {
      v = field.octave<kBf16>(p.x, p.z, j);
    } else if (j < items) {
      const int w = j - nh;
      const float wf = field.sc[kWarpFreq];
      v = noise3_value((p.px * wf) * pow2(w), (p.py * wf) * pow2(w), (p.pz * wf) * pow2(w),
                       field.seed + kWarpSeedOffset + static_cast<uint32_t>(w));
    }
    float o[kLanes];
#pragma unroll
    for (int q = 0; q < kLanes; ++q) o[q] = __shfl_sync(0xffffffffu, v, q, kLanes);
#pragma unroll
    for (int q = 0; q < kLanes; ++q) {
      const int i = base + q;
      const float an = __fmaf_rn(wt->amp[i], o[q], n), a3 = __fmaf_rn(wt->amp[i], o[q], n3);
      n = i < nh ? an : n;
      n3 = i >= nh && i < items ? a3 : n3;
    }
  }

  // Field::value, its octaves over the group. Every lane of the warp calls
  // it together (a group without a ray on a stale one).
  template <bool kBf16>
  __device__ __forceinline__ float value(const Ray& r, float t) const {
    const float* sc = field.sc;
    const Point p = point(r, t);
    float n = 0.f, n3 = 0.f;
#pragma unroll
    for (int k = 0; k < kFixedRounds; ++k) value_round<kBf16>(k * kLanes, p, n, n3);
    for (int base = kFixedRounds * kLanes; base < items; base += kLanes) {
      value_round<kBf16>(base, p, n, n3);
    }
    float f = p.py - (sc[kHeightOffset] + sc[kHeightScale] * n);
    if (field.volumetric) f = f - sc[kWarpAmp] * n3;
    return f;
  }

  // The sums of Field::value_grad, one round: lane k evaluates item base + k
  // (octave j: noise2 and its rotated derivatives; the warp's octave w:
  // noise3_hess's value and gradient), the lanes exchange them through
  // shared memory (the polish runs on a group alone), and every lane adds
  // them in item order.
  __device__ __forceinline__ void grad_round(int base, const Point& p, float& n, float& nxs,
                                             float& nzs, float& n3, float (&d3)[3]) const {
    const Octaves* oct = field.oct;
    const int nh = octaves();
    const int j = base + lane;
    float a = 0.f, b = 0.f, c = 0.f, d = 0.f;
    if (j < nh) {
      float nx, nz;
      noise2(oct->cf[j] * p.x - oct->sf[j] * p.z, oct->sf[j] * p.x + oct->cf[j] * p.z,
             field.seed + static_cast<uint32_t>(j), a, nx, nz);
      b = oct->c[j] * nx + oct->s[j] * nz;
      c = -oct->s[j] * nx + oct->c[j] * nz;
    } else if (j < items) {
      const int w = j - nh;
      const float wf = field.sc[kWarpFreq];
      float nd[3], nh3[6];
      noise3_hess((p.px * wf) * pow2(w), (p.py * wf) * pow2(w), (p.pz * wf) * pow2(w),
                  field.seed + kWarpSeedOffset + static_cast<uint32_t>(w), a, nd, nh3);
      b = nd[0];
      c = nd[1];
      d = nd[2];
    }
    xch[lane] = make_float4(a, b, c, d);
    __syncwarp(mask);
#pragma unroll
    for (int q = 0; q < kLanes; ++q) {
      const int i = base + q;
      const float4 e = xch[q];
      const bool height = i < nh, warp = !height && i < items;
      const float am = wt->amp[i], af = wt->af[i];
      n = height ? __fmaf_rn(am, e.x, n) : n;
      nxs = height ? __fmaf_rn(af, e.y, nxs) : nxs;
      nzs = height ? __fmaf_rn(af, e.z, nzs) : nzs;
      n3 = warp ? __fmaf_rn(am, e.x, n3) : n3;
      d3[0] = warp ? __fmaf_rn(af, e.y, d3[0]) : d3[0];
      d3[1] = warp ? __fmaf_rn(af, e.z, d3[1]) : d3[1];
      d3[2] = warp ? __fmaf_rn(af, e.w, d3[2]) : d3[2];
    }
    __syncwarp(mask);
  }

  // Field::value_grad, its octaves over the group.
  __device__ __forceinline__ void value_grad(const Ray& r, float t, float& f, float& gx,
                                             float& gy, float& gz, float& h) const {
    const float* sc = field.sc;
    const Point p = point(r, t);
    float n = 0.f, nxs = 0.f, nzs = 0.f, n3 = 0.f, d3[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < kFixedRounds; ++k) grad_round(k * kLanes, p, n, nxs, nzs, n3, d3);
    for (int base = kFixedRounds * kLanes; base < items; base += kLanes) {
      grad_round(base, p, n, nxs, nzs, n3, d3);
    }
    const float wa = sc[kWarpAmp], wf = sc[kWarpFreq];
    h = sc[kHeightOffset] + sc[kHeightScale] * n;
    const float scale = sc[kHeightScale] * field.sc[kHorizontalScale];
    f = p.py - h;
    gx = -scale * nxs;
    gy = 1.f;
    gz = -scale * nzs;
    if (field.volumetric) {
      f = f - wa * n3;
      const float waf = wa * wf;
      gx = gx - waf * d3[0];
      gy = gy - waf * d3[1];
      gz = gz - waf * d3[2];
    }
  }
};

// A ray whose march is done, kept in shared memory until its warp polishes
// and shades it.
struct Finished {
  int idx;
  float t, prev_t;
  int hit;
};

// The next slot a group will march, fetched ahead in stages, one per march
// step of its current ray, so that its loads' latency hides behind the
// march: 0 lane 0 takes a value from the counter, 2 it keeps it in
// raw_copy (shuffled to the group every iteration), 3 the slot and its
// pixel id, 4 that pixel's t and prev; kReady all known. (The compiler
// merges a warp's counter requests into one atomic and waits for it where
// it is issued.)
constexpr int kReady = 5;
struct NextSlot {
  int stage, raw, raw_copy, slot, idx;
  float t, prev_t;
};

template <bool kBf16, int kOct, bool kFrames>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
trace_phase2_kernel(const float* __restrict__ packed, const int* __restrict__ seed_ptr,
                    const int* __restrict__ n_alive_ptr, const int* __restrict__ ids,
                    const float* __restrict__ prev, float* __restrict__ color,
                    float* __restrict__ t_io, float* __restrict__ hit_out,
                    int* __restrict__ scratch, TraceConfig cfg) {
  __shared__ float sc[kAmps + kMaxOctaves];
  __shared__ Octaves oct;
  __shared__ ItemWeights wt;
  __shared__ float4 xch[kGroupsPerBlock][kLanes];
  __shared__ Finished done[kWarpsPerBlock][kPool];
  const int n_params = kAmps + cfg.num_octaves;
  if constexpr (kFrames) {
    // This block's frame: its packed scalars, n_alive, list, planes and
    // counter pair.
    const size_t frame = blockIdx.y;
    const size_t px = frame * static_cast<size_t>(cfg.local_h) * cfg.width;
    packed += frame * n_params;
    n_alive_ptr += frame;
    ids += px;
    prev += px;
    color += 3 * px;
    t_io += px;
    hit_out += px;
    scratch += 2 * frame;
  }
  const int items = cfg.num_octaves + (cfg.volumetric ? cfg.warp_octaves : 0);
  for (int k = threadIdx.x; k < n_params; k += blockDim.x) sc[k] = packed[k];
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < cfg.num_octaves) load_octave(sc, threadIdx.x, oct);
  __syncthreads();
  if (threadIdx.x < kMaxItems) {
    const int i = threadIdx.x, w = i - cfg.num_octaves;
    float amp = 0.f, af = 0.f;
    if (i < cfg.num_octaves) {
      amp = oct.amp[i];
      af = oct.af[i];
    } else if (i < items) {  // fbm3's amp and amp * freq
      amp = pow2(-w);
      af = pow2(-w) * pow2(w);
    }
    wt.amp[i] = amp;
    wt.af[i] = af;
  }
  __syncthreads();

  const int n_alive = *n_alive_ptr;
  const int lane32 = threadIdx.x % 32;
  const unsigned mask = ((1u << kLanes) - 1u) << (lane32 / kLanes * kLanes);
  const int group = static_cast<int>(threadIdx.x) / kLanes;
  const GroupField<kOct> gf{Field{sc, &oct, cfg.num_octaves, static_cast<uint32_t>(*seed_ptr),
                            cfg.volumetric != 0, cfg.warp_octaves},
                      &wt, xch[group], static_cast<int>(threadIdx.x % kLanes), mask, items};
  const float env = envelope(sc, cfg);
  const float eps_m = cfg.hit_eps * cfg.march_eps_scale;
  const int n_pix = cfg.local_h * cfg.width;
  const int n_groups = static_cast<int>(gridDim.x) * kGroupsPerBlock;
  Finished* const pool = done[threadIdx.x / 32];
  const int group_in_warp = (threadIdx.x % 32) / kLanes;

  // Slot s holds the pixel ids[n_alive - 1 - s]: phase 1's warps that march
  // longest list their survivors last, so the longest rays start first.
  auto pixel_of = [&](int slot) { return ids[n_alive - 1 - slot]; };
  auto ray_of = [&](int idx) {
    const int row = idx / cfg.width;
    const int col = idx - row * cfg.width;
    const CameraRay cr = camera_ray(sc, cfg.height, cfg.width, row, col);
    return Ray{sc[kPos + 0], sc[kPos + 1], sc[kPos + 2], cr.dx, cr.dy, cr.dz};
  };
  // One stage of fetching the next slot; ``bslot`` is lane 0's raw_copy.
  auto advance = [&](NextSlot& nx, int bslot) {
    if (nx.stage == 0) {
      if (gf.lane == 0) nx.raw = atomicAdd(scratch, 1);
    } else if (nx.stage == 2) {
      nx.raw_copy = nx.raw;
    } else if (nx.stage == 3) {
      nx.slot = n_groups + bslot;
      if (nx.slot < n_alive) nx.idx = pixel_of(nx.slot);
    } else if (nx.stage == 4 && nx.slot < n_alive) {
      nx.t = t_io[nx.idx];
      nx.prev_t = prev[nx.idx];
    }
    nx.stage = min(nx.stage + 1, kReady);
  };

  // --- the warp's loop: each group with a ray takes one march step
  // (trace_march.cuh:march's chunked step) and one stage of fetching its
  // next slot; a group whose ray is done adds it to the warp's pool and
  // starts the next. When the pool holds a ray per group, or no group of the
  // warp has a ray left, the warp polishes and shades the pool, a ray per
  // group per round. Branches are uniform over a group; the loop and its
  // field evaluation run on the whole warp.
  int idx = 0, steps = 0;
  Ray ray{};
  March m{};
  // The first slots go round the blocks (slot = group x blocks + block), so
  // the longest rays spread over every SM.
  NextSlot nx{kReady, 0, 0, group * static_cast<int>(gridDim.x) + static_cast<int>(blockIdx.x),
              0, 0.f, 0.f};
  if (nx.slot < n_alive) {
    nx.idx = pixel_of(nx.slot);
    nx.t = t_io[nx.idx];
    nx.prev_t = prev[nx.idx];
  }
  // Start the ray of slot nx.slot from phase 1's t and last advancing
  // sample, not yet hit and still marching (phase 1 listed it because its
  // march was cut by the budget), and start fetching the slot after it.
  auto start = [&]() {
    idx = nx.idx;
    ray = ray_of(idx);
    m = March{nx.t, nx.prev_t, true, false};
    steps = 0;
    nx.stage = 0;
  };
  bool have = nx.slot < n_alive;
  if (have) start();
  int pooled = 0;  // the warp's finished rays in ``pool``
  for (;;) {
    const bool any_ray = __any_sync(0xffffffffu, have);
    if (any_ray) {
      const int bslot = __shfl_sync(0xffffffffu, nx.raw_copy, 0, kLanes);
      const float f = gf.template value<kBf16>(ray, m.t);
      bool finished = false;
      Finished fin{};
      if (have) {
        // The chunked step, its branches as selects: a hit ends the march
        // where it is, an envelope escape (a certain miss) at t_max, else
        // the ray advances.
        ++steps;
        const bool is_hit = f < eps_m * m.t;
        const bool escape = !is_hit && ray.oy + m.t * ray.dy > env && ray.dy >= 0.f;
        float step = fmaxf(cfg.step_relax * f, cfg.hit_eps);
        if (cfg.step_floor_t > 0.f) step = fmaxf(step, cfg.step_floor_t * m.t);
        const float t_new = fminf(m.t + step, cfg.t_max);
        const bool advances = !is_hit && !escape;
        m.hit = is_hit;
        m.prev_t = advances ? m.t : m.prev_t;
        m.t = escape ? cfg.t_max : (advances ? t_new : m.t);
        m.active = advances && t_new < cfg.t_max;
        advance(nx, bslot);
        if (!m.active || steps == cfg.budget) {
          finished = true;
          fin = Finished{idx, m.t, m.prev_t, m.hit ? 1 : 0};
          while (nx.stage < kReady) {
            advance(nx, nx.stage == 3 ? __shfl_sync(mask, nx.raw_copy, 0, kLanes) : 0);
          }
          have = nx.slot < n_alive;
          if (have) start();
        }
      }
      // Each group that finished a ray adds it to the warp's pool.
      const unsigned adds = __ballot_sync(0xffffffffu, finished && gf.lane == 0);
      if (finished && gf.lane == 0) pool[pooled + __popc(adds & ((1u << lane32) - 1u))] = fin;
      pooled += __popc(adds);
    }
    if (!any_ray || pooled >= kGroupsPerWarp) {
      // Polish and shade the pool, a ray per group in each round.
      __syncwarp();
      for (int base = 0; base < pooled; base += kGroupsPerWarp) {
        const int k = base + group_in_warp;
        if (k < pooled) {
          const Finished e = pool[k];
          polish_and_shade(gf, ray_of(e.idx), sc, cfg, e.t, e.prev_t, e.hit != 0, e.idx, n_pix,
                           color, t_io, hit_out);
        }
      }
      __syncwarp();
      pooled = 0;
      if (!any_ray) break;
    }
  }
  // Every group's last fetch is done before its block counts itself out in
  // scratch[1]; the last block out (of its frame) sets both back to 0.
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(scratch + 1, 1) == static_cast<int>(gridDim.x) - 1) {
      atomicExch(scratch, 0);
      atomicExch(scratch + 1, 0);
    }
  }
}

// The blocks of a launch over each frame of n_pix pixels (the grid's x; its
// y is the frames): the resident blocks (the occupancy query, once per device
// and instantiation) shared out evenly among the frames, at least one each,
// and no more than a frame's pixels could fill.
template <bool kBf16, int kOct, bool kFrames>
cudaError_t blocks_for(int n_pix, int frames, int& blocks) {
  static int resident[kMaxDevices];
  int dev = 0;
  if (const cudaError_t err = cudaGetDevice(&dev)) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (const cudaError_t err =
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) {
      return err;
    }
    if (const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, trace_phase2_kernel<kBf16, kOct, kFrames>, kThreads, 0)) {
      return err;
    }
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    resident[dev] = per_sm * sms;
  }
  blocks = std::max(1, std::min(resident[dev] / frames,
                                (n_pix + kGroupsPerBlock - 1) / kGroupsPerBlock));
  return cudaSuccess;
}

// The pointers of a launch, each to its frames' data one after another.
struct Phase2Args {
  const float* packed;
  const int *seed, *n_alive, *ids;
  const float* prev;
  float *color, *t, *hit;
  int* scratch;
};

template <bool kBf16, int kOct, bool kFrames>
cudaError_t launch_frames(const Phase2Args& a, const TraceConfig& cfg, int frames,
                          cudaStream_t stream) {
  int blocks = 0;
  if (const cudaError_t err =
          blocks_for<kBf16, kOct, kFrames>(cfg.local_h * cfg.width, frames, blocks)) {
    return err;
  }
  trace_phase2_kernel<kBf16, kOct, kFrames><<<dim3(blocks, frames), kThreads, 0, stream>>>(
      a.packed, a.seed, a.n_alive, a.ids, a.prev, a.color, a.t, a.hit, a.scratch, cfg);
  return cudaGetLastError();
}

// The main path's 6 octaves run their own instantiation (kOct 6), any other
// count the runtime loop (kOct 0); one frame the instantiation without the
// frame axis, a batch the one with it.
template <bool kBf16>
cudaError_t launch(const Phase2Args& a, const TraceConfig& cfg, int frames,
                   cudaStream_t stream) {
  if (cfg.num_octaves == kUnrolledOctaves) {
    return frames == 1 ? launch_frames<kBf16, kUnrolledOctaves, false>(a, cfg, 1, stream)
                       : launch_frames<kBf16, kUnrolledOctaves, true>(a, cfg, frames, stream);
  }
  return frames == 1 ? launch_frames<kBf16, 0, false>(a, cfg, 1, stream)
                     : launch_frames<kBf16, 0, true>(a, cfg, frames, stream);
}

}  // namespace

extern "C" {

// Launches phase 2 over ``frames`` frames on ``stream`` and returns its CUDA
// error (0 on success). Device pointers, each to ``frames`` consecutive
// frames of its data: ``packed`` (frames, kAmps + num_octaves), ``seed`` one
// int32 for them all, ``n_alive`` one int32 per frame and ``ids`` the pixel
// id of each slot (int32, local_h * width per frame), both as phase 1 wrote
// them, ``prev`` phase 1's (local_h, width) output, ``color``, ``t`` and
// ``hit`` phase 1's outputs, overwritten at the pixels of the first n_alive
// slots (``t`` is read there first); ``scratch`` two int32 per frame, 0 when
// the kernel starts and left at 0 (launches that may overlap, on different
// streams, need their own). cfg.budget is the steps left (max_steps -
// compact_budget), cfg.phase 2; ``frames`` 1 to kMaxFrames. The caller
// validates shapes, dtypes and contiguity.
int trace_compact_launch(const float* packed, const int* seed, const int* n_alive,
                         const int* ids, const float* prev, float* color, float* t,
                         float* hit, int* scratch, TraceConfig cfg, int frames, void* stream) {
  if (cfg.march_mode != kCompact || cfg.phase != 2 || scratch == nullptr || frames < 1 ||
      frames > kMaxFrames) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Phase2Args a{packed, seed, n_alive, ids, prev, color, t, hit, scratch};
  return static_cast<int>(cfg.bf16 ? launch<true>(a, cfg, frames, s)
                                   : launch<false>(a, cfg, frames, s));
}

}  // extern "C"
