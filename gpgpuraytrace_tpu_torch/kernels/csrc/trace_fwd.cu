// Forward trace kernel: raygen -> primed, envelope-skipping sphere-trace
// march -> bracketed Newton polish -> shade, one thread per pixel, each warp
// a 4x8 tile of pixels, persistent warps fetching tiles until none is left.
//
// Replaces gpgpuraytrace_tpu/kernels/trace.py:_trace_kernel (heightfield or
// volumetric, optionally primed) with every variant of its march: chunked,
// fixed (no early exit), lod (a certified coarse-field phase, then the fine
// march), the bf16 march field, and the debug_steps executed-step counter;
// and _trace_phase1_kernel, compaction's first phase: the unprimed chunked
// march stopped after cfg.budget steps, with each ray's still-marching flag
// and last advancing sample as two more outputs, and the pixel ids of the
// rays still marching appended to a list whose length n_alive stays on the
// device (trace_compact.cu resumes those rays). The TPU kernels compute the
// same per pixel over (16, 128) tiles of a sequential TPU grid. The plain
// PyTorch versions are gpgpuraytrace_tpu_torch/kernels/trace.py:
// trace_frame_reference and trace_phase1_reference, line for line the same
// arithmetic.
//
// The variants are template parameters (mode, bf16, debug), dispatched by
// trace_fwd_launch, so each instantiation carries only its own march; the
// main path's (chunked, no counter, float32 or bf16) has a twin with its 6
// octaves unrolled (kOctaves), which a frame of 6 octaves runs. The march,
// the polish and the shade are trace_march.cuh's, which phase 2 shares.
//
// A launch traces a batch of frames (the JAX package's vmap over its kernel:
// a flythrough batch, gpgpuraytrace_tpu/ops/flythrough.py:_make_batch_render;
// a row-band rank's interleaved stripes, parallel/sharded.py) as one pool of
// tiles, frame 0's first: each warp takes the next tile of the pool whatever
// its frame, with that frame's packed scalars (kept in the warp's slice of
// shared memory), prime map and outputs, so a pixel's arithmetic is its
// one-frame launch's. The frame axis is a template parameter too (kFrames):
// a one-frame launch runs the instantiations without it, whose code is the
// one-frame kernel's as it was.
//
// What bounds it on the H100: INT32 and FP32 issue. Each march step
// evaluates the value-only fBm, about 77 FP32 and 49 INT32 operations per
// octave (the lattice hash is integer work; plus about 150 and 125 per warp
// octave of the volumetric 3D noise; chip_smoke.py:OPS counts them), and a
// pixel marches a few to tens of steps, while it reads one prime value and
// writes five floats (about 20 bytes). So all per-ray state stays in
// registers and shared memory holds only the packed scene scalars and the
// per-octave coefficients. A warp runs until its longest ray is done, so the
// schedule is built around that:
// - A warp takes a 4x8 tile (kernels/trace.py:WARP_TILE) rather than 32
//   pixels of a row: neighbours in both directions march alike, and a warp
//   executes 14-16% fewer steps (PERF.md, section 3). Ragged edges (band
//   heights, the 66-row coarse frame, widths not a multiple of 8) mask their
//   lanes.
// - The grid is what fits on the card at once (occupancy x SMs, capped by
//   the tiles), and lane 0 of each warp takes the next tile from a counter
//   in the wrapper's scratch buffer: a warp that finishes early takes more
//   work instead of idling until its block's slowest warp ends. The last
//   warp to finish sets the counter back to 0 for the next launch on the
//   stream, so a launch needs no memset. The tile order changes no output
//   bit.
// - A frame with few tiles (the 66x64 coarse prime pass: 136) launches
//   blocks of fewer warps, so its tiles spread over all SMs, one or two
//   warps each, where the march's serial chain of steps sets the time.
// - A batch's frames share one pool of tiles and so the resident warps:
//   when its frames march unevenly (a rank's stripes, some all sky, some at
//   the horizon) no warp idles while another frame has tiles left. (Each
//   frame with its own share of the blocks, the batch ran as long as its
//   slowest frame took on that share: a 4K rank's 15 stripes of 36 rows
//   0.76-0.82 ms against 0.57 ms for the mean of the four bands' passes,
//   PERF.md.)
// - The 6 octaves' noise chains are independent, so the main path's field
//   unrolls them (Field::value<kBf16, 6>) and they overlap; the sum keeps
//   its order. Only the main path's chunked march was timed with it (the
//   coarse pass 15-22% faster, PERF.md section 6), so only it has the twin.
// Each thread stops marching as soon as its own ray is done; the TPU kernel
// instead checks for a whole-tile exit every march_chunk steps, which gives
// the same result because a finished lane never changes state, and
// RenderConfig makes the chunk divide max_steps (and compact_budget).

#include <algorithm>

#include <cooperative_groups.h>

#include "trace_march.cuh"

namespace {

// A warp's tile: kTileRows x kTileCols pixels (kernels/trace.py:WARP_TILE).
constexpr int kTileRows = 4, kTileCols = 8;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;
// __launch_bounds__' blocks per SM, chosen by timing 2-5 (PERF.md, section 6).
constexpr int kMinBlocks = 2;
// The main path's octave count, unrolled in Field::value by the chunked,
// uncounted instantiations.
constexpr int kUnrolledOctaves = 6;
constexpr int kMaxDevices = 64;

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

// The pointers of one launch: device buffers, null where unused.
struct FwdArgs {
  const float* packed;
  const int* seed;
  const float* prime;
  float *color, *t, *hit;
  int* steps;
  float *alive, *prev;
  int *ids, *n_alive;
  int* tile_scratch;
};

// What every pixel of a launch shares: the scalars in shared memory, the
// field, the envelope and the lod margin.
struct Frame {
  const float* sc;
  Field field;
  float env;
  float margin;  // lod only
  int k_coarse, wo_coarse;
};

// ``p`` offset by ``offset`` elements, or null where it is null (an input or
// output the launch does not use).
template <class T>
__device__ __forceinline__ T* at_frame(T* p, size_t offset) {
  return p == nullptr ? p : p + offset;
}

// One pixel (row, col of the band): raygen, the march of kMode, polish and
// shade, its outputs at idx = row * width + col.
template <int kMode, bool kBf16, bool kDebug, int kOctaves>
__device__ __forceinline__ void trace_pixel(const Frame& fr, const FwdArgs& a,
                                            const TraceConfig& cfg, int row, int col) {
  const float* sc = fr.sc;
  const int n_pix = cfg.local_h * cfg.width;
  const int idx = row * cfg.width + col;

  // --- raygen (kernels/trace.py:_raygen_rc) ------------------------------
  const CameraRay cr = camera_ray(sc, cfg.height, cfg.width, row, col);
  const float dy = cr.dy;
  const Ray ray{sc[kPos + 0], sc[kPos + 1], sc[kPos + 2], cr.dx, dy, cr.dz};

  // --- sky-envelope entry (_envelope, _envelope_entry) -------------------
  const float env = fr.env;  // the entry below and the march's escape test
  const float oy = ray.oy;
  float t = cfg.t_min;
  if (oy > env) {
    t = dy < 0.f ? clip((env - oy) / dy, cfg.t_min, cfg.t_max) : cfg.t_max;
  }
  bool active = t < cfg.t_max;
  float prev_t = t;
  if (cfg.primed) {
    t = fmaxf(t, a.prime[idx]);
    active = active && t < cfg.t_max;
    prev_t = fmaxf(t * kPrimePullback, cfg.t_min);
  }

  if constexpr (kMode == kLod) {
    // --- lod phase 1 (_trace_kernel lod branch, _coarse_field_fn) -------
    // Step on f_coarse - margin <= f while it exceeds max(margin/2,
    // hit_eps t): no step can pass a surface of the full field. A parked
    // lane never changes state again, so the per-thread exit is exact.
    Field coarse = fr.field;
    coarse.num_octaves = fr.k_coarse;
    coarse.warp_octaves = fr.wo_coarse;
    const float margin = fr.margin;
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

  // --- march (_tile_trace march_step): max_steps, or compaction phase 1's
  // budget -------------------------------------------------------------------
  March m{t, prev_t, active, false};
  const int n_steps = kMode == kCompact ? cfg.budget : cfg.max_steps;
  const int executed =
      march<kMode == kFixed, kBf16, kDebug, kOctaves>(fr.field, ray, env, cfg, n_steps, m);
  if constexpr (kDebug) a.steps[idx] = executed;
  if constexpr (kMode == kCompact) {
    // Still marching after the budget: polished and shaded as a miss here,
    // resumed by phase 2 (trace_compact.cu), which overwrites its outputs.
    a.alive[idx] = m.active ? 1.f : 0.f;
    a.prev[idx] = m.prev_t;
    if (m.active) {
      // Append the pixel id to the survivors' list: one atomic per group of
      // converged threads, ids in lane order within it. A survivor's result
      // does not depend on its slot, so the order across warps (whichever
      // warp gets there first) changes no output bit.
      const cooperative_groups::coalesced_group g = cooperative_groups::coalesced_threads();
      int base = 0;
      if (g.thread_rank() == 0) base = atomicAdd(a.n_alive, static_cast<int>(g.size()));
      a.ids[g.shfl(base, 0) + static_cast<int>(g.thread_rank())] = idx;
    }
  }
  polish_and_shade(fr.field, ray, sc, cfg, m.t, m.prev_t, m.hit, idx, n_pix, a.color, a.t,
                   a.hit);
}

// The packed scalars that the octave table (load_octave), the envelope and
// the lod margin are computed from.
__device__ __forceinline__ bool shapes_field(int k) {
  return k == kLacunarity || k == kHeightScale || k == kHeightOffset || k == kWarpAmp ||
         k >= kAmps;
}

// The frame axis (kFrames): a batch's tiles form one pool, frame 0's first,
// from which each warp takes the next tile (tile_scratch[0]) whatever its
// frame, so the card stays full until the batch's last tiles however unevenly
// its frames march. A warp keeps its frame's scalars and octaves in its own
// slice of shared memory and loads them again when a tile takes it to the
// next frame (tiles come in order, so at most B - 1 times); it computes the
// octave table and the envelope again only where the scalars they read
// change: every warp reaches a frame's first tiles at about the same time,
// so the card waits out each frame's switch at once, and recomputing the
// table (double-precision sincos) cost a 4K rank's batch of 15 stripes about
// 2.7 us a stripe (PERF.md). A pixel's arithmetic is its one-frame launch's.
template <int kMode, bool kBf16, bool kDebug, int kOctaves>
__device__ __forceinline__ void trace_pool(const FwdArgs& all, const TraceConfig& cfg) {
  __shared__ float warp_sc[kWarpsPerBlock][kAmps + kMaxOctaves];
  __shared__ Octaves warp_oct[kWarpsPerBlock];
  __shared__ float warp_margin[kWarpsPerBlock];  // lod only
  const int n_params = kAmps + cfg.num_octaves;
  const int k_coarse = max(1, (cfg.num_octaves + 1) / 2);
  const int wo_coarse = max(1, cfg.warp_octaves - 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sc = warp_sc[warp];
  const int tiles_x = (cfg.width + kTileCols - 1) / kTileCols;
  const int n_tiles = tiles_x * ((cfg.local_h + kTileRows - 1) / kTileRows);
  const int pool = n_tiles * static_cast<int>(gridDim.y);  // launch_frames bounds it
  const size_t n_pix = static_cast<size_t>(cfg.local_h) * cfg.width;
  const uint32_t seed = static_cast<uint32_t>(*all.seed);
  const int tile_row = lane / kTileCols, tile_col = lane % kTileCols;
  int frame = -1;
  FwdArgs a = all;
  float env = 0.f;
  for (;;) {
    int tile = 0;
    if (lane == 0) tile = atomicAdd(all.tile_scratch, 1);
    tile = __shfl_sync(0xffffffffu, tile, 0);
    if (tile >= pool) break;
    const int f = tile / n_tiles;
    tile -= f * n_tiles;
    if (f != frame) {
      // This warp's new frame: its row of packed scalars, its planes of every
      // per-pixel input and output, its slot of n_alive.
      bool same = frame >= 0;
      frame = f;
      const size_t px = static_cast<size_t>(f) * n_pix;
      a = FwdArgs{all.packed + static_cast<size_t>(f) * n_params, all.seed,
                  at_frame(all.prime, px), all.color + 3 * px, all.t + px, all.hit + px,
                  at_frame(all.steps, px), at_frame(all.alive, px), at_frame(all.prev, px),
                  at_frame(all.ids, px), at_frame(all.n_alive, static_cast<size_t>(f)),
                  all.tile_scratch};
      // Its scalars; where those that the octave table, the envelope and the
      // lod margin read are its last frame's bit for bit (a rank's stripes
      // and a fly batch share the scene's), those stay.
      __syncwarp();  // every lane is done with the last frame's scalars
      for (int k = lane; k < n_params; k += 32) {
        const float v = a.packed[k];
        same = same && (!shapes_field(k) || __float_as_uint(v) == __float_as_uint(sc[k]));
        sc[k] = v;
      }
      same = __all_sync(0xffffffffu, same);
      __syncwarp();
      if (!same) {
        if (lane < cfg.num_octaves) load_octave(sc, lane, warp_oct[warp]);
        if constexpr (kMode == kLod) {
          if (lane == 0) {
            warp_margin[warp] = lod_margin(sc, cfg.num_octaves, k_coarse,
                                           cfg.volumetric != 0, cfg.warp_octaves, wo_coarse);
          }
        }
        __syncwarp();
        env = envelope(sc, cfg);
      }
    }
    const Frame fr{sc,
                   Field{sc, &warp_oct[warp], cfg.num_octaves, seed, cfg.volumetric != 0,
                         cfg.warp_octaves},
                   env, kMode == kLod ? warp_margin[warp] : 0.f, k_coarse, wo_coarse};
    const int ty = tile / tiles_x;
    const int row = ty * kTileRows + tile_row;
    const int col = (tile - ty * tiles_x) * kTileCols + tile_col;
    if (row < cfg.local_h && col < cfg.width) {
      trace_pixel<kMode, kBf16, kDebug, kOctaves>(fr, a, cfg, row, col);
    }
  }
  // As the one-frame kernel's, over every warp of the grid: the last one out
  // sets the pool's counter pair back to 0.
  if (lane == 0) {
    __threadfence();
    const int warps = static_cast<int>(gridDim.x * gridDim.y * (blockDim.x / 32));
    if (atomicAdd(all.tile_scratch + 1, 1) == warps - 1) {
      atomicExch(all.tile_scratch, 0);
      atomicExch(all.tile_scratch + 1, 0);
    }
  }
}

template <int kMode, bool kBf16, bool kDebug, int kOctaves, bool kFrames>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
trace_fwd_kernel(const float* __restrict__ packed, const int* __restrict__ seed,
                 const float* __restrict__ prime, float* __restrict__ color,
                 float* __restrict__ t_out, float* __restrict__ hit_out,
                 int* __restrict__ steps_out, float* __restrict__ alive_out,
                 float* __restrict__ prev_out, int* __restrict__ ids_out,
                 int* __restrict__ n_alive, int* __restrict__ tile_scratch, TraceConfig cfg) {
  const FwdArgs a{packed,    seed,     prime,   color,  t_out,   hit_out,
                  steps_out, alive_out, prev_out, ids_out, n_alive, tile_scratch};
  if constexpr (kFrames) {
    trace_pool<kMode, kBf16, kDebug, kOctaves>(a, cfg);
  } else {
    const int n_params = kAmps + cfg.num_octaves;
    __shared__ float sc[kAmps + kMaxOctaves];
    __shared__ Octaves oct;
    __shared__ float margin;  // lod only
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
    const Frame fr{sc,
                   Field{sc, &oct, cfg.num_octaves, static_cast<uint32_t>(*seed),
                         cfg.volumetric != 0, cfg.warp_octaves},
                   envelope(sc, cfg), kMode == kLod ? margin : 0.f, k_coarse, wo_coarse};

    // --- the tiles: lane 0 takes the next one from tile_scratch[0], the
    // warp traces its pixels -------------------------------------------------
    const int tiles_x = (cfg.width + kTileCols - 1) / kTileCols;
    const int n_tiles = tiles_x * ((cfg.local_h + kTileRows - 1) / kTileRows);
    const int lane = threadIdx.x % 32;
    const int tile_row = lane / kTileCols, tile_col = lane % kTileCols;
    for (;;) {
      int tile = 0;
      if (lane == 0) tile = atomicAdd(tile_scratch, 1);
      tile = __shfl_sync(0xffffffffu, tile, 0);
      if (tile >= n_tiles) break;
      const int ty = tile / tiles_x;
      const int row = ty * kTileRows + tile_row;
      const int col = (tile - ty * tiles_x) * kTileCols + tile_col;
      if (row < cfg.local_h && col < cfg.width) {
        trace_pixel<kMode, kBf16, kDebug, kOctaves>(fr, a, cfg, row, col);
      }
    }
    // Every warp's last fetch is done before it counts itself out in
    // tile_scratch[1]; the last one out sets both back to 0.
    if (lane == 0) {
      __threadfence();
      const int warps = static_cast<int>(gridDim.x * (blockDim.x / 32));
      if (atomicAdd(tile_scratch + 1, 1) == warps - 1) {
        atomicExch(tile_scratch, 0);
        atomicExch(tile_scratch + 1, 0);
      }
    }
  }
}

// The grid of a launch over n_tiles tiles: warps per block and blocks.
struct Grid {
  int warps, blocks;
};

// The grid over a pool of n_tiles tiles of each of ``frames`` frames (its y
// is the frames, its x the blocks over each). A pool that fills the card runs
// kWarpsPerBlock-warp blocks, as many as are resident at once (the occupancy
// query, once per device and instantiation); a smaller one runs blocks of
// pool / SMs warps (at least 1), about one block per SM, so that its tiles
// spread over them all. One frame is the pool of its own tiles.
template <int kMode, bool kBf16, bool kDebug, int kOctaves, bool kFrames>
cudaError_t grid_for(int n_tiles, int frames, Grid& g) {
  static int sms[kMaxDevices], resident[kMaxDevices];
  int dev = 0;
  if (const cudaError_t err = cudaGetDevice(&dev)) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    if (const cudaError_t err =
            cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev)) {
      return err;
    }
    int per_sm = 0;
    if (const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, trace_fwd_kernel<kMode, kBf16, kDebug, kOctaves, kFrames>, kThreads,
            0)) {
      return err;
    }
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    resident[dev] = per_sm * sms[dev];
  }
  const int pool = n_tiles * frames;
  g.warps = std::max(1, std::min(kWarpsPerBlock, pool / sms[dev]));
  const int blocks = (pool + g.warps - 1) / g.warps;
  const int total = g.warps == kWarpsPerBlock ? std::min(blocks, resident[dev]) : blocks;
  g.blocks = (total + frames - 1) / frames;
  return cudaSuccess;
}

// The most tiles a launch's pool holds, so that its int32 counter, which
// every warp takes once past the end, cannot overflow.
constexpr long long kMaxPoolTiles = 1LL << 30;

template <int kMode, bool kBf16, bool kDebug, int kOctaves, bool kFrames>
cudaError_t launch_frames(const FwdArgs& a, const TraceConfig& cfg, int frames,
                          cudaStream_t stream) {
  const int n_tiles = ((cfg.width + kTileCols - 1) / kTileCols) *
                      ((cfg.local_h + kTileRows - 1) / kTileRows);
  if (static_cast<long long>(n_tiles) * frames > kMaxPoolTiles) return cudaErrorInvalidValue;
  Grid g{};
  if (const cudaError_t err =
          grid_for<kMode, kBf16, kDebug, kOctaves, kFrames>(n_tiles, frames, g)) {
    return err;
  }
  const dim3 grid(g.blocks, frames);
  trace_fwd_kernel<kMode, kBf16, kDebug, kOctaves, kFrames><<<grid, 32 * g.warps, 0, stream>>>(
      a.packed, a.seed, a.prime, a.color, a.t, a.hit, a.steps, a.alive, a.prev, a.ids,
      a.n_alive, a.tile_scratch, cfg);
  return cudaGetLastError();
}

// One frame runs the instantiation without the frame axis, a batch the one
// with it.
template <int kMode, bool kBf16, bool kDebug, int kOctaves>
cudaError_t launch_octaves(const FwdArgs& a, const TraceConfig& cfg, int frames,
                           cudaStream_t stream) {
  if (frames == 1) return launch_frames<kMode, kBf16, kDebug, kOctaves, false>(a, cfg, 1, stream);
  return launch_frames<kMode, kBf16, kDebug, kOctaves, true>(a, cfg, frames, stream);
}

template <int kMode, bool kBf16, bool kDebug>
cudaError_t launch_variant(const FwdArgs& a, const TraceConfig& cfg, int frames,
                           cudaStream_t stream) {
  if constexpr (kMode == kChunked && !kDebug) {
    if (cfg.num_octaves == kUnrolledOctaves) {
      return launch_octaves<kMode, kBf16, kDebug, kUnrolledOctaves>(a, cfg, frames, stream);
    }
  }
  return launch_octaves<kMode, kBf16, kDebug, 0>(a, cfg, frames, stream);
}

template <int kMode>
cudaError_t launch_mode(const FwdArgs& a, const TraceConfig& cfg, int frames,
                        cudaStream_t stream) {
  const bool bf16 = cfg.bf16 != 0, debug = a.steps != nullptr;
  if (bf16 && debug) return launch_variant<kMode, true, true>(a, cfg, frames, stream);
  if (bf16) return launch_variant<kMode, true, false>(a, cfg, frames, stream);
  if (debug) return launch_variant<kMode, false, true>(a, cfg, frames, stream);
  return launch_variant<kMode, false, false>(a, cfg, frames, stream);
}

}  // namespace

extern "C" {

// Launches the kernel instantiation that cfg.march_mode, cfg.bf16 and
// ``steps`` select over ``frames`` frames on ``stream`` and returns its CUDA
// error (0 on success). Pointers are device pointers, each to ``frames``
// consecutive frames of its data (frame b's at b times one frame's size);
// ``packed`` is (frames, kAmps + num_octaves), ``seed`` one int32 for them
// all. ``prime`` is null unless cfg.primed, ``steps`` (an int32 per pixel)
// null unless the counter is wanted, ``alive`` and ``prev`` (a float per
// pixel), ``ids`` (an int32 per pixel) and ``n_alive`` (one int32 per frame)
// null unless cfg.march_mode is kCompact, which launches compaction's phase 1
// (cfg.phase 1, no counter, unprimed): it sets n_alive to 0 on the stream,
// then the kernel writes frame b's survivors' pixel ids to its ids[0,
// n_alive[b]). ``tile_scratch`` is two int32 of scratch (the pool's counter
// pair, the batch's too), which must be 0 when the kernel starts and which it
// leaves at 0; launches that may overlap (on different streams) need their
// own. ``frames`` is 1 to kMaxFrames, and a batch's tiles at most
// kMaxPoolTiles. The caller validates shapes, dtypes and contiguity.
int trace_fwd_launch(const float* packed, const int* seed, const float* prime,
                     float* color, float* t, float* hit, int* steps, float* alive,
                     float* prev, int* ids, int* n_alive, int* tile_scratch, TraceConfig cfg,
                     int frames, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FwdArgs a{packed, seed, prime, color, t, hit, steps, alive, prev, ids, n_alive,
                  tile_scratch};
  if (tile_scratch == nullptr || frames < 1 || frames > kMaxFrames) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (cfg.march_mode) {
    case kChunked:
      return static_cast<int>(launch_mode<kChunked>(a, cfg, frames, s));
    case kFixed:
      return static_cast<int>(launch_mode<kFixed>(a, cfg, frames, s));
    case kLod:
      return static_cast<int>(launch_mode<kLod>(a, cfg, frames, s));
    case kCompact:
      if (cfg.phase != 1 || steps != nullptr || prime != nullptr || alive == nullptr ||
          prev == nullptr || ids == nullptr || n_alive == nullptr) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      if (const cudaError_t err = cudaMemsetAsync(n_alive, 0, frames * sizeof(int), s)) {
        return static_cast<int>(err);
      }
      return static_cast<int>(
          cfg.bf16 ? launch_variant<kCompact, true, false>(a, cfg, frames, s)
                   : launch_variant<kCompact, false, false>(a, cfg, frames, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* trace_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
