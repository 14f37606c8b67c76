// Forward trace kernel: raygen -> primed, envelope-skipping sphere-trace
// march -> bracketed Newton polish -> shade, one thread per pixel.
//
// Replaces gpgpuraytrace_tpu/kernels/trace.py:_trace_kernel (heightfield or
// volumetric, optionally primed) with every variant of its march: chunked,
// fixed (no early exit), lod (a certified coarse-field phase, then the fine
// march), the bf16 march field, and the debug_steps executed-step counter;
// and _trace_phase1_kernel, compaction's first phase: the unprimed chunked
// march stopped after cfg.budget steps, with each ray's still-marching flag
// and last advancing sample as two more outputs, and the pixel ids of the
// rays still marching appended to a list whose length n_alive stays on the
// device (trace_compact.cu resumes those rays). The TPU kernels compute the same per pixel over (16, 128)
// tiles of a sequential TPU grid. The plain PyTorch versions are
// gpgpuraytrace_tpu_torch/kernels/trace.py:trace_frame_reference and
// trace_phase1_reference, line for line the same arithmetic.
//
// The variants are template parameters (mode, bf16, debug), dispatched by
// trace_fwd_launch, so each instantiation carries only its own march and the
// default (chunked, float, no counter) compiles as it did alone. The march,
// the polish and the shade are trace_march.cuh's, which phase 2 shares.
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
// chunk divide max_steps (and compact_budget).

#include <cooperative_groups.h>

#include "trace_march.cuh"

namespace {
constexpr int kThreads = 256;
}  // namespace

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
                 int* __restrict__ steps_out, float* __restrict__ alive_out,
                 float* __restrict__ prev_out, int* __restrict__ ids_out,
                 int* __restrict__ n_alive, TraceConfig cfg) {
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
  const float dy = cr.dy;
  const Ray ray{sc[kPos + 0], sc[kPos + 1], sc[kPos + 2], cr.dx, dy, cr.dz};
  const uint32_t seed = static_cast<uint32_t>(*seed_ptr);
  const Field field{sc, &oct, cfg.num_octaves, seed, cfg.volumetric != 0,
                    cfg.warp_octaves};

  // --- sky-envelope entry (_envelope, _envelope_entry) -------------------
  const float env = envelope(sc, cfg);  // the entry below and the march's escape test
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

  // --- march (_tile_trace march_step): max_steps, or compaction phase 1's
  // budget -------------------------------------------------------------------
  March m{t, prev_t, active, false};
  const int n_steps = kMode == kCompact ? cfg.budget : cfg.max_steps;
  const int executed = march<kMode == kFixed, kBf16, kDebug>(field, ray, env, cfg, n_steps, m);
  if constexpr (kDebug) steps_out[idx] = executed;
  if constexpr (kMode == kCompact) {
    // Still marching after the budget: polished and shaded as a miss here,
    // resumed by phase 2 (trace_compact.cu), which overwrites its outputs.
    alive_out[idx] = m.active ? 1.f : 0.f;
    prev_out[idx] = m.prev_t;
    if (m.active) {
      // Append the pixel id to the survivors' list: one atomic per group of
      // converged threads, ids in lane order within it. A survivor's result
      // does not depend on its slot, so the order across warps (whichever
      // warp gets there first) changes no output bit.
      const cooperative_groups::coalesced_group g = cooperative_groups::coalesced_threads();
      int base = 0;
      if (g.thread_rank() == 0) base = atomicAdd(n_alive, static_cast<int>(g.size()));
      ids_out[g.shfl(base, 0) + static_cast<int>(g.thread_rank())] = idx;
    }
  }
  polish_and_shade(field, ray, sc, cfg, m.t, m.prev_t, m.hit, idx, n_pix, color, t_out,
                   hit_out);
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
};

template <int kMode, bool kBf16, bool kDebug>
void launch_variant(const FwdArgs& a, const TraceConfig& cfg, cudaStream_t stream) {
  const int n_pix = cfg.local_h * cfg.width;
  const int blocks = (n_pix + kThreads - 1) / kThreads;
  trace_fwd_kernel<kMode, kBf16, kDebug><<<blocks, kThreads, 0, stream>>>(
      a.packed, a.seed, a.prime, a.color, a.t, a.hit, a.steps, a.alive, a.prev, a.ids,
      a.n_alive, cfg);
}

template <int kMode>
void launch_mode(const FwdArgs& a, const TraceConfig& cfg, cudaStream_t stream) {
  const bool bf16 = cfg.bf16 != 0, debug = a.steps != nullptr;
  if (bf16 && debug) {
    launch_variant<kMode, true, true>(a, cfg, stream);
  } else if (bf16) {
    launch_variant<kMode, true, false>(a, cfg, stream);
  } else if (debug) {
    launch_variant<kMode, false, true>(a, cfg, stream);
  } else {
    launch_variant<kMode, false, false>(a, cfg, stream);
  }
}

}  // namespace

extern "C" {

// Launches the kernel instantiation that cfg.march_mode, cfg.bf16 and
// ``steps`` select on ``stream`` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers; ``prime`` is null unless
// cfg.primed, ``steps`` (an int32 per pixel) null unless the counter is
// wanted, ``alive`` and ``prev`` (a float per pixel), ``ids`` (an int32 per
// pixel) and ``n_alive`` (one int32) null unless cfg.march_mode is kCompact,
// which launches compaction's phase 1 (cfg.phase 1, no counter, unprimed):
// it sets n_alive to 0 on the stream, then the kernel writes the survivors'
// pixel ids to ids[0, n_alive). The caller validates shapes, dtypes and
// contiguity.
int trace_fwd_launch(const float* packed, const int* seed, const float* prime,
                     float* color, float* t, float* hit, int* steps, float* alive,
                     float* prev, int* ids, int* n_alive, TraceConfig cfg, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FwdArgs a{packed, seed, prime, color, t, hit, steps, alive, prev, ids, n_alive};
  switch (cfg.march_mode) {
    case kChunked:
      launch_mode<kChunked>(a, cfg, s);
      break;
    case kFixed:
      launch_mode<kFixed>(a, cfg, s);
      break;
    case kLod:
      launch_mode<kLod>(a, cfg, s);
      break;
    case kCompact:
      if (cfg.phase != 1 || steps != nullptr || prime != nullptr || alive == nullptr ||
          prev == nullptr || ids == nullptr || n_alive == nullptr) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      if (const cudaError_t err = cudaMemsetAsync(n_alive, 0, sizeof(int), s)) {
        return static_cast<int>(err);
      }
      if (cfg.bf16) {
        launch_variant<kCompact, true, false>(a, cfg, s);
      } else {
        launch_variant<kCompact, false, false>(a, cfg, s);
      }
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
