// Compaction's phase 2: resume the march of the rays phase 1 left marching,
// one thread per compacted slot, and write each result straight to its
// pixel's place in phase 1's outputs.
//
// Replaces gpgpuraytrace_tpu/kernels/trace.py:_trace_phase2_kernel with the
// unpack of its glue _render_compact_raw. The TPU kernel marches dense
// (16, 128) tiles of survivors, moved there and back by two payload sorts
// (scatter and gather were slow on the TPU). Here the slot's pixel id is
// enough: the thread recomputes raygen from (row, col), reads the pixel's t
// and last advancing sample from phase 1's outputs, and writes colour, t and
// hit in place. Pixel ids are unique, so no two threads write one place.
// Phase 1 lists only rays still marching, so every listed ray resumes. Its plain PyTorch version is
// gpgpuraytrace_tpu_torch/kernels/trace.py:trace_phase2_reference.
//
// The survivor count n_alive stays on the device: the grid covers every
// pixel, and a block whose first slot is at or past n_alive returns before
// it loads anything, so nothing waits on the host and n_alive = 0 is no
// special case. The march, polish and shade are trace_march.cuh's, the code
// the one-pass kernel runs, so a resumed ray ends where the one-pass march
// ends it.

#include "trace_march.cuh"

namespace {
constexpr int kThreads = 256;

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
trace_phase2_kernel(const float* __restrict__ packed, const int* __restrict__ seed_ptr,
                    const int* __restrict__ n_alive_ptr, const int* __restrict__ ids,
                    const float* __restrict__ prev, float* __restrict__ color, float* __restrict__ t_io,
                    float* __restrict__ hit_out, TraceConfig cfg) {
  const int n_alive = *n_alive_ptr;
  if (static_cast<int>(blockIdx.x * blockDim.x) >= n_alive) return;  // whole block
  __shared__ float sc[kAmps + kMaxOctaves];
  __shared__ Octaves oct;
  const int n_params = kAmps + cfg.num_octaves;
  for (int k = threadIdx.x; k < n_params; k += blockDim.x) sc[k] = packed[k];
  __syncthreads();
  if (threadIdx.x == 0) load_octaves(sc, cfg.num_octaves, oct);
  __syncthreads();

  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= n_alive) return;
  const int idx = ids[slot];
  const int row = idx / cfg.width;
  const int col = idx - row * cfg.width;
  const CameraRay cr = camera_ray(sc, cfg.height, cfg.width, row, col);
  const Ray ray{sc[kPos + 0], sc[kPos + 1], sc[kPos + 2], cr.dx, cr.dy, cr.dz};
  const Field field{sc, &oct, cfg.num_octaves, static_cast<uint32_t>(*seed_ptr),
                    cfg.volumetric != 0, cfg.warp_octaves};
  const float env = envelope(sc, cfg);
  // Resume from phase 1's t and last advancing sample, not yet hit, and
  // still marching: phase 1 listed the ray because its march was cut by the
  // budget (never t < t_max, which would re-march a finished hit).
  March m{t_io[idx], prev[idx], true, false};
  march<false, kBf16, false>(field, ray, env, cfg, cfg.budget, m);
  polish_and_shade(field, ray, sc, cfg, m.t, m.prev_t, m.hit, idx,
                   cfg.local_h * cfg.width, color, t_io, hit_out);
}

}  // namespace

extern "C" {

// Launches phase 2 on ``stream`` and returns cudaGetLastError() (0 on
// success). Device pointers: ``n_alive`` one int32 and ``ids`` the pixel id of
// each slot (int32, local_h * width), both as phase 1 wrote them, ``prev``
// phase 1's (local_h, width) output, ``color``, ``t`` and ``hit`` phase 1's outputs,
// overwritten at the pixels of the first n_alive slots (``t`` is read there
// first). cfg.budget is the steps left (max_steps - compact_budget), cfg.phase
// 2. The caller validates shapes, dtypes and contiguity.
int trace_compact_launch(const float* packed, const int* seed, const int* n_alive,
                         const int* ids, const float* prev, float* color, float* t,
                         float* hit, TraceConfig cfg, void* stream) {
  if (cfg.march_mode != kCompact || cfg.phase != 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_pix = cfg.local_h * cfg.width;
  const int blocks = (n_pix + kThreads - 1) / kThreads;
  if (cfg.bf16) {
    trace_phase2_kernel<true><<<blocks, kThreads, 0, s>>>(packed, seed, n_alive, ids, prev,
                                                           color, t, hit, cfg);
  } else {
    trace_phase2_kernel<false><<<blocks, kThreads, 0, s>>>(packed, seed, n_alive, ids, prev,
                                                            color, t, hit, cfg);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
