// Test-only kernel: the march field's 2D value noise alone, by the forward
// trace kernel's own device functions (noise2_value, or noise2_value_bf16
// with bf16), one thread per point, so a check can hold the card's
// arithmetic to gpgpuraytrace_tpu_torch/ops/noise.py bit for bit. Not part
// of the kernel library: tests/noise_probe.py builds it on its own.

#include "field.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
noise2_probe_kernel(const float* __restrict__ x, const float* __restrict__ z, int n,
                    uint32_t seed, int bf16, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = bf16 ? noise2_value_bf16(x[i], z[i], seed) : noise2_value(x[i], z[i], seed);
}

}  // namespace

extern "C" {

// Launches noise2_probe_kernel over ``n`` device points on ``stream``;
// returns cudaGetLastError() (0 on success).
int noise2_probe_launch(const float* x, const float* z, int n, int seed, int bf16,
                        float* out, void* stream) {
  noise2_probe_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      x, z, n, static_cast<uint32_t>(seed), bf16, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
