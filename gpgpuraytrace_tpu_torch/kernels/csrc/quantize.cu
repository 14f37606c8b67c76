// Tonemap and quantize linear RGB to display uint8, one pass over a batch of
// frames.
//
// Replaces the XLA fusion of tonemap -> clip -> x 255 + 0.5 -> uint8 inside
// the JAX package's compiled batch program,
// gpgpuraytrace_tpu/ops/flythrough.py:_make_batch_render (:51-52). It is not
// a Pallas kernel there; eager PyTorch ran it as eight elementwise passes
// (add, divide, clamp, pow, clamp, multiply, add, cast). Its plain PyTorch
// version is gpgpuraytrace_tpu_torch/kernels/quantize.py:
// tonemap_quantize_reference, and every output byte equals that version's
// on the card: each step below rounds as torch's eager CUDA pass for it does.
// - 1 + x, x / (1 + x), c * 255 and + 0.5 round once each, with no FMA
//   contraction (nvcc would fuse c * 255 + 0.5): __fadd_rn, __fdiv_rn,
//   __fmul_rn. ATen's add with a scalar computes a + 1 * b, exact in the
//   product, so a fused form rounds the same.
// - clamp to [0, 1] as ATen's clamp_scalar kernel: NaN passes through,
//   anything else is min(max(v, 0), 1).
// - The gamma is ATen's pow(Tensor, Scalar) on float: pow_(base, exp)
//   (ATen/native/cuda/Pow.cuh), that is ::pow(float, float), CUDA's powf,
//   with the Python scalar 1.0 / 2.2 cast to float (kGamma). Not 1.0f / 2.2f,
//   which is a division in float and may round differently. Like ATen's
//   lambda, the kernel takes the exponent as an argument, so powf is not
//   specialised to a constant.
// - The cast goes float -> int64 -> uint8, as c10's
//   static_cast_with_inter_type<uint8_t, float> does. The value is in
//   [0.5, 255.5] here, so this truncates.
//
// What bounds it on the H100: bytes. Each pixel reads 12 bytes and writes 3
// (a 1920x1080 batch of 4: 99.5 MB read and 24.9 MB written, 0.0371 ms at
// 3.35 TB/s); its ~40 float operations and one powf are far below the FP32
// peak. The design: one thread per pixel, a block per 128 columns of a row
// (blockIdx.y the row, blockIdx.z the frame: no index division). The input
// is any (n, h, w, 3) float32 view, given by its four strides; the trace
// kernels' colour is planar, (B, 3, H, W), viewed as (B, H, W, 3), and is
// read in place. Each channel is then a contiguous row, so a warp reads
// three coalesced 128-byte runs and writes its 96 output bytes contiguous.

#include <cuda_runtime.h>

namespace {

constexpr float kGamma = static_cast<float>(1.0 / 2.2);
constexpr int kThreads = 128;  // 1920 and 512 columns are whole blocks
constexpr long long kMaxGridYZ = 65535;

__device__ __forceinline__ float clamp01(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.f), 1.f);
}

__device__ __forceinline__ unsigned char quantize_channel(float x, float gamma) {
  float c = clamp01(__fdiv_rn(x, __fadd_rn(1.f, x)));
  c = clamp01(powf(c, gamma));
  const float v = __fadd_rn(__fmul_rn(c, 255.f), 0.5f);
  return static_cast<unsigned char>(static_cast<long long>(v));
}

__global__ void __launch_bounds__(kThreads)
    tonemap_quantize_kernel(const float* __restrict__ in, unsigned char* __restrict__ out,
                            int w, long long s0, long long s1, long long s2, long long s3,
                            float gamma) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= w) {
    return;
  }
  const long long row = blockIdx.y;
  const long long frame = blockIdx.z;
  const float* src = in + frame * s0 + row * s1 + col * s2;
  unsigned char* dst = out + 3 * ((frame * gridDim.y + row) * w + col);
  dst[0] = quantize_channel(src[0], gamma);
  dst[1] = quantize_channel(src[s3], gamma);
  dst[2] = quantize_channel(src[2 * s3], gamma);
}

}  // namespace

extern "C" {

// Launches the kernel on ``stream`` and returns its CUDA error (0 on
// success). ``in`` points at element (0, 0, 0, 0) of an (n, h, w, 3) float32
// view with strides s0 .. s3 in elements; ``out`` at a contiguous
// (n, h, w, 3) uint8 tensor. n and h are at most 65535 (the grid's z and y;
// cudaErrorInvalidValue above). The caller validates shapes, dtypes and
// devices.
int tonemap_quantize_launch(const float* in, unsigned char* out, long long n, long long h,
                            long long w, long long s0, long long s1, long long s2,
                            long long s3, void* stream) {
  if (n < 0 || h < 0 || w < 0 || n > kMaxGridYZ || h > kMaxGridYZ || w > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n * h * w == 0) {
    return 0;
  }
  const dim3 grid(static_cast<unsigned>((w + kThreads - 1) / kThreads),
                  static_cast<unsigned>(h), static_cast<unsigned>(n));
  tonemap_quantize_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, static_cast<int>(w), s0, s1, s2, s3, kGamma);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
