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
// on the card, for every one of the 2^32 float32 inputs.
//
// The chain (chain_level) rounds each step as torch's eager CUDA pass does:
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
//   lambda, the chain takes the exponent as an argument, so powf is not
//   specialised to a constant.
// - The cast goes float -> int64 -> uint8, as c10's
//   static_cast_with_inter_type<uint8_t, float> does (NaN, so +inf too,
//   gives 0).
//
// The table. For a finite x >= +0 (sign bit clear, bits below 0x7f800000)
// the output is a step function of x's bit pattern, and non-negative floats
// order as their bit patterns. Let e_k be the least such pattern whose chain
// output is >= k (k = 1 .. 255): the count of edges e_k <= bits is the
// running maximum of the chain, which equals the chain except in windows
// just after an edge where x / (1 + x) or powf steps back by an ulp. The
// edges come from the chain itself, on the card: tonemap_quantize_scan_kernel
// evaluates it at every finite non-negative pattern (2^31 - 2^23 of them) and
// lists each pattern where the level changes; kernels/quantize.py turns the
// list into the edges, the windows and the table below, once per device.
// A pixel then looks its level up:
// - a piece is x's exponent and top 6 mantissa bits (bits >> 17); the table
//   holds for each piece from e_1's to e_255's the count of edges below its
//   first pattern, and no piece holds more than one edge (checked when the
//   table is made: the levels lie at least 0.03 binades apart, a piece spans
//   at most 0.023), so one compare with the next edge finishes the level;
// - inputs in [e_k, w_k), where w_k is the end of level k's last window (w_k
//   = e_k where it has none), and every input that is not a finite x >= +0
//   (a set sign bit, +-inf, NaN) take the exact chain.
// The table is 2.1 KB of edges and window ends and 1 byte a piece (about
// 1.8 KB), copied into shared memory by each block.
//
// What bounds it on the H100: bytes. Each pixel reads 12 bytes and writes 3
// (a 1920x1080 batch of 4: 99.5 MB read and 24.9 MB written, 0.0371 ms at
// 3.35 TB/s). The fast path takes the fly path's layout: (B, 3, H, W) planes
// viewed as (B, H, W, 3), each channel's row contiguous, the width a multiple
// of 4 and the planes 16-byte aligned. A thread takes 4 consecutive pixels of
// a row: one 16-byte streaming load per plane, three 4-byte stores of the 12
// output bytes (offset 12 g, 4-aligned). The 1-D grid is the blocks resident
// on the card, walking the 4-pixel groups grid-stride, kGroups groups an
// iteration, so 96 bytes are in flight per thread. Any other layout (the
// channels interleaved, a width that is not a multiple of 4, an unaligned
// view) takes the scalar path: a pixel per thread, the same table.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kGamma = static_cast<float>(1.0 / 2.2);
constexpr int kThreads = 256;
constexpr int kGroups = 2;                  // 4-pixel groups a thread per iteration
constexpr unsigned kFinite = 0x7f800000u;   // patterns below: finite x >= +0
constexpr unsigned kScanRun = 256;          // patterns per thread of the scan
// The table's layout in 32-bit words (kernels/quantize.py:pack_table):
// [base piece, pieces, 0, 0], the edges e_0 = 0, e_1 .. e_255 and four
// sentinels 0xffffffff, the window ends w_0 .. w_255, then one byte a piece.
constexpr int kHeader = 4;
constexpr int kEdges = 260;
constexpr int kWindowEnds = 256;
constexpr int kPieceWords = kHeader + kEdges + kWindowEnds;
constexpr int kPieceShift = 17;             // exponent and top 6 mantissa bits
constexpr int kMaxTableBytes = 48 * 1024;   // dynamic shared memory without opt-in

__device__ __forceinline__ float clamp01(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.f), 1.f);
}

// The exact chain, one function for the scan, the windows and every input
// that is not a finite x >= +0, so all of them run the same code.
__device__ __noinline__ unsigned chain_level(float x, float gamma) {
  float c = clamp01(__fdiv_rn(x, __fadd_rn(1.f, x)));
  c = clamp01(powf(c, gamma));
  const float v = __fadd_rn(__fmul_rn(c, 255.f), 0.5f);
  return static_cast<unsigned char>(static_cast<long long>(v));
}

struct Table {
  const unsigned* edge;          // e_0 .. e_259
  const unsigned* window_end;    // w_0 .. w_255
  const unsigned char* piece;    // edges below each piece's first pattern
  int base;
  int last;
};

extern __shared__ uint4 table_smem[];

// Copies the table into shared memory (every thread of the block must call).
__device__ __forceinline__ Table load_table(const uint4* __restrict__ table, int words) {
  for (int i = threadIdx.x; i < words / 4; i += blockDim.x) {
    table_smem[i] = table[i];
  }
  __syncthreads();
  const unsigned* s = reinterpret_cast<const unsigned*>(table_smem);
  return {s + kHeader, s + kHeader + kEdges,
          reinterpret_cast<const unsigned char*>(s + kPieceWords),
          static_cast<int>(s[0]), static_cast<int>(s[1]) - 1};
}

// The level of ``bits`` by the table; ``exact`` is set where the chain must
// decide instead (not a finite x >= +0, or inside a window).
__device__ __forceinline__ unsigned table_level(unsigned bits, const Table& t, bool& exact) {
  const int i = min(max(static_cast<int>(bits >> kPieceShift) - t.base, 0), t.last);
  const unsigned k0 = t.piece[i];
  const unsigned k = k0 + (bits >= t.edge[k0 + 1]);
  exact |= (bits >= kFinite) | (bits < t.window_end[k]);
  return k;
}

__device__ __forceinline__ unsigned level_of(float x, const Table& t, float gamma) {
  bool exact = false;
  const unsigned k = table_level(__float_as_uint(x), t, exact);
  return exact ? chain_level(x, gamma) : k;
}

// n / d for n < 2^31 by a multiply (Granlund and Montgomery's round-up
// method; d = 1 gives mul 1, shift 0).
struct FastDiv {
  unsigned mul;
  unsigned shift;
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return (__umulhi(n, mul) + n) >> shift;
  }
};

FastDiv fast_div(unsigned d) {
  unsigned shift = 0;
  while ((1ull << shift) < d) {
    ++shift;
  }
  const unsigned long long mul = ((1ull << 32) * ((1ull << shift) - d)) / d + 1;
  return {static_cast<unsigned>(mul), shift};
}

struct Layout {
  long long h, w, s0, s1, s2, s3;
};

__device__ __forceinline__ float lane(const float4& v, int p) {
  return p == 0 ? v.x : p == 1 ? v.y : p == 2 ? v.z : v.w;
}

// The fast path: 4 pixels of a row a group, ``groups`` = n * h * w / 4.
__global__ void __launch_bounds__(kThreads)
    tonemap_quantize_kernel(const float* __restrict__ in, unsigned char* __restrict__ out,
                            const uint4* __restrict__ table, int table_words,
                            unsigned groups, FastDiv by_quads, unsigned quads, FastDiv by_h,
                            Layout l, float gamma) {
  const Table t = load_table(table, table_words);
  const unsigned stride = gridDim.x * kThreads;
  for (unsigned g = blockIdx.x * kThreads + threadIdx.x; g < groups; g += kGroups * stride) {
    float4 v[kGroups][3];
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const unsigned gu = g + u * stride;
      if (gu < groups) {
        const unsigned row = by_quads.div(gu);
        const unsigned frame = by_h.div(row);
        const float* src = in + frame * l.s0 + (row - frame * static_cast<unsigned>(l.h)) * l.s1
                           + 4 * (gu - row * quads);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          v[u][c] = __ldcs(reinterpret_cast<const float4*>(src + c * l.s3));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const unsigned gu = g + u * stride;
      if (gu >= groups) {
        continue;
      }
      unsigned lv[4][3];  // [pixel][channel]
      bool exact = false;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          lv[p][c] = table_level(__float_as_uint(lane(v[u][c], p)), t, exact);
        }
      }
      if (exact) {  // rare: a window, a negative, +-inf or NaN in the group
#pragma unroll
        for (int p = 0; p < 4; ++p) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            lv[p][c] = level_of(lane(v[u][c], p), t, gamma);
          }
        }
      }
      unsigned* dst = reinterpret_cast<unsigned*>(out + 12ull * gu);
      dst[0] = lv[0][0] | lv[0][1] << 8 | lv[0][2] << 16 | lv[1][0] << 24;
      dst[1] = lv[1][1] | lv[1][2] << 8 | lv[2][0] << 16 | lv[2][1] << 24;
      dst[2] = lv[2][2] | lv[3][0] << 8 | lv[3][1] << 16 | lv[3][2] << 24;
    }
  }
}

// The scalar path: a pixel per thread, any strides.
__global__ void __launch_bounds__(kThreads)
    tonemap_quantize_scalar_kernel(const float* __restrict__ in, unsigned char* __restrict__ out,
                                   const uint4* __restrict__ table, int table_words,
                                   unsigned long long pixels, Layout l, float gamma) {
  const Table t = load_table(table, table_words);
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * kThreads;
  for (unsigned long long p = blockIdx.x * static_cast<unsigned long long>(kThreads)
                              + threadIdx.x;
       p < pixels; p += stride) {
    const unsigned long long row = p / l.w;
    const unsigned long long frame = row / l.h;
    const float* src = in + frame * l.s0 + (row - frame * l.h) * l.s1 + (p - row * l.w) * l.s2;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out[3 * p + c] = static_cast<unsigned char>(level_of(src[c * l.s3], t, gamma));
    }
  }
}

// Every pattern b in [0, kFinite): where chain_level(b) differs from the
// pattern before (level 0 before +0), appends (b << 8) | level to
// ``changes`` (in no order; ``count`` counts them all, kept or not).
__global__ void __launch_bounds__(kThreads)
    tonemap_quantize_scan_kernel(unsigned long long* __restrict__ changes,
                                 unsigned* __restrict__ count, unsigned capacity, float gamma) {
  const unsigned long long lo =
      (blockIdx.x * static_cast<unsigned long long>(kThreads) + threadIdx.x) * kScanRun;
  if (lo >= kFinite) {
    return;
  }
  const unsigned hi = lo + kScanRun < kFinite ? static_cast<unsigned>(lo) + kScanRun : kFinite;
  unsigned prev = lo == 0 ? 0u : chain_level(__uint_as_float(static_cast<unsigned>(lo) - 1), gamma);
  for (unsigned b = static_cast<unsigned>(lo); b < hi; ++b) {
    const unsigned level = chain_level(__uint_as_float(b), gamma);
    if (level != prev) {
      const unsigned i = atomicAdd(count, 1u);
      if (i < capacity) {
        changes[i] = static_cast<unsigned long long>(b) << 8 | level;
      }
      prev = level;
    }
  }
}

template <class Kernel>
int resident_blocks(Kernel kernel, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  }
  return err == cudaSuccess ? sms * per_sm : -static_cast<int>(err);
}

}  // namespace

extern "C" {

// Launches the scan on ``stream`` and returns its CUDA error (0 on success).
// ``count`` must be 0 on entry; ``changes`` holds ``capacity`` entries.
int tonemap_quantize_scan_launch(unsigned long long* changes, unsigned* count,
                                 unsigned capacity, void* stream) {
  const unsigned long long threads = (kFinite + kScanRun - 1) / kScanRun;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  tonemap_quantize_scan_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      changes, count, capacity, kGamma);
  return static_cast<int>(cudaGetLastError());
}

// Launches the kernel on ``stream`` and returns its CUDA error (0 on
// success). ``in`` points at element (0, 0, 0, 0) of an (n, h, w, 3) float32
// view with strides s0 .. s3 in elements; ``out`` at a contiguous
// (n, h, w, 3) uint8 tensor; ``table`` at the device's table of
// ``table_words`` 32-bit words (a multiple of 4, 16-byte aligned). The
// caller validates shapes, dtypes and devices.
int tonemap_quantize_launch(const float* in, unsigned char* out, const int* table,
                            int table_words, long long n, long long h, long long w,
                            long long s0, long long s1, long long s2, long long s3,
                            void* stream) {
  if (n < 0 || h < 0 || w < 0 || table_words < kPieceWords || table_words % 4
      || 4ll * table_words > kMaxTableBytes
      || reinterpret_cast<std::uintptr_t>(table) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned long long pixels = static_cast<unsigned long long>(n) * h * w;
  if (pixels == 0) {
    return 0;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* tab = reinterpret_cast<const uint4*>(table);
  const int smem = 4 * table_words;
  const Layout l{h, w, s0, s1, s2, s3};
  const bool vec = s2 == 1 && w % 4 == 0 && s0 % 4 == 0 && s1 % 4 == 0 && s3 % 4 == 0
                   && reinterpret_cast<std::uintptr_t>(in) % 16 == 0 && pixels / 4 < (1ull << 31);
  if (vec) {
    const unsigned groups = static_cast<unsigned>(pixels / 4);
    const int resident = resident_blocks(tonemap_quantize_kernel, smem);
    if (resident <= 0) {
      return resident < 0 ? -resident : static_cast<int>(cudaErrorInvalidConfiguration);
    }
    const unsigned long long need = (groups + kThreads * kGroups - 1) / (kThreads * kGroups);
    const unsigned blocks = static_cast<unsigned>(need < static_cast<unsigned long long>(resident)
                                                      ? need : resident);
    const unsigned quads = static_cast<unsigned>(w / 4);
    tonemap_quantize_kernel<<<blocks, kThreads, smem, s>>>(
        in, out, tab, table_words, groups, fast_div(quads), quads,
        fast_div(static_cast<unsigned>(h)), l, kGamma);
  } else {
    const int resident = resident_blocks(tonemap_quantize_scalar_kernel, smem);
    if (resident <= 0) {
      return resident < 0 ? -resident : static_cast<int>(cudaErrorInvalidConfiguration);
    }
    const unsigned long long need = (pixels + kThreads - 1) / kThreads;
    const unsigned blocks = static_cast<unsigned>(need < static_cast<unsigned long long>(resident)
                                                      ? need : resident);
    tonemap_quantize_scalar_kernel<<<blocks, kThreads, smem, s>>>(in, out, tab, table_words,
                                                                   pixels, l, kGamma);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
