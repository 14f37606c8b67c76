// A flythrough batch's inputs onto the card in one launch: the caller's scene
// leaves and the batch's times into the private copy that the batch's
// captured CUDA graph reads by address (ops/flythrough.py:FlyBatch).
//
// Replaces no TPU kernel. The JAX package passes the scene and the times to
// its compiled batch program as arguments, and XLA copies them in with the
// call (gpgpuraytrace_tpu/ops/flythrough.py:_make_batch_render). A CUDA graph
// reads fixed addresses instead, so before each replay the port copied the 23
// leaves one by one (torch._foreach_copy_ over leaves of mixed dtypes and
// shapes takes its slow path: a cudaMemcpyAsync each) and the times through a
// pinned host buffer: about 277 us of host time a batch, while the card idled.
//
// fly_load_kernel: one block, a warp per leaf (LEAF_NAMES order, the int32
// seed among the floats) and one for the times. A lane copies the leaf's
// 32-bit words lane, lane + 32, ..., so every value arrives bit for bit, a
// NaN's payload and the seed's integer too. The source pointers and the
// times travel in the argument block, passed by value (a __grid_constant__
// parameter, indexed where it lies), so a later launch never reads a host
// buffer that an earlier one still needs, and the caller's leaves are read
// where they lie at each call: a scene handed over anew and an edit in place
// both arrive. Launched on the stream that replays the graph, it writes the
// private copy after every earlier replay has read it and before the next.
//
// What bounds it on the H100: nothing but the launch. A 6-octave scene is 48
// words, a batch of 4 four more.

#include <cuda_runtime.h>

namespace {

// kernels/load.py:PARAM_BYTES: the argument block's size on every CUDA
// target (sm_90 takes 32 KB under CUDA 12.1 and later; this block fits the
// 4 KB that every one takes).
constexpr int kParamBytes = 4096;
// gpgpuraytrace_tpu_torch/utils/convert.py:LEAF_NAMES.
constexpr int kLeaves = 23;
// A warp per leaf and one for the times.
constexpr int kThreads = 32 * (kLeaves + 1);

}  // namespace

// What the wrapper fills once (destinations, counts) and at every call
// (sources); kernels/load.py:_Head.
struct FlyLoadHead {
  const unsigned* src[kLeaves];
  unsigned* dst[kLeaves];
  float* times_dst;
  int count[kLeaves];
  int batch;
};

// kernels/load.py:MAX_TIMES.
constexpr int kMaxTimes = static_cast<int>((kParamBytes - sizeof(FlyLoadHead)) / sizeof(float));

// The argument block: kernels/load.py:LoadArgs.
struct FlyLoadArgs {
  FlyLoadHead head;
  float times[kMaxTimes];
};

static_assert(sizeof(FlyLoadHead) == 472, "kernels/load.py:_Head's layout");
static_assert(sizeof(FlyLoadArgs) == kParamBytes, "the argument block fills 4 KB");

namespace {

__global__ void __launch_bounds__(kThreads) fly_load_kernel(const __grid_constant__ FlyLoadArgs a) {
  const int item = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (item == kLeaves) {
    for (int i = lane; i < a.head.batch; i += 32) a.head.times_dst[i] = a.times[i];
    return;
  }
  const unsigned* src = a.head.src[item];
  unsigned* dst = a.head.dst[item];
  for (int i = lane; i < a.head.count[item]; i += 32) dst[i] = src[i];
}

}  // namespace

extern "C" {

// Launches fly_load_kernel on ``stream`` of CUDA device ``device`` with
// ``*args`` (copied into the launch, so the caller may refill it at once) and
// returns its CUDA error (0 on success). The calling thread's current device
// is ``device`` for the launch and as it was after. The caller validates the
// leaves' devices, dtypes, shapes and contiguity.
int fly_load_launch(const FlyLoadArgs* args, int device, void* stream) {
  if (args == nullptr || args->head.times_dst == nullptr || args->head.batch < 0 ||
      args->head.batch > kMaxTimes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int k = 0; k < kLeaves; ++k) {
    if (args->head.src[k] == nullptr || args->head.dst[k] == nullptr || args->head.count[k] < 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  fly_load_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  err = cudaGetLastError();
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

}  // extern "C"
