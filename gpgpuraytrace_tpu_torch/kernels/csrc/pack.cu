// Scene packing: the scene's leaves -> the packed scalar rows that the trace
// kernels read, and the rows' cotangent -> the leaves' gradients.
//
// Replaces no TPU kernel. The JAX package builds the same rows in
// gpgpuraytrace_tpu/utils/packing.py:pack_scene, inside the program that XLA
// compiles and fuses, and lets JAX's autodiff pull the cotangent back. Eager
// PyTorch ran that as about 44 kernels forward (the camera basis, tan, the sun
// direction's normalisation, the scalar fills and the concatenations) and
// about 29 backward, each on a handful of floats, twice a step (the coarse
// prime pass packs its own rows). Their plain PyTorch versions are
// gpgpuraytrace_tpu_torch/utils/packing.py:pack_scenes and autograd's
// pullback through its ops.
//
// pack_kernel: a block per frame, a thread per slot of the frame's row
// (kAmps + octaves floats), each writing its value to the row and, where
// the coarse pass is asked for, to the coarse row, which differs only in the
// aspect and ROW0. A thread loads at most three floats before its stores
// (one thread per frame writing the whole row ran 11 us in a replayed graph:
// each load waited on the stores before it, which may alias the leaves).
// Each value rounds as torch's eager CUDA ops round it, so a row equals
// what the ops wrote:
// - cosf, sinf and tanf are CUDA's accurate functions (ATen's sin, cos and
//   tan kernels call them), not the __ intrinsics; 0.5 * fov is exact.
// - forward (sy * cp, sp, cy * cp), right (cy, 0, -sy) and up = forward x
//   right, each component of the cross product a * b - c * d as ATen's
//   cross kernel compiles it: fma(a, b, -(c * d)) (cross_diff).
// - the sun direction s * rsqrtf(sum(s * s) + 1e-12): the squares rounded
//   apart, summed in the order of ATen's reduction over 3 floats (two
//   threads: (s0^2 + s2^2) + s1^2), the 1e-12 the double literal cast to
//   float, rsqrtf as ATen's rsqrt kernel.
// - the aspect and ROW0 come from the host, rounded to float from double as
//   torch.full rounds them. Frame b's ROW0 is row0 + b row0_step (a row-band
//   rank's interleaved stripes, evenly spaced; 0 for frames that share one
//   ROW0, which then is row0 itself), exact in float for whole rows below
//   2^24, as the wrapper checks.
// A frame's row reads its own camera leaves (a frame stride of 0: a camera
// leaf all frames share), so row b of a batch is the one-camera launch's
// row for camera b, bit for bit.
//
// pack_vjp_kernel: one block per leaf (22), its threads over the leaf's
// values (and frames, for a camera leaf with a value per frame). A leaf
// takes the chain rule as autograd applies it to the ops of the plain
// packing: a copied leaf its slice of the cotangent; fov_y the tan slot's
// through (1 + tan^2) / 2; sun_dir the normalisation's Jacobian,
// g r - s r^3 (g . s); yaw and pitch the camera basis's (r x g_up onto
// forward and g_up x f onto right, as autograd pulls back the cross
// product, then through the products to the sines and cosines). Where
// every frame reads one value, its frames' cotangents are summed where
// they meet (the slot, tan, the sun's components, the sines and cosines),
// frame by frame in order, before the leaf's own derivative is applied
// once, as autograd sums a broadcast. A leaf whose gradient pointer is null
// is skipped. ASPECT and ROW0 are constants: no leaf reads their
// cotangent, nor the coarse rows'.
//
// What bounds it on the H100: nothing but the launch. A 6-octave row is 56
// floats; a frame's trigonometry is four functions. The gain is the 70 or
// so launches it replaces, each 1.2-1.4 us of the card's time in a replayed
// graph.

#include "field.cuh"

namespace {

// The scene's float leaves in gpgpuraytrace_tpu_torch/utils/convert.py:
// LEAF_NAMES order with the int seed left out (kernels/pack.py:FLOAT_LEAVES).
enum Leaf : int {
  kLeafAmplitudes, kLeafLacunarity, kLeafHeightScale, kLeafHeightOffset,
  kLeafHorizontalScale, kLeafWarpAmplitude, kLeafWarpFrequency,
  kLeafPosition, kLeafYaw, kLeafPitch, kLeafFovY,
  kLeafSunDir, kLeafSunColor, kLeafAmbient, kLeafAlbedoLow, kLeafAlbedoHigh,
  kLeafSnowColor, kLeafSnowHeight, kLeafFogColor, kLeafFogDensity,
  kLeafSkyZenith, kLeafSkyHorizon, kLeafCount
};

constexpr int kVjpThreads = 64;
// A thread per packed slot of a frame's row, a block per frame.
constexpr int kPackThreads = (kAmps + kMaxOctaves + 31) / 32 * 32;
// torch's 1e-12 (a Python float) as ATen casts it for a float32 tensor.
constexpr float kSunEps = static_cast<float>(1e-12);

}  // namespace

// Every float leaf by pointer: ``value`` its values, ``grad`` where the VJP
// writes its gradient (null: not wanted), ``frame_stride`` the floats from
// one frame's value to the next's (0: one value that every frame reads).
struct PackLeaves {
  const float* value[kLeafCount];
  float* grad[kLeafCount];
  int frame_stride[kLeafCount];
};

// ``frames`` rows; the fine pass's aspect and frame 0's ROW0, and the coarse
// pass's; each pass's ROW0 step from one frame to the next.
struct PackConfig {
  int frames;
  int num_octaves;
  float aspect;
  float row0;
  float coarse_aspect;
  float coarse_row0;
  float row0_step;
  float coarse_row0_step;
};

namespace {

// Frame b's ROW0: row0 + b step, or row0 where the frames share it.
__device__ __forceinline__ float frame_row0(float row0, float step, int b) {
  return step == 0.f ? row0 : __fadd_rn(row0, __fmul_rn(static_cast<float>(b), step));
}

// The packed offset of a leaf that the rows copy, -1 for the computed ones
// (yaw, pitch, fov_y, sun_dir).
__device__ __forceinline__ int copy_slot(int leaf) {
  switch (leaf) {
    case kLeafAmplitudes: return kAmps;
    case kLeafLacunarity: return kLacunarity;
    case kLeafHeightScale: return kHeightScale;
    case kLeafHeightOffset: return kHeightOffset;
    case kLeafHorizontalScale: return kHorizontalScale;
    case kLeafWarpAmplitude: return kWarpAmp;
    case kLeafWarpFrequency: return kWarpFreq;
    case kLeafPosition: return kPos;
    case kLeafSunColor: return kSunColor;
    case kLeafAmbient: return kAmbient;
    case kLeafAlbedoLow: return kAlbedoLow;
    case kLeafAlbedoHigh: return kAlbedoHigh;
    case kLeafSnowColor: return kSnowColor;
    case kLeafSnowHeight: return kSnowHeight;
    case kLeafFogColor: return kFogColor;
    case kLeafFogDensity: return kFogDensity;
    case kLeafSkyZenith: return kSkyZenith;
    case kLeafSkyHorizon: return kSkyHorizon;
    default: return -1;
  }
}

// Floats of one frame's value of a leaf.
__device__ __forceinline__ int leaf_size(int leaf, int num_octaves) {
  switch (leaf) {
    case kLeafAmplitudes: return num_octaves;
    case kLeafPosition: case kLeafSunDir: case kLeafSunColor: case kLeafAmbient:
    case kLeafAlbedoLow: case kLeafAlbedoHigh: case kLeafSnowColor:
    case kLeafFogColor: case kLeafSkyZenith: case kLeafSkyHorizon:
      return 3;
    default: return 1;
  }
}

__device__ __forceinline__ float leaf_at(const PackLeaves& l, int leaf, int frame, int i) {
  return l.value[leaf][frame * l.frame_stride[leaf] + i];
}

// a * b - c * d as ATen's cross kernel rounds it.
__device__ __forceinline__ float cross_diff(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, -__fmul_rn(c, d));
}

__device__ __forceinline__ void cross(const float a[3], const float b[3], float out[3]) {
  out[0] = cross_diff(a[1], b[2], a[2], b[1]);
  out[1] = cross_diff(a[2], b[0], a[0], b[2]);
  out[2] = cross_diff(a[0], b[1], a[1], b[0]);
}

// The camera basis of ops/camera.py:camera_basis (world up +y).
struct Basis {
  float cy, sy, cp, sp;
  float fwd[3], right[3], up[3];
};

__device__ Basis camera_basis(float yaw, float pitch) {
  Basis o;
  o.cy = cosf(yaw);
  o.sy = sinf(yaw);
  o.cp = cosf(pitch);
  o.sp = sinf(pitch);
  o.fwd[0] = __fmul_rn(o.sy, o.cp);
  o.fwd[1] = o.sp;
  o.fwd[2] = __fmul_rn(o.cy, o.cp);
  o.right[0] = o.cy;
  o.right[1] = 0.0f;
  o.right[2] = -o.sy;
  cross(o.fwd, o.right, o.up);
  return o;
}

// rsqrt(sum(s * s) + 1e-12) of the sun direction s.
__device__ __forceinline__ float sun_rnorm(const float* s) {
  const float q = __fadd_rn(__fadd_rn(__fmul_rn(s[0], s[0]), __fmul_rn(s[2], s[2])),
                            __fmul_rn(s[1], s[1]));
  return rsqrtf(__fadd_rn(q, kSunEps));
}

// The leaf that packed slot k copies, and the index ``i`` of the value in
// it; -1 for the slots computed here.
__device__ __forceinline__ int copied_leaf(int k, int num_octaves, int* i) {
  for (int leaf = 0; leaf < kLeafCount; ++leaf) {
    const int slot = copy_slot(leaf);
    if (slot >= 0 && k >= slot && k < slot + leaf_size(leaf, num_octaves)) {
      *i = k - slot;
      return leaf;
    }
  }
  return -1;
}

__global__ void pack_kernel(PackLeaves l, PackConfig c, float* out, float* coarse) {
  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const int n = kAmps + c.num_octaves;
  if (k >= n) return;
  const long long at = static_cast<long long>(b) * n + k;
  if (k == kAspect || k == kRow0) {
    out[at] = k == kAspect ? c.aspect : frame_row0(c.row0, c.row0_step, b);
    if (coarse) {
      coarse[at] = k == kAspect ? c.coarse_aspect
                                : frame_row0(c.coarse_row0, c.coarse_row0_step, b);
    }
    return;
  }
  int i = 0;
  const int leaf = copied_leaf(k, c.num_octaves, &i);
  float v;
  if (leaf >= 0) {
    v = leaf_at(l, leaf, b, i);
  } else if (k == kTanFov) {
    v = tanf(__fmul_rn(0.5f, leaf_at(l, kLeafFovY, b, 0)));
  } else if (k >= kSunDir && k < kSunDir + 3) {
    const float* sun = l.value[kLeafSunDir];
    v = __fmul_rn(sun[k - kSunDir], sun_rnorm(sun));
  } else {
    const Basis cam = camera_basis(leaf_at(l, kLeafYaw, b, 0), leaf_at(l, kLeafPitch, b, 0));
    v = k < kRight ? cam.fwd[k - kFwd] : k < kUp ? cam.right[k - kRight] : cam.up[k - kUp];
  }
  out[at] = v;
  if (coarse) coarse[at] = v;
}

// The cotangents of frame b's sin and cos of yaw (sy_bar, cy_bar) and of
// pitch (sp_bar, cp_bar) from its row's cotangent ``g``: the cotangents of
// forward and right, each with its share of up = forward x right's (r x g_up
// onto forward, g_up x f onto right, as autograd pulls back a cross
// product), then through the products of the basis.
struct TrigBar {
  float sy, cy, sp, cp;
};

__device__ TrigBar trig_bar(const PackLeaves& l, int b, const float* g) {
  const Basis cam = camera_basis(leaf_at(l, kLeafYaw, b, 0), leaf_at(l, kLeafPitch, b, 0));
  float gf[3], gr[3];
  cross(cam.right, g + kUp, gf);
  cross(g + kUp, cam.fwd, gr);
  for (int k = 0; k < 3; ++k) {
    gf[k] = __fadd_rn(g[kFwd + k], gf[k]);
    gr[k] = __fadd_rn(g[kRight + k], gr[k]);
  }
  return {__fsub_rn(__fmul_rn(gf[0], cam.cp), gr[2]), __fadd_rn(__fmul_rn(gf[2], cam.cp), gr[0]),
          gf[1], __fadd_rn(__fmul_rn(gf[0], cam.sy), __fmul_rn(gf[2], cam.cy))};
}

// Value i of ``leaf``'s gradient from the frames [first, last) that read it
// (one frame, or every frame for a shared value), as autograd takes it: the
// frames' cotangents summed first, where they meet (the row's slot, tan,
// the sun's three components, the trigonometric functions of yaw and
// pitch), then the leaf's own derivative applied once.
__device__ float leaf_bar(const PackLeaves& l, int leaf, int i, int first, int last, int row,
                          const float* gbar) {
  const int slot = copy_slot(leaf);
  if (slot >= 0 || leaf == kLeafFovY) {
    const int k = slot >= 0 ? slot + i : kTanFov;
    float acc = gbar[static_cast<long long>(first) * row + k];
    for (int b = first + 1; b < last; ++b) {
      acc = __fadd_rn(acc, gbar[static_cast<long long>(b) * row + k]);
    }
    if (slot >= 0) return acc;
    const float t = tanf(__fmul_rn(0.5f, leaf_at(l, kLeafFovY, first, 0)));
    return __fmul_rn(__fmul_rn(acc, __fadd_rn(1.0f, __fmul_rn(t, t))), 0.5f);
  }
  if (leaf == kLeafSunDir) {
    float g[3];
    for (int k = 0; k < 3; ++k) {
      g[k] = gbar[static_cast<long long>(first) * row + kSunDir + k];
      for (int b = first + 1; b < last; ++b) {
        g[k] = __fadd_rn(g[k], gbar[static_cast<long long>(b) * row + kSunDir + k]);
      }
    }
    const float* s = l.value[kLeafSunDir];
    const float r = sun_rnorm(s);
    const float gs = __fadd_rn(__fadd_rn(__fmul_rn(g[0], s[0]), __fmul_rn(g[1], s[1])),
                               __fmul_rn(g[2], s[2]));
    const float r3 = __fmul_rn(__fmul_rn(r, r), r);
    return __fsub_rn(__fmul_rn(g[i], r), __fmul_rn(s[i], __fmul_rn(r3, gs)));
  }
  TrigBar acc = trig_bar(l, first, gbar + static_cast<long long>(first) * row);
  for (int b = first + 1; b < last; ++b) {
    const TrigBar t = trig_bar(l, b, gbar + static_cast<long long>(b) * row);
    acc = {__fadd_rn(acc.sy, t.sy), __fadd_rn(acc.cy, t.cy), __fadd_rn(acc.sp, t.sp),
           __fadd_rn(acc.cp, t.cp)};
  }
  const float x = leaf_at(l, leaf, first, 0);
  const float c = cosf(x), sn = sinf(x);
  return leaf == kLeafYaw ? __fadd_rn(__fmul_rn(acc.cy, -sn), __fmul_rn(acc.sy, c))
                          : __fadd_rn(__fmul_rn(acc.cp, -sn), __fmul_rn(acc.sp, c));
}

__global__ void pack_vjp_kernel(PackLeaves l, PackConfig c, const float* gbar) {
  const int leaf = blockIdx.x;
  float* grad = l.grad[leaf];
  if (grad == nullptr) return;
  const int size = leaf_size(leaf, c.num_octaves);
  const bool per_frame = l.frame_stride[leaf] != 0;
  const int n = per_frame ? c.frames * size : size;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int first = per_frame ? j / size : 0;
    grad[j] = leaf_bar(l, leaf, j % size, first, per_frame ? first + 1 : c.frames,
                       kAmps + c.num_octaves, gbar);
  }
}

bool valid(const PackLeaves& l, const PackConfig& c) {
  if (c.frames < 1 || c.num_octaves < 1 || c.num_octaves > kMaxOctaves) return false;
  for (int k = 0; k < kLeafCount; ++k) {
    if (l.value[k] == nullptr || l.frame_stride[k] < 0) return false;
  }
  return true;
}

}  // namespace

extern "C" {

// Launches pack_kernel on ``stream`` and returns its CUDA error (0 on
// success): ``out`` (frames, kAmps + num_octaves) float32, contiguous, and
// ``coarse`` the same shape, or null where the coarse rows are not wanted.
// The caller validates the leaves' devices, dtypes, sizes and contiguity.
int pack_launch(PackLeaves leaves, PackConfig cfg, float* out, float* coarse, void* stream) {
  if (!valid(leaves, cfg) || out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  pack_kernel<<<cfg.frames, kPackThreads, 0, static_cast<cudaStream_t>(stream)>>>(leaves, cfg,
                                                                                  out, coarse);
  return static_cast<int>(cudaGetLastError());
}

// Launches pack_vjp_kernel on ``stream`` and returns its CUDA error:
// ``gbar`` is the rows' cotangent (frames, kAmps + num_octaves) float32,
// contiguous; each non-null ``leaves.grad`` receives its leaf's gradient,
// every value of it written.
int pack_vjp_launch(PackLeaves leaves, PackConfig cfg, const float* gbar, void* stream) {
  if (!valid(leaves, cfg) || gbar == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  pack_vjp_kernel<<<kLeafCount, kVjpThreads, 0, static_cast<cudaStream_t>(stream)>>>(leaves, cfg,
                                                                                    gbar);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
