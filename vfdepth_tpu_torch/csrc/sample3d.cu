// Trilinear frustum sampler (kernel K3).
//
// Replaces the TPU kernel vfdepth_tpu/ops/sample3d_packed.py:101
// `_combine_kernel` (launched by `_combine_taps`, :117) TOGETHER with the
// XLA oct build and row gather in front of it (`_build_oct`,
// `take_along_axis`, sample3d_packed.py:242-297; entry
// `grid_sample_3d_packed`, :257).
//
// What it computes: out[b, n, :] = trilinear sample of vol[b] ([H(y), W(x),
// D(z), C], the voxel pipeline's yxz layout) at coords[b, n] = (x, y, z) in
// [-1, 1], align_corners=True, zeros padding. Non-finite coordinates give
// zeros. The tap rule (clamped bases, weights rederived from the clamp
// offset, so every tap read is in bounds; the TPU kernel's tap order) is in
// sample3d_taps.cuh, shared with the backward (K4).
//
// What bounds it on Hopper: bytes — the [B, N, C] output (295 MB per
// frameset at the production shapes) against a 51 MB volume that L2 holds.
// The TPU needed the packed "oct" copy of the volume because its gathers
// are row-count bound; here the 8 tap rows (C contiguous values each) are
// read directly, channel-fastest, so tap reads and output writes are
// coalesced and no oct copy exists.
//
// Design. The first port gave each thread 4 channels of one point and had
// every one of the C/4 threads of a point recompute the point's whole tap
// set (3 coordinate loads, 3 axis weights, 8 weights, 8 64-bit offsets) for
// 8 vector loads and 1 store: instruction-bound, so its bf16 form, on half
// the bytes, took as long as the f32 one. Now a block of 256 threads owns
// 256 consecutive points. Phase 1: one thread per point computes its
// clamped base row and 8 weights once, into shared memory. Phase 2: the
// threads walk (point, channel group) items channel-fastest, a group being
// V channels read and written as one 16-byte vector (V = 4 f32, 8 bf16; 4
// bf16 = 8 bytes where C % 8 != 0), each item's 8 tap rows at one base plus
// the 8 fixed tap offsets (32-bit where one batch's volume has fewer than
// 2^31 elements). A thread issues all the tap loads of its next items
// before their first product: 4 items (32 loads) in f32, 1 in bf16, the
// fastest of the counts timed at the production shapes on the H100. So
// the bf16 form's instruction count halves with its bytes. Outputs go out
// as streaming stores (the volume, not the output, should stay in L2).
// For other C (or unaligned tensors) one warp per point, lanes over
// channels. The per-element arithmetic (the weights, and out = sum of
// tap * weight in tap order, from tap 0's product) is the same in every
// path, and the same as the first port's: the same bits.
//
// Element type: f32, or bf16 under mixed precision (the JAX kernel's bf16
// volume: its rows are read as bf16, combined in f32, and the output is
// rounded once to bf16, `_combine_kernel` :101-111 with the out dtype of
// :141).
//
// A fourth entry, vf_sample3d_gather_bf16, is not a port of a TPU kernel:
// it is `sampler_3d: gather` on a bf16 volume, JAX's XLA gather in its
// literal bf16 arithmetic (see its kernel below).
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"
#include "sample3d_taps.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPts = kThreads;     // points per block of the vector kernel

// one warp per point, lanes over channels (any C)
template <typename T>
__global__ void __launch_bounds__(kThreads)
sample3d_trilinear_kernel(const T* __restrict__ vol,
                          const float* __restrict__ coords,
                          T* __restrict__ out, int64_t nb, int h, int w,
                          int d, int64_t c, int64_t n) {
  const int64_t pt = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (pt >= nb * n) return;
  const PointTaps t = point_taps(coords, pt, n, h, w, d, c);
  const T* base = vol + t.base;
  T* dst = out + pt * c;
  for (int64_t ch = lane; ch < c; ch += 32) {
    float acc = ld1(base + t.off[0] + ch) * t.wt[0];
    for (int k = 1; k < 8; ++k) acc += ld1(base + t.off[k] + ch) * t.wt[k];
    st1(dst + ch, acc);
  }
}

struct TapSet {
  int64_t base;    // element offset of tap (y0, x0, z0)'s row
  float wt[8];     // tap t = dz*4 + dx*2 + dy (dy fastest)
};

// V consecutive elements (f32 x4: 16 bytes; bf16 x4: 8; bf16 x8: 16),
// widened to f32 on load and rounded once on store
template <int V>
__device__ __forceinline__ void loadv(const float* p, float (&v)[V]) {
  static_assert(V == 4, "f32 vectors are 4 wide");
  const float4 f = ld4(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
template <int V>
__device__ __forceinline__ void loadv(const __nv_bfloat16* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 f = ld4(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t words[4] = {u.x, u.y, u.z, u.w};
    for (int i = 0; i < 4; ++i) {
      const float2 f = bf16x2_float2(words[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

template <int V>
__device__ __forceinline__ void storev(float* p, const float (&v)[V]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
template <int V>
__device__ __forceinline__ void storev(__nv_bfloat16* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    __stcs(reinterpret_cast<uint2*>(p),
           make_uint2(bf16x2_bits(v[0], v[1]), bf16x2_bits(v[2], v[3])));
  } else {
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(bf16x2_bits(v[0], v[1]), bf16x2_bits(v[2], v[3]),
                      bf16x2_bits(v[4], v[5]), bf16x2_bits(v[6], v[7])));
  }
}

// C % V == 0, V-element aligned tensors: a tap phase (one thread per point)
// and a combine phase over (point, V channels) items, kItems at a time, all
// their tap loads issued before the first product
template <typename T, int V, typename Off, int kItems>
__global__ void __launch_bounds__(kThreads)
sample3d_trilinear_vec_kernel(const T* __restrict__ vol,
                              const float* __restrict__ coords,
                              T* __restrict__ out, int64_t nb, int h, int w,
                              int d, int c, int64_t n) {
  __shared__ TapSet taps[kPts];
  const int64_t p0 = (int64_t)blockIdx.x * kPts;
  const int np = nb * n - p0 < kPts ? (int)(nb * n - p0) : kPts;
  if ((int)threadIdx.x < np) {
    const PointWeights pw = point_weights(coords, p0 + threadIdx.x, n, h, w,
                                          d);
    TapSet t;
    t.base = pw.vox * c;
    for (int k = 0; k < 8; ++k) t.wt[k] = pw.wt[k];
    taps[threadIdx.x] = t;
  }
  __syncthreads();

  // tap k's row from the base: dy * (one y step) + dx * (one x step) + dz * c
  Off off[8];
  const Off sz = (Off)d * c, sy = (Off)w * sz;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    off[k] = (k & 1) * sy + ((k >> 1) & 1) * sz + ((k >> 2) & 1) * (Off)c;
  const int cv = c / V;
  const int step = kThreads / cv, rem = kThreads % cv;
  int p = threadIdx.x / cv, g = threadIdx.x % cv;
  while (p < np) {
    // this item (live: p < np) and the next kItems - 1, kThreads apart (an
    // item past the tile repeats this one and is not stored)
    int ps[kItems], gs[kItems];
    bool live[kItems];
    ps[0] = p;
    gs[0] = g;
    live[0] = true;
#pragma unroll
    for (int i = 1; i < kItems; ++i) {
      int pp = ps[i - 1] + step, gg = gs[i - 1] + rem;
      if (gg >= cv) { gg -= cv; ++pp; }
      ps[i] = pp;
      gs[i] = gg;
      live[i] = pp < np;
    }
    float v[kItems][8][V];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int pi = live[i] ? ps[i] : ps[0], gi = live[i] ? gs[i] : gs[0];
      const T* q = vol + taps[pi].base + gi * V;
#pragma unroll
      for (int k = 0; k < 8; ++k) loadv<V>(q + off[k], v[i][k]);
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int pi = live[i] ? ps[i] : ps[0];
      float acc[V];
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = v[i][0][j] * taps[pi].wt[0];
#pragma unroll
      for (int k = 1; k < 8; ++k)
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] += v[i][k][j] * taps[pi].wt[k];
      if (live[i]) storev<V>(out + (p0 + ps[i]) * c + gs[i] * V, acc);
    }
    p = ps[kItems - 1] + step;
    g = gs[kItems - 1] + rem;
    if (g >= cv) { g -= cv; ++p; }
  }
}

// ---------------------------------------------------------- gather-bf16
// `sampler_3d: gather` on a bf16 volume: the counterpart of the XLA gather
// grid_sample_3d (vfdepth_tpu/ops/grid_sample.py:188-235), not of a TPU
// kernel, in its literal bf16 arithmetic (the tap rule is gather_point in
// sample3d_taps.cuh): the fractions rounded to bf16, 1 - w and each
// product of three weights rounded, weight * valid, vals * weight rounded,
// and the 8 taps summed in JAX's order (dx fastest), each addition rounded.
// Every bf16 operand is exact in f32, so an f32 product or sum rounded to
// bf16 is XLA's bf16 operation.
//
// What bounds it: bytes, as K3-bf16 (the [B, N, C] output, 295 MB at batch
// 2 of the production shapes, against a volume that L2 holds), and then
// the rounding arithmetic, 8 taps x C products and sums a point. Design:
// K3-bf16's layout with the gather rule. A block of 256 threads owns 256
// points; one thread a point computes its 8 clipped voxel rows and 8
// rounded weights once, into shared memory; then the threads walk (point,
// V channels) items channel-fastest, V = 8 (one 16-byte load per tap, all
// 8 issued before the first product, and a streaming 16-byte store) where
// C % 8 == 0 and the tensors are 16-byte aligned, else 2 or 1. The
// arithmetic takes two channels at a time (bf16x2_scale, bf16x2_add): the
// same roundings as one at a time, in fewer instructions.

struct GatherTaps {
  int vox[8];      // tap t's voxel row in the batch (clipped into the volume)
  float wt[8];     // its bf16 weight times valid
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int V>
__global__ void __launch_bounds__(kThreads)
sample3d_gather_bf16_kernel(const __nv_bfloat16* __restrict__ vol,
                            const float* __restrict__ coords,
                            __nv_bfloat16* __restrict__ out, int64_t total,
                            int h, int w, int d, int c, int64_t n) {
  __shared__ GatherTaps taps[kPts];
  const int64_t p0 = (int64_t)blockIdx.x * kPts;
  const int np = total - p0 < kPts ? (int)(total - p0) : kPts;
  if ((int)threadIdx.x < np) {
    const int64_t pt = p0 + threadIdx.x;
    const GatherPoint p = gather_point(coords + pt * 3, h, w, d);
    float a[3][2];                     // per axis: (1 - w, w), bf16 values
    for (int k = 0; k < 3; ++k) {
      const float wk = round_bf16(p.f[k]);
      a[k][0] = round_bf16(__fsub_rn(1.0f, wk));
      a[k][1] = wk;
    }
    const int vol0 = (int)(pt / n) * h * w * d;
    GatherTaps tp;
    for (int t = 0; t < 8; ++t) {
      int vox;
      const bool valid = gather_tap(p, t, h, w, d, vox);
      const float wgt = round_bf16(__fmul_rn(
          round_bf16(__fmul_rn(a[0][t & 1], a[1][(t >> 1) & 1])),
          a[2][t >> 2]));
      tp.wt[t] = __fmul_rn(wgt, valid ? 1.0f : 0.0f);
      tp.vox[t] = vol0 + vox;
    }
    taps[threadIdx.x] = tp;
  }
  __syncthreads();
  const int cv = c / V;
  for (int e = threadIdx.x; e < np * cv; e += kThreads) {
    const int p = e / cv, ch = (e - p * cv) * V;
    Bf16Words<V> v[8];
#pragma unroll
    for (int t = 0; t < 8; ++t)
      v[t] = load_bf16<V>(vol + (int64_t)taps[p].vox[t] * c + ch);
    Bf16Words<V> acc;
#pragma unroll
    for (int j = 0; j < Bf16Words<V>::kWords; ++j)
      acc.w[j] = bf16x2_scale(v[0].w[j], taps[p].wt[0]);
#pragma unroll
    for (int t = 1; t < 8; ++t)
#pragma unroll
      for (int j = 0; j < Bf16Words<V>::kWords; ++j)
        acc.w[j] = bf16x2_add(acc.w[j], bf16x2_scale(v[t].w[j],
                                                     taps[p].wt[t]));
    store_bf16<V>(out + (p0 + p) * c + ch, acc);
  }
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Items in flight a thread: 4 in f32 (32 vector loads), 1 in bf16 (8 loads
// of 8 channels; 4 were slower), the fastest counts timed on the H100 at
// the production shapes.
template <typename T, int V>
void launch_vec(const T* vol, const float* coords, T* out, int64_t b,
                int64_t h, int64_t w, int64_t d, int64_t c, int64_t n,
                cudaStream_t s) {
  constexpr int kItems = sizeof(T) == 4 ? 4 : 1;
  const int64_t blocks = (b * n + kPts - 1) / kPts;
  if (h * w * d * c < ((int64_t)1 << 31))
    sample3d_trilinear_vec_kernel<T, V, int32_t, kItems>
        <<<(unsigned)blocks, kThreads, 0, s>>>(vol, coords, out, b, (int)h,
                                               (int)w, (int)d, (int)c, n);
  else
    sample3d_trilinear_vec_kernel<T, V, int64_t, kItems>
        <<<(unsigned)blocks, kThreads, 0, s>>>(vol, coords, out, b, (int)h,
                                               (int)w, (int)d, (int)c, n);
}

template <typename T>
int launch(const T* vol, const float* coords, T* out, int64_t b, int64_t h,
           int64_t w, int64_t d, int64_t c, int64_t n, void* stream) {
  if (h < 2 || w < 2 || d < 2 || c < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr bool kBf16 = sizeof(T) == 2;
  // one vector of a point's channels is 16 bytes (8 for bf16 at C % 8 != 0)
  if (kBf16 && c % 8 == 0 && aligned(vol, 16) && aligned(out, 16)) {
    if constexpr (kBf16) launch_vec<T, 8>(vol, coords, out, b, h, w, d, c, n, s);
  } else if (c % 4 == 0 && aligned(vol, 4 * sizeof(T)) &&
             aligned(out, 4 * sizeof(T))) {
    launch_vec<T, 4>(vol, coords, out, b, h, w, d, c, n, s);
  } else {
    const int64_t blocks = (b * n + kWarps - 1) / kWarps;
    sample3d_trilinear_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
        vol, coords, out, b, (int)h, (int)w, (int)d, c, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vf_sample3d_trilinear(const float* vol, const float* coords,
                                     float* out, int64_t b, int64_t h,
                                     int64_t w, int64_t d, int64_t c,
                                     int64_t n, void* stream) {
  return launch(vol, coords, out, b, h, w, d, c, n, stream);
}

// the bf16 form: vol and out bf16, coords f32
extern "C" int vf_sample3d_trilinear_bf16(const __nv_bfloat16* vol,
                                          const float* coords,
                                          __nv_bfloat16* out, int64_t b,
                                          int64_t h, int64_t w, int64_t d,
                                          int64_t c, int64_t n, void* stream) {
  return launch(vol, coords, out, b, h, w, d, c, n, stream);
}

// the gather-bf16 form of `sampler_3d: gather` under mixed precision: vol
// and out bf16, coords f32
extern "C" int vf_sample3d_gather_bf16(const __nv_bfloat16* vol,
                                       const float* coords,
                                       __nv_bfloat16* out, int64_t b,
                                       int64_t h, int64_t w, int64_t d,
                                       int64_t c, int64_t n, void* stream) {
  if (h < 1 || w < 1 || d < 1 || c < 1 || c > (1 << 20) ||
      b * h * w * d >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t blocks = (b * n + kPts - 1) / kPts;
  if (blocks == 0) return (int)cudaGetLastError();
  auto kernel = sample3d_gather_bf16_kernel<1>;
  if (c % 8 == 0 && aligned(vol, 16) && aligned(out, 16))
    kernel = sample3d_gather_bf16_kernel<8>;
  else if (c % 2 == 0 && aligned(vol, 4) && aligned(out, 4))
    kernel = sample3d_gather_bf16_kernel<2>;
  kernel<<<(unsigned)blocks, kThreads, 0, s>>>(vol, coords, out, b * n,
                                              (int)h, (int)w, (int)d, (int)c,
                                              n);
  return (int)cudaGetLastError();
}
