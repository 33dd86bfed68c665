// Backward of the back-projection sampler: grouped (kernel K2) and
// ungrouped (kernel K2b).
//
// Replaces the TPU kernel vfdepth_tpu/ops/pallas_sample.py:301 `_bwd_kernel`
// as launched by `_bwd_call` (pallas_sample.py:497): with group_size > 0
// from the grouped backward `_pallas_backproject_grouped_bwd` (:748), K2;
// with group_size = 0 from `_pallas_sample_bwd` (:605),
// `_pallas_sample_masked_bwd` (:629) and `_pallas_backproject_bwd` (:686),
// K2b.
//
// What it computes, for every camera `cam` and every point n that its
// forward sampled for that camera (K2 and gated K2b: marked valid; ungated
// K2b: live):
//   dfeat[cam, tap pixel, c] += W_tap(n) * g[row(cam), n, c]   (c < C)
// over the 4 bilinear taps of the point, recomputed from the coordinates
// exactly as the forward computes them (backproject_taps.cuh). K2's row is
// the camera's group (b, g): each camera reads its group's cotangent; K2b's
// row is the camera's own. Only the first C columns of g are read: the
// trailing mask, rel and valid columns get no gradient, nor do the mask and
// the coordinates. The forward's validity gates as a select, never a
// multiply: a point that is not valid adds nothing, even where its
// cotangent row is not finite.
//
// What bounds it on Hopper: bytes. At the production shapes (K2: b=2, 6
// cameras of 48x80 merged features, C = 768, 200,000 voxel points; K2b: the
// same for 3 cameras with their own rows) the cotangent is 2.46 GB (K2) or
// 3.69 GB (K2b), and only the rows of points some camera sees need to be
// read; the output (141 MB / 71 MB) is small. The TPU kernel builds
// transposed one-hot matrices for its MXU; on Hopper the natural form is a
// scatter-add. Design: vectorised atomics. One block owns a tile of kTile
// points of one (b, group) (K2) or one camera (K2b); phase 1 computes each
// (camera, point)'s taps once into shared memory (as the forward does),
// phase 2 walks the tile's (point, 4 channels) pairs, reads the cotangent
// row once (as wide as its stride allows: K2b's C+1 rows are only 4-byte
// aligned) for all the cameras that use it, and adds w * g into the feature
// map with one float4 atomicAdd per tap (sm_90 has 16-byte atomics). Each
// (pixel, channel) address receives tens of additions, from points that are
// neighbours in the voxel order, so contention is local; the sums are taken
// in a varying order (a run-to-run difference of a few ulp). A
// deterministic alternative - bucket the point-taps by pixel (a counting
// sort) and sum each list in a block - costs two more passes and a sort; it
// is left for a later change.
//
// K2 has a bf16 form (mixed precision): the cotangent is read as bf16 (its
// C+2 rows of 770 bf16 are 4-byte aligned: two bf16x2 loads per 4
// channels), the taps and the f32 atomics into the zeroed f32 feature
// gradient are the f32 form's, and the caller rounds the gradient once to
// bf16, as the JAX kernel's bf16 output does (pallas_sample.py:552, :581).
// K2b has the same bf16 form, gated and ungated: its cotangent rows hold
// C_in >= C bf16 values, 769 (merged) or 513 / 257 (unmerged) in the
// model, odd, so every other row starts on a 2-byte boundary and the reads
// fall back to scalar loads (``vec_width`` picks 1 for an odd stride).
#include <cuda_runtime.h>
#include <stdint.h>

#include "backproject_taps.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr int kMaxGroup = kThreads / kTile;

struct BwdTaps {
  int64_t off[4];  // element offsets into dfeat of the 4 tap rows, -1 = none
  float w[4];
};

// The taps of (camera, point) if its forward used it, else none; returns
// whether it has any.
template <bool kRaw>
__device__ __forceinline__ bool point_taps(const float* coords,
                                           const float* valid, int64_t cam,
                                           int64_t pt, int64_t n, int ncols,
                                           int h, int w, int64_t c,
                                           BwdTaps& t) {
  for (int j = 0; j < 4; ++j) { t.off[j] = -1; t.w[j] = 0.0f; }
  if (valid != nullptr && valid[cam * n + pt] == 0.0f) return false;
  const TapPoint q = tap_point<kRaw>(coords + (cam * n + pt) * ncols, h, w);
  if (!q.live) return false;
  bilinear_taps(q, cam, h, w, c, t.off, t.w);
  return true;
}

// One block: the cotangent rows src[p * ldg] (p < rows) scattered into the
// taps of the `cams` cameras of taps[k][p].
template <typename T, bool kVec4>
__device__ __forceinline__ void scatter_tile(const T* __restrict__ src,
                                             BwdTaps (*taps)[kTile],
                                             const int* seen, int cams,
                                             int rows, int64_t c, int64_t ldg,
                                             int gvec,
                                             float* __restrict__ dfeat) {
  if (kVec4) {
    const int c4 = (int)c / 4;
    for (int idx = threadIdx.x; idx < rows * c4; idx += kThreads) {
      const int p = idx / c4;
      if (!seen[p]) continue;
      const int ch = (idx - p * c4) * 4;
      const float4 gv = load4(src + p * ldg + ch, gvec);
      for (int k = 0; k < cams; ++k) {
        const BwdTaps& t = taps[k][p];
        for (int j = 0; j < 4; ++j) {
          if (t.off[j] < 0) continue;
          const float wt = t.w[j];
          atomicAdd(reinterpret_cast<float4*>(dfeat + t.off[j] + ch),
                    make_float4(wt * gv.x, wt * gv.y, wt * gv.z, wt * gv.w));
        }
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * (int)c; idx += kThreads) {
      const int p = idx / (int)c;
      if (!seen[p]) continue;
      const int ch = idx - p * (int)c;
      const float gv = ld1(src + p * ldg + ch);
      for (int k = 0; k < cams; ++k) {
        const BwdTaps& t = taps[k][p];
        for (int j = 0; j < 4; ++j)
          if (t.off[j] >= 0) atomicAdd(dfeat + t.off[j] + ch, t.w[j] * gv);
      }
    }
  }
}

template <typename T, bool kRaw, bool kVec4>
__global__ void __launch_bounds__(kThreads)
backproject_grouped_bwd_kernel(const T* __restrict__ g,
                               const float* __restrict__ coords,
                               const float* __restrict__ valid,
                               float* __restrict__ dfeat, int gs, int h,
                               int w, int64_t c, int64_t ldg, int64_t n,
                               int gvec) {
  __shared__ BwdTaps taps[kMaxGroup][kTile];
  __shared__ int seen[kTile];   // some camera of the group sees the point
  const int grp = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int64_t n0 = (int64_t)blockIdx.x * kTile;
  const int64_t cam0 = (bi * 2 + grp) * gs;

  if (threadIdx.x < kTile) seen[threadIdx.x] = 0;
  __syncthreads();
  // phase 1: one thread per (camera of the group, point of the tile)
  {
    const int k = threadIdx.x / kTile;
    const int p = threadIdx.x % kTile;
    const int64_t pt = n0 + p;
    if (k < gs && pt < n) {
      if (point_taps<kRaw>(coords, valid, cam0 + k, pt, n, 3, h, w, c,
                           taps[k][p]))
        seen[p] = 1;
    }
  }
  __syncthreads();

  const int rows = (n - n0 < kTile) ? (int)(n - n0) : kTile;
  scatter_tile<T, kVec4>(g + ((bi * 2 + grp) * n + n0) * ldg, taps, seen, gs,
                         rows, c, ldg, gvec, dfeat);
}

template <typename T, bool kRaw, bool kVec4>
__global__ void __launch_bounds__(kThreads)
sample2d_bwd_kernel(const T* __restrict__ g,
                    const float* __restrict__ coords,
                    const float* __restrict__ valid,
                    float* __restrict__ dfeat, int h, int w, int64_t c,
                    int64_t ldg, int64_t n, int ncols, int gvec) {
  __shared__ BwdTaps taps[1][kTile];
  __shared__ int seen[kTile];
  const int64_t cam = blockIdx.y;
  const int64_t n0 = (int64_t)blockIdx.x * kTile;

  if (threadIdx.x < kTile) {
    const int64_t pt = n0 + threadIdx.x;
    seen[threadIdx.x] =
        pt < n && point_taps<kRaw>(coords, valid, cam, pt, n, ncols, h, w, c,
                                   taps[0][threadIdx.x]);
  }
  __syncthreads();

  const int rows = (n - n0 < kTile) ? (int)(n - n0) : kTile;
  scatter_tile<T, kVec4>(g + (cam * n + n0) * ldg, taps, seen, 1, rows, c,
                         ldg, gvec, dfeat);
}

template <typename T>
int launch_grouped_bwd(const T* g, const float* coords, const float* valid,
                       float* dfeat, int64_t b, int64_t gs, int64_t h,
                       int64_t w, int64_t c, int64_t ldg, int64_t n, int raw,
                       void* stream) {
  if (gs < 1 || gs > kMaxGroup || ldg < c) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + kTile - 1) / kTile), 2, (unsigned)b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = c % 4 == 0 && vec_width(dfeat, c) == 4;
  const int gvec = vec_width(g, ldg);
#define VF_GROUPED_BWD(RAW, VEC)                                             \
  backproject_grouped_bwd_kernel<T, RAW, VEC><<<grid, kThreads, 0, s>>>(     \
      g, coords, valid, dfeat, (int)gs, (int)h, (int)w, c, ldg, n, gvec)
  if (raw) {
    if (vec4) VF_GROUPED_BWD(true, true); else VF_GROUPED_BWD(true, false);
  } else {
    if (vec4) VF_GROUPED_BWD(false, true); else VF_GROUPED_BWD(false, false);
  }
#undef VF_GROUPED_BWD
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sample2d_bwd(const T* g, const float* coords, const float* valid,
                        float* dfeat, int64_t B, int64_t h, int64_t w,
                        int64_t c, int64_t ldg, int64_t n, int64_t ncols,
                        int raw, void* stream) {
  if (ldg < c || ncols < (raw ? 3 : 2) || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + kTile - 1) / kTile), (unsigned)B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = c % 4 == 0 && vec_width(dfeat, c) == 4;
  const int gvec = vec_width(g, ldg);
#define VF_SAMPLE2D_BWD(RAW, VEC)                                            \
  sample2d_bwd_kernel<T, RAW, VEC><<<grid, kThreads, 0, s>>>(                \
      g, coords, valid, dfeat, (int)h, (int)w, c, ldg, n, (int)ncols, gvec)
  if (raw) {
    if (vec4) VF_SAMPLE2D_BWD(true, true); else VF_SAMPLE2D_BWD(true, false);
  } else {
    if (vec4) VF_SAMPLE2D_BWD(false, true); else VF_SAMPLE2D_BWD(false, false);
  }
#undef VF_SAMPLE2D_BWD
  return (int)cudaGetLastError();
}

}  // namespace

// K2: g [b, 2, n, ldg] (the forward output's cotangent, ldg >= c), coords
// [b*2*gs, n, 3], valid [b*2*gs, n] -> dfeat [b*2*gs, h, w, c], which the
// caller zeroes.
extern "C" int vf_backproject_grouped_bwd(
    const float* g, const float* coords, const float* valid, float* dfeat,
    int64_t b, int64_t gs, int64_t h, int64_t w, int64_t c, int64_t ldg,
    int64_t n, int raw, void* stream) {
  return launch_grouped_bwd(g, coords, valid, dfeat, b, gs, h, w, c, ldg, n,
                            raw, stream);
}

// K2's bf16 form: g bf16; coords, valid and dfeat f32
extern "C" int vf_backproject_grouped_bwd_bf16(
    const __nv_bfloat16* g, const float* coords, const float* valid,
    float* dfeat, int64_t b, int64_t gs, int64_t h, int64_t w, int64_t c,
    int64_t ldg, int64_t n, int raw, void* stream) {
  return launch_grouped_bwd(g, coords, valid, dfeat, b, gs, h, w, c, ldg, n,
                            raw, stream);
}

// K2b: g [B, n, ldg] (ldg >= c), coords [B, n, ncols], valid [B, n] or null
// (no gate: every live point) -> dfeat [B, h, w, c], which the caller
// zeroes.
extern "C" int vf_sample2d_bwd(const float* g, const float* coords,
                               const float* valid, float* dfeat, int64_t B,
                               int64_t h, int64_t w, int64_t c, int64_t ldg,
                               int64_t n, int64_t ncols, int raw,
                               void* stream) {
  return launch_sample2d_bwd(g, coords, valid, dfeat, B, h, w, c, ldg, n,
                             ncols, raw, stream);
}

// K2b's bf16 form: g bf16; coords, valid and dfeat f32
extern "C" int vf_sample2d_bwd_bf16(const __nv_bfloat16* g,
                                    const float* coords, const float* valid,
                                    float* dfeat, int64_t B, int64_t h,
                                    int64_t w, int64_t c, int64_t ldg,
                                    int64_t n, int64_t ncols, int raw,
                                    void* stream) {
  return launch_sample2d_bwd(g, coords, valid, dfeat, B, h, w, c, ldg, n,
                             ncols, raw, stream);
}
