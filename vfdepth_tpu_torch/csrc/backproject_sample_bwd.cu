// Backward of the grouped raw-mode back-projection sampler (kernel K2).
//
// Replaces the TPU kernel vfdepth_tpu/ops/pallas_sample.py:301 `_bwd_kernel`
// as launched by `_bwd_call` (pallas_sample.py:497) from the grouped raw
// backward `_pallas_backproject_grouped_bwd` (:748).
//
// What it computes, for every camera `cam` of group g of batch b and every
// voxel point n that the forward (K1) marked valid for that camera:
//   dfeat[cam, tap pixel, c] += W_tap(n) * g[b, g, n, c]   (c < C)
// over the 4 bilinear taps of the point, recomputed from cam3 exactly as K1
// computes them (backproject_taps.cuh). Only the feature channels get a
// gradient: the trailing rel and valid columns of g are ignored, the mask
// and the coordinates get none. The forward's per-camera `valid` gates as a
// select, never a multiply: a point that is not valid adds nothing, even
// where its cotangent row is not finite.
//
// What bounds it on Hopper: bytes. At the production shapes (b=2, 6 cameras
// of 48x80 merged features, C = 768, 200,000 voxel points) the cotangent g
// is 2.46 GB, and only the rows of points some camera sees (~16%) need to
// be read; the output (141 MB) is small. The TPU kernel builds transposed
// one-hot matrices for its MXU; on Hopper the natural form is a scatter-add.
// Design: vectorised atomics. One block owns a tile of kTile points of one
// (b, group); phase 1 computes each (camera, point)'s taps once into shared
// memory (as K1 does), phase 2 walks the tile's (point, 4 channels) pairs,
// reads the group's cotangent row once (two float2 loads: rows of C+2
// floats start 8-byte aligned) for all the cameras that see the point, and
// adds w * g into the feature map with one float4 atomicAdd per tap
// (sm_90 has 16-byte atomics). Each (pixel, channel) address receives ~34
// additions on the fake rig, from points that are neighbours in the voxel
// order, so contention is local; the sums are taken in a varying order (a
// run-to-run difference of a few ulp). A deterministic alternative - bucket
// the point-taps by pixel (a counting sort) and sum each list in a block -
// costs two more passes and a sort; it is left for a later change.
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

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
backproject_grouped_raw_bwd_kernel(const float* __restrict__ g,
                                   const float* __restrict__ cam3,
                                   const float* __restrict__ valid,
                                   float* __restrict__ dfeat, int gs, int h,
                                   int w, int64_t c, int64_t ldg, int64_t n) {
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
      const int64_t cam = cam0 + k;
      BwdTaps t;
      for (int j = 0; j < 4; ++j) { t.off[j] = -1; t.w[j] = 0.0f; }
      if (valid[cam * n + pt] != 0.0f) {
        const RawPoint q = raw_point(cam3 + (cam * n + pt) * 3, h, w);
        bilinear_taps(q, cam, h, w, c, t.off, t.w);
        seen[p] = 1;
      }
      taps[k][p] = t;
    }
  }
  __syncthreads();

  const int rows = (n - n0 < kTile) ? (int)(n - n0) : kTile;
  const float* src = g + ((bi * 2 + grp) * n + n0) * ldg;
  if (kVec4) {
    const int c4 = (int)c / 4;
    for (int idx = threadIdx.x; idx < rows * c4; idx += kThreads) {
      const int p = idx / c4;
      if (!seen[p]) continue;
      const int ch = (idx - p * c4) * 4;
      const float2* row = reinterpret_cast<const float2*>(src + p * ldg + ch);
      const float2 a = __ldg(row), b = __ldg(row + 1);
      for (int k = 0; k < gs; ++k) {
        const BwdTaps& t = taps[k][p];
        for (int j = 0; j < 4; ++j) {
          if (t.off[j] < 0) continue;
          const float wt = t.w[j];
          atomicAdd(reinterpret_cast<float4*>(dfeat + t.off[j] + ch),
                    make_float4(wt * a.x, wt * a.y, wt * b.x, wt * b.y));
        }
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * (int)c; idx += kThreads) {
      const int p = idx / (int)c;
      if (!seen[p]) continue;
      const int ch = idx - p * (int)c;
      const float gv = __ldg(src + p * ldg + ch);
      for (int k = 0; k < gs; ++k) {
        const BwdTaps& t = taps[k][p];
        for (int j = 0; j < 4; ++j)
          if (t.off[j] >= 0) atomicAdd(dfeat + t.off[j] + ch, t.w[j] * gv);
      }
    }
  }
}

}  // namespace

// g [b, 2, n, ldg] (the forward output's cotangent, ldg >= c), cam3 [b*2*gs,
// n, 3], valid [b*2*gs, n] -> dfeat [b*2*gs, h, w, c], which the caller
// zeroes.
extern "C" int vf_backproject_grouped_raw_bwd(
    const float* g, const float* cam3, const float* valid, float* dfeat,
    int64_t b, int64_t gs, int64_t h, int64_t w, int64_t c, int64_t ldg,
    int64_t n, void* stream) {
  if (gs < 1 || gs > kMaxGroup || ldg < c) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + kTile - 1) / kTile), 2, (unsigned)b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c % 4 == 0 && ldg % 2 == 0 &&
      reinterpret_cast<uintptr_t>(g) % 8 == 0 &&
      reinterpret_cast<uintptr_t>(dfeat) % 16 == 0) {
    backproject_grouped_raw_bwd_kernel<true><<<grid, kThreads, 0, s>>>(
        g, cam3, valid, dfeat, (int)gs, (int)h, (int)w, c, ldg, n);
  } else {
    backproject_grouped_raw_bwd_kernel<false><<<grid, kThreads, 0, s>>>(
        g, cam3, valid, dfeat, (int)gs, (int)h, (int)w, c, ldg, n);
  }
  return (int)cudaGetLastError();
}
