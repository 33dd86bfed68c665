// Backward of the trilinear frustum sampler (kernel K4).
//
// Replaces the TPU kernel vfdepth_tpu/ops/sample3d_packed.py:146
// `_updates_kernel` (launched by `_build_updates`, :161) TOGETHER with the
// XLA scatter and three-axis fold behind it (`_packed_bwd`, :305-340), in
// its `packed_f32grad` form: f32 accumulation.
//
// What it computes: dvol[b, tap voxel, c] += w_tap(n) * g[b, n, c] for the 8
// clamped-base taps of every frustum point n, with exactly the forward's
// weights (sample3d_taps.cuh), so every write is in bounds. dvol [b, h(y),
// w(x), d(z), C] is zeroed by the caller. Coordinates get no gradient. A tap
// of weight exactly 0 (a far-out or non-finite point) is skipped: the
// result differs from adding 0 * g only where g is not finite.
//
// What bounds it on Hopper: bytes and atomics. The cotangent g is 295 MB
// per frameset at the production shapes (1,152,000 points x 64 channels),
// dvol 51 MB per frameset; b=2 volumes (102 MB) exceed the 50 MB L2, so the
// atomics partly go through to memory. The TPU built an [N, 8C] update
// stream because its scatters are row-count bound; on Hopper each tap is
// added in place. Design: one thread per (point, 4 channels) (C % 4 == 0,
// C = 64 in production): it recomputes its point's 8 taps, reads 16 bytes
// of g (coalesced) and issues one float4 atomicAdd per live tap (sm_90 has
// 16-byte atomics), else one warp per point with scalar atomics. Frustum
// points crowd near the cameras, where ~50 depth bins of many pixels fall
// into few voxels: those voxels take hundreds of additions while most take
// none (~46 per touched voxel on average), and the atomics on a hot voxel
// serialise in L2. Consecutive points are consecutive depth bins of one
// pixel, so a warp's atomics often hit the same rows; the sum order varies
// from run to run (a few ulp).
#include <cuda_runtime.h>
#include <stdint.h>

#include "sample3d_taps.cuh"

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
sample3d_trilinear_bwd_kernel(const float* __restrict__ g,
                              const float* __restrict__ coords,
                              float* __restrict__ dvol, int64_t nb, int h,
                              int w, int d, int64_t c, int64_t n) {
  const int64_t pt = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (pt >= nb * n) return;
  const PointTaps t = point_taps(coords, pt, n, h, w, d, c);
  float* base = dvol + t.base;
  for (int64_t ch = lane; ch < c; ch += 32) {
    const float gv = __ldg(g + pt * c + ch);
    for (int k = 0; k < 8; ++k)
      if (t.wt[k] != 0.0f) atomicAdd(base + t.off[k] + ch, t.wt[k] * gv);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
sample3d_trilinear_bwd_vec4_kernel(const float* __restrict__ g,
                                   const float* __restrict__ coords,
                                   float* __restrict__ dvol, int64_t nb,
                                   int h, int w, int d, int64_t c,
                                   int64_t n) {
  const int64_t c4 = c / 4;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nb * n * c4) return;
  const int64_t pt = idx / c4;
  const int64_t ch = (idx - pt * c4) * 4;
  const PointTaps t = point_taps(coords, pt, n, h, w, d, c);
  const float4 gv = __ldg(reinterpret_cast<const float4*>(g + pt * c + ch));
  float* base = dvol + t.base + ch;
  for (int k = 0; k < 8; ++k) {
    const float wt = t.wt[k];
    if (wt == 0.0f) continue;
    atomicAdd(reinterpret_cast<float4*>(base + t.off[k]),
              make_float4(wt * gv.x, wt * gv.y, wt * gv.z, wt * gv.w));
  }
}

}  // namespace

// g [b, n, c], coords [b, n, 3] -> dvol [b, h, w, d, c] (zeroed by the
// caller)
extern "C" int vf_sample3d_trilinear_bwd(const float* g, const float* coords,
                                         float* dvol, int64_t b, int64_t h,
                                         int64_t w, int64_t d, int64_t c,
                                         int64_t n, void* stream) {
  if (h < 2 || w < 2 || d < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = c % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(dvol) % 16 == 0;
  const int threads = kWarps * 32;
  if (vec4) {
    const int64_t blocks = (b * n * (c / 4) + threads - 1) / threads;
    sample3d_trilinear_bwd_vec4_kernel<<<(unsigned)blocks, threads, 0, s>>>(
        g, coords, dvol, b, (int)h, (int)w, (int)d, c, n);
  } else {
    const int64_t blocks = (b * n + kWarps - 1) / kWarps;
    sample3d_trilinear_bwd_kernel<<<(unsigned)blocks, threads, 0, s>>>(
        g, coords, dvol, b, (int)h, (int)w, (int)d, c, n);
  }
  return (int)cudaGetLastError();
}
