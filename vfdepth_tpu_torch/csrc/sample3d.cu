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
// are row-count bound; here the 8 tap rows (C contiguous floats each) are
// read directly, channel-fastest, so tap reads and output writes are
// coalesced and no oct copy exists. When C % 4 == 0 (C = 64 in production)
// each thread owns 4 channels of one point and moves them as float4s (C/4
// threads per point); otherwise one warp per point, lanes over channels.
// The per-element arithmetic is the same in both.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sample3d_taps.cuh"

namespace {

constexpr int kWarps = 8;

// one warp per point, lanes over channels (any C)
__global__ void __launch_bounds__(kWarps * 32)
sample3d_trilinear_kernel(const float* __restrict__ vol,
                          const float* __restrict__ coords,
                          float* __restrict__ out, int64_t nb, int h, int w,
                          int d, int64_t c, int64_t n) {
  const int64_t pt = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (pt >= nb * n) return;
  const PointTaps t = point_taps(coords, pt, n, h, w, d, c);
  const float* base = vol + t.base;
  float* dst = out + pt * c;
  for (int64_t ch = lane; ch < c; ch += 32) {
    float acc = __ldg(base + t.off[0] + ch) * t.wt[0];
    for (int k = 1; k < 8; ++k) acc += __ldg(base + t.off[k] + ch) * t.wt[k];
    dst[ch] = acc;
  }
}

// C % 4 == 0, 16-byte aligned tensors: one thread per (point, 4 channels);
// C/4 consecutive threads share a point and read each tap row as float4s
__global__ void __launch_bounds__(kWarps * 32)
sample3d_trilinear_vec4_kernel(const float* __restrict__ vol,
                               const float* __restrict__ coords,
                               float* __restrict__ out, int64_t nb, int h,
                               int w, int d, int64_t c, int64_t n) {
  const int64_t c4 = c / 4;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nb * n * c4) return;
  const int64_t pt = idx / c4;
  const int64_t ch = (idx - pt * c4) * 4;
  const PointTaps t = point_taps(coords, pt, n, h, w, d, c);
  const float* base = vol + t.base;
  float4 v = __ldg(reinterpret_cast<const float4*>(base + t.off[0] + ch));
  float4 acc = make_float4(v.x * t.wt[0], v.y * t.wt[0], v.z * t.wt[0],
                           v.w * t.wt[0]);
  for (int k = 1; k < 8; ++k) {
    v = __ldg(reinterpret_cast<const float4*>(base + t.off[k] + ch));
    acc.x += v.x * t.wt[k];
    acc.y += v.y * t.wt[k];
    acc.z += v.z * t.wt[k];
    acc.w += v.w * t.wt[k];
  }
  *reinterpret_cast<float4*>(out + pt * c + ch) = acc;
}

}  // namespace

extern "C" int vf_sample3d_trilinear(const float* vol, const float* coords,
                                     float* out, int64_t b, int64_t h,
                                     int64_t w, int64_t d, int64_t c,
                                     int64_t n, void* stream) {
  if (h < 2 || w < 2 || d < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = c % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(vol) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int threads = kWarps * 32;
  if (vec4) {
    const int64_t blocks = (b * n * (c / 4) + threads - 1) / threads;
    sample3d_trilinear_vec4_kernel<<<(unsigned)blocks, threads, 0, s>>>(
        vol, coords, out, b, (int)h, (int)w, (int)d, c, n);
  } else {
    const int64_t blocks = (b * n + kWarps - 1) / kWarps;
    sample3d_trilinear_kernel<<<(unsigned)blocks, threads, 0, s>>>(
        vol, coords, out, b, (int)h, (int)w, (int)d, c, n);
  }
  return (int)cudaGetLastError();
}
