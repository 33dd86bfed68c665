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
// zeros. Per axis, with pixel coordinate p, floor p0, frac t and the base
// clamped to [0, size-2] (off = p0 - base):
//   w(base)   = (1-t)*[off==0] + t*[off==-1]
//   w(base+1) = t*[off==0] + (1-t)*[off==+1]
// exactly `_kernel_axis_weights`, so every tap read is in bounds and
// out-of-range taps carry weight 0. The 8 taps are combined in the TPU
// kernel's order (dy fastest, dz slowest).
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

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ void axis_weights(float coord, int size, int& base,
                                             float& w0, float& w1) {
  float p = ((coord + 1.0f) * 0.5f) * (float)(size - 1);
  // far-out coordinates keep weight 0; the clamp only keeps the int cast
  // defined (any p outside [-1, size] already gives two zero weights)
  p = fminf(fmaxf(p, -2.0f), (float)(size + 1));
  const float p0 = floorf(p);
  const float t = p - p0;
  const int i0 = (int)p0;
  base = min(max(i0, 0), size - 2);
  const int off = i0 - base;
  const float is0 = off == 0 ? 1.0f : 0.0f;
  const float ism1 = off == -1 ? 1.0f : 0.0f;
  const float isp1 = off == 1 ? 1.0f : 0.0f;
  w0 = (1.0f - t) * is0 + t * ism1;
  w1 = t * is0 + (1.0f - t) * isp1;
}

struct PointTaps {
  const float* base;   // tap (y0, x0, z0) row
  int64_t off[8];      // element offsets of the 8 tap rows from base
  float wt[8];
};

__device__ __forceinline__ PointTaps point_taps(const float* vol,
                                                const float* coords,
                                                int64_t pt, int64_t n, int h,
                                                int w, int d, int64_t c) {
  const int64_t bi = pt / n;
  const float* q = coords + pt * 3;
  float x = q[0], y = q[1], z = q[2];
  if (!(isfinite(x) && isfinite(y) && isfinite(z))) x = y = z = -4.0f;
  int xb, yb, zb;
  float wx0, wx1, wy0, wy1, wz0, wz1;
  axis_weights(x, w, xb, wx0, wx1);
  axis_weights(y, h, yb, wy0, wy1);
  axis_weights(z, d, zb, wz0, wz1);
  PointTaps t;
  // tap index t = dz*4 + dx*2 + dy (dy fastest), the TPU kernel's order
  const float wzx[4] = {wz0 * wx0, wz0 * wx1, wz1 * wx0, wz1 * wx1};
  const int64_t sz = (int64_t)d * c;          // one x step
  const int64_t sy = (int64_t)w * sz;         // one y step
  for (int k = 0; k < 8; ++k) {
    t.wt[k] = wzx[k >> 1] * ((k & 1) ? wy1 : wy0);
    t.off[k] = (k & 1) * sy + ((k >> 1) & 1) * sz + ((k >> 2) & 1) * c;
  }
  t.base = vol + (((bi * h + yb) * w + xb) * (int64_t)d + zb) * c;
  return t;
}

// one warp per point, lanes over channels (any C)
__global__ void __launch_bounds__(kWarps * 32)
sample3d_trilinear_kernel(const float* __restrict__ vol,
                          const float* __restrict__ coords,
                          float* __restrict__ out, int64_t nb, int h, int w,
                          int d, int64_t c, int64_t n) {
  const int64_t pt = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (pt >= nb * n) return;
  const PointTaps t = point_taps(vol, coords, pt, n, h, w, d, c);
  float* dst = out + pt * c;
  for (int64_t ch = lane; ch < c; ch += 32) {
    float acc = __ldg(t.base + t.off[0] + ch) * t.wt[0];
    for (int k = 1; k < 8; ++k) acc += __ldg(t.base + t.off[k] + ch) * t.wt[k];
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
  const PointTaps t = point_taps(vol, coords, pt, n, h, w, d, c);
  float4 v = __ldg(reinterpret_cast<const float4*>(t.base + t.off[0] + ch));
  float4 acc = make_float4(v.x * t.wt[0], v.y * t.wt[0], v.z * t.wt[0],
                           v.w * t.wt[0]);
  for (int k = 1; k < 8; ++k) {
    v = __ldg(reinterpret_cast<const float4*>(t.base + t.off[k] + ch));
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
