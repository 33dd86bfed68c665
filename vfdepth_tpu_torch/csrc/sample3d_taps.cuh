// Tap rule of the trilinear frustum sampler, shared by its forward (K3,
// sample3d.cu) and its backward in both forms (K4, sample3d_bwd.cu), so the
// backward scatters exactly where the forward gathered.
//
// Per axis, with pixel coordinate p, floor p0, frac t and the base clamped
// to [0, size-2] (off = p0 - base):
//   w(base)   = (1-t)*[off==0] + t*[off==-1]
//   w(base+1) = t*[off==0] + (1-t)*[off==+1]
// exactly `_kernel_axis_weights` (vfdepth_tpu/ops/sample3d_packed.py:50), so
// every tap is in bounds and out-of-range taps carry weight 0. Non-finite
// coordinates become -4 (all weights 0). The 8 taps are ordered as the TPU
// kernel's (dy fastest, dz slowest).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

// A point's clamped base voxel (y0, x0, z0) and its 8 tap weights, tap t =
// dz*4 + dx*2 + dy (dy fastest), the TPU kernel's order, from its
// coordinates q = (x, y, z).
struct PointBase {
  int y, x, z;
  float wt[8];
};

__device__ __forceinline__ PointBase point_base(const float* q, int h, int w,
                                                int d) {
  float x = q[0], y = q[1], z = q[2];
  if (!(isfinite(x) && isfinite(y) && isfinite(z))) x = y = z = -4.0f;
  float wx0, wx1, wy0, wy1, wz0, wz1;
  PointBase p;
  axis_weights(x, w, p.x, wx0, wx1);
  axis_weights(y, h, p.y, wy0, wy1);
  axis_weights(z, d, p.z, wz0, wz1);
  const float wzx[4] = {wz0 * wx0, wz0 * wx1, wz1 * wx0, wz1 * wx1};
  for (int k = 0; k < 8; ++k) p.wt[k] = wzx[k >> 1] * ((k & 1) ? wy1 : wy0);
  return p;
}

struct PointWeights {
  int64_t vox;         // flat index of tap (y0, x0, z0) in [b, h, w, d]
  float wt[8];         // tap t = dz*4 + dx*2 + dy (dy fastest)
};

// point `pt` of the flat [b * n] point list; the volume is [b, h, w, d, ...]
__device__ __forceinline__ PointWeights point_weights(const float* coords,
                                                      int64_t pt, int64_t n,
                                                      int h, int w, int d) {
  const int64_t bi = pt / n;
  const PointBase b = point_base(coords + pt * 3, h, w, d);
  PointWeights p;
  for (int k = 0; k < 8; ++k) p.wt[k] = b.wt[k];
  p.vox = ((bi * h + b.y) * w + b.x) * (int64_t)d + b.z;
  return p;
}

struct PointTaps {
  int64_t base;        // element offset of tap (y0, x0, z0)'s row
  int64_t off[8];      // element offsets of the 8 tap rows from base
  float wt[8];
};

// point `pt` of the flat [b * n] point list; the volume is [b, h, w, d, c]
__device__ __forceinline__ PointTaps point_taps(const float* coords,
                                                int64_t pt, int64_t n, int h,
                                                int w, int d, int64_t c) {
  const PointWeights p = point_weights(coords, pt, n, h, w, d);
  PointTaps t;
  const int64_t sz = (int64_t)d * c;          // one x step
  const int64_t sy = (int64_t)w * sz;         // one y step
  for (int k = 0; k < 8; ++k) {
    t.wt[k] = p.wt[k];
    t.off[k] = (k & 1) * sy + ((k >> 1) & 1) * sz + ((k >> 2) & 1) * c;
  }
  t.base = p.vox * c;
  return t;
}

// ------------------------------------------------------------------------
// The tap rule of `sampler_3d: gather` under mixed precision, shared by its
// forward (sample3d.cu) and backward (sample3d_bwd.cu): the XLA gather
// `grid_sample_3d` (vfdepth_tpu/ops/grid_sample.py:188-235) and the taps
// of its scatter `_trilinear_taps` (:111-143), not the clamped rule above.
// Per axis, in f32: p = ((coord + 1) * 0.5) * (size - 1), the floor p0 and
// the fraction p - p0; tap t = dx + 2*dy + 4*dz (JAX's order: dx fastest)
// reads voxel p0 + (dx, dy, dz) where it lies inside the volume (per-tap
// validity, no base clamp), else the voxel clipped into it times 0.
// Non-finite coordinates become -2 (every tap invalid). The _rn intrinsics
// keep nvcc from contracting a product and a sum into one rounding.

struct GatherPoint {
  float f[3];      // the f32 fraction per axis (x, y, z)
  int i[3];        // the floor per axis, clamped to [-2, size + 1] (a floor
                   // outside [-1, size] leaves both taps invalid either way)
};

__device__ __forceinline__ GatherPoint gather_point(const float* q, int h,
                                                    int w, int d) {
  float c[3] = {q[0], q[1], q[2]};
  if (!(isfinite(c[0]) && isfinite(c[1]) && isfinite(c[2])))
    c[0] = c[1] = c[2] = -2.0f;
  const int size[3] = {w, h, d};
  GatherPoint p;
  for (int a = 0; a < 3; ++a) {
    const float x = __fmul_rn(__fmul_rn(__fadd_rn(c[a], 1.0f), 0.5f),
                              (float)(size[a] - 1));
    const float x0 = floorf(x);
    p.f[a] = __fsub_rn(x, x0);
    p.i[a] = (int)fminf(fmaxf(x0, -2.0f), (float)(size[a] + 1));
  }
  return p;
}

// tap t of p: whether it lies inside the volume, and the flat yxz index
// (y * w + x) * d + z of its voxel, clipped into the volume
__device__ __forceinline__ bool gather_tap(const GatherPoint& p, int t, int h,
                                           int w, int d, int& vox) {
  const int x = p.i[0] + (t & 1), y = p.i[1] + ((t >> 1) & 1),
            z = p.i[2] + (t >> 2);
  vox = (min(max(y, 0), h - 1) * w + min(max(x, 0), w - 1)) * d +
        min(max(z, 0), d - 1);
  return x >= 0 && x < w && y >= 0 && y < h && z >= 0 && z < d;
}

// the scatter's f32 weight of tap t: ((X * Y) * Z) * valid, X = 1 - fx or
// fx, and so on (`_trilinear_taps` :137-138)
__device__ __forceinline__ float gather_weight_f32(const GatherPoint& p,
                                                   int t, bool valid) {
  const float x = t & 1 ? p.f[0] : __fsub_rn(1.0f, p.f[0]);
  const float y = (t >> 1) & 1 ? p.f[1] : __fsub_rn(1.0f, p.f[1]);
  const float z = t >> 2 ? p.f[2] : __fsub_rn(1.0f, p.f[2]);
  return __fmul_rn(__fmul_rn(__fmul_rn(x, y), z), valid ? 1.0f : 0.0f);
}
