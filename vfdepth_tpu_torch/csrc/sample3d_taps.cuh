// Tap rule of the trilinear frustum sampler, shared by its forward (K3,
// sample3d.cu) and its backward (K4, sample3d_bwd.cu), so the backward
// scatters exactly where the forward gathered.
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

struct PointTaps {
  int64_t base;        // element offset of tap (y0, x0, z0)'s row
  int64_t off[8];      // element offsets of the 8 tap rows from base
  float wt[8];
};

// point `pt` of the flat [b * n] point list; the volume is [b, h, w, d, c]
__device__ __forceinline__ PointTaps point_taps(const float* coords,
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
  t.base = (((bi * h + yb) * w + xb) * (int64_t)d + zb) * c;
  return t;
}
