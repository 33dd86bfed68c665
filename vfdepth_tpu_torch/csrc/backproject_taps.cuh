// Tap rule of the grouped raw-mode back-projection, shared by its forward
// (K1, backproject_sample.cu) and its backward (K2,
// backproject_sample_bwd.cu), so the backward scatters exactly where the
// forward gathered.
//
// A raw camera-plane point (u, v, z) is divided by z + 1e-8; NaN goes to 2w
// and both axes are clipped to +-2w (as the TPU kernel does); the point is
// live iff z > 0 and the align-corners pixel lies in [0, w-1] x [0, h-1].
// Its 4 bilinear taps are (x0, y0), (x0+1, y0), (x0, y0+1), (x0+1, y0+1);
// a tap outside the image (zeros padding) gets offset -1 and weight 0.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

struct RawPoint {
  bool live;
  int ix, iy;      // floor of the pixel coordinate
  float fx, fy;    // its fraction
  float z;
};

__device__ __forceinline__ RawPoint raw_point(const float* q, int h, int w) {
  const float u = q[0], v = q[1], z = q[2];
  const float zp = z + 1e-8f;
  const float big = 2.0f * (float)w;
  float x = u / zp;
  float y = v / zp;
  if (isnan(x)) x = big;
  if (isnan(y)) y = big;
  x = fminf(fmaxf(x, -big), big);
  y = fminf(fmaxf(y, -big), big);
  RawPoint p;
  p.z = z;
  p.live = (z > 0.0f) && (x >= 0.0f) && (x <= (float)(w - 1)) &&
           (y >= 0.0f) && (y <= (float)(h - 1));
  const float x0 = floorf(x), y0 = floorf(y);
  p.fx = x - x0;
  p.fy = y - y0;
  p.ix = (int)x0;
  p.iy = (int)y0;
  return p;
}

// The 4 taps of a live point of camera `cam`: element offsets (pixel row *
// c) into a [cams, h, w, c] map, -1 where the tap leaves the image.
__device__ __forceinline__ void bilinear_taps(const RawPoint& p, int64_t cam,
                                              int h, int w, int64_t c,
                                              int64_t off[4], float wt[4]) {
  for (int j = 0; j < 4; ++j) { off[j] = -1; wt[j] = 0.0f; }
  const int64_t row0 = (cam * h + p.iy) * (int64_t)w + p.ix;
  const bool xin = p.ix + 1 < w, yin = p.iy + 1 < h;
  off[0] = row0 * c;
  wt[0] = (1.0f - p.fx) * (1.0f - p.fy);
  if (xin) { off[1] = (row0 + 1) * c; wt[1] = p.fx * (1.0f - p.fy); }
  if (yin) { off[2] = (row0 + w) * c; wt[2] = (1.0f - p.fx) * p.fy; }
  if (xin && yin) { off[3] = (row0 + w + 1) * c; wt[3] = p.fx * p.fy; }
}
