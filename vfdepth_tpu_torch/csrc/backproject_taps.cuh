// Tap rule of the back-projection sampler, shared by its forward kernels
// (K1 grouped, K1b ungrouped: backproject_sample.cu) and its backward
// kernels (K2, K2b: backproject_sample_bwd.cu), so a backward scatters
// exactly where its forward gathered. Both coordinate forms of the TPU
// kernel's tap prep (vfdepth_tpu/ops/pallas_sample.py:60 `_pix_taps`):
//
// raw: a camera-plane point (u, v, z) is divided by z + 1e-8; NaN goes to
//   2w and both axes are clipped to +-2w; the point is live iff z > 0 and
//   the align-corners pixel lies in [0, w-1] x [0, h-1].
// normalised: (x, y) in [-1, 1], align corners; a non-finite x or y sends
//   both to pixel -4 (dead); pixel = (c + 1) * (0.5 * (size - 1)); the
//   point is live iff floor(x) lies in [-1, w-1] and floor(y) in [-1, h-1].
//
// A live point's 4 bilinear taps are (x0, y0), (x0+1, y0), (x0, y0+1),
// (x0+1, y0+1); a tap outside the image (zeros padding) gets offset -1 and
// weight 0. Its nearest tap is picked per axis by "the f32 fraction > 0.5
// takes the upper tap" (not round-half-even); a picked tap outside the
// image reads 0.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"

struct TapPoint {
  bool live;
  int ix, iy;      // floor of the pixel coordinate (valid where live)
  float fx, fy;    // its fraction
  float z;         // raw: the camera-frame depth; normalised: unused
};

__device__ __forceinline__ TapPoint raw_point(const float* q, int h, int w) {
  const float u = q[0], v = q[1], z = q[2];
  const float zp = z + 1e-8f;
  const float big = 2.0f * (float)w;
  float x = u / zp;
  float y = v / zp;
  if (isnan(x)) x = big;
  if (isnan(y)) y = big;
  x = fminf(fmaxf(x, -big), big);
  y = fminf(fmaxf(y, -big), big);
  TapPoint p;
  p.z = z;
  p.live = (z > 0.0f) && (x >= 0.0f) && (x <= (float)(w - 1)) &&
           (y >= 0.0f) && (y <= (float)(h - 1));
  const float x0 = floorf(x), y0 = floorf(y);
  p.fx = x - x0;
  p.fy = y - y0;
  p.ix = p.live ? (int)x0 : 0;
  p.iy = p.live ? (int)y0 : 0;
  return p;
}

__device__ __forceinline__ TapPoint norm_point(const float* q, int h, int w) {
  const bool finite = isfinite(q[0]) && isfinite(q[1]);
  const float x = finite ? (q[0] + 1.0f) * (0.5f * (float)(w - 1)) : -4.0f;
  const float y = finite ? (q[1] + 1.0f) * (0.5f * (float)(h - 1)) : -4.0f;
  const float x0 = floorf(x), y0 = floorf(y);
  TapPoint p;
  p.z = 0.0f;
  // compared as floats: a huge coordinate never reaches an int cast
  p.live = (x0 >= -1.0f) && (x0 <= (float)(w - 1)) && (y0 >= -1.0f) &&
           (y0 <= (float)(h - 1));
  p.fx = x - x0;
  p.fy = y - y0;
  p.ix = p.live ? (int)x0 : 0;
  p.iy = p.live ? (int)y0 : 0;
  return p;
}

template <bool kRaw>
__device__ __forceinline__ TapPoint tap_point(const float* q, int h, int w) {
  return kRaw ? raw_point(q, h, w) : norm_point(q, h, w);
}

// The 4 taps of a live point of camera `cam`: element offsets (pixel row *
// c) into a [cams, h, w, c] map, -1 where the tap leaves the image.
__device__ __forceinline__ void bilinear_taps(const TapPoint& p, int64_t cam,
                                              int h, int w, int64_t c,
                                              int64_t off[4], float wt[4]) {
  for (int j = 0; j < 4; ++j) { off[j] = -1; wt[j] = 0.0f; }
  const int64_t row0 = (cam * h + p.iy) * (int64_t)w + p.ix;
  const bool x0in = p.ix >= 0, x1in = p.ix + 1 < w;
  const bool y0in = p.iy >= 0, y1in = p.iy + 1 < h;
  if (x0in && y0in) { off[0] = row0 * c; wt[0] = (1.0f - p.fx) * (1.0f - p.fy); }
  if (x1in && y0in) { off[1] = (row0 + 1) * c; wt[1] = p.fx * (1.0f - p.fy); }
  if (x0in && y1in) { off[2] = (row0 + w) * c; wt[2] = (1.0f - p.fx) * p.fy; }
  if (x1in && y1in) { off[3] = (row0 + w + 1) * c; wt[3] = p.fx * p.fy; }
}

// The mask value at a live point's nearest tap; mask_cam is camera `cam`'s
// [h, w] map.
__device__ __forceinline__ float nearest_mask(const TapPoint& p,
                                              const float* mask_cam, int h,
                                              int w) {
  const int xn = p.ix + (p.fx > 0.5f ? 1 : 0);
  const int yn = p.iy + (p.fy > 0.5f ? 1 : 0);
  return (xn >= 0 && xn < w && yn >= 0 && yn < h)
             ? mask_cam[(int64_t)yn * w + xn] : 0.0f;
}
