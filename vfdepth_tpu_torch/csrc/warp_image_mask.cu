// Image + mask warp with its coordinate-derivative maps (kernel K5).
//
// Replaces the TPU kernel vfdepth_tpu/ops/warp_mxu.py:75 `_fwd_kernel`
// (launched by `_fwd_call`, :267; entry `warp_image_mask_mxu`, :365).
//
// What it computes, per (warp b, target pixel n) with normalised coords
// (cx, cy) = coords[b, n] (align_corners):
//   non-finite (cx or cy) -> both -4 (every tap dead)
//   x = (cx + 1) * (0.5 * (w - 1)), y likewise, each clipped to +-1e6
//   taps at (floor x, floor y) and +1 on each axis, weights (1-t, t), an
//   out-of-image tap reads 0 (zeros padding)
//   img_w[b, n, c]  = bilinear RGB sample
//   mask_w[b, n]    = mask at the tap picked per axis by "t > 0.5 takes the
//                     upper tap" (nearest), 0 when that tap leaves the image
//   ddx[b, n, c]    = d img_w / d x = sum over the y taps of wy * (v1 - v0)
//   ddy[b, n, c]    = d img_w / d y = sum over the x taps of wx * (v1 - v0)
// The backward (coordinate gradient) is an elementwise dot of the upstream
// gradient with ddx / ddy, done outside the kernel (ops/warp.py).
// The TPU kernel rounds the sources and ddx / ddy to bf16 for its one-hot
// MXU matmuls; the f32 form here keeps everything in f32. The bf16 form
// (mixed precision: bf16 sources, the JAX model's warp sources) reads bf16
// images and masks, keeps the coordinates and the arithmetic f32, and
// rounds the warped image, the mask and ddx / ddy once to bf16, the
// outputs' dtype in warp_mxu.py:313-330.
//
// What bounds it on Hopper: bytes. Per call at the production shapes (24
// warps of 384x640) it reads the coordinates (47 MB) and writes 3 + 1 +
// 3 + 3 floats per target pixel (236 MB); the sources (24 RGB images and
// masks, 94 MB) are read through L2, each 3.9 MB warp source staying
// resident while its pixels' threads run. The TPU needed one-hot matmuls
// because its gathers are slow; on Hopper the natural form is a direct
// gather: one thread per target pixel, 4 taps x (RGB + mask), all outputs
// written by that thread (neighbouring threads write neighbouring pixels).
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kC = 3;   // RGB, as the TPU kernel

__device__ __forceinline__ float pixel_coord(float c, int size) {
  float p = (c + 1.0f) * (0.5f * (float)(size - 1));
  return fminf(fmaxf(p, -1e6f), 1e6f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_image_mask_kernel(const T* __restrict__ img,
                       const T* __restrict__ mask,
                       const float* __restrict__ coords,
                       T* __restrict__ out_img,
                       T* __restrict__ out_mask,
                       T* __restrict__ ddx, T* __restrict__ ddy,
                       int64_t total, int64_t n, int h, int w) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int64_t bi = idx / n;
  float cx = coords[idx * 2], cy = coords[idx * 2 + 1];
  if (!(isfinite(cx) && isfinite(cy))) cx = cy = -4.0f;
  const float x = pixel_coord(cx, w), y = pixel_coord(cy, h);
  const float x0f = floorf(x), y0f = floorf(y);
  const float tx = x - x0f, ty = y - y0f;
  const int ix = (int)x0f, iy = (int)y0f;
  const bool x0in = ix >= 0 && ix < w, x1in = ix + 1 >= 0 && ix + 1 < w;
  const bool y0in = iy >= 0 && iy < h, y1in = iy + 1 >= 0 && iy + 1 < h;
  const T* src = img + bi * (int64_t)h * w * kC;
  const int64_t r0 = (int64_t)iy * w + ix;   // tap (x0, y0), pixel index
  float v00[kC], v10[kC], v01[kC], v11[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    v00[c] = (x0in && y0in) ? ld1(src + r0 * kC + c) : 0.0f;
    v10[c] = (x1in && y0in) ? ld1(src + (r0 + 1) * kC + c) : 0.0f;
    v01[c] = (x0in && y1in) ? ld1(src + (r0 + w) * kC + c) : 0.0f;
    v11[c] = (x1in && y1in) ? ld1(src + (r0 + w + 1) * kC + c) : 0.0f;
  }
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const float top = (1.0f - tx) * v00[c] + tx * v10[c];
    const float bot = (1.0f - tx) * v01[c] + tx * v11[c];
    st1(out_img + idx * kC + c, (1.0f - ty) * top + ty * bot);
    st1(ddx + idx * kC + c,
        (1.0f - ty) * (v10[c] - v00[c]) + ty * (v11[c] - v01[c]));
    st1(ddy + idx * kC + c, bot - top);
  }
  const int mx = ix + (tx > 0.5f ? 1 : 0), my = iy + (ty > 0.5f ? 1 : 0);
  const bool min_ = mx >= 0 && mx < w && my >= 0 && my < h;
  st1(out_mask + idx,
      min_ ? ld1(mask + bi * (int64_t)h * w + (int64_t)my * w + mx) : 0.0f);
}

template <typename T>
int launch(const T* img, const T* mask, const float* coords, T* out_img,
           T* out_mask, T* ddx, T* ddy, int64_t b, int64_t h, int64_t w,
           int64_t n, void* stream) {
  if (h < 1 || w < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const int64_t total = b * n;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  warp_image_mask_kernel<T><<<(unsigned)blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      img, mask, coords, out_img, out_mask, ddx, ddy, total, n, (int)h,
      (int)w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vf_warp_image_mask(const float* img, const float* mask,
                                  const float* coords, float* out_img,
                                  float* out_mask, float* ddx, float* ddy,
                                  int64_t b, int64_t h, int64_t w, int64_t n,
                                  void* stream) {
  return launch(img, mask, coords, out_img, out_mask, ddx, ddy, b, h, w, n,
                stream);
}

// the bf16 form: images, masks and every output bf16, coords f32
extern "C" int vf_warp_image_mask_bf16(
    const __nv_bfloat16* img, const __nv_bfloat16* mask, const float* coords,
    __nv_bfloat16* out_img, __nv_bfloat16* out_mask, __nv_bfloat16* ddx,
    __nv_bfloat16* ddy, int64_t b, int64_t h, int64_t w, int64_t n,
    void* stream) {
  return launch(img, mask, coords, out_img, out_mask, ddx, ddy, b, h, w, n,
                stream);
}
