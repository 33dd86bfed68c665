// Grouped raw-mode back-projection sampler (kernel K1).
//
// Replaces the TPU kernel vfdepth_tpu/ops/pallas_sample.py:176 `_fwd_kernel`
// in its grouped raw mode, as launched by `_fwd_call_grouped`
// (pallas_sample.py:431; entry `sample_backproject_grouped_raw_pallas`).
//
// What it computes, per (batch b, camera group g, voxel point n):
//   for each camera k of the group (cameras are ordered group-major):
//     (u, v, z) = cam3[cam, n];  x = u / (z + 1e-8), y = v / (z + 1e-8)
//     NaN -> 2w, then clip to +-2w (both axes, as the TPU kernel does)
//     live  = z > 0 and 0 <= x <= w-1 and 0 <= y <= h-1
//     feat  = bilinear sample of feats[cam] at (x, y), zeros padding
//     m     = mask[cam] at the NEAREST tap, picked by "f32 frac > 0.5 takes
//             the upper tap" (not round-half-even)
//     valid = live and m > 0.5
//   out[b, g, n] = sum_k [feat * valid, z * rel_scale * valid, valid]
//   valid_out[cam, n] = valid    (per camera; the backward's gate)
//
// What bounds it on Hopper: bytes. The [b, 2, N, C+2] output is ~93% of the
// compulsory traffic at the production shapes (1.23 GB of 1.32 GB per
// frameset in f32); the feature maps (71 MB) stay resident in the 50 MB L2
// a camera at a time, and the bilinear tap reads hit it.
//
// Design: the TPU kernel builds one-hot weight matrices and runs them on the
// MXU only because TPU gathers are slow; on Hopper a direct 4-tap gather is
// the natural form. One block owns a tile of kTile points of one
// (b, group). Phase 1: one thread per (camera, point) computes the taps once
// into shared memory (row offsets, weights, validity, rel). Phase 2: the
// block walks the tile's output as ONE contiguous run of kTile*(C+2) floats
// (consecutive points' rows are adjacent), channel-fastest, so both the
// NHWC tap-row reads and the output writes are coalesced; the group sum is
// accumulated in registers over the group's cameras, in camera order — no
// atomics. Phase 2 is instruction-bound when each thread makes one output
// (tap bookkeeping per element), so for C % 4 == 0 (C = 768 in production)
// a thread makes 4 channels of one point from float4 tap reads. Points no
// camera sees cost only shared-memory reads. All offsets into the tensors
// are 64-bit: at b=4 the output alone passes 2^31 elements.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr int kMaxGroup = kThreads / kTile;

struct Taps {
  int64_t off[4];  // element offsets of the 4 bilinear tap rows, -1 = none
  float w[4];
  float valid;     // 0 or 1
  float rel;       // valid ? z * rel_scale : 0
};

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
backproject_grouped_raw_kernel(const float* __restrict__ feats,
                               const float* __restrict__ mask,
                               const float* __restrict__ cam3,
                               float* __restrict__ out,
                               float* __restrict__ valid_out,
                               int gs, int h, int w, int64_t c, int64_t n,
                               float rel_scale) {
  __shared__ Taps taps[kMaxGroup][kTile];
  const int g = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int64_t n0 = (int64_t)blockIdx.x * kTile;
  const int64_t cam0 = (bi * 2 + g) * gs;

  // phase 1: one thread per (camera of the group, point of the tile)
  {
    const int k = threadIdx.x / kTile;
    const int p = threadIdx.x % kTile;
    const int64_t pt = n0 + p;
    if (k < gs && pt < n) {
      const int64_t cam = cam0 + k;
      const float* q = cam3 + (cam * n + pt) * 3;
      const float u = q[0], v = q[1], z = q[2];
      const float zp = z + 1e-8f;
      const float big = 2.0f * (float)w;
      float x = u / zp;
      float y = v / zp;
      if (isnan(x)) x = big;
      if (isnan(y)) y = big;
      x = fminf(fmaxf(x, -big), big);
      y = fminf(fmaxf(y, -big), big);
      const bool live = (z > 0.0f) && (x >= 0.0f) && (x <= (float)(w - 1)) &&
                        (y >= 0.0f) && (y <= (float)(h - 1));
      Taps t;
      float valid = 0.0f;
      for (int j = 0; j < 4; ++j) { t.off[j] = -1; t.w[j] = 0.0f; }
      if (live) {
        const float x0 = floorf(x), y0 = floorf(y);
        const float fx = x - x0, fy = y - y0;
        const int ix = (int)x0, iy = (int)y0;
        const int xn = ix + (fx > 0.5f ? 1 : 0);
        const int yn = iy + (fy > 0.5f ? 1 : 0);
        const float m = (xn < w && yn < h)
                            ? mask[(cam * h + yn) * (int64_t)w + xn] : 0.0f;
        if (m > 0.5f) {
          valid = 1.0f;
          const int64_t row0 = (cam * h + iy) * (int64_t)w + ix;
          const bool xin = ix + 1 < w, yin = iy + 1 < h;
          // tap order (x0,y0), (x0+1,y0), (x0,y0+1), (x0+1,y0+1)
          t.off[0] = row0 * c;
          t.w[0] = (1.0f - fx) * (1.0f - fy);
          if (xin) { t.off[1] = (row0 + 1) * c; t.w[1] = fx * (1.0f - fy); }
          if (yin) { t.off[2] = (row0 + w) * c; t.w[2] = (1.0f - fx) * fy; }
          if (xin && yin) { t.off[3] = (row0 + w + 1) * c; t.w[3] = fx * fy; }
        }
      }
      t.valid = valid;
      t.rel = valid != 0.0f ? z * rel_scale : 0.0f;  // select: no NaN * 0
      taps[k][p] = t;
      valid_out[cam * n + pt] = valid;
    }
  }
  __syncthreads();

  // phase 2: the tile's output rows are one contiguous run (its length,
  // kTile*(C+2), fits 32 bits: the in-tile index math stays 32-bit)
  const int co = (int)c + 2;
  const int rows = (n - n0 < kTile) ? (int)(n - n0) : kTile;
  float* dst = out + ((bi * 2 + g) * n + n0) * co;
  if (kVec4) {
    // one thread per (point, 4 channels): float4 tap reads, two float2
    // stores (rows start 8-byte aligned: C+2 is even)
    const int c4 = (int)c / 4;
    for (int idx = threadIdx.x; idx < rows * c4; idx += kThreads) {
      const int p = idx / c4;
      const int ch = (idx - p * c4) * 4;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int k = 0; k < gs; ++k) {
        const Taps& t = taps[k][p];
        if (t.valid == 0.0f) continue;
        float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int j = 0; j < 4; ++j) {
          if (t.off[j] < 0) continue;
          const float4 f =
              __ldg(reinterpret_cast<const float4*>(feats + t.off[j] + ch));
          val.x += t.w[j] * f.x;
          val.y += t.w[j] * f.y;
          val.z += t.w[j] * f.z;
          val.w += t.w[j] * f.w;
        }
        acc.x += val.x;
        acc.y += val.y;
        acc.z += val.z;
        acc.w += val.w;
      }
      float2* o = reinterpret_cast<float2*>(dst + p * co + ch);
      o[0] = make_float2(acc.x, acc.y);
      o[1] = make_float2(acc.z, acc.w);
    }
    for (int idx = threadIdx.x; idx < rows * 2; idx += kThreads) {
      const int p = idx / 2;
      float acc = 0.0f;
      for (int k = 0; k < gs; ++k)
        acc += (idx & 1) ? taps[k][p].valid : taps[k][p].rel;
      dst[p * co + (int)c + (idx & 1)] = acc;
    }
    return;
  }
  for (int idx = threadIdx.x; idx < rows * co; idx += kThreads) {
    const int p = idx / co;
    const int ch = idx - p * co;
    float acc = 0.0f;
    if (ch < c) {
      for (int k = 0; k < gs; ++k) {
        const Taps& t = taps[k][p];
        if (t.valid == 0.0f) continue;
        float val = 0.0f;
        for (int j = 0; j < 4; ++j)
          if (t.off[j] >= 0) val += t.w[j] * __ldg(feats + t.off[j] + ch);
        acc += val;
      }
    } else if (ch == c) {
      for (int k = 0; k < gs; ++k) acc += taps[k][p].rel;
    } else {
      for (int k = 0; k < gs; ++k) acc += taps[k][p].valid;
    }
    dst[idx] = acc;
  }
}

}  // namespace

extern "C" int vf_backproject_grouped_raw(
    const float* feats, const float* mask, const float* cam3, float* out,
    float* valid, int64_t b, int64_t gs, int64_t h, int64_t w, int64_t c,
    int64_t n, float rel_scale, void* stream) {
  if (gs < 1 || gs > kMaxGroup) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + kTile - 1) / kTile), 2, (unsigned)b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c % 4 == 0 && reinterpret_cast<uintptr_t>(feats) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 8 == 0) {
    backproject_grouped_raw_kernel<true><<<grid, kThreads, 0, s>>>(
        feats, mask, cam3, out, valid, (int)gs, (int)h, (int)w, c, n,
        rel_scale);
  } else {
    backproject_grouped_raw_kernel<false><<<grid, kThreads, 0, s>>>(
        feats, mask, cam3, out, valid, (int)gs, (int)h, (int)w, c, n,
        rel_scale);
  }
  return (int)cudaGetLastError();
}
