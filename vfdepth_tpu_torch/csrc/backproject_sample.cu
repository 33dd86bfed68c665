// Back-projection sampler: grouped (kernel K1) and ungrouped (kernel K1b).
//
// Replaces the TPU kernel vfdepth_tpu/ops/pallas_sample.py:176 `_fwd_kernel`
// in all of its modes: grouped, as launched by `_fwd_call_grouped`
// (pallas_sample.py:431; entries `sample_backproject_grouped_raw_pallas`
// :806 and `sample_backproject_grouped_pallas` :766), and ungrouped, as
// launched by `_fwd_call` (:382; entries `sample_bilinear_pallas` :643,
// `sample_bilinear_with_nearest_mask_pallas` :655,
// `sample_backproject_pallas` :705, `sample_backproject_raw_pallas` :793).
// The tap rule (raw camera-plane or normalised coordinates, bilinear taps,
// nearest mask pick) is in backproject_taps.cuh, shared with the backward
// kernels (K2, K2b).
//
// K1, per (batch b, camera group g, voxel point n), over the group's cameras
// k (ordered group-major):
//   valid = live and the nearest mask value > 0.5
//   rel   = z * rel_scale (raw) or the third coordinate column (normalised)
//   out[b, g, n] = sum_k [feat * valid, rel * valid, valid]
//   valid_out[cam, n] = valid    (per camera; the backward's gate)
// K1b, per (camera or image B, point n), one output row each, by mode:
//   0 bilinear:    out [B, N, C]   = bilinear feat (live points)
//   1 mask:        out [B, N, C+1] = [bilinear feat, nearest mask value]
//   2 backproject: out [B, N, C+1] = [feat * valid, rel * valid],
//                  valid_out [B, N] = valid
// `rel * valid` is a select (a NaN depth of an invalid point gives 0: XLA
// simplifies the JAX kernel's multiply to one).
//
// What bounds them on Hopper: bytes. The output is ~93% of the compulsory
// traffic at the production shapes (K1: [1, 2, 200000, 770] f32, 1.23 GB;
// K1b: [3, 200000, 769] f32, 1.85 GB); the feature maps (71 MB / 35 MB)
// stay resident in the 50 MB L2 a camera at a time, and the tap reads hit
// it.
//
// Design: the TPU kernel builds one-hot weight matrices and runs them on the
// MXU only because TPU gathers are slow; on Hopper a direct 4-tap gather is
// the natural form. One block owns a tile of kTile points of one (b, group)
// (K1) or one camera (K1b). Phase 1: one thread per (camera, point) computes
// the taps once into shared memory (row offsets, weights, validity, rel or
// mask value). Phase 2: the block walks the tile's output rows
// channel-fastest, so the NHWC tap-row reads and the output writes are
// coalesced; K1's group sum is accumulated in registers over the group's
// cameras, in camera order - no atomics. Phase 2 is instruction-bound when
// each thread makes one output (tap bookkeeping per element), so for
// C % 4 == 0 (C = 768 in production) a thread makes 4 channels of one point
// from float4 tap reads and stores them as wide as the row stride allows
// (K1b's C+1 rows are only 4-byte aligned: scalar stores). Points no camera
// sees cost only shared-memory reads. All offsets into the tensors are
// 64-bit: at b=4 K1's output alone passes 2^31 elements.
//
// K1 has a bf16 form (mixed precision): bf16 features in, bf16 output,
// loads and stores in bf16 while the taps, weights and the group sum stay
// f32 (the sum is rounded once, where the JAX kernel rounds each camera's
// row to bf16 and sums them in bf16). Its C+2 rows of 770 bf16 are 1540
// bytes, 4-byte aligned: the 4 channels of a thread go out as two bf16x2
// stores. The mask, coordinates and per-camera validity stay f32.
//
// K1b has the same bf16 form, in all four modes: the 4 taps of a bf16 map
// are combined in f32 and the row is rounded once to bf16, as the JAX
// kernel's bf16 output (pallas_sample.py:426); the mask value and the rel
// column are f32 until that one rounding, the validity stays an f32 0/1.
// Its rows are odd: C+1 = 769 (merged), 513 or 257 (unmerged) bf16 values,
// so every other row starts on a 2-byte boundary and a thread's 4 channels
// go out as scalar stores (``vec_width`` of elem.cuh picks 1 for an odd
// row stride); the tap reads stay 4 bf16 wide where the map allows.
#include <cuda_runtime.h>
#include <stdint.h>

#include "backproject_taps.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr int kMaxGroup = kThreads / kTile;

struct Taps {
  int64_t off[4];  // element offsets of the 4 bilinear tap rows, -1 = none
  float w[4];
  float keep;      // 0 or 1: the point's features are sampled
  float extra;     // K1: rel * valid; K1b: mask value (mode 1), rel (mode 2)
};

// rel-depth of a point: z * rel_scale (raw) or the third coordinate column
template <bool kRaw>
__device__ __forceinline__ float rel_of(const TapPoint& t, const float* q,
                                        float rel_scale) {
  return kRaw ? t.z * rel_scale : q[2];
}

template <typename T, bool kRaw, bool kVec4>
__global__ void __launch_bounds__(kThreads)
backproject_grouped_kernel(const T* __restrict__ feats,
                           const float* __restrict__ mask,
                           const float* __restrict__ coords,
                           T* __restrict__ out,
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
      const float* q = coords + (cam * n + pt) * 3;
      const TapPoint tp = tap_point<kRaw>(q, h, w);
      Taps t;
      float valid = 0.0f;
      for (int j = 0; j < 4; ++j) { t.off[j] = -1; t.w[j] = 0.0f; }
      if (tp.live && nearest_mask(tp, mask + cam * h * (int64_t)w, h, w) >
                         0.5f) {
        valid = 1.0f;
        bilinear_taps(tp, cam, h, w, c, t.off, t.w);
      }
      t.keep = valid;
      // a select: no NaN * 0
      t.extra = valid != 0.0f ? rel_of<kRaw>(tp, q, rel_scale) : 0.0f;
      taps[k][p] = t;
      valid_out[cam * n + pt] = valid;
    }
  }
  __syncthreads();

  // phase 2: the tile's output rows are one contiguous run (its length,
  // kTile*(C+2), fits 32 bits: the in-tile index math stays 32-bit)
  const int co = (int)c + 2;
  const int rows = (n - n0 < kTile) ? (int)(n - n0) : kTile;
  T* dst = out + ((bi * 2 + g) * n + n0) * co;
  if (kVec4) {
    // one thread per (point, 4 channels): one vector tap read, two 2-element
    // stores (rows start 2-element aligned: C+2 is even)
    const int c4 = (int)c / 4;
    for (int idx = threadIdx.x; idx < rows * c4; idx += kThreads) {
      const int p = idx / c4;
      const int ch = (idx - p * c4) * 4;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int k = 0; k < gs; ++k) {
        const Taps& t = taps[k][p];
        if (t.keep == 0.0f) continue;
        float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int j = 0; j < 4; ++j) {
          if (t.off[j] < 0) continue;
          const float4 f = ld4(feats + t.off[j] + ch);
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
      store4(dst + p * co + ch, acc, 2);
    }
    for (int idx = threadIdx.x; idx < rows * 2; idx += kThreads) {
      const int p = idx / 2;
      float acc = 0.0f;
      for (int k = 0; k < gs; ++k)
        acc += (idx & 1) ? taps[k][p].keep : taps[k][p].extra;
      st1(dst + p * co + (int)c + (idx & 1), acc);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * co; idx += kThreads) {
      const int p = idx / co;
      const int ch = idx - p * co;
      float acc = 0.0f;
      if (ch < c) {
        for (int k = 0; k < gs; ++k) {
          const Taps& t = taps[k][p];
          if (t.keep == 0.0f) continue;
          float val = 0.0f;
          for (int j = 0; j < 4; ++j)
            if (t.off[j] >= 0) val += t.w[j] * ld1(feats + t.off[j] + ch);
          acc += val;
        }
      } else if (ch == c) {
        for (int k = 0; k < gs; ++k) acc += taps[k][p].extra;
      } else {
        for (int k = 0; k < gs; ++k) acc += taps[k][p].keep;
      }
      st1(dst + idx, acc);
    }
  }
}

// K1b. kMode: 0 bilinear, 1 bilinear + nearest mask value, 2 back-projection
// epilogue (raw or normalised coordinates; the others take normalised ones).
// T: the element type of feats and out (f32, or bf16 in the bf16 form).
template <typename T, bool kRaw, int kMode, bool kVec4>
__global__ void __launch_bounds__(kThreads)
sample2d_kernel(const T* __restrict__ feats,
                const float* __restrict__ mask,
                const float* __restrict__ coords,
                T* __restrict__ out, float* __restrict__ valid_out,
                int h, int w, int64_t c, int64_t n, int ncols,
                float rel_scale, int out_vec) {
  __shared__ Taps taps[kTile];
  const int64_t cam = blockIdx.y;
  const int64_t n0 = (int64_t)blockIdx.x * kTile;

  // phase 1: one thread per point of the tile
  if (threadIdx.x < kTile) {
    const int p = threadIdx.x;
    const int64_t pt = n0 + p;
    if (pt < n) {
      const float* q = coords + (cam * n + pt) * ncols;
      const TapPoint tp = tap_point<kRaw>(q, h, w);
      Taps t;
      float keep = 0.0f, extra = 0.0f;
      for (int j = 0; j < 4; ++j) { t.off[j] = -1; t.w[j] = 0.0f; }
      if (tp.live) {
        if (kMode == 0) {
          keep = 1.0f;
        } else {
          const float m = nearest_mask(tp, mask + cam * h * (int64_t)w, h, w);
          if (kMode == 1) {
            keep = 1.0f;
            extra = m;
          } else {
            keep = m > 0.5f ? 1.0f : 0.0f;
          }
        }
        if (keep != 0.0f) bilinear_taps(tp, cam, h, w, c, t.off, t.w);
      }
      if (kMode == 2) {
        // a select: no NaN * 0
        extra = keep != 0.0f ? rel_of<kRaw>(tp, q, rel_scale) : 0.0f;
        valid_out[cam * n + pt] = keep;
      }
      t.keep = keep;
      t.extra = extra;
      taps[p] = t;
    }
  }
  __syncthreads();

  // phase 2: the tile's output rows are one contiguous run
  const int co = (int)c + (kMode == 0 ? 0 : 1);
  const int rows = (n - n0 < kTile) ? (int)(n - n0) : kTile;
  T* dst = out + (cam * n + n0) * co;
  if (kVec4) {
    // one thread per (point, 4 channels): 4-element tap reads
    const int c4 = (int)c / 4;
    for (int idx = threadIdx.x; idx < rows * c4; idx += kThreads) {
      const int p = idx / c4;
      const int ch = (idx - p * c4) * 4;
      const Taps& t = taps[p];
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (t.keep != 0.0f) {
        for (int j = 0; j < 4; ++j) {
          if (t.off[j] < 0) continue;
          const float4 f = ld4(feats + t.off[j] + ch);
          acc.x += t.w[j] * f.x;
          acc.y += t.w[j] * f.y;
          acc.z += t.w[j] * f.z;
          acc.w += t.w[j] * f.w;
        }
      }
      store4(dst + p * co + ch, acc, out_vec);
    }
    if (kMode != 0)
      for (int p = threadIdx.x; p < rows; p += kThreads)
        st1(dst + p * co + (int)c, taps[p].extra);
  } else {
    for (int idx = threadIdx.x; idx < rows * co; idx += kThreads) {
      const int p = idx / co;
      const int ch = idx - p * co;
      const Taps& t = taps[p];
      float acc = 0.0f;
      if (ch < c) {
        if (t.keep != 0.0f)
          for (int j = 0; j < 4; ++j)
            if (t.off[j] >= 0) acc += t.w[j] * ld1(feats + t.off[j] + ch);
      } else {
        acc = t.extra;
      }
      st1(dst + idx, acc);
    }
  }
}

template <typename T, bool kRaw, int kMode>
void launch_sample2d(const dim3& grid, cudaStream_t s, bool vec4,
                     const T* feats, const float* mask, const float* coords,
                     T* out, float* valid, int h, int w, int64_t c, int64_t n,
                     int ncols, float rel_scale, int out_vec) {
  if (vec4)
    sample2d_kernel<T, kRaw, kMode, true><<<grid, kThreads, 0, s>>>(
        feats, mask, coords, out, valid, h, w, c, n, ncols, rel_scale,
        out_vec);
  else
    sample2d_kernel<T, kRaw, kMode, false><<<grid, kThreads, 0, s>>>(
        feats, mask, coords, out, valid, h, w, c, n, ncols, rel_scale,
        out_vec);
}

template <typename T>
int launch_sample2d_modes(const T* feats, const float* mask,
                          const float* coords, T* out, float* valid,
                          int64_t B, int64_t h, int64_t w, int64_t c,
                          int64_t n, int64_t ncols, int mode, int raw,
                          float rel_scale, void* stream) {
  if (mode < 0 || mode > 2 || (raw && mode != 2) || ncols < 2 ||
      ((raw || mode == 2) && ncols < 3) || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + kTile - 1) / kTile), (unsigned)B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = c % 4 == 0 && vec_width(feats, c) == 4;
  const int out_vec = vec_width(out, c + (mode == 0 ? 0 : 1));
  const int nc = (int)ncols;
  if (mode == 0)
    launch_sample2d<T, false, 0>(grid, s, vec4, feats, mask, coords, out,
                                 valid, (int)h, (int)w, c, n, nc, rel_scale,
                                 out_vec);
  else if (mode == 1)
    launch_sample2d<T, false, 1>(grid, s, vec4, feats, mask, coords, out,
                                 valid, (int)h, (int)w, c, n, nc, rel_scale,
                                 out_vec);
  else if (raw)
    launch_sample2d<T, true, 2>(grid, s, vec4, feats, mask, coords, out,
                                valid, (int)h, (int)w, c, n, nc, rel_scale,
                                out_vec);
  else
    launch_sample2d<T, false, 2>(grid, s, vec4, feats, mask, coords, out,
                                 valid, (int)h, (int)w, c, n, nc, rel_scale,
                                 out_vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_grouped(const T* feats, const float* mask, const float* coords,
                   T* out, float* valid, int64_t b, int64_t gs, int64_t h,
                   int64_t w, int64_t c, int64_t n, float rel_scale, int raw,
                   void* stream) {
  if (gs < 1 || gs > kMaxGroup) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + kTile - 1) / kTile), 2, (unsigned)b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = c % 4 == 0 && vec_width(feats, c) == 4 &&
                    vec_width(out, c + 2) >= 2;
#define VF_GROUPED(RAW, VEC)                                                 \
  backproject_grouped_kernel<T, RAW, VEC><<<grid, kThreads, 0, s>>>(         \
      feats, mask, coords, out, valid, (int)gs, (int)h, (int)w, c, n,        \
      rel_scale)
  if (raw) {
    if (vec4) VF_GROUPED(true, true); else VF_GROUPED(true, false);
  } else {
    if (vec4) VF_GROUPED(false, true); else VF_GROUPED(false, false);
  }
#undef VF_GROUPED
  return (int)cudaGetLastError();
}

}  // namespace

// K1: feats [b*2*gs, h, w, c], mask [b*2*gs, h, w], coords [b*2*gs, n, 3]
// (raw (u, v, z), or normalised (x, y, rel)) -> out [b, 2, n, c+2], valid
// [b*2*gs, n].
extern "C" int vf_backproject_grouped(
    const float* feats, const float* mask, const float* coords, float* out,
    float* valid, int64_t b, int64_t gs, int64_t h, int64_t w, int64_t c,
    int64_t n, float rel_scale, int raw, void* stream) {
  return launch_grouped(feats, mask, coords, out, valid, b, gs, h, w, c, n,
                        rel_scale, raw, stream);
}

// K1's bf16 form: feats and out bf16; mask, coords and valid f32
extern "C" int vf_backproject_grouped_bf16(
    const __nv_bfloat16* feats, const float* mask, const float* coords,
    __nv_bfloat16* out, float* valid, int64_t b, int64_t gs, int64_t h,
    int64_t w, int64_t c, int64_t n, float rel_scale, int raw, void* stream) {
  return launch_grouped(feats, mask, coords, out, valid, b, gs, h, w, c, n,
                        rel_scale, raw, stream);
}

// K1b: feats [B, h, w, c], mask [B, h, w] (modes 1, 2; else unused), coords
// [B, n, ncols] -> out [B, n, c (+1 in modes 1, 2)], valid [B, n] (mode 2).
extern "C" int vf_sample2d(const float* feats, const float* mask,
                           const float* coords, float* out, float* valid,
                           int64_t B, int64_t h, int64_t w, int64_t c,
                           int64_t n, int64_t ncols, int mode, int raw,
                           float rel_scale, void* stream) {
  return launch_sample2d_modes(feats, mask, coords, out, valid, B, h, w, c,
                               n, ncols, mode, raw, rel_scale, stream);
}

// K1b's bf16 form: feats and out bf16; mask, coords and valid f32
extern "C" int vf_sample2d_bf16(const __nv_bfloat16* feats, const float* mask,
                                const float* coords, __nv_bfloat16* out,
                                float* valid, int64_t B, int64_t h, int64_t w,
                                int64_t c, int64_t n, int64_t ncols, int mode,
                                int raw, float rel_scale, void* stream) {
  return launch_sample2d_modes(feats, mask, coords, out, valid, B, h, w, c,
                               n, ncols, mode, raw, rel_scale, stream);
}
