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
// What bounds them on Hopper: bytes, and how they leave the SM. The output
// is ~93% of the compulsory traffic at the production shapes (K1: [1, 2,
// 200000, 770] f32, 1.23 GB; K1b: [3, 200000, 769] f32, 1.85 GB); the
// feature maps (71 MB / 35 MB) stay resident in the 50 MB L2 a camera at a
// time, and the tap reads hit it. The rows' strides (770 or 769 elements,
// 513 and 257 unmerged) are only 8, 4 or 2 bytes aligned, and a thread that
// stores its own channels of a row at that alignment sends 2-4 times the
// L2 write requests the bytes need. The tap gathers are latency-bound L2
// reads (K1 reads about twice its output bytes at the production shapes).
//
// Design: the TPU kernel builds one-hot weight matrices and runs them on the
// MXU only because TPU gathers are slow; on Hopper a direct 4-tap gather is
// the natural form. One block owns a tile of 32 points of one (b, group)
// (K1) or one camera (K1b), and each output has that one owner, written
// once. Phase 1 (taps): the threads compute the taps of each (camera,
// point) once into shared memory (row offsets, weights, validity, rel or
// mask value): one thread a point for K1b, the gs * 32 pairs of K1 over
// the block. Most threads idle in this short phase; tiles of 64 to 256
// points, which keep them busy, gave each warp more rows to walk and were
// slower in every form. Phase 2 (rows): a warp owns a row at a time; its
// lanes take the row's 4-channel groups (C % 4 == 0: C = 768, 512 or 256),
// several in flight, read the 4 tap rows as one vector each (branch-free:
// a tap off the image loads nothing), K1 summing its group's cameras in
// registers in camera order (only those that sample the point; the same
// for the whole warp). A row whose stride keeps every row 16-byte aligned
// goes straight out as vector stores. Any other row is written into the
// warp's row buffer in shared memory at the row's own alignment (buffer
// byte b = global byte b mod 16), its rel / valid / mask columns in place,
// then copied out as 16-byte streaming stores (st.global.cs.v4; its partial
// first and last 16 bytes element by element, beside the neighbouring
// rows' warps writing theirs): one __syncwarp before and after, no block
// barrier. For other C, one channel a lane, stored directly (a warp's
// stores are then consecutive). Points no camera sees cost only
// shared-memory reads. All offsets into the tensors are 64-bit: at b=4
// K1's output alone passes 2^31 elements. The tile size, the groups in
// flight and the bf16 staging's bank rotation are the fastest of the
// variants timed on the H100 at the production shapes.
//
// The arithmetic and its order are the previous design's (tap j = 0..3,
// K1's group sum in camera order, f32 combine, one rounding of a bf16
// output), so both give the same bits on the same inputs.
//
// K1 has a bf16 form (mixed precision): bf16 features in, bf16 output,
// loads and stores in bf16 while the taps, weights and the group sum stay
// f32 (the sum is rounded once, where the JAX kernel rounds each camera's
// row to bf16 and sums them in bf16). The mask, coordinates and per-camera
// validity stay f32.
//
// K1b has the same bf16 form, in all four modes: the 4 taps of a bf16 map
// are combined in f32 and the row is rounded once to bf16, as the JAX
// kernel's bf16 output (pallas_sample.py:426); the mask value and the rel
// column are f32 until that one rounding, the validity stays an f32 0/1.
// Its rows are odd (C+1 = 769 merged, 513 or 257 unmerged): the staging
// buffer takes them at any alignment, and the stores stay 16 bytes wide.
#include <cuda_runtime.h>
#include <stdint.h>

#include "backproject_taps.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileB = 32;         // K1b points per block
constexpr int kTileG = 32;         // K1 points per block
constexpr int kMaxGroup = 8;
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may take

struct Taps {
  int64_t off[4];  // element offsets of the 4 bilinear tap rows, -1 = none
  float w[4];      // 0 where off is -1
  float keep;      // 0 or 1: the point's features are sampled
  float extra;     // K1: rel * valid; K1b: mask value (mode 1), rel (mode 2)
};

// rel-depth of a point: z * rel_scale (raw) or the third coordinate column
template <bool kRaw>
__device__ __forceinline__ float rel_of(const TapPoint& t, const float* q,
                                        float rel_scale) {
  return kRaw ? t.z * rel_scale : q[2];
}

__host__ __device__ __forceinline__ int round16(int bytes) {
  return (bytes + 15) & ~15;
}

// Bytes of a warp's row buffer: one row of `co` elements of T and room for
// the row's offset from a 16-byte boundary.
template <typename T>
__host__ __device__ __forceinline__ int row_buffer_bytes(int co) {
  return round16(15 + co * (int)sizeof(T));
}

// 4 values of lane `lane` into a row buffer (16-byte aligned base) at
// element `pos`, as wide as pos allows. bf16 values at an odd position go
// out an element an instruction, the two half-warps on different elements,
// so that a warp whose lanes hold consecutive quads touches 32 distinct
// banks an instruction (the same element of every lane would hit each bank
// twice). The other misaligned cases take no rotation: there the selects
// it needs cost more than the conflicts (timed on the H100).
__device__ __forceinline__ void put4(float* s, int pos, float4 v, int) {
  if ((pos & 3) == 0) {
    *reinterpret_cast<float4*>(s + pos) = v;
  } else if ((pos & 1) == 0) {
    *reinterpret_cast<float2*>(s + pos) = make_float2(v.x, v.y);
    *reinterpret_cast<float2*>(s + pos + 2) = make_float2(v.z, v.w);
  } else {
    s[pos] = v.x; s[pos + 1] = v.y; s[pos + 2] = v.z; s[pos + 3] = v.w;
  }
}
__device__ __forceinline__ void put4(__nv_bfloat16* s, int pos, float4 v,
                                     int lane) {
  const uint32_t lo = bf16x2_bits(v.x, v.y), hi = bf16x2_bits(v.z, v.w);
  if ((pos & 3) == 0) {
    *reinterpret_cast<uint2*>(s + pos) = make_uint2(lo, hi);
  } else if ((pos & 1) == 0) {
    reinterpret_cast<uint32_t*>(s + pos)[0] = lo;
    reinterpret_cast<uint32_t*>(s + pos + 2)[0] = hi;
  } else {
    uint16_t half[4] = {(uint16_t)(lo & 0xffffu), (uint16_t)(lo >> 16),
                        (uint16_t)(hi & 0xffffu), (uint16_t)(hi >> 16)};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = (q + 2 * (lane >> 4)) & 3;
      const uint16_t x = e == 0 ? half[0] : e == 1 ? half[1]
                                          : e == 2 ? half[2] : half[3];
      reinterpret_cast<uint16_t*>(s + pos + e)[0] = x;
    }
  }
}

// 4 output values straight to a 16-byte aligned row: one streaming vector
// store (16 bytes f32, 8 bf16)
__device__ __forceinline__ void store4cs(float* p, float4 v) { __stcs(
    reinterpret_cast<float4*>(p), v); }
__device__ __forceinline__ void store4cs(__nv_bfloat16* p, float4 v) {
  __stcs(reinterpret_cast<uint2*>(p),
         make_uint2(bf16x2_bits(v.x, v.y), bf16x2_bits(v.z, v.w)));
}

// A warp's staged row out: element j of the row is buf[shift + j] and
// dst[j], shift = (dst's address mod 16) / sizeof(T), so buffer and output
// agree mod 16 bytes: whole 16-byte blocks go out as one streaming vector
// store, the partial first and last block element by element.
template <typename T>
__device__ __forceinline__ void flush_row(const T* buf, T* dst, int shift,
                                          int len, int lane) {
  constexpr int es = (int)sizeof(T);
  const int lo = shift * es, hi = (shift + len) * es;
  char* g = reinterpret_cast<char*>(dst) - lo;          // 16-byte aligned
  const char* s = reinterpret_cast<const char*>(buf);
  const int blocks = (hi + 15) >> 4;
  for (int q = lane; q < blocks; q += 32) {
    const int b0 = q << 4;
    if (b0 >= lo && b0 + 16 <= hi) {
      __stcs(reinterpret_cast<float4*>(g + b0),
             *reinterpret_cast<const float4*>(s + b0));
    } else {
      const int e = b0 + 16 < hi ? b0 + 16 : hi;
      for (int b = b0 > lo ? b0 : lo; b < e; b += es)
        *reinterpret_cast<T*>(g + b) = *reinterpret_cast<const T*>(s + b);
    }
  }
}

template <typename T>
__device__ __forceinline__ float tap_sum1(const T* feats, const Taps& t,
                                          int ch) {
  float f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = t.off[j] >= 0 ? ld1(feats + t.off[j] + ch) : 0.0f;
  float val = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) val += t.w[j] * f[j];
  return val;
}

// sum_j w_j * feat row j at channels ch..ch+3 (taps in order j = 0..3). A
// tap off the image (offset -1, weight 0) reads nothing and adds +0, which
// leaves the sum as it was (a sum that starts at +0 is never -0): the loads
// carry no branch, so a point's 4 loads issue together. Points (K1:
// cameras) that sample nothing are skipped by the callers, warp-uniformly.
template <typename T>
__device__ __forceinline__ float4 tap_sum4(const T* feats, const Taps& t,
                                           int ch) {
  float4 f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = t.off[j] >= 0 ? ld4(feats + t.off[j] + ch)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    val.x += t.w[j] * f[j].x;
    val.y += t.w[j] * f[j].y;
    val.z += t.w[j] * f[j].z;
    val.w += t.w[j] * f[j].w;
  }
  return val;
}

// Row storage of a tile: kStaged rows go through the warps' row buffers
// (any alignment), kDirect ones straight out (16-byte aligned rows);
// kScalar is one channel a lane (C % 4 != 0 or unaligned features).
enum RowStore { kDirect = 0, kStaged = 1, kScalar = 2 };

template <typename T, bool kRaw, int kStore>
__global__ void __launch_bounds__(kThreads)
backproject_grouped_kernel(const T* __restrict__ feats,
                           const float* __restrict__ mask,
                           const float* __restrict__ coords,
                           T* __restrict__ out,
                           float* __restrict__ valid_out,
                           int gs, int h, int w, int64_t c, int64_t n,
                           float rel_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  Taps* taps = reinterpret_cast<Taps*>(smem);          // [gs][kTileG]
  const int co = (int)c + 2;
  const int g = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int64_t n0 = (int64_t)blockIdx.x * kTileG;
  const int64_t cam0 = (bi * 2 + g) * gs;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* buf = reinterpret_cast<T*>(
      smem + round16(gs * kTileG * (int)sizeof(Taps)) +
      warp * row_buffer_bytes<T>(co));

  // phase 1: every thread takes (camera of the group, point of the tile)
  // pairs, kThreads at a time
  for (int i = threadIdx.x; i < gs * kTileG; i += kThreads) {
    const int k = i / kTileG;
    const int p = i % kTileG;
    const int64_t pt = n0 + p;
    if (pt >= n) continue;
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
    taps[k * kTileG + p] = t;
    valid_out[cam * n + pt] = valid;
  }
  __syncthreads();

  // phase 2: a warp per row; the group sum over the cameras in order
  const int rows = (n - n0 < kTileG) ? (int)(n - n0) : kTileG;
  T* run = out + ((bi * 2 + g) * n + n0) * co;
  const int c4 = (int)c / 4;
  for (int r = warp; r < rows; r += kWarps) {
    T* dst = run + (int64_t)r * co;
    if (kStore == kScalar) {
      for (int ch = lane; ch < co; ch += 32) {
        float acc = 0.0f;
        for (int k = 0; k < gs; ++k) {
          const Taps& t = taps[k * kTileG + r];
          if (ch < c) {
            if (t.keep != 0.0f) acc += tap_sum1(feats, t, ch);
          } else {
            acc += ch == c ? t.extra : t.keep;
          }
        }
        st1(dst + ch, acc);
      }
      continue;
    }
    const int shift =
        (int)(reinterpret_cast<uintptr_t>(dst) & 15) / (int)sizeof(T);
    // the cameras that sample this point (the same for the whole warp)
    unsigned kept = 0;
    for (int k = 0; k < gs; ++k)
      if (taps[k * kTileG + r].keep != 0.0f) kept |= 1u << k;
#pragma unroll 2
    for (int gi = lane; gi < c4; gi += 32) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (unsigned m = kept; m; m &= m - 1) {
        const int k = __ffs(m) - 1;
        const float4 val = tap_sum4(feats, taps[k * kTileG + r], gi * 4);
        acc.x += val.x;
        acc.y += val.y;
        acc.z += val.z;
        acc.w += val.w;
      }
      if (kStore == kStaged) put4(buf, shift + gi * 4, acc, lane);
      else store4cs(dst + gi * 4, acc);
    }
    if (lane < 2) {
      float acc = 0.0f;
      for (int k = 0; k < gs; ++k) {
        const Taps& t = taps[k * kTileG + r];
        acc += lane ? t.keep : t.extra;
      }
      st1((kStore == kStaged ? buf + shift : dst) + (int)c + lane, acc);
    }
    if (kStore == kStaged) {
      __syncwarp();
      flush_row(buf, dst, shift, co, lane);
      __syncwarp();      // the buffer is rewritten by the warp's next row
    }
  }
}

// K1b's 4-channel groups of one row, lane, lane + 32, ..., kU of them in
// flight (staged f32 rows: 4, the others 2: the faster counts timed)
template <int kStore, int kU, typename T>
__device__ __forceinline__ void row_groups(const T* feats, const Taps& t,
                                           bool live, T* buf, T* dst,
                                           int shift, int c4, int lane) {
#pragma unroll kU
  for (int gi = lane; gi < c4; gi += 32) {
    const float4 acc = live ? tap_sum4(feats, t, gi * 4)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (kStore == kStaged) put4(buf, shift + gi * 4, acc, lane);
    else store4cs(dst + gi * 4, acc);
  }
}

// K1b. kMode: 0 bilinear, 1 bilinear + nearest mask value, 2 back-projection
// epilogue (raw or normalised coordinates; the others take normalised ones).
// T: the element type of feats and out (f32, or bf16 in the bf16 form).
template <typename T, bool kRaw, int kMode, int kStore>
__global__ void __launch_bounds__(kThreads)
sample2d_kernel(const T* __restrict__ feats,
                const float* __restrict__ mask,
                const float* __restrict__ coords,
                T* __restrict__ out, float* __restrict__ valid_out,
                int h, int w, int64_t c, int64_t n, int ncols,
                float rel_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  Taps* taps = reinterpret_cast<Taps*>(smem);          // [kTileB]
  const int co = (int)c + (kMode == 0 ? 0 : 1);
  const int64_t cam = blockIdx.y;
  const int64_t n0 = (int64_t)blockIdx.x * kTileB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* buf = reinterpret_cast<T*>(smem + round16(kTileB * (int)sizeof(Taps)) +
                                warp * row_buffer_bytes<T>(co));

  // phase 1: one thread per point of the tile
  for (int p = threadIdx.x; p < kTileB; p += kThreads) {
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

  // phase 2: a warp per row (a point not sampled is a row of zeros)
  const int rows = (n - n0 < kTileB) ? (int)(n - n0) : kTileB;
  T* run = out + (cam * n + n0) * co;
  const int c4 = (int)c / 4;
  for (int r = warp; r < rows; r += kWarps) {
    const Taps t = taps[r];
    T* dst = run + (int64_t)r * co;
    if (kStore == kScalar) {
      for (int ch = lane; ch < co; ch += 32)
        st1(dst + ch, ch < c ? (t.keep != 0.0f ? tap_sum1(feats, t, ch) : 0.0f)
                             : t.extra);
      continue;
    }
    const int shift =
        (int)(reinterpret_cast<uintptr_t>(dst) & 15) / (int)sizeof(T);
    const bool live = t.keep != 0.0f;     // the same for the whole warp
    row_groups<kStore, kStore == kStaged && sizeof(T) == 4 ? 4 : 2>(
        feats, t, live, buf, dst, shift, c4, lane);
    if (kMode != 0 && lane == 0)
      st1((kStore == kStaged ? buf + shift : dst) + (int)c, t.extra);
    if (kStore == kStaged) {
      __syncwarp();
      flush_row(buf, dst, shift, co, lane);
      __syncwarp();      // the buffer is rewritten by the warp's next row
    }
  }
}

// How a launch stores its rows: 4-channel groups (C % 4 == 0, feature rows
// 4-element aligned) straight out where every row starts 16-byte aligned,
// else through the warps' row buffers; one channel a lane otherwise.
template <typename T>
int row_store(const T* feats, const T* out, int64_t c, int co) {
  if (c % 4 != 0 || vec_width(feats, c) != 4) return kScalar;
  const bool aligned = reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                       (co * (int64_t)sizeof(T)) % 16 == 0;
  return aligned ? kDirect : kStaged;
}

// The dynamic shared memory of a launch (raised above the 48 KB default
// where it needs more), then the launch itself.
template <typename Kernel, typename... Args>
int launch_with_smem(Kernel kernel, const dim3& grid, int smem,
                     cudaStream_t s, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T, bool kRaw, int kMode>
int launch_sample2d(const dim3& grid, cudaStream_t s, const T* feats,
                    const float* mask, const float* coords, T* out,
                    float* valid, int h, int w, int64_t c, int64_t n,
                    int ncols, float rel_scale) {
  const int co = (int)c + (kMode == 0 ? 0 : 1);
  const int store = row_store(feats, out, c, co);
  const int smem = round16(kTileB * (int)sizeof(Taps)) +
                   (store == kStaged ? kWarps * row_buffer_bytes<T>(co) : 0);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
#define VF_SAMPLE2D(STORE)                                                   \
  launch_with_smem(sample2d_kernel<T, kRaw, kMode, STORE>, grid, smem, s,    \
                   feats, mask, coords, out, valid, h, w, c, n, ncols,       \
                   rel_scale)
  if (store == kDirect) return VF_SAMPLE2D(kDirect);
  if (store == kStaged) return VF_SAMPLE2D(kStaged);
  return VF_SAMPLE2D(kScalar);
#undef VF_SAMPLE2D
}

template <typename T>
int launch_sample2d_modes(const T* feats, const float* mask,
                          const float* coords, T* out, float* valid,
                          int64_t B, int64_t h, int64_t w, int64_t c,
                          int64_t n, int64_t ncols, int mode, int raw,
                          float rel_scale, void* stream) {
  if (mode < 0 || mode > 2 || (raw && mode != 2) || ncols < 2 ||
      ((raw || mode == 2) && ncols < 3) || B > 65535 || c < 1 ||
      c > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + kTileB - 1) / kTileB), (unsigned)B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = (int)ncols;
  if (mode == 0)
    return launch_sample2d<T, false, 0>(grid, s, feats, mask, coords, out,
                                        valid, (int)h, (int)w, c, n, nc,
                                        rel_scale);
  if (mode == 1)
    return launch_sample2d<T, false, 1>(grid, s, feats, mask, coords, out,
                                        valid, (int)h, (int)w, c, n, nc,
                                        rel_scale);
  if (raw)
    return launch_sample2d<T, true, 2>(grid, s, feats, mask, coords, out,
                                       valid, (int)h, (int)w, c, n, nc,
                                       rel_scale);
  return launch_sample2d<T, false, 2>(grid, s, feats, mask, coords, out,
                                      valid, (int)h, (int)w, c, n, nc,
                                      rel_scale);
}

template <typename T, bool kRaw>
int launch_grouped_raw(const dim3& grid, cudaStream_t s, const T* feats,
                       const float* mask, const float* coords, T* out,
                       float* valid, int gs, int h, int w, int64_t c,
                       int64_t n, float rel_scale) {
  const int co = (int)c + 2;
  const int store = row_store(feats, out, c, co);
  const int smem = round16(gs * kTileG * (int)sizeof(Taps)) +
                   (store == kStaged ? kWarps * row_buffer_bytes<T>(co) : 0);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
#define VF_GROUPED(STORE)                                                    \
  launch_with_smem(backproject_grouped_kernel<T, kRaw, STORE>, grid, smem,   \
                   s, feats, mask, coords, out, valid, gs, h, w, c, n,       \
                   rel_scale)
  if (store == kDirect) return VF_GROUPED(kDirect);
  if (store == kStaged) return VF_GROUPED(kStaged);
  return VF_GROUPED(kScalar);
#undef VF_GROUPED
}

template <typename T>
int launch_grouped(const T* feats, const float* mask, const float* coords,
                   T* out, float* valid, int64_t b, int64_t gs, int64_t h,
                   int64_t w, int64_t c, int64_t n, float rel_scale, int raw,
                   void* stream) {
  if (gs < 1 || gs > kMaxGroup || c < 1 || c > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + kTileG - 1) / kTileG), 2, (unsigned)b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (raw)
    return launch_grouped_raw<T, true>(grid, s, feats, mask, coords, out,
                                       valid, (int)gs, (int)h, (int)w, c, n,
                                       rel_scale);
  return launch_grouped_raw<T, false>(grid, s, feats, mask, coords, out,
                                      valid, (int)gs, (int)h, (int)w, c, n,
                                      rel_scale);
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
