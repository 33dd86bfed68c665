// Backward of the trilinear frustum sampler (kernel K4), in both of its
// forms.
//
// Replaces the TPU kernel vfdepth_tpu/ops/sample3d_packed.py:146
// `_updates_kernel` (launched by `_build_updates`, :161) TOGETHER with the
// XLA scatter and three-axis fold behind it (`_packed_bwd`, :305-340): its
// `packed_f32grad` form (f32 updates, f32 accumulation;
// vf_sample3d_trilinear_bwd) and its `packed` form (bf16 updates;
// vf_sample3d_trilinear_bwd_bf16, at the end of this file).
//
// f32 form. What it computes: dvol[b, tap voxel, c] += w_tap(n) * g[b, n,
// c] for the 8 clamped-base taps of every frustum point n, with exactly the
// forward's weights (sample3d_taps.cuh), so every write is in bounds. dvol
// [b, h(y), w(x), d(z), C] is zeroed by the caller. Coordinates get no
// gradient. A tap of weight exactly 0 (a far-out or non-finite point) is
// skipped: the result differs from adding 0 * g only where g is not finite.
//
// What bounds it on Hopper: bytes and atomics. The cotangent g is 295 MB
// per frameset at the production shapes (1,152,000 points x 64 channels),
// dvol 51 MB per frameset; b=2 volumes (102 MB) exceed the 50 MB L2, so the
// atomics partly go through to memory. The TPU built an [N, 8C] update
// stream because its scatters are row-count bound; on Hopper each tap is
// added in place. Design: one thread per (point, 4 channels) (C % 4 == 0,
// C = 64 in production): it recomputes its point's 8 taps, reads 16 bytes
// of g (coalesced) and issues one float4 atomicAdd per live tap (sm_90 has
// 16-byte atomics), else one warp per point with scalar atomics. Frustum
// points crowd near the cameras, where ~50 depth bins of many pixels fall
// into few voxels: those voxels take hundreds of additions while most take
// none (~46 per touched voxel on average), and the atomics on a hot voxel
// serialise in L2. Consecutive points are consecutive depth bins of one
// pixel, so a warp's atomics often hit the same rows; the sum order varies
// from run to run (a few ulp).
//
// The f32 form also takes a bf16 cotangent (mixed precision with
// `packed_f32grad`; vf_sample3d_trilinear_bwd_f32upd_bf16): g is read as
// bf16 and widened, each tap product is formed in f32 (`_updates_kernel`
// :146-155 with out_dtype f32) and added with the same float4 f32 atomics
// into the zeroed f32 dvol; the caller rounds dvol once to bf16
// (`_packed_bwd` :340 `astype(g.dtype)`). JAX sums each tap plane in f32
// and folds the planes in f32: the same f32 sums in another order, so no
// tap planes and no fold are needed here. The cotangent is half the bytes
// of the f32 form's; the atomics are the same.
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"
#include "sample3d_taps.cuh"

namespace {

constexpr int kWarps = 8;

template <typename G>
__global__ void __launch_bounds__(kWarps * 32)
sample3d_trilinear_bwd_kernel(const G* __restrict__ g,
                              const float* __restrict__ coords,
                              float* __restrict__ dvol, int64_t nb, int h,
                              int w, int d, int64_t c, int64_t n) {
  const int64_t pt = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (pt >= nb * n) return;
  const PointTaps t = point_taps(coords, pt, n, h, w, d, c);
  float* base = dvol + t.base;
  for (int64_t ch = lane; ch < c; ch += 32) {
    const float gv = ld1(g + pt * c + ch);
    for (int k = 0; k < 8; ++k)
      if (t.wt[k] != 0.0f) atomicAdd(base + t.off[k] + ch, t.wt[k] * gv);
  }
}

template <typename G>
__global__ void __launch_bounds__(kWarps * 32)
sample3d_trilinear_bwd_vec4_kernel(const G* __restrict__ g,
                                   const float* __restrict__ coords,
                                   float* __restrict__ dvol, int64_t nb,
                                   int h, int w, int d, int64_t c,
                                   int64_t n) {
  const int64_t c4 = c / 4;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nb * n * c4) return;
  const int64_t pt = idx / c4;
  const int64_t ch = (idx - pt * c4) * 4;
  const PointTaps t = point_taps(coords, pt, n, h, w, d, c);
  const float4 gv = ld4(g + pt * c + ch);
  float* base = dvol + t.base + ch;
  for (int k = 0; k < 8; ++k) {
    const float wt = t.wt[k];
    if (wt == 0.0f) continue;
    atomicAdd(reinterpret_cast<float4*>(base + t.off[k]),
              make_float4(wt * gv.x, wt * gv.y, wt * gv.z, wt * gv.w));
  }
}

template <typename G>
int launch_f32_updates(const G* g, const float* coords, float* dvol,
                       int64_t b, int64_t h, int64_t w, int64_t d, int64_t c,
                       int64_t n, void* stream) {
  if (h < 2 || w < 2 || d < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = c % 4 == 0 && vec_width(g, c) == 4 &&
                    reinterpret_cast<uintptr_t>(dvol) % 16 == 0;
  const int threads = kWarps * 32;
  if (vec4) {
    const int64_t blocks = (b * n * (c / 4) + threads - 1) / threads;
    sample3d_trilinear_bwd_vec4_kernel<G><<<(unsigned)blocks, threads, 0, s>>>(
        g, coords, dvol, b, (int)h, (int)w, (int)d, c, n);
  } else {
    const int64_t blocks = (b * n + kWarps - 1) / kWarps;
    sample3d_trilinear_bwd_kernel<G><<<(unsigned)blocks, threads, 0, s>>>(
        g, coords, dvol, b, (int)h, (int)w, (int)d, c, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// g [b, n, c], coords [b, n, 3] -> dvol [b, h, w, d, c] (zeroed by the
// caller)
extern "C" int vf_sample3d_trilinear_bwd(const float* g, const float* coords,
                                         float* dvol, int64_t b, int64_t h,
                                         int64_t w, int64_t d, int64_t c,
                                         int64_t n, void* stream) {
  return launch_f32_updates(g, coords, dvol, b, h, w, d, c, n, stream);
}

// the same with a bf16 g (f32 products and sums; dvol f32, zeroed by the
// caller, who rounds it once to bf16)
extern "C" int vf_sample3d_trilinear_bwd_f32upd_bf16(
    const __nv_bfloat16* g, const float* coords, float* dvol, int64_t b,
    int64_t h, int64_t w, int64_t d, int64_t c, int64_t n, void* stream) {
  return launch_f32_updates(g, coords, dvol, b, h, w, d, c, n, stream);
}

// bf16-update form. What it computes, as `_packed_bwd` with grad_dtype
// "bf16": for every frustum point n and tap t, the product w_t(n) * g[b, n,
// c] in f32, rounded once to bf16 (`_updates_kernel` :146-158), is added in
// bf16 to the tap plane acc[b, base(n), t, c] (the `.at[idx].add` of
// :321-322; every addition rounds to bf16); then the 8 planes fold back into
// the volume in f32, dz first, then dx, then dy (:335-337), each stage
// adding the plane at a voxel to the one its lower neighbour holds, and the
// sum is rounded once to g's dtype (f32 for an f32 config with
// `sampler_3d: packed`, bf16 under mixed precision). The accumulator [b,
// h*w*d, 8, c] bf16 is zeroed by the caller.
//
// What bounds it on Hopper: atomics, then bytes. At the production shapes
// (b = 2, 1,152,000 points x 64 channels each, 200,000 voxels) the
// accumulator is 410 MB: its zeroing, the scatter's read-modify-writes and
// the fold's read each stream it once, where the f32 form touches a 102 MB
// dvol. The TPU built an [N, 8C] update stream and scattered whole rows;
// here the scatter runs one thread per (point, channel pair): it recomputes
// its point's taps (sample3d_taps.cuh, as K3) and makes one native bf16x2
// atomicAdd (sm_90) per tap of nonzero weight, a warp covering a 64-channel
// tap row in 128 contiguous bytes. A tap of weight exactly 0 is skipped: the
// result differs from adding 0 * g only where g is not finite. Hot voxels
// near the cameras take hundreds of bf16 additions in a varying order, so
// the sums are not deterministic and differ from an f32 accumulation by the
// bf16 rounding of each addition. The fold runs one thread per (voxel,
// channel pair) and reads its 8 planes from the voxel and its lower
// neighbours; its f32 adds are taken in the JAX fold's order, so a given
// accumulator folds bit for bit as the plain version does.
namespace {

template <typename G>
__global__ void __launch_bounds__(kWarps * 32)
sample3d_bwd_bf16_scatter_kernel(const G* __restrict__ g,
                                 const float* __restrict__ coords,
                                 __nv_bfloat16* __restrict__ acc, int64_t nb,
                                 int h, int w, int d, int64_t c, int64_t n) {
  const int64_t c2 = c / 2;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nb * n * c2) return;
  const int64_t pt = idx / c2;
  const int64_t ch = (idx - pt * c2) * 2;
  const PointWeights p = point_weights(coords, pt, n, h, w, d);
  const float2 gv = ld2(g + pt * c + ch);
  __nv_bfloat162* row =
      reinterpret_cast<__nv_bfloat162*>(acc + p.vox * 8 * c + ch);
  for (int k = 0; k < 8; ++k) {
    const float wt = p.wt[k];
    if (wt == 0.0f) continue;
    atomicAdd(row + k * c2, __floats2bfloat162_rn(wt * gv.x, wt * gv.y));
  }
}

// odd C or unaligned tensors: one warp per point, lanes over channels
template <typename G>
__global__ void __launch_bounds__(kWarps * 32)
sample3d_bwd_bf16_scatter_scalar_kernel(const G* __restrict__ g,
                                        const float* __restrict__ coords,
                                        __nv_bfloat16* __restrict__ acc,
                                        int64_t nb, int h, int w, int d,
                                        int64_t c, int64_t n) {
  const int64_t pt = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (pt >= nb * n) return;
  const PointWeights p = point_weights(coords, pt, n, h, w, d);
  __nv_bfloat16* row = acc + p.vox * 8 * c;
  for (int64_t ch = lane; ch < c; ch += 32) {
    const float gv = ld1(g + pt * c + ch);
    for (int k = 0; k < 8; ++k)
      if (p.wt[k] != 0.0f)
        atomicAdd(row + k * c + ch, __float2bfloat16_rn(p.wt[k] * gv));
  }
}

// kPair: 2 channels per thread (C even, aligned), else 1
template <typename G, bool kPair>
__global__ void __launch_bounds__(kWarps * 32)
sample3d_bwd_bf16_fold_kernel(const __nv_bfloat16* __restrict__ acc,
                              G* __restrict__ dvol, int64_t nb, int h, int w,
                              int d, int64_t c) {
  constexpr int kK = kPair ? 2 : 1;
  const int64_t cw = c / kK;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nb * h * (int64_t)w * d * cw) return;
  const int64_t vox = idx / cw;
  const int64_t ch = (idx - vox * cw) * kK;
  const int z = (int)(vox % d);
  const int x = (int)((vox / d) % w);
  const int y = (int)((vox / d / w) % h);
  // plane t of the voxel (dy, dx, dz) below this one; 0 outside the volume
  auto plane = [&](int dy, int dx, int dz, int t) -> float2 {
    if (y < dy || x < dx || z < dz) return make_float2(0.0f, 0.0f);
    const int64_t v = vox - ((int64_t)dy * w + dx) * d - dz;
    const __nv_bfloat16* q = acc + (v * 8 + t) * c + ch;
    return kPair ? ld2(q) : make_float2(ld1(q), 0.0f);
  };
  auto add = [](float2 a, float2 b) {
    return make_float2(a.x + b.x, a.y + b.y);
  };
  // the dz fold of plane j (= dx*2 + dy) at the voxel (dy, dx) below
  auto fold_z = [&](int dy, int dx, int j) {
    return add(plane(dy, dx, 0, j), plane(dy, dx, 1, 4 + j));
  };
  // the dx fold of plane dyp at the voxel dy below
  auto fold_x = [&](int dy, int dyp) {
    return add(fold_z(dy, 0, dyp), fold_z(dy, 1, 2 + dyp));
  };
  const float2 v = add(fold_x(0, 0), fold_x(1, 1));
  G* out = dvol + vox * c + ch;
  if (kPair)
    st2(out, v);
  else
    st1(out, v.x);
}

template <typename G>
int launch_bf16(const G* g, const float* coords, __nv_bfloat16* acc, G* dvol,
                int64_t b, int64_t h, int64_t w, int64_t d, int64_t c,
                int64_t n, cudaStream_t s) {
  const int threads = kWarps * 32;
  const bool pair = c % 2 == 0 && vec_width(g, c) >= 2 &&
                    vec_width(acc, c) >= 2 && vec_width(dvol, c) >= 2;
  if (pair) {
    const int64_t blocks = (b * n * (c / 2) + threads - 1) / threads;
    sample3d_bwd_bf16_scatter_kernel<G><<<(unsigned)blocks, threads, 0, s>>>(
        g, coords, acc, b, (int)h, (int)w, (int)d, c, n);
  } else {
    const int64_t blocks = (b * n + kWarps - 1) / kWarps;
    sample3d_bwd_bf16_scatter_scalar_kernel<G>
        <<<(unsigned)blocks, threads, 0, s>>>(g, coords, acc, b, (int)h,
                                              (int)w, (int)d, c, n);
  }
  const int64_t outs = b * h * w * d * (pair ? c / 2 : c);
  const unsigned blocks = (unsigned)((outs + threads - 1) / threads);
  if (pair)
    sample3d_bwd_bf16_fold_kernel<G, true><<<blocks, threads, 0, s>>>(
        acc, dvol, b, (int)h, (int)w, (int)d, c);
  else
    sample3d_bwd_bf16_fold_kernel<G, false><<<blocks, threads, 0, s>>>(
        acc, dvol, b, (int)h, (int)w, (int)d, c);
  return (int)cudaGetLastError();
}

}  // namespace

// g [b, n, c] (f32, or bf16 where g_bf16), coords [b, n, 3], acc [b, h*w*d,
// 8, c] bf16 zeroed by the caller -> dvol [b, h, w, d, c] in g's dtype
extern "C" int vf_sample3d_trilinear_bwd_bf16(const void* g,
                                              const float* coords,
                                              __nv_bfloat16* acc, void* dvol,
                                              int64_t b, int64_t h, int64_t w,
                                              int64_t d, int64_t c, int64_t n,
                                              int g_bf16, void* stream) {
  if (h < 2 || w < 2 || d < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_bf16)
    return launch_bf16(static_cast<const __nv_bfloat16*>(g), coords, acc,
                       static_cast<__nv_bfloat16*>(dvol), b, h, w, d, c, n, s);
  return launch_bf16(static_cast<const float*>(g), coords, acc,
                     static_cast<float*>(dvol), b, h, w, d, c, n, s);
}
