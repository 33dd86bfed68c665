// Deterministic destination-tile plan of the backward kernels K2/K2b
// (backproject_sample_bwd.cu) and K4 (sample3d_bwd.cu), written by hand: no
// library sort.
//
// Both backward kernels scatter each live contribution (a frustum point of
// K4, a (camera, voxel point) of K2) into the 2**k output cells around its
// tap base. Instead of adding them there with atomics, the plan sorts the
// contributions by the OUTPUT TILE of their base, and a block that owns a
// tile of outputs walks the lists of the bases that reach it, in a fixed
// order, and writes every output of its tile once.
//
// Keys. The outputs of an image (a frameset of K4's volume, a camera of
// K2's feature map) are cut into tiles of ty x tx cells (K4: voxel columns
// at full depth; K2: pixels). A base (by, bx) reaches the cells (by + dy,
// bx + dx), dy, dx in {0, 1}, so an output tile reads the bases of its own
// cells and the halo one row below and one column left of it. A base's key
// is its key tile (floor(by / ty) + 1, floor(bx / tx) + 1; the extra row and
// column hold the bases at -1 that K2's normalised coordinates allow) times
// 4, plus a sub-key: 2 if it lies on its tile's last row, 1 if on its last
// column, 3 on both. A tile's list is then five contiguous runs of the
// sorted order: its own key tile (sub-keys 0-3), the key tile below (2-3),
// the one to the left (1, then 3) and the diagonal one (3). A contribution
// that adds nothing (K4: all 8 weights 0; K2: not valid or not live) gets
// the key n_keys and sorts past the end: it is never read.
//
// Sort. A stable least-significant-digit counting sort in 8-bit digits
// (two passes for up to 65,535 keys, three up to 2^24 - 1): per block of
// 2048 items a digit histogram (shared-memory integer atomics: the counts
// do not depend on their order), an exclusive scan of the histograms in
// (digit, block) order, and a stable scatter that ranks each item among
// the block's items of its digit in item order (__match_any_sync within a
// warp, warp counts in shared memory across warps). Within a key, items
// keep their index order, so the plan is the same on every run;
// ops/dest_tiles.py computes the same plan with bincount, cumsum and a
// stable argsort.
//
// Work. A tile of L contributions is walked in ceil(L / chunk) chunks, chunk
// = max(256, 2 * ceil(mean L)) so no block walks more than about twice the
// mean list: the hot tiles near the cameras (up to ~6x the mean) are cut in
// chunks, whose partial tiles go to scratch slots and are summed in chunk
// order by a combine pass. The slots are bounded by n_tiles / 2 + 16; past
// that no tile is cut (a fixed rule: the plan stays deterministic).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"

namespace tiles {
namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;
constexpr int kTile = kThreads * kPer;     // items per sort / scan block
constexpr int kPlanThreads = 1024;
constexpr int kMinChunk = 256;

__host__ __device__ inline int ceil_div(int64_t a, int64_t b) {
  return (int)((a + b - 1) / b);
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// the output tile grid of n_img images of h x w cells in tiles of ty x tx
struct Grid {
  int n_img, h, w, ty, tx;
  __host__ __device__ int nty() const { return ceil_div(h, ty); }
  __host__ __device__ int ntx() const { return ceil_div(w, tx); }
  __host__ __device__ int n_tiles() const { return n_img * nty() * ntx(); }
  __host__ __device__ int n_keys() const {
    return n_img * (nty() + 1) * (ntx() + 1) * 4;
  }
  // first key of key tile (ky, kx) of image img
  __host__ __device__ int key_tile(int img, int ky, int kx) const {
    return ((img * (nty() + 1) + ky) * (ntx() + 1) + kx) * 4;
  }
  // the key of base (by, bx) of image img, by >= -1, bx >= -1
  __device__ int key(int img, int by, int bx) const {
    const int ky = floor_div(by, ty), kx = floor_div(bx, tx);
    const int sub = (by - ky * ty == ty - 1 ? 2 : 0) |
                    (bx - kx * tx == tx - 1 ? 1 : 0);
    return key_tile(img, ky + 1, kx + 1) + sub;
  }
  // output tile t -> (image, tile row, tile column)
  __host__ __device__ void tile(int t, int& img, int& oy, int& ox) const {
    ox = t % ntx();
    oy = (t / ntx()) % nty();
    img = t / (ntx() * nty());
  }
};

// The five runs of the sorted order that output tile t reads, in order.
struct Runs {
  int beg[5], end[5], total;         // end: the runs' lengths, cumulated
  __device__ Runs(const Grid& g, const int* __restrict__ start, int t) {
    int img, oy, ox;
    g.tile(t, img, oy, ox);
    const int own = g.key_tile(img, oy + 1, ox + 1);
    const int below = g.key_tile(img, oy, ox + 1);
    const int left = g.key_tile(img, oy + 1, ox);
    const int diag = g.key_tile(img, oy, ox);
    const int lo[5] = {own, below + 2, left + 1, left + 3, diag + 3};
    const int hi[5] = {own + 4, below + 4, left + 2, left + 4, diag + 4};
    total = 0;
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      beg[r] = start[lo[r]];
      total += start[hi[r]] - beg[r];
      end[r] = total;
    }
  }
  // the sorted position of the v-th contribution of the tile (v < total)
  __device__ int at(int v) const {
    int pos = beg[0] + v;
#pragma unroll
    for (int r = 1; r < 5; ++r)
      if (v >= end[r - 1]) pos = beg[r] + v - end[r - 1];
    return pos;
  }
};

// ---------------------------------------------------------------- scans

// exclusive scan of `count` values, one per thread of a block of n threads
// (n a multiple of 32, <= 1024); returns the block total to every thread
template <int kN>
__device__ int block_exclusive_scan(int v, int& total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kN / 32 ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;               // inclusive
  }
  __syncthreads();
  total = warp_sums[kN / 32 - 1];
  const int r = x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
  __syncthreads();                     // warp_sums is reused by the caller
  return r;
}

// in-place exclusive scan of a[0, n) by ONE block of kPlanThreads threads,
// each thread a contiguous segment; returns the total
__device__ int single_block_scan(int* a, int n) {
  const int seg = ceil_div(n, kPlanThreads);
  const int lo = min(n, (int)threadIdx.x * seg), hi = min(n, lo + seg);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += a[i];
  int total;
  int run = block_exclusive_scan<kPlanThreads>(s, total);
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kThreads)
scan_reduce_kernel(const int* __restrict__ a, int n, int* __restrict__ sums) {
  const int64_t i0 = (int64_t)blockIdx.x * kTile + threadIdx.x * kPer;
  int s = 0;
  for (int k = 0; k < kPer; ++k)
    if (i0 + k < n) s += a[i0 + k];
  int total;
  block_exclusive_scan<kThreads>(s, total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kPlanThreads)
scan_top_kernel(int* sums, int n) { single_block_scan(sums, n); }

__global__ void __launch_bounds__(kThreads)
scan_down_kernel(int* a, int n, const int* __restrict__ sums) {
  const int64_t i0 = (int64_t)blockIdx.x * kTile + threadIdx.x * kPer;
  int v[kPer], s = 0;
  for (int k = 0; k < kPer; ++k) {
    v[k] = i0 + k < n ? a[i0 + k] : 0;
    s += v[k];
  }
  int total;
  int run = block_exclusive_scan<kThreads>(s, total) + sums[blockIdx.x];
  for (int k = 0; k < kPer; ++k) {
    if (i0 + k < n) a[i0 + k] = run;
    run += v[k];
  }
}

// in-place exclusive scan of a[0, n) (n > 0) with `sums` of ceil(n / kTile)
inline void exclusive_scan(int* a, int n, int* sums, cudaStream_t s) {
  const int nb = ceil_div(n, kTile);
  scan_reduce_kernel<<<nb, kThreads, 0, s>>>(a, n, sums);
  scan_top_kernel<<<1, kPlanThreads, 0, s>>>(sums, nb);
  scan_down_kernel<<<nb, kThreads, 0, s>>>(a, n, sums);
}

// ----------------------------------------------------------------- sort

// hist[d * n_blk + blk] = items of block blk whose digit is d
__global__ void __launch_bounds__(kThreads)
digit_hist_kernel(const int* __restrict__ keys, int n, int shift,
                  int* __restrict__ hist) {
  __shared__ int counts[256];
  counts[threadIdx.x] = 0;
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * kTile;
  for (int r = 0; r < kPer; ++r) {
    const int64_t i = base + r * kThreads + threadIdx.x;
    if (i < n) atomicAdd(&counts[(keys[i] >> shift) & 255], 1);
  }
  __syncthreads();
  hist[(int64_t)threadIdx.x * gridDim.x + blockIdx.x] = counts[threadIdx.x];
}

// stable scatter by digit: offsets = the scanned histogram; idx_in null
// means the identity
__global__ void __launch_bounds__(kThreads)
digit_scatter_kernel(const int* __restrict__ keys_in,
                     const int* __restrict__ idx_in, int n, int shift,
                     const int* __restrict__ offsets,
                     int* __restrict__ keys_out, int* __restrict__ idx_out) {
  constexpr int kWarps = kThreads / 32;
  __shared__ int base[256];
  __shared__ int warp_cnt[kWarps][256];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  base[threadIdx.x] = offsets[(int64_t)threadIdx.x * gridDim.x + blockIdx.x];
  for (int r = 0; r < kPer; ++r) {
    for (int w = 0; w < kWarps; ++w) warp_cnt[w][threadIdx.x] = 0;
    __syncthreads();
    const int64_t i = (int64_t)blockIdx.x * kTile + r * kThreads + threadIdx.x;
    const bool in = i < n;
    const int key = in ? keys_in[i] : 0;
    const int d = in ? (key >> shift) & 255 : 256 + lane;   // unique if out
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int rank = __popc(peers & ((1u << lane) - 1));
    if (in && rank == 0) warp_cnt[warp][d] = __popc(peers);
    __syncthreads();
    if (in) {
      int pos = base[d] + rank;
      for (int w = 0; w < warp; ++w) pos += warp_cnt[w][d];
      keys_out[pos] = key;
      idx_out[pos] = idx_in ? idx_in[i] : (int)i;
    }
    __syncthreads();
    int add = 0;
    for (int w = 0; w < kWarps; ++w) add += warp_cnt[w][threadIdx.x];
    base[threadIdx.x] += add;
    __syncthreads();
  }
}

// start[k] = the first sorted position whose key is >= k, k in [0, n_keys]
__global__ void key_starts_kernel(const int* __restrict__ sorted, int n,
                                  int n_keys, int* __restrict__ start) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k > n_keys) return;
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (sorted[mid] < k) lo = mid + 1; else hi = mid;
  }
  start[k] = lo;
}

// Work of the tiles: chunk_off[t] (exclusive prefix of each tile's chunks,
// chunk_off[n_tiles] the total), slot_off[t] (first scratch slot of a tile
// cut in two or more chunks; prefix of their chunk counts) and
// params = {chunk length, slots used}.
__global__ void __launch_bounds__(kPlanThreads)
tile_work_kernel(Grid g, const int* __restrict__ start, int* chunk_off,
                 int* slot_off, int* params, int max_slots) {
  const int nt = g.n_tiles();
  __shared__ int chunk_len;
  int sum = 0;
  for (int t = threadIdx.x; t < nt; t += kPlanThreads)
    sum += Runs(g, start, t).total;
  int total;
  block_exclusive_scan<kPlanThreads>(sum, total);
  if (threadIdx.x == 0)
    chunk_len = max(kMinChunk, 2 * ceil_div(total, max(nt, 1)));
  __syncthreads();
  const int len = chunk_len;
  for (int t = threadIdx.x; t < nt; t += kPlanThreads) {
    const int k = max(1, ceil_div(Runs(g, start, t).total, len));
    chunk_off[t] = k;
    slot_off[t] = k > 1 ? k : 0;
  }
  chunk_off[nt] = 0;
  slot_off[nt] = 0;
  __syncthreads();
  single_block_scan(chunk_off, nt + 1);
  const int slots = single_block_scan(slot_off, nt + 1);
  if (slots > max_slots) {           // no cut: every tile one chunk
    for (int t = threadIdx.x; t <= nt; t += kPlanThreads) {
      chunk_off[t] = t;
      slot_off[t] = 0;
    }
  }
  if (threadIdx.x == 0) {
    params[0] = slots > max_slots ? INT32_MAX : len;
    params[1] = slots > max_slots ? 0 : slots;
  }
}

// the scratch ints of `plan` for n items and n_keys keys
inline int64_t workspace_ints(int64_t n, int64_t n_keys) {
  const int64_t hist = 256 * (int64_t)ceil_div(n, kTile);
  return 4 * n + hist + ceil_div(hist, kTile);
}

// Stable sort of keys[0, n) (each in [0, n_keys], n_keys = dead) into
// order [n] (item indices by key, stable; the live ones first) and start
// [n_keys + 1] (the first sorted position of each key; start[n_keys] is the
// live count); `ws` holds workspace_ints(n, n_keys) ints. The sort alone
// is also the plan of the gather-bf16 backward (sample3d_bwd.cu), whose
// keys are voxels, not tiles.
inline int sort_keys(const int* keys, int n, int n_keys, int* ws, int* order,
                     int* start, cudaStream_t s) {
  if (n <= 0 || n_keys <= 0) return (int)cudaErrorInvalidValue;
  const int nb = ceil_div(n, kTile);
  int* k0 = ws;
  int* k1 = k0 + n;
  int* i0 = k1 + n;
  int* i1 = i0 + n;
  int* hist = i1 + n;
  int* sums = hist + 256 * (int64_t)nb;
  int passes = 1;
  while ((int64_t)1 << (8 * passes) <= n_keys) ++passes;
  const int* cur_k = keys;
  const int* cur_i = nullptr;
  for (int p = 0; p < passes; ++p) {
    int* out_k = p % 2 ? k1 : k0;
    int* out_i = p == passes - 1 ? order : (p % 2 ? i1 : i0);
    digit_hist_kernel<<<nb, kThreads, 0, s>>>(cur_k, n, 8 * p, hist);
    exclusive_scan(hist, 256 * nb, sums, s);
    digit_scatter_kernel<<<nb, kThreads, 0, s>>>(cur_k, cur_i, n, 8 * p,
                                                 hist, out_k, out_i);
    cur_k = out_k;
    cur_i = out_i;
  }
  key_starts_kernel<<<ceil_div(n_keys + 1, 256), 256, 0, s>>>(cur_k, n,
                                                              n_keys, start);
  return (int)cudaGetLastError();
}

// The plan from keys[0, n) (each in [0, n_keys], n_keys = dead): order
// and start (sort_keys) and the tile work (tile_work_kernel); `ws` holds
// workspace_ints(n, n_keys) ints.
inline int plan(const int* keys, int n, const Grid& g, int* ws, int* order,
                int* start, int* chunk_off, int* slot_off, int* params,
                int max_slots, cudaStream_t s) {
  const int err = sort_keys(keys, n, g.n_keys(), ws, order, start, s);
  if (err != 0) return err;
  tile_work_kernel<<<1, kPlanThreads, 0, s>>>(g, start, chunk_off, slot_off,
                                              params, max_slots);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- block walk (K4)

// The raw bits of g's elements (f32, or bf16 as 16 bits) and V of them as
// one load, packed and unpacked without going through memory.
template <typename T> struct Raw { using type = float; };
template <> struct Raw<__nv_bfloat16> { using type = unsigned short; };
template <typename R, int V> struct RawVec;
template <> struct RawVec<float, 4> { using type = float4; };
template <> struct RawVec<float, 2> { using type = float2; };
template <> struct RawVec<float, 1> { using type = float; };
template <> struct RawVec<unsigned short, 4> { using type = uint2; };
template <> struct RawVec<unsigned short, 2> { using type = unsigned int; };
template <> struct RawVec<unsigned short, 1> { using type = unsigned short; };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(unsigned short x) {
  return __uint_as_float((unsigned int)x << 16);    // bf16 -> f32, exact
}
__device__ __forceinline__ float bf16_lo(unsigned int x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned int x) {
  return __uint_as_float(x & 0xffff0000u);
}

__device__ __forceinline__ void pack(float4& v, const float* e) {
  v = make_float4(e[0], e[1], e[2], e[3]);
}
__device__ __forceinline__ void pack(float2& v, const float* e) {
  v = make_float2(e[0], e[1]);
}
__device__ __forceinline__ void pack(float& v, const float* e) { v = e[0]; }
__device__ __forceinline__ void pack(uint2& v, const unsigned short* e) {
  v = make_uint2(e[0] | (unsigned int)e[1] << 16,
                 e[2] | (unsigned int)e[3] << 16);
}
__device__ __forceinline__ void pack(unsigned int& v,
                                     const unsigned short* e) {
  v = e[0] | (unsigned int)e[1] << 16;
}
__device__ __forceinline__ void pack(unsigned short& v,
                                     const unsigned short* e) {
  v = e[0];
}

__device__ __forceinline__ void widen_to(float* o, float4 v) {
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void widen_to(float* o, float2 v) {
  o[0] = v.x; o[1] = v.y;
}
__device__ __forceinline__ void widen_to(float* o, float v) { o[0] = v; }
__device__ __forceinline__ void widen_to(float* o, uint2 v) {
  o[0] = bf16_lo(v.x); o[1] = bf16_hi(v.x);
  o[2] = bf16_lo(v.y); o[3] = bf16_hi(v.y);
}
__device__ __forceinline__ void widen_to(float* o, unsigned int v) {
  o[0] = bf16_lo(v); o[1] = bf16_hi(v);
}
__device__ __forceinline__ void widen_to(float* o, unsigned short v) {
  o[0] = widen(v);
}

// A batch of cotangent rows on its way to shared memory: kRows rows of kCS
// values of T (the first `avail` of each exist; the rest read 0), loaded by
// all kThreads threads as V-element vectors (thread t holds vectors q *
// kThreads + t, so a warp reads 32 * V consecutive values of a row) and
// kept as raw bits in registers while the previous batch is summed, then
// widened to f32 into shared memory.
template <typename T, int kRows, int kCS, int kThreads, int V>
struct RowStage {
  using R = typename Raw<T>::type;
  using VT = typename RawVec<R, V>::type;
  static constexpr int kVecs = kRows * kCS / (kThreads * V);
  static_assert(kRows * kCS % (kThreads * V) == 0, "rows per thread");
  VT v[kVecs];
  int avail;

  // row_of(rec) -> the row's first value of the slice, for recs[0, cnt)
  template <typename Rec, typename RowOf>
  __device__ __forceinline__ void load(RowOf row_of, const Rec* recs,
                                       int cnt) {
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
      const int f = (q * kThreads + (int)threadIdx.x) * V;
      const int p = f / kCS, ch = f % kCS;
      if (p < cnt && ch + V <= avail) {
        v[q] = __ldg(reinterpret_cast<const VT*>(row_of(recs[p]) + ch));
      } else {
        R e[V];
#pragma unroll
        for (int k = 0; k < V; ++k)
          e[k] = p < cnt && ch + k < avail
                     ? __ldg(reinterpret_cast<const R*>(row_of(recs[p]) +
                                                        ch + k))
                     : R(0);
        pack(v[q], e);
      }
    }
  }

  __device__ __forceinline__ void store(float* rows) const {
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
      const int f = (q * kThreads + (int)threadIdx.x) * V;
      float x[4];
      widen_to(x, v[q]);
      if (V == 4)
        *reinterpret_cast<float4*>(rows + f) =
            make_float4(x[0], x[1], x[2], x[3]);
      else if (V == 2)
        *reinterpret_cast<float2*>(rows + f) = make_float2(x[0], x[1]);
      else
        rows[f] = x[0];
    }
  }
};

// Walks the positions [v_beg, v_end) of a tile's runs in batches of kBatch
// points, in order, as a pipeline that keeps the memory busy while the
// block sums: threads t < kBatch fetch the item of point t of the batch
// after next (order) and the coordinates of the next batch (load_q), and
// make its records (make_rec, into the record buffer not in use); all
// threads load the next batch's cotangent rows (stage, from the records)
// into registers; meanwhile the block sums the current batch from shared
// memory: process(recs, rows, count). recs holds 2 * kBatch records, rows
// kBatch rows of the stage's kCS values.
template <int kBatch, typename Rec, typename Stage, typename LoadQ,
          typename MakeRec, typename RowOf, typename Process>
__device__ __forceinline__ void walk(const Runs& runs,
                                     const int* __restrict__ order,
                                     int v_beg, int v_end, Rec* recs,
                                     float* rows, Stage& stage, LoadQ load_q,
                                     MakeRec make_rec, RowOf row_of,
                                     Process process) {
  const int n_pts = v_end - v_beg;
  const int tid = threadIdx.x;
  auto item_of = [&](int b) {
    const int i = b * kBatch + tid;
    return tid < kBatch && i < n_pts ? order[runs.at(v_beg + i)] : -1;
  };
  auto count = [&](int b) { return min(kBatch, n_pts - b * kBatch); };
  float q[3];
  const int item0 = item_of(0);
  if (item0 >= 0) {
    load_q(item0, q);
    make_rec(item0, q, recs[tid]);
  }
  int item1 = item_of(1), item2 = item_of(2);
  if (item1 >= 0) load_q(item1, q);
  __syncthreads();
  stage.load(row_of, recs, count(0));
  for (int b = 0; b * kBatch < n_pts; ++b) {
    stage.store(rows);
    if (item1 >= 0) make_rec(item1, q, recs[((b + 1) & 1) * kBatch + tid]);
    item1 = item2;
    if (item1 >= 0) load_q(item1, q);
    item2 = item_of(b + 3);
    __syncthreads();                 // rows of b, records of b + 1 written
    if ((b + 1) * kBatch < n_pts)
      stage.load(row_of, recs + ((b + 1) & 1) * kBatch, count(b + 1));
    process(recs + (b & 1) * kBatch, rows, count(b));
    __syncthreads();                 // rows and records of b are used
  }
}

// ---------------------------------------------- warp walk (K2, K2b)

// cp.async of W bytes (4, 8 or 16; src and dst aligned to W) from global to
// shared memory: the copy is tracked by commit groups, not by a register,
// so a warp can keep many in flight while it works on shared memory.
template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src) : "memory");
  else if (W == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's newest commit groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The bytes [src, src + bytes) copied by the warp's lanes in W-byte words
// from the W-aligned address at or below src into dst (W-aligned); returns
// the offset of src's first byte in dst (0 unless src is not W-aligned:
// a bf16 row of odd length).
template <int W>
__device__ __forceinline__ int warp_copy(unsigned char* dst, const void* src,
                                         int bytes, int lane) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a0 = a & ~(uintptr_t)(W - 1);
  const int shift = (int)(a - a0);
  const int words = (shift + bytes + W - 1) / W;
  for (int k = lane; k < words; k += 32)
    cp_async<W>(dst + k * W, reinterpret_cast<const void*>(a0 + k * W));
  return shift;
}

// N elements of a staged row (f32, or bf16 bits) at byte offset `at` of a
// shared-memory slot, widened to f32; elements past `avail` read 0
template <typename T, int N>
__device__ __forceinline__ void read_row(const unsigned char* slot, int at,
                                         int avail, float* out) {
  using R = typename Raw<T>::type;
  using VT = typename RawVec<R, N>::type;
  if (at % (int)sizeof(VT) == 0 && avail >= N) {
    float x[4];
    widen_to(x, *reinterpret_cast<const VT*>(slot + at));
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = x[k];
    return;
  }
#pragma unroll
  for (int k = 0; k < N; ++k)
    out[k] = k < avail ? widen(*reinterpret_cast<const R*>(
                             slot + at + k * (int)sizeof(R)))
                       : 0.0f;
}

// One warp's shared memory for a walk: the records of two batches of 32
// points, and per lane the item and the coordinates on their way in.
template <typename Rec>
struct WalkBuf {
  Rec recs[64];
  int item[32];
  float q[32][4];
};

// One warp walks the positions [v_beg, v_end) of a tile's runs, in order,
// with nothing it waits for held in a register: every fetch is a cp.async
// into shared memory. Lane l makes the record of point l of each batch of
// 32 (ops.make_rec(item, q, rec)) into a ring of two batches as the warp
// starts the batch before it; the item is fetched three batches ahead and
// the coordinates (nq floats of coords at item * ncols) two batches ahead.
// The cotangent row of point p is copied (ops.copy_row(rec, slot)) kAhead
// points ahead into a ring of kAhead + 1 row slots of slot_bytes each, and
// the warp sums point p (ops.sum(rec, slot)) once its copy has landed. Ops
// holds its state by value and inlines its methods, so nothing of it lives
// in local memory.
template <int kAhead, typename Rec, typename Ops>
__device__ __forceinline__ void warp_walk(const Runs runs,
                                          const int* __restrict__ order,
                                          const float* __restrict__ coords,
                                          int ncols, int nq, int v_beg,
                                          int v_end, WalkBuf<Rec>& buf,
                                          unsigned char* rows, int slot_bytes,
                                          Ops& ops) {
  const int n = v_end - v_beg;
  const int lane = threadIdx.x % 32;
  // batch 0's records now; batch 1's coordinates and batch 2's item
  // fetched; their copies complete before the walk starts
  if (lane < n) {
    const int item = order[runs.at(v_beg + lane)];
    float q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < nq; ++k) q[k] = coords[(int64_t)item * ncols + k];
    ops.make_rec(item, q, buf.recs[lane]);
  }
  int item_next = 32 + lane < n ? order[runs.at(v_beg + 32 + lane)] : -1;
  if (item_next >= 0)
    for (int k = 0; k < nq; ++k)
      cp_async<4>(&buf.q[lane][k], coords + (int64_t)item_next * ncols + k);
  if (64 + lane < n)
    cp_async<4>(&buf.item[lane], order + runs.at(v_beg + 64 + lane));
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  for (int p = 0; p < kAhead; ++p) {
    if (p < n) ops.copy_row(buf.recs[p], rows + p * slot_bytes);
    cp_async_commit();
  }
  for (int p = 0; p < n; ++p) {
    cp_async_wait<kAhead - 1>();       // this lane's copies for point p
    __syncwarp();                      // and every lane's
    if (p % 32 == 0) {                 // a new batch: the next one's records
      const int b = p / 32;
      if (item_next >= 0) {
        float q[4] = {buf.q[lane][0], buf.q[lane][1], buf.q[lane][2], 0.0f};
        ops.make_rec(item_next, q, buf.recs[((b + 1) & 1) * 32 + lane]);
      }
      const int i2 = (b + 2) * 32 + lane, i3 = (b + 3) * 32 + lane;
      item_next = i2 < n ? buf.item[lane] : -1;
      if (item_next >= 0)
        for (int k = 0; k < nq; ++k)
          cp_async<4>(&buf.q[lane][k],
                      coords + (int64_t)item_next * ncols + k);
      if (i3 < n) cp_async<4>(&buf.item[lane], order + runs.at(v_beg + i3));
      __syncwarp();
    }
    const int ahead = p + kAhead;
    if (ahead < n)
      ops.copy_row(buf.recs[ahead % 64],
                   rows + (ahead % (kAhead + 1)) * slot_bytes);
    cp_async_commit();
    ops.sum(buf.recs[p % 64], rows + (p % (kAhead + 1)) * slot_bytes);
  }
  cp_async_wait<0>();
}

// the largest number of work items (chunks) a plan of g can give
__host__ inline int max_chunks(const Grid& g) {
  return g.n_tiles() + g.n_tiles() / 2 + 1;
}

__host__ inline int max_slots(const Grid& g) { return g.n_tiles() / 2 + 16; }

// work item w of a block -> (tile, chunk), or tile -1 past the end
__device__ inline void find_work(const int* __restrict__ chunk_off, int nt,
                                 int w, int& tile, int& chunk) {
  tile = -1;
  if (w >= chunk_off[nt]) return;
  int lo = 0, hi = nt;                 // the last t with chunk_off[t] <= w
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (chunk_off[mid] <= w) lo = mid; else hi = mid;
  }
  tile = lo;
  chunk = w - chunk_off[lo];
}

}  // namespace
}  // namespace tiles
