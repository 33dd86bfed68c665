// Backward of the trilinear frustum sampler (kernel K4), in its three
// forms, as deterministic reductions over destination tiles.
//
// Replaces the TPU kernel vfdepth_tpu/ops/sample3d_packed.py:146
// `_updates_kernel` (launched by `_build_updates`, :161) TOGETHER with the
// XLA scatter and three-axis fold behind it (`_packed_bwd`, :305-340): its
// `packed_f32grad` form (f32 updates: vf_sample3d_trilinear_bwd, and
// vf_sample3d_trilinear_bwd_f32upd_bf16 for a bf16 cotangent under mixed
// precision) and its `packed` form (bf16 updates:
// vf_sample3d_trilinear_bwd_bf16). Two more entries are not ports of a TPU
// kernel: vf_sample3d_gather_bwd_plan and vf_sample3d_gather_bwd_bf16 are
// the backward of `sampler_3d: gather` on a bf16 volume, JAX's XLA
// scatter of bf16 updates into a bf16 volume (see their kernels below).
//
// What it computes: dvol[b, tap voxel, c] += w_tap(n) * g[b, n, c] for the
// 8 clamped-base taps of every frustum point n, with exactly the forward's
// weights (sample3d_taps.cuh). Coordinates get no gradient. A tap of weight
// exactly 0 (a far-out or non-finite point) adds nothing, even where g is
// not finite.
//  * f32 updates: f32 products and f32 sums; dvol is written once in g's
//    dtype (a bf16 dvol is rounded once, as `_packed_bwd` :340 does).
//  * bf16 updates: each product is formed in f32 and rounded once to bf16
//    (`_updates_kernel` :146-158); the products are summed in bf16, every
//    addition rounding, per tap plane (base voxel, tap) as the `.at[].add`
//    of :321-322 does; then the 8 planes fold in f32, dz, then dx, then dy
//    (:335-337), and the sum is rounded once to g's dtype.
//
// Design (csrc/dest_tiles.cuh): a plan sorts the live points by the voxel
// column of their base (keys from the coordinates the forward saved; a
// point whose 8 weights are all 0 is dropped, and its row of g is never
// read). One block of 8 warps owns a tile of voxel columns at full depth
// and 64 channels (4 x 4 columns for f32 updates, 2 x 2 for bf16 updates),
// keeps its sums in shared memory (80 KB at depth 20: f32 sums, or the 8
// bf16 tap planes of each voxel, indexed by the voxel the tap lands on) and
// writes each output once: no zero-fill, no accumulator in device memory,
// no cast pass. A tile reads the points of its own columns and of the
// columns one below it in y and in x (25/16 of its own points for 4 x 4,
// 9/4 for 2 x 2); their taps that land outside the tile are skipped. The
// block stages the cotangent rows of 64 points at a time (tiles::walk: all
// threads load the next batch into registers while the block sums the
// current one from shared memory).
//
// Order, for determinism: warp w owns the cells (y, x, z) of the tile with
// (z + 2x + 4y) % 8 == w (tile-local). The 8 taps of a point land in 8
// different classes, so for each point every warp adds the one tap it owns,
// its 32 lanes two channels each; no two warps share a cell, and a warp
// takes the points in list order (reading the sums of 4 points at once and
// forwarding a sum to a later point of the 4 that hits the same cell), so
// every output (and every tap-plane entry) takes its additions in the
// plan's order, the same on every run. Within a tap plane that is point
// order, each addition rounded to bf16 as XLA's scatter rounds it: the
// plain version (whose bf16 `index_add_` accumulates a call in f32 and
// rounds once) agrees bit for bit where every plane entry takes one
// addition, and tests/helpers_torch_plan.py models this order exactly.
//
// Hot tiles: points crowd near the cameras (625 in one tap-plane entry at
// most). A list longer than the plan's chunk (twice the mean list) is
// walked by several blocks, one chunk each, which write partial tiles to
// scratch; a combine pass sums them in chunk order (for bf16 updates: the
// bf16 planes, chunk by chunk in bf16, then the fold). So with cut tiles
// the bf16 sums are taken chunk by chunk: a fixed order, but not point
// order (XLA's scatter order is unspecified too). Every form is
// deterministic: the same inputs give the same bits. The wrapper reserves
// the scratch for the most slots a plan may use (tiles::max_slots: half
// the tiles + 16; a plan that would need more cuts no tile): one partial
// tile per slot and 64-channel slice: 52.5 MB for f32 updates (1250 tiles,
// a slot of 4 x 4 x 20 x 64 f32) and 206 MB for bf16 updates (5000 tiles,
// a slot of 2 x 2 x 20 voxels x 8 planes x 64 bf16) at the production
// shapes, of which the plans of chip_smoke.py's frustum use about half.
//
// What bounds it on Hopper: the walk, not the bytes. At the production
// shapes (b = 2, 1,152,000 points x 64 channels per frameset) g is 590 MB
// in f32 (295 MB in bf16) and dvol 102 MB (51 MB), but each point's row is
// a separate 256-byte (128-byte) read at a random place, once per tile
// that reaches it, and each of the 8 warps spends ~20 instructions per
// point on the one tap it owns. The atomic kernel it replaced read g in
// order and was faster (root PERF.md, section 6); this one is kept for its
// determinism.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "dest_tiles.cuh"
#include "elem.cuh"
#include "sample3d_taps.cuh"

namespace {

constexpr int kThreads = 256;      // 8 warps
constexpr int kCS = 64;            // channels per block: 32 lanes x 2
constexpr int kBatch = 64;         // points staged per step
constexpr int kGroup = 4;          // points a warp sums at once

// A point as the tile sees it. Its taps are numbered s = dz + 2 dx + 4 dy
// here (the tap that lands in warp w's class is s = (w - class) % 8).
struct PointRec {
  int item;                        // flat point index b * n + n_i
  int at0;                         // the tile cell of its base (may be < 0)
  int meta;                        // its base's class | live taps << 8
  float wt[8];                     // the tap weights, by s
};

__global__ void sample3d_bwd_keys_kernel(const float* __restrict__ coords,
                                         int total, int d, int n,
                                         tiles::Grid grid,
                                         int* __restrict__ keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const PointBase p = point_base(coords + (int64_t)i * 3, grid.h, grid.w, d);
  bool live = false;
  for (int k = 0; k < 8; ++k) live |= p.wt[k] != 0.0f;
  keys[i] = live ? grid.key(i / n, p.y, p.x) : grid.n_keys();
}

template <bool kPlanes>
__host__ __device__ constexpr size_t acc_bytes_per_cell() {
  return kPlanes ? 8 * kCS * sizeof(__nv_bfloat16) : kCS * sizeof(float);
}

__host__ constexpr size_t stage_bytes() {
  return kBatch * kCS * sizeof(float) + 2 * kBatch * sizeof(PointRec);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the 8 bf16 planes of a voxel folded in f32 in `_packed_bwd`'s order:
// ((P0 + P4) + (P2 + P6)) + ((P1 + P5) + (P3 + P7)), plane t = dz*4 +
// dx*2 + dy holding the sum at the base the tap came from
__device__ __forceinline__ float fold(const float p[8]) {
  return ((p[0] + p[4]) + (p[2] + p[6])) + ((p[1] + p[5]) + (p[3] + p[7]));
}

// shared-memory slot of channel c_l of plane k of a cell (bf16 updates)
__device__ __forceinline__ int plane_slot(int cell, int k, int c_l) {
  return (cell * 8 + k) * kCS + c_l;
}

// the f32 sum (f32 updates) or the folded bf16 planes (bf16 updates) of
// channel c_l of a cell, from a tile of shared-memory layout
template <bool kPlanes>
__device__ __forceinline__ float cell_value(const unsigned char* tile,
                                            int cell, int c_l) {
  if (!kPlanes) return reinterpret_cast<const float*>(tile)[cell * kCS + c_l];
  const __nv_bfloat16* planes =
      reinterpret_cast<const __nv_bfloat16*>(tile);
  float p[8];
  for (int j = 0; j < 8; ++j)
    p[j] = __bfloat162float(planes[plane_slot(cell, j, c_l)]);
  return fold(p);
}

template <typename G>
__device__ __forceinline__ void store_voxel(G* dvol, const tiles::Grid& g,
                                            int img, int y0, int x0, int d,
                                            int64_t c, int cell, int ch,
                                            float v) {
  const int z = cell % d, vx = (cell / d) % g.tx, vy = cell / (d * g.tx);
  const int y = y0 + vy, x = x0 + vx;
  if (y < g.h && x < g.w && ch < c)
    st1(dvol + ((((int64_t)img * g.h + y) * g.w + x) * d + z) * c + ch, v);
}

// One block: one chunk of one tile's list, 64 channels. Warp w owns the
// cells (y, x, z) of the tile with (z + 2x + 4y) % 8 == w (tile-local, the
// cell's class): the 8 taps of a point land in 8 different classes, so for
// each point every warp adds exactly the one tap it owns (if it lies in
// the tile), its 32 lanes two channels each. No two warps share a cell and
// a warp takes the points in list order, so every output (and every
// tap-plane entry) receives its additions in that order. A warp reads the
// sums of kGroup points at once and forwards a sum to a later point of the
// group that hits the same address: the same additions in the same order.
// V: the vector width of g's rows.
template <typename G, bool kPlanes, int V>
__global__ void __launch_bounds__(kThreads, 2)
sample3d_bwd_tile_kernel(const G* __restrict__ g,
                         const float* __restrict__ coords,
                         const int* __restrict__ order,
                         const int* __restrict__ start,
                         const int* __restrict__ chunk_off,
                         const int* __restrict__ slot_off,
                         const int* __restrict__ params, tiles::Grid grid,
                         int n, int d, int64_t c,
                         unsigned char* __restrict__ partial,
                         G* __restrict__ dvol) {
  extern __shared__ __align__(16) unsigned char smem[];
  int t, chunk;
  tiles::find_work(chunk_off, grid.n_tiles(), blockIdx.x, t, chunk);
  if (t < 0) return;
  const tiles::Runs runs(grid, start, t);
  int img, oy, ox;
  grid.tile(t, img, oy, ox);
  const int y0 = oy * grid.ty, x0 = ox * grid.tx;
  const int ty = grid.ty, tx = grid.tx;
  const int cells = ty * tx * d;
  const size_t acc_bytes = (size_t)cells * acc_bytes_per_cell<kPlanes>();
  float* rows = reinterpret_cast<float*>(smem + acc_bytes);
  PointRec* recs = reinterpret_cast<PointRec*>(rows + kBatch * kCS);
  for (size_t i = threadIdx.x; i < acc_bytes / 16; i += kThreads)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int cl = 2 * lane;                         // its channels in the slice
  const int64_t ch0 = (int64_t)blockIdx.y * kCS;
  const int64_t len = params[0];
  const int v_beg = (int)min((int64_t)runs.total, chunk * len);
  const int v_end = (int)min((int64_t)runs.total, (chunk + 1) * len);

  tiles::RowStage<G, kBatch, kCS, kThreads, V> stage;
  stage.avail = (int)min((int64_t)kCS, c - ch0);
  auto load_q = [&](int item, float* q) {
    q[0] = coords[(int64_t)item * 3];
    q[1] = coords[(int64_t)item * 3 + 1];
    q[2] = coords[(int64_t)item * 3 + 2];
  };
  const int txd = tx * d;
  auto make_rec = [&](int item, const float* q, PointRec& r) {
    const PointBase p = point_base(q, grid.h, grid.w, d);
    const int y = p.y, x = p.x, z = p.z;
    const int ly = y - y0, lx = x - x0;
    int live = 0;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int dz = s & 1, dx = (s >> 1) & 1, dy = s >> 2;
      const float wt = p.wt[dz * 4 + dx * 2 + dy];
      r.wt[s] = wt;
      if (wt != 0.0f && ly + dy >= 0 && ly + dy < ty && lx + dx >= 0 &&
          lx + dx < tx)
        live |= 1 << s;
    }
    r.item = item;
    r.at0 = ly * txd + lx * d + z;
    r.meta = ((z + 2 * lx + 4 * ly) & 7) | live << 8;
  };
  auto row_of = [&](const PointRec& r) { return g + (int64_t)r.item * c + ch0; };
  auto process = [&](const PointRec* batch, const float* rws, int cnt) {
    for (int p0 = 0; p0 < cnt; p0 += kGroup) {
      int at[kGroup];
      bool ok[kGroup];
      float wv[kGroup];
      float2 gv[kGroup], a[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        ok[u] = false;
        at[u] = 0;
        wv[u] = 0.0f;
        if (p0 + u < cnt) {
          const PointRec& r = batch[p0 + u];
          const int s = (warp - r.meta) & 7;        // the tap this warp owns
          ok[u] = (r.meta >> (8 + s)) & 1;
          const int cell = r.at0 + (s >> 2) * txd + ((s >> 1) & 1) * d +
                           (s & 1);
          at[u] = kPlanes ? plane_slot(cell, (s & 1) << 2 | (s & 2) | s >> 2,
                                       cl)
                          : cell * kCS + cl;
          wv[u] = r.wt[s];
        }
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (!ok[u]) continue;
        gv[u] = *reinterpret_cast<const float2*>(rws + (p0 + u) * kCS + cl);
        a[u] = kPlanes ? __bfloat1622float2(
                             reinterpret_cast<const __nv_bfloat162*>(smem)[at[u] / 2])
                       : reinterpret_cast<const float2*>(smem)[at[u] / 2];
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (!ok[u]) continue;
#pragma unroll
        for (int v = 0; v < u; ++v)
          if (ok[v] && at[v] == at[u]) a[u] = a[v];
        if (kPlanes) {
          // each product rounded once, then a bf16 addition
          a[u].x = round_bf16(a[u].x + round_bf16(wv[u] * gv[u].x));
          a[u].y = round_bf16(a[u].y + round_bf16(wv[u] * gv[u].y));
        } else {
          a[u].x += wv[u] * gv[u].x;
          a[u].y += wv[u] * gv[u].y;
        }
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (!ok[u]) continue;
        if (kPlanes)
          reinterpret_cast<__nv_bfloat162*>(smem)[at[u] / 2] =
              __floats2bfloat162_rn(a[u].x, a[u].y);
        else
          reinterpret_cast<float2*>(smem)[at[u] / 2] = a[u];
      }
    }
  };
  tiles::walk<kBatch>(runs, order, v_beg, v_end, recs, rows, stage, load_q,
                      make_rec, row_of, process);

  const int n_chunks = chunk_off[t + 1] - chunk_off[t];
  if (n_chunks > 1) {                  // a partial tile, summed later
    const size_t slot = (size_t)(slot_off[t] + chunk) * gridDim.y + blockIdx.y;
    float4* dst = reinterpret_cast<float4*>(partial + slot * acc_bytes);
    for (size_t i = threadIdx.x; i < acc_bytes / 16; i += kThreads)
      dst[i] = reinterpret_cast<const float4*>(smem)[i];
    return;
  }
  for (int e = threadIdx.x; e < cells * kCS; e += kThreads) {
    const int cell = e / kCS, c_l = e % kCS;
    store_voxel(dvol, grid, img, y0, x0, d, c, cell, (int)(ch0 + c_l),
                cell_value<kPlanes>(smem, cell, c_l));
  }
}

// the tiles walked in two or more chunks: their partial tiles summed in
// chunk order (bf16 planes in bf16, then folded), written once
template <typename G, bool kPlanes>
__global__ void __launch_bounds__(kThreads)
sample3d_bwd_combine_kernel(const int* __restrict__ chunk_off,
                            const int* __restrict__ slot_off,
                            tiles::Grid grid, int d, int64_t c,
                            const unsigned char* __restrict__ partial,
                            G* __restrict__ dvol) {
  const int t = blockIdx.x;
  const int n_chunks = chunk_off[t + 1] - chunk_off[t];
  if (n_chunks < 2) return;
  int img, oy, ox;
  grid.tile(t, img, oy, ox);
  const int cells = grid.ty * grid.tx * d;
  const size_t acc_bytes = (size_t)cells * acc_bytes_per_cell<kPlanes>();
  auto slot = [&](int k) {
    return partial + ((size_t)(slot_off[t] + k) * gridDim.y + blockIdx.y) *
                         acc_bytes;
  };
  for (int e = threadIdx.x; e < cells * kCS; e += kThreads) {
    const int cell = e / kCS, c_l = e % kCS;
    float v;
    if (kPlanes) {
      float p[8];
      for (int j = 0; j < 8; ++j) {
        const int at = plane_slot(cell, j, c_l);
        p[j] = __bfloat162float(
            reinterpret_cast<const __nv_bfloat16*>(slot(0))[at]);
        for (int k = 1; k < n_chunks; ++k)
          p[j] = round_bf16(p[j] + __bfloat162float(
              reinterpret_cast<const __nv_bfloat16*>(slot(k))[at]));
      }
      v = fold(p);
    } else {
      v = 0.0f;
      for (int k = 0; k < n_chunks; ++k)
        v += cell_value<false>(slot(k), cell, c_l);
    }
    store_voxel(dvol, grid, img, oy * grid.ty, ox * grid.tx, d, c, cell,
                (int)((int64_t)blockIdx.y * kCS + c_l), v);
  }
}

template <typename G, bool kPlanes>
int launch(const G* g, const float* coords, const int* order,
           const int* start, const int* chunk_off, const int* slot_off,
           const int* params, void* partial, G* dvol, int64_t b, int64_t h,
           int64_t w, int64_t d, int64_t c, int64_t n, int64_t ty,
           int64_t tx, void* stream) {
  if (h < 2 || w < 2 || d < 2 || ty < 1 || tx < 1 || ty > 254 || tx > 254 ||
      d > 65535 || b * n >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const tiles::Grid grid{(int)b, (int)h, (int)w, (int)ty, (int)tx};
  const size_t smem =
      (size_t)ty * tx * d * acc_bytes_per_cell<kPlanes>() + stage_bytes();
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int v = vec_width(g, c);
  auto kernel = v == 4   ? sample3d_bwd_tile_kernel<G, kPlanes, 4>
                : v == 2 ? sample3d_bwd_tile_kernel<G, kPlanes, 2>
                         : sample3d_bwd_tile_kernel<G, kPlanes, 1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int slices = tiles::ceil_div(c, kCS);
  kernel<<<dim3(tiles::max_chunks(grid), slices), kThreads, smem, s>>>(
      g, coords, order, start, chunk_off, slot_off, params, grid, (int)n,
      (int)d, c, static_cast<unsigned char*>(partial), dvol);
  sample3d_bwd_combine_kernel<G, kPlanes>
      <<<dim3(grid.n_tiles(), slices), kThreads, 0, s>>>(
          chunk_off, slot_off, grid, (int)d, c,
          static_cast<unsigned char*>(partial), dvol);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------- gather-bf16
// `sampler_3d: gather` on a bf16 volume: the counterpart of the XLA scatter
// of its backward `_gs3d_bwd` (vfdepth_tpu/ops/grid_sample.py:165-184), not
// of a TPU kernel. Each tap of each point (item i = point * 8 + tap, tap
// t = dx + 2 dy + 4 dz: gather_tap in sample3d_taps.cuh) adds the update
// g[point] * w_t, formed in f32 and rounded once to bf16, into the bf16
// dvol at its voxel, starting from +0, every addition rounded to bf16, in
// item order; a tap of weight 0 adds nothing and is dropped.
//
// What bounds it: the g rows of the live points (295 MB at batch 2 of the
// production shapes) read once, dvol written once; in practice the
// ordering: one tap list a voxel, in item order, and each list a serial
// chain of rounded additions. Design:
//  * Plan. Inside the volume a point puts at most one tap on a voxel, so
//    a voxel's taps in item order are its contributing points in point
//    order. The plan sorts POINTS, not taps, by their base voxel (their
//    floors, each >= -1: a key of the [b, h + 1, w + 1, d + 1] grid of
//    bases), stably, with tiles::sort_keys: 8 times fewer keys.
//  * Candidates. Voxel v's candidates are the points of its 8 bases
//    v - (dx, dy, dz), reaching it through tap dx + 2 dy + 4 dz; a count
//    and a scan give each voxel its place in one array of (point, weight)
//    entries. One block a voxel column merges them by point in shared
//    memory (the column's points are 4 contiguous segments of the plan)
//    and writes them coalesced; a voxel of more than kColumnCap candidates
//    (none at the production shapes) is merged by one thread.
//  * Sum. Most voxels have a few dozen candidates: 8 lanes a voxel, 8
//    channels a lane (16-byte loads); a voxel of more than kHotMin takes a
//    warp that scales 32 rows at a time into shared memory, so its serial
//    chain is one shared load and one addition an entry, and these voxels
//    are listed first so their chains start early. Each voxel's sum is one
//    serial chain by contract: the hottest voxel of the production step
//    (3,369 taps) bounds the sum's latency from below.
// Every sum takes two channels an instruction (bf16x2_scale, bf16x2_add:
// the same roundings); C % 8 != 0 or unaligned rows take a warp a voxel at
// 2 or 1 channels a lane. The order is fixed, so a relaunch gives the same
// bits; ops/sample3d.py sample3d_gather_bwd_plain sums in the same order.

constexpr int kColumnCap = 4096;   // points a column kernel's window holds
constexpr int kHotMin = 512;       // a voxel of more candidates: summed first
constexpr int kGroupBatch = 8;     // entries an 8-lane group loads at once

// the key of voxel v's own base (v = ((img * h + y) * w + x) * d + z), and
// that of the base reaching v through tap t
__device__ __forceinline__ int voxel_base_key(int v, int h, int w, int d) {
  const int z = v % d, x = (v / d) % w, yi = v / (d * w);
  return ((yi / h * (h + 1) + yi % h + 1) * (w + 1) + x + 1) * (d + 1) + z +
         1;
}

__device__ __forceinline__ int run_key(int key0, int t, int w, int d) {
  return key0 - (t >> 2) - (t & 1) * (d + 1) - ((t >> 1) & 1) * (w + 1) *
                                                    (d + 1);
}

__global__ void sample3d_gather_bwd_keys_kernel(
    const float* __restrict__ coords, int total, int h, int w, int d, int n,
    int n_keys, int* __restrict__ keys) {
  const int pt = blockIdx.x * blockDim.x + threadIdx.x;
  if (pt >= total) return;
  const GatherPoint p = gather_point(coords + (int64_t)pt * 3, h, w, d);
  bool live = false;
  for (int t = 0; t < 8; ++t) {
    int vox;
    const bool valid = gather_tap(p, t, h, w, d, vox);
    live |= gather_weight_f32(p, t, valid) != 0.0f;
  }
  keys[pt] = live ? gather_base_key(p, pt / n, h, w, d) : n_keys;
}

// The first key of base column (y - dy, x - dx) of image img (its base at
// z = -1); its bases z = -1 .. d - 1 are the d + 1 keys from there.
__device__ __forceinline__ int base_column_key(int img, int y, int x, int q,
                                               int h, int w, int d) {
  return ((img * (h + 1) + y - (q >> 1) + 1) * (w + 1) + x - (q & 1) + 1) *
         (d + 1);
}

// cnt[v]: the points of the 8 bases that reach voxel v (its candidates);
// cnt[n_vox] = 0. A voxel of more than hot_min candidates is listed in
// hot_list (in no fixed order: which warp sums it does not change its bits)
__global__ void sample3d_gather_bwd_count_kernel(
    const int* __restrict__ start, int n_vox, int h, int w, int d,
    int hot_min, int* __restrict__ cnt, int* __restrict__ hot_list,
    int* __restrict__ hot_count) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v > n_vox) return;
  int sum = 0;
  if (v < n_vox) {
    const int key0 = voxel_base_key(v, h, w, d);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int k = run_key(key0, t, w, d);
      sum += start[k + 1] - start[k];
    }
    if (sum > hot_min) hot_list[atomicAdd(hot_count, 1)] = v;
  }
  cnt[v] = sum;
}

// A candidate as the sum reads it: the point and its tap's f32 weight (its
// bits, >= 0: a weight is +0 or positive), or -1 - tap where the serial
// merge left the weight to the sum.
__device__ __forceinline__ int2 make_entry(int pt, float wt) {
  return make_int2(pt, __float_as_int(wt));
}

// sq[i] = coords of the plan's i-th live point: the column kernel then
// reads a point and its coordinates at the same place
__global__ void sample3d_gather_bwd_sorted_coords_kernel(
    const float* __restrict__ coords, const int* __restrict__ order,
    const int* __restrict__ live, float* __restrict__ sq) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= *live) return;
  const int pt = order[i];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    sq[(int64_t)i * 3 + k] = coords[(int64_t)pt * 3 + k];
}

// One block a voxel column (img, y, x) at full depth: its candidates
// merged by point, written to entries[off[v], off[v + 1]) of each voxel v
// of the column. The column's list, the points of the 4 base columns
// (y - dy, x - dx) that reach it, is 4 contiguous segments of the plan's
// order (each sorted by base z, then point). The block walks the column in
// windows of voxels [z0, z1) whose bases z0 - 1 .. z1 - 1 hold at most
// `cap` points: phase 1 stages them in shared memory with their base z and
// their 2 weights toward this column (taps dx + 2 dy, and + 4); phase 2
// ranks each toward its voxels (its count of smaller points in each of the
// voxel's 8 runs, by binary search); phase 3 writes the window's merged
// lists out in order, coalesced. A voxel of more than `cap` candidates is
// left to the serial merge below.
__global__ void __launch_bounds__(kThreads)
sample3d_gather_bwd_column_kernel(const float* __restrict__ sq,
                                  const int* __restrict__ order,
                                  const int* __restrict__ start,
                                  const int* __restrict__ off,
                                  int2* __restrict__ entries, int h, int w,
                                  int d, int cap) {
  extern __shared__ __align__(16) int csm[];
  __shared__ int seg_beg[4];
  const int col = blockIdx.x, x = col % w, yi = col / w;
  const int img = yi / h, y = yi % h;
  const int tid = threadIdx.x;
  // shared memory: rs[4][d + 2] (base column q's bases z = j - 1 hold its
  // points [rs[q][j], rs[q][j + 1]) of the column's list), wo[d + 1] (the
  // window's voxel lists in merged), then per point of the window its
  // index, base z and 2 weights, and 2 merged entries (point * 2 + dz)
  int* rs = csm;
  int* wo = rs + 4 * (d + 2);
  int* e_pt = wo + d + 1;
  float* e_w = reinterpret_cast<float*>(e_pt + cap);      // [cap][2]
  unsigned short* merged = reinterpret_cast<unsigned short*>(e_w + 2 * cap);
  signed char* e_bz = reinterpret_cast<signed char*>(merged + 2 * cap);
  for (int e = tid; e < 4 * (d + 2); e += kThreads) {
    const int q = e / (d + 2), j = e % (d + 2);
    const int k = base_column_key(img, y, x, q, h, w, d);
    const int at = start[k + j];
    if (j == 0) seg_beg[q] = at;
    rs[e] = at;
  }
  __syncthreads();
  for (int e = tid; e < 4 * (d + 2); e += kThreads)
    rs[e] -= seg_beg[e / (d + 2)];
  __syncthreads();
  // the points of bases z0 - 1 .. z1 - 1 (runs j = z0 .. z1 of each q)
  auto count = [&](int z0, int z1) {
    int n = 0;
    for (int q = 0; q < 4; ++q)
      n += rs[q * (d + 2) + z1 + 1] - rs[q * (d + 2) + z0];
    return n;
  };
  const int v0 = col * d;              // the column's first voxel
  int z0 = 0;
  while (z0 < d) {
    if (count(z0, z0 + 1) > cap) {     // the serial merge's voxel
      ++z0;
      continue;
    }
    int z1 = z0 + 1;
    while (z1 < d && count(z1, z1 + 1) <= cap && count(z0, z1 + 1) <= cap)
      ++z1;
    // window-local list: base column q's points [rs[q][z0], rs[q][z1 + 1])
    // from qo[q]
    int qo[5];
    qo[0] = 0;
    for (int q = 0; q < 4; ++q)
      qo[q + 1] = qo[q] + rs[q * (d + 2) + z1 + 1] - rs[q * (d + 2) + z0];
    const int total = qo[4];
    for (int i = tid; i < total; i += kThreads) {
      int q = 0;
      while (i >= qo[q + 1]) ++q;
      const int at = seg_beg[q] + rs[q * (d + 2) + z0] + i - qo[q];
      const int pt = __ldg(order + at);
      const GatherPoint p = gather_point(sq + (int64_t)at * 3, h, w, d);
      const int t0 = (q & 1) + 2 * (q >> 1);
      e_pt[i] = pt;
      e_bz[i] = (signed char)p.i[2];
      e_w[2 * i] = gather_weight_f32(p, t0, true);
      e_w[2 * i + 1] = gather_weight_f32(p, t0 + 4, true);
    }
    if (tid == 0) {
      wo[0] = 0;
      for (int z = z0; z < z1; ++z)
        wo[z - z0 + 1] = wo[z - z0] + count(z, z + 1);
    }
    __syncthreads();
    // phase 2: point i of base z bz, toward voxel z = bz + dz
    for (int e = tid; e < 2 * total; e += kThreads) {
      const int i = e >> 1, z = e_bz[i] + (e & 1);
      if (z < z0 || z >= z1) continue;
      const int pt = e_pt[i];
      int rank = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int* r = rs + q * (d + 2);
        const int base = qo[q] - r[z0];
#pragma unroll
        for (int j = 0; j < 2; ++j) {  // runs of bases z - 1 (j = 0) and z
          int lo = base + r[z + j], hi = base + r[z + j + 1];
          const int beg = lo;
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (e_pt[mid] < pt) lo = mid + 1; else hi = mid;
          }
          rank += lo - beg;
        }
      }
      merged[wo[z - z0] + rank] = (unsigned short)e;
    }
    __syncthreads();
    // phase 3: voxels z0 .. z1 - 1 are consecutive, their lists contiguous
    int2* dst = entries + off[v0 + z0];
    for (int k = tid; k < wo[z1 - z0]; k += kThreads) {
      const int m = merged[k];
      dst[k] = make_entry(e_pt[m >> 1], e_w[m]);
    }
    __syncthreads();
    z0 = z1;
  }
}

// bytes of the column kernel's shared memory at a cap of points
__host__ inline size_t column_smem(int d, int cap) {
  return (size_t)(4 * (d + 2) + d + 1) * sizeof(int) +
         (size_t)cap * (sizeof(int) + 2 * sizeof(float) +
                        2 * sizeof(unsigned short) + 1);
}

// One thread a voxel of more than `cap` candidates: its 8 runs (each in
// point order) merged by point into entries[off[v], off[v + 1]), each run's
// next element loaded one step ahead; the weights are left to the sum, so
// the merge's serial chain waits on no coordinates.
__global__ void sample3d_gather_bwd_merge_kernel(
    const int* __restrict__ order, const int* __restrict__ start,
    const int* __restrict__ off, int n_vox, int h, int w, int d, int cap,
    int2* __restrict__ entries) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n_vox) return;
  int o = off[v];
  const int o_end = off[v + 1];
  if (o_end - o <= cap) return;        // the column kernel's voxel
  const int key0 = voxel_base_key(v, h, w, d);
  int pos[8], end[8], head[8], next[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int k = run_key(key0, t, w, d);
    pos[t] = start[k];
    end[t] = start[k + 1];
    head[t] = pos[t] < end[t] ? __ldg(order + pos[t]) : INT32_MAX;
    next[t] = pos[t] + 1 < end[t] ? __ldg(order + pos[t] + 1) : INT32_MAX;
  }
  for (; o < o_end; ++o) {
    int best = head[0], tb = 0;
#pragma unroll
    for (int t = 1; t < 8; ++t)
      if (head[t] < best) {
        best = head[t];
        tb = t;
      }
    entries[o] = make_int2(best, -1 - tb);
#pragma unroll
    for (int t = 0; t < 8; ++t)
      if (t == tb) {
        head[t] = next[t];
        ++pos[t];
        next[t] = pos[t] + 1 < end[t] ? __ldg(order + pos[t] + 1)
                                      : INT32_MAX;
      }
  }
}

// the entry's f32 weight: its own, or its tap's (-1 - e.y) from the
// point's coordinates
__device__ __forceinline__ int2 weighted(int2 e, const float* coords, int h,
                                        int w, int d) {
  if (e.y < 0) {
    const GatherPoint p = gather_point(coords + (int64_t)e.x * 3, h, w, d);
    e.y = __float_as_int(gather_weight_f32(p, -1 - e.y, true));
  }
  return e;
}

// One warp sums voxel v, V channels a lane (32 * V a pass): its entries in
// order, 32 at a time (lane j loads entry j; the next 32 are loaded while
// these are summed), each batch's rows all loaded before its first
// addition; entries of weight 0 are dropped. The shortest chain a long
// list can take: the hot voxels' path.
template <int V>
__device__ __forceinline__ void sum_voxel_warp(
    const __nv_bfloat16* __restrict__ g, const float* __restrict__ coords,
    const int2* __restrict__ entries, const int* __restrict__ off,
    __nv_bfloat16* __restrict__ dvol, int v, int h, int w, int d, int c) {
  constexpr int kWords = Bf16Words<V>::kWords;
  const int lane = threadIdx.x % 32;
  const int beg = off[v], end = off[v + 1];
  for (int ch0 = 0; ch0 < c; ch0 += 32 * V) {
    const int ch = ch0 + lane * V;
    const bool has = ch < c;
    Bf16Words<V> acc;
#pragma unroll
    for (int u = 0; u < kWords; ++u) acc.w[u] = 0u;     // +0.0
    int2 e = beg + lane < end ? __ldg(entries + beg + lane) : make_int2(0, 0);
    e = weighted(e, coords, h, w, d);
    for (int b0 = beg; b0 < end; b0 += 32) {
      const int cnt = min(32, end - b0);
      int2 e_next = b0 + 32 + lane < end ? __ldg(entries + b0 + 32 + lane)
                                         : make_int2(0, 0);
      Bf16Words<V> row[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if (j >= cnt) break;
        const int pt = __shfl_sync(0xffffffffu, e.x, j);
        const int wb = __shfl_sync(0xffffffffu, e.y, j);
        if (has && wb != 0) row[j] = load_bf16<V>(g + (int64_t)pt * c + ch);
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if (j >= cnt) break;
        const float wt = __int_as_float(__shfl_sync(0xffffffffu, e.y, j));
        if (has && wt != 0.0f)
#pragma unroll
          for (int u = 0; u < kWords; ++u)
            acc.w[u] = bf16x2_add(acc.w[u], bf16x2_scale(row[j].w[u], wt));
      }
      e = weighted(e_next, coords, h, w, d);
    }
    if (has) store_bf16<V>(dvol + (int64_t)v * c + ch, acc);
  }
}

// One warp sums hot voxel v, 64 channels a pass, C % 8 == 0 and 16-byte
// aligned rows: its entries 32 at a time. Lane j loads entry j's row slice
// (eight 16-byte loads: a batch's 256 loads in flight at once) and scales
// it into terms[j] in shared memory (+0 for an entry of weight 0, which
// leaves the sum as it is: a bf16 sum that starts at +0 is never -0, and
// x + +0 = x; rows of 36 words, so 8 lanes' 16-byte stores hit 32 banks),
// so the serial chain is, an entry, one 4-byte shared load and one
// add.bf16x2 a lane; the next 32 entries' rows are loaded while it runs.
__device__ __forceinline__ void sum_voxel_warp_staged(
    const __nv_bfloat16* __restrict__ g, const float* __restrict__ coords,
    const int2* __restrict__ entries, const int* __restrict__ off,
    __nv_bfloat16* __restrict__ dvol, int v, int h, int w, int d, int c,
    uint32_t (*terms)[36]) {
  const int lane = threadIdx.x % 32;
  const int beg = off[v], end = off[v + 1];
  for (int ch0 = 0; ch0 < c; ch0 += 64) {
    const int nvec = min(8, (c - ch0) / 8);     // 16-byte vectors a row
    uint32_t acc = 0u;                           // +0.0, channels 2 lane, +1
    auto load_rows = [&](int b0, Bf16Words<8> (&rows)[8], float& wt) {
      const int j = b0 + lane;
      wt = 0.0f;
      if (j < end) {
        const int2 e = weighted(__ldg(entries + j), coords, h, w, d);
        wt = __int_as_float(e.y);
        if (e.y != 0)
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (q < nvec)
              rows[q] = load_bf16<8>(g + (int64_t)e.x * c + ch0 + 8 * q);
      }
    };
    Bf16Words<8> rows[8];
    float wt;
    load_rows(beg, rows, wt);
    for (int b0 = beg; b0 < end; b0 += 32) {
      const int cnt = min(32, end - b0);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        uint4 t = make_uint4(0u, 0u, 0u, 0u);
        if (q < nvec && wt != 0.0f)
          t = make_uint4(bf16x2_scale(rows[q].w[0], wt),
                         bf16x2_scale(rows[q].w[1], wt),
                         bf16x2_scale(rows[q].w[2], wt),
                         bf16x2_scale(rows[q].w[3], wt));
        *reinterpret_cast<uint4*>(&terms[lane][4 * q]) = t;
      }
      __syncwarp();
      load_rows(b0 + 32, rows, wt);
      for (int j = 0; j < cnt; ++j) acc = bf16x2_add(acc, terms[j][lane]);
      __syncwarp();
    }
    if (2 * lane < c - ch0)
      store_bf16<2>(dvol + (int64_t)v * c + ch0 + 2 * lane,
                    Bf16Words<2>{{acc}});
  }
}

// 8 lanes sum voxel v, 8 channels a lane (16-byte loads; 64 a pass): each
// lane reads the voxel's entries itself (the group's lanes read the same
// ones; the next kGroupBatch are loaded while these are summed), their
// rows all loaded before the first addition. Fewer instructions an entry
// than the warp paths, where most voxels have a few dozen candidates.
__device__ __forceinline__ void sum_voxel_group8(
    const __nv_bfloat16* __restrict__ g, const float* __restrict__ coords,
    const int2* __restrict__ entries, const int* __restrict__ off,
    __nv_bfloat16* __restrict__ dvol, int v, int h, int w, int d, int c) {
  const int gl = threadIdx.x % 8;
  const int beg = off[v], end = off[v + 1];
  for (int ch0 = 0; ch0 < c; ch0 += 64) {
    const int ch = ch0 + gl * 8;
    const bool has = ch < c;
    Bf16Words<8> acc;
#pragma unroll
    for (int u = 0; u < 4; ++u) acc.w[u] = 0u;          // +0.0
    int2 e[kGroupBatch], e_next[kGroupBatch];
#pragma unroll
    for (int j = 0; j < kGroupBatch; ++j)
      e_next[j] = beg + j < end ? __ldg(entries + beg + j) : make_int2(0, 0);
    for (int b0 = beg; b0 < end; b0 += kGroupBatch) {
#pragma unroll
      for (int j = 0; j < kGroupBatch; ++j) {
        e[j] = weighted(e_next[j], coords, h, w, d);
        const int at = b0 + kGroupBatch + j;
        e_next[j] = at < end ? __ldg(entries + at) : make_int2(0, 0);
      }
      Bf16Words<8> row[kGroupBatch];
#pragma unroll
      for (int j = 0; j < kGroupBatch; ++j)
        if (has && e[j].y != 0)
          row[j] = load_bf16<8>(g + (int64_t)e[j].x * c + ch);
#pragma unroll
      for (int j = 0; j < kGroupBatch; ++j)
        if (has && e[j].y != 0)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            acc.w[u] = bf16x2_add(acc.w[u],
                                  bf16x2_scale(row[j].w[u],
                                               __int_as_float(e[j].y)));
    }
    if (has) store_bf16<8>(dvol + (int64_t)v * c + ch, acc);
  }
}

// The sum: every voxel written once. Warps [0, hot_warps) take the listed
// hot voxels first, a warp each (their long serial chains start early;
// staged in shared memory where V = 8); the rest take the other voxels in
// order, 8 lanes each where V = 8, else a warp each.
template <int V>
__global__ void __launch_bounds__(kThreads)
sample3d_gather_bwd_sum_kernel(const __nv_bfloat16* __restrict__ g,
                               const float* __restrict__ coords,
                               const int2* __restrict__ entries,
                               const int* __restrict__ off,
                               const int* __restrict__ hot_list,
                               const int* __restrict__ hot_count,
                               int hot_warps, int hot_min,
                               __nv_bfloat16* __restrict__ dvol, int n_vox,
                               int h, int w, int d, int c) {
  const int warp = (int)(((int64_t)blockIdx.x * kThreads + threadIdx.x) / 32);
  if (warp < hot_warps) {
    if (warp >= *hot_count) return;
    if constexpr (V == 8) {
      __shared__ __align__(16) uint32_t terms[kThreads / 32][32][36];
      sum_voxel_warp_staged(g, coords, entries, off, dvol, hot_list[warp], h,
                            w, d, c, terms[threadIdx.x / 32]);
    } else {
      sum_voxel_warp<V>(g, coords, entries, off, dvol, hot_list[warp], h, w,
                        d, c);
    }
    return;
  }
  const int per_warp = V == 8 ? 4 : 1;
  const int v = (warp - hot_warps) * per_warp + (int)(threadIdx.x % 32) /
                                                    (32 / per_warp);
  if (v >= n_vox || off[v + 1] - off[v] > hot_min) return;
  if constexpr (V == 8)
    sum_voxel_group8(g, coords, entries, off, dvol, v, h, w, d, c);
  else
    sum_voxel_warp<V>(g, coords, entries, off, dvol, v, h, w, d, c);
}

}  // namespace

// The plan of coords [b, n, 3] over output tiles of ty x tx voxel columns of
// the [b, h, w, d] volume: ws holds the keys [b * n] and
// tiles::workspace_ints; order [b * n], start [n_keys + 1], chunk_off and
// slot_off [n_tiles + 1], params [2].
extern "C" int vf_sample3d_bwd_plan(const float* coords, int* ws, int* order,
                                    int* start, int* chunk_off, int* slot_off,
                                    int* params, int64_t b, int64_t h,
                                    int64_t w, int64_t d, int64_t n,
                                    int64_t ty, int64_t tx, void* stream) {
  if (h < 2 || w < 2 || d < 2 || b * n >= INT32_MAX || b * n < 1)
    return (int)cudaErrorInvalidValue;
  const tiles::Grid grid{(int)b, (int)h, (int)w, (int)ty, (int)tx};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int total = (int)(b * n);
  sample3d_bwd_keys_kernel<<<tiles::ceil_div(total, 256), 256, 0, s>>>(
      coords, total, (int)d, (int)n, grid, ws);
  return tiles::plan(ws, total, grid, ws + total, order, start, chunk_off,
                     slot_off, params, tiles::max_slots(grid), s);
}

// f32 updates: g [b, n, c] f32 -> dvol [b, h, w, d, c] f32, written once;
// partial: scratch of max_slots * ceil(c / 64) partial tiles
extern "C" int vf_sample3d_trilinear_bwd(
    const float* g, const float* coords, const int* order, const int* start,
    const int* chunk_off, const int* slot_off, const int* params,
    void* partial, float* dvol, int64_t b, int64_t h, int64_t w, int64_t d,
    int64_t c, int64_t n, int64_t ty, int64_t tx, void* stream) {
  return launch<float, false>(g, coords, order, start, chunk_off, slot_off,
                              params, partial, dvol, b, h, w, d, c, n, ty,
                              tx, stream);
}

// the same with a bf16 g: f32 products and sums, dvol bf16 rounded once
extern "C" int vf_sample3d_trilinear_bwd_f32upd_bf16(
    const __nv_bfloat16* g, const float* coords, const int* order,
    const int* start, const int* chunk_off, const int* slot_off,
    const int* params, void* partial, __nv_bfloat16* dvol, int64_t b,
    int64_t h, int64_t w, int64_t d, int64_t c, int64_t n, int64_t ty,
    int64_t tx, void* stream) {
  return launch<__nv_bfloat16, false>(g, coords, order, start, chunk_off,
                                      slot_off, params, partial, dvol, b, h,
                                      w, d, c, n, ty, tx, stream);
}

// bf16 updates: g [b, n, c] f32 or bf16 (g_bf16) -> dvol in g's dtype
extern "C" int vf_sample3d_trilinear_bwd_bf16(
    const void* g, const float* coords, const int* order, const int* start,
    const int* chunk_off, const int* slot_off, const int* params,
    void* partial, void* dvol, int64_t b, int64_t h, int64_t w, int64_t d,
    int64_t c, int64_t n, int64_t ty, int64_t tx, int g_bf16, void* stream) {
  if (g_bf16)
    return launch<__nv_bfloat16, true>(
        static_cast<const __nv_bfloat16*>(g), coords, order, start,
        chunk_off, slot_off, params, partial,
        static_cast<__nv_bfloat16*>(dvol), b, h, w, d, c, n, ty, tx, stream);
  return launch<float, true>(static_cast<const float*>(g), coords, order,
                             start, chunk_off, slot_off, params, partial,
                             static_cast<float*>(dvol), b, h, w, d, c, n, ty,
                             tx, stream);
}

// the gather-bf16 backward's plan: order [b*n] (the points by base voxel,
// stable; the live ones first) and start [b*(h+1)*(w+1)*(d+1) + 1]; ws
// holds b*n keys and then tiles::workspace_ints(b*n, that key count) ints
extern "C" int vf_sample3d_gather_bwd_plan(const float* coords, int* ws,
                                           int* order, int* start, int64_t b,
                                           int64_t h, int64_t w, int64_t d,
                                           int64_t n, void* stream) {
  if (h < 1 || w < 1 || d < 1 || b * n < 1 || b * n * 8 >= INT32_MAX ||
      b * (h + 1) * (w + 1) * (d + 1) >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pts = (int)(b * n);
  const int n_keys = (int)(b * (h + 1) * (w + 1) * (d + 1));
  sample3d_gather_bwd_keys_kernel<<<tiles::ceil_div(pts, 256), 256, 0, s>>>(
      coords, pts, (int)h, (int)w, (int)d, (int)n, n_keys, ws);
  return tiles::sort_keys(ws, pts, n_keys, ws + pts, order, start, s);
}

// the gather-bf16 backward on that plan: g [b, n, c] bf16 -> dvol [b, h, w,
// d, c] bf16, every voxel written once; ws holds the voxels' candidate
// offsets [b*h*w*d + 1], the scan's ceil((b*h*w*d + 1) / 2048) sums, one
// int of padding, the candidates (point, weight) [8*b*n], the live
// points' coordinates in plan order [b*n, 3], and the hot voxels' count and
// list [1 + min(b*h*w*d, 8*b*n / 512)] (ints)
extern "C" int vf_sample3d_gather_bwd_bf16(
    const __nv_bfloat16* g, const float* coords, const int* order,
    const int* start, int* ws, __nv_bfloat16* dvol, int64_t b, int64_t h,
    int64_t w, int64_t d, int64_t c, int64_t n, void* stream) {
  if (h < 1 || w < 1 || d < 1 || c < 1 || c > (1 << 20) || n < 1 ||
      b * (h + 1) * (w + 1) * (d + 1) >= INT32_MAX || b * n * 8 >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_vox = (int)(b * h * w * d);
  // the column kernel holds bases z in a signed char: d <= 127, else every
  // voxel with a candidate takes the serial merge
  const int cap = d <= 127 ? kColumnCap : 0;
  int* off = ws;
  int* sums = off + n_vox + 1;
  const int64_t used = n_vox + 1 + tiles::ceil_div(n_vox + 1, tiles::kTile);
  int2* entries = reinterpret_cast<int2*>(ws + used + (used & 1));
  float* sq = reinterpret_cast<float*>(entries + 8 * b * n);
  // at most 8 b n candidates in all, so at most 8 b n / kHotMin hot voxels
  const int hot_warps = (int)std::min<int64_t>(n_vox, 8 * b * n / kHotMin);
  int* hot_count = reinterpret_cast<int*>(sq + 3 * b * n);
  int* hot_list = hot_count + 1;
  cudaError_t err = cudaMemsetAsync(hot_count, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  sample3d_gather_bwd_count_kernel<<<tiles::ceil_div(n_vox + 1, 256), 256, 0,
                                     s>>>(start, n_vox, (int)h, (int)w,
                                          (int)d, kHotMin, off, hot_list,
                                          hot_count);
  tiles::exclusive_scan(off, n_vox + 1, sums, s);
  const int n_keys = (int)(b * (h + 1) * (w + 1) * (d + 1));
  sample3d_gather_bwd_sorted_coords_kernel<<<tiles::ceil_div(b * n, 256), 256,
                                             0, s>>>(coords, order,
                                                     start + n_keys, sq);
  const size_t smem = column_smem((int)d, cap);
  err = cudaFuncSetAttribute(sample3d_gather_bwd_column_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  sample3d_gather_bwd_column_kernel<<<(unsigned)(b * h * w), kThreads, smem,
                                      s>>>(sq, order, start, off, entries,
                                           (int)h, (int)w, (int)d, cap);
  sample3d_gather_bwd_merge_kernel<<<tiles::ceil_div(n_vox, 128), 128, 0,
                                     s>>>(order, start, off, n_vox, (int)h,
                                          (int)w, (int)d, cap, entries);
  auto aligned = [](const void* p, int bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  auto sum = sample3d_gather_bwd_sum_kernel<1>;
  int per_warp = 1;
  if (c % 8 == 0 && aligned(g, 16) && aligned(dvol, 16)) {
    sum = sample3d_gather_bwd_sum_kernel<8>;
    per_warp = 4;
  } else if (c % 2 == 0 && aligned(g, 4) && aligned(dvol, 4)) {
    sum = sample3d_gather_bwd_sum_kernel<2>;
  }
  const int64_t warps = hot_warps + tiles::ceil_div(n_vox, per_warp);
  sum<<<tiles::ceil_div(warps * 32, kThreads), kThreads, 0, s>>>(
      g, coords, entries, off, hot_list, hot_count, hot_warps, kHotMin, dvol,
      n_vox, (int)h, (int)w, (int)d, (int)c);
  return (int)cudaGetLastError();
}
