// Backward of the trilinear frustum sampler (kernel K4), in its three
// forms, as deterministic reductions over destination tiles.
//
// Replaces the TPU kernel vfdepth_tpu/ops/sample3d_packed.py:146
// `_updates_kernel` (launched by `_build_updates`, :161) TOGETHER with the
// XLA scatter and three-axis fold behind it (`_packed_bwd`, :305-340): its
// `packed_f32grad` form (f32 updates: vf_sample3d_trilinear_bwd, and
// vf_sample3d_trilinear_bwd_f32upd_bf16 for a bf16 cotangent under mixed
// precision) and its `packed` form (bf16 updates:
// vf_sample3d_trilinear_bwd_bf16).
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
