// Backward of the back-projection sampler: grouped (kernel K2) and
// ungrouped (kernel K2b), as deterministic reductions over destination
// tiles.
//
// Replaces the TPU kernel vfdepth_tpu/ops/pallas_sample.py:301 `_bwd_kernel`
// as launched by `_bwd_call` (pallas_sample.py:497): with group_size > 0
// from the grouped backward `_pallas_backproject_grouped_bwd` (:748), K2;
// with group_size = 0 from `_pallas_sample_bwd` (:605),
// `_pallas_sample_masked_bwd` (:629) and `_pallas_backproject_bwd` (:686),
// K2b.
//
// What it computes, for every camera `cam` and every point n that its
// forward sampled for that camera (K2 and gated K2b: marked valid; ungated
// K2b: live):
//   dfeat[cam, tap pixel, c] += W_tap(n) * g[row(cam), n, c]   (c < C)
// over the 4 bilinear taps of the point, recomputed from the coordinates
// exactly as the forward computes them (backproject_taps.cuh), raw or
// normalised (kRaw). K2's row is the camera's group (b, g): each camera
// reads its group's cotangent; K2b's row is the camera's own. Only the
// first C columns of g are read: the trailing mask, rel and valid columns
// get no gradient, nor do the mask and the coordinates. The forward's
// validity gates as a select, never a multiply: a point that is not valid
// never enters the plan, so its cotangent row is never read, even where it
// is not finite. Sums are f32; dfeat is written once in f32 (the wrapper
// rounds it once to bf16 for a bf16 cotangent, as the JAX kernel's bf16
// output does, pallas_sample.py:552, :581).
//
// Design (csrc/dest_tiles.cuh): a plan sorts the (camera, point) pairs that
// add something by the pixel of their tap base (floor x, floor y, in [-1,
// W-1] x [-1, H-1]); a block of one warp owns one camera's tile of 4 x 4
// pixels and 128 channels, reads the lists of its own base pixels and of
// the halo one row above and one column to the left (25/16 of its own
// pairs), keeps its sums in shared memory (8 KB) and writes each element of
// dfeat once: no zero-fill, no atomics. The cotangent rows of the next 8
// pairs are on their way into shared memory by cp.async (tiles::warp_walk:
// no register waits on them) while the warp sums; lane l adds channels 4l
// to 4l + 3 of all 4 taps of a pair at once (4 different pixels). A copy
// is as wide as the rows' stride allows: 8-byte words for K2's C+2 rows,
// 4-byte words for K2b's odd rows of 769 (f32 and bf16), 513 and 257
// values, a bf16 row that starts between two words shifted by 2 bytes.
//
// Order, for determinism: a warp walks its tile's list in plan order and
// adds every tap of a pair before the next pair; no other warp touches the
// tile, so every output takes its additions in the plan's order: the
// result is the same, bit for bit, on every run.
//
// Hot tiles: a list longer than the plan's chunk (twice the mean list) is
// walked by several warps whose partial tiles a combine pass sums in chunk
// order: still one fixed order. The wrapper reserves the scratch for the
// most slots a plan may use (tiles::max_slots: half the tiles + 16), one
// 4 x 4 x 128 f32 partial tile per slot and channel slice: 71.6 MB for K2
// (2880 tiles, 6 slices) and 36.2 MB for K2b (1440 tiles) at the
// production shapes.
//
// What bounds it on Hopper: the walk. At the production shapes (K2: b=2, 6
// cameras of 48x80 merged features, C = 768, 200,000 voxel points; K2b: 3
// cameras with their own rows) only the rows of valid pairs are read (~1.3
// GB in f32 for K2, once per camera that sees the point, and again by the
// tiles whose halo holds it) and dfeat (141 MB / 71 MB) is written once;
// the plan is ~50 MB of int32. Each row slice is a separate 512-byte read
// at a random place, and the copies and waits, not the sums, take most of
// the time (root PERF.md, section 6).
#include <cuda_runtime.h>
#include <stdint.h>

#include "backproject_taps.cuh"
#include "dest_tiles.cuh"

namespace {

// One warp per block, one work item each: a block's shared memory is freed
// as soon as its own chunk ends (chunks range from a few pairs to the
// plan's chunk length), not when the slowest of several ends.
constexpr int kWarps = 1;
constexpr int kThreads = 32 * kWarps;
constexpr int kCS = 128;           // channels per work item: 32 lanes x 4
constexpr int kAhead = 8;          // points whose rows are copied ahead

// A (camera, point) as its tile sees it (32 bytes: two 16-byte loads).
struct __align__(16) PointRec {
  int row;                         // cotangent row: group's (K2) or own (K2b)
  int at0;                         // the tile pixel of its base (may be < 0)
  int live;                        // bit j: tap j lies in the tile and image
  int pad;
  float wt[4];                     // tap j = dx + 2 dy
};

// a warp's shared memory: its tile's sums, its walk buffer, its row slots
template <typename T>
__host__ __device__ constexpr size_t warp_bytes(int cells) {
  return cells * kCS * sizeof(float) + sizeof(tiles::WalkBuf<PointRec>) +
         (kAhead + 1) * (kCS * sizeof(T) + 16);
}

template <bool kRaw>
__global__ void backproject_bwd_keys_kernel(const float* __restrict__ coords,
                                            const float* __restrict__ valid,
                                            int total, int n, int ncols,
                                            tiles::Grid grid,
                                            int* __restrict__ keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int key = grid.n_keys();
  if (valid == nullptr || valid[i] != 0.0f) {
    const TapPoint q = tap_point<kRaw>(coords + (int64_t)i * ncols, grid.h,
                                       grid.w);
    if (q.live) key = grid.key(i / n, q.iy, q.ix);
  }
  keys[i] = key;
}

// What a warp does with a (camera, point) of its tile (tiles::warp_walk),
// its state held by value.
template <typename T, bool kRaw, int W>
struct K2Ops {
  const T* g;
  int64_t ldg, ch0;
  int avail, lane, gs, n, h, w, ty, tx, y0, x0;
  float* acc;

  __device__ __forceinline__ void make_rec(int item, const float* q,
                                           PointRec& r) const {
    const TapPoint tp = tap_point<kRaw>(q, h, w);
    const int pt = item % n;
    const int ly = tp.iy - y0, lx = tp.ix - x0;
    r.row = gs > 0 ? (item / n / gs) * n + pt : item;
    r.at0 = ly * tx + lx;
    r.wt[0] = (1.0f - tp.fx) * (1.0f - tp.fy);
    r.wt[1] = tp.fx * (1.0f - tp.fy);
    r.wt[2] = (1.0f - tp.fx) * tp.fy;
    r.wt[3] = tp.fx * tp.fy;
    int live = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int vy = ly + (j >> 1), vx = lx + (j & 1);
      if (vy >= 0 && vy < ty && vx >= 0 && vx < tx && y0 + vy < h &&
          x0 + vx < w)
        live |= 1 << j;
    }
    r.live = live;
  }

  __device__ __forceinline__ void copy_row(const PointRec& r,
                                           unsigned char* slot) const {
    const int shift = tiles::warp_copy<W>(
        slot, g + (int64_t)r.row * ldg + ch0, avail * (int)sizeof(T),
        lane);
    if (lane == 0) slot[kCS * sizeof(T) + 15] = (unsigned char)shift;
  }

  __device__ __forceinline__ void sum(const PointRec& r,
                                      const unsigned char* slot) const {
    float gv[4];
    tiles::read_row<T, 4>(slot, slot[kCS * sizeof(T) + 15] +
                                    4 * lane * (int)sizeof(T),
                          avail - 4 * lane, gv);
    const int live = r.live, at0 = r.at0;
    float4 a[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {      // 4 different pixels: loads first
      if (!(live >> j & 1)) continue;
      a[j] = reinterpret_cast<const float4*>(
          acc)[(at0 + (j >> 1) * tx + (j & 1)) * (kCS / 4) + lane];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!(live >> j & 1)) continue;
      const float wt = r.wt[j];
      a[j].x += wt * gv[0];
      a[j].y += wt * gv[1];
      a[j].z += wt * gv[2];
      a[j].w += wt * gv[3];
      reinterpret_cast<float4*>(
          acc)[(at0 + (j >> 1) * tx + (j & 1)) * (kCS / 4) + lane] = a[j];
    }
  }
};

// One warp: one chunk of one camera tile's list (a work item), 128
// channels, its lanes four channels each. The warp owns the tile: for each
// point in list order it adds the point's taps that land in the tile and
// the image (4 different pixels), so every output receives its additions
// in that order. The tile's f32 sums live in the warp's shared memory and
// are written once. W: the bytes of one cp.async of g's rows (16, 8 or 4).
template <typename T, bool kRaw, int W>
__global__ void __launch_bounds__(kThreads)
backproject_bwd_tile_kernel(const T* __restrict__ g,
                            const float* __restrict__ coords,
                            const int* __restrict__ order,
                            const int* __restrict__ start,
                            const int* __restrict__ chunk_off,
                            const int* __restrict__ slot_off,
                            const int* __restrict__ params, tiles::Grid grid,
                            int gs, int n, int ncols, int64_t c, int64_t ldg,
                            float* __restrict__ partial,
                            float* __restrict__ dfeat) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int t, chunk;
  tiles::find_work(chunk_off, grid.n_tiles(), blockIdx.x * kWarps + warp, t,
                   chunk);
  if (t < 0) return;                   // the whole warp: no block barrier
  const tiles::Runs runs(grid, start, t);
  int cam, oy, ox;
  grid.tile(t, cam, oy, ox);
  const int y0 = oy * grid.ty, x0 = ox * grid.tx;
  const int ty = grid.ty, tx = grid.tx;
  const int cells = ty * tx;
  const int slot_bytes = kCS * sizeof(T) + 16;
  float* acc = reinterpret_cast<float*>(smem + warp * warp_bytes<T>(cells));
  auto& buf = *reinterpret_cast<tiles::WalkBuf<PointRec>*>(acc + cells * kCS);
  unsigned char* rows = reinterpret_cast<unsigned char*>(&buf + 1);
  for (int i = lane; i < cells * kCS / 4; i += 32)
    reinterpret_cast<float4*>(acc)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  const int64_t ch0 = (int64_t)blockIdx.y * kCS;
  const int avail = (int)min((int64_t)kCS, c - ch0);   // channels here
  const int64_t len = params[0];
  const int v_beg = (int)min((int64_t)runs.total, chunk * len);
  const int v_end = (int)min((int64_t)runs.total, (chunk + 1) * len);

  K2Ops<T, kRaw, W> ops{g, ldg, ch0, avail, lane, gs, n, grid.h, grid.w,
                        ty, tx, y0, x0, acc};
  tiles::warp_walk<kAhead>(runs, order, coords, ncols, kRaw ? 3 : 2, v_beg,
                           v_end, buf, rows, slot_bytes, ops);
  __syncwarp();

  if (chunk_off[t + 1] - chunk_off[t] > 1) {       // a partial tile
    float4* dst = reinterpret_cast<float4*>(
        partial + ((int64_t)(slot_off[t] + chunk) * gridDim.y + blockIdx.y) *
                      cells * kCS);
    for (int i = lane; i < cells * kCS / 4; i += 32)
      dst[i] = reinterpret_cast<const float4*>(acc)[i];
    return;
  }
  for (int cell = 0; cell < cells; ++cell) {       // a pixel's 128 channels
    const int y = y0 + cell / tx, x = x0 + cell % tx;
    if (y >= grid.h || x >= grid.w) continue;
    float* o = dfeat + (((int64_t)cam * grid.h + y) * grid.w + x) * c + ch0;
    const float4 v = reinterpret_cast<const float4*>(acc)[cell * (kCS / 4) +
                                                          lane];
    const float vv[4] = {v.x, v.y, v.z, v.w};
    for (int k = 0; k < 4; ++k)
      if (4 * lane + k < c - ch0) o[4 * lane + k] = vv[k];
  }
}

// the tiles walked in two or more chunks: partial tiles summed in chunk
// order, written once
__global__ void __launch_bounds__(256)
backproject_bwd_combine_kernel(const int* __restrict__ chunk_off,
                               const int* __restrict__ slot_off,
                               tiles::Grid grid, int64_t c,
                               const float* __restrict__ partial,
                               float* __restrict__ dfeat) {
  const int t = blockIdx.x;
  const int n_chunks = chunk_off[t + 1] - chunk_off[t];
  if (n_chunks < 2) return;
  int cam, oy, ox;
  grid.tile(t, cam, oy, ox);
  const int64_t size = (int64_t)grid.ty * grid.tx * kCS;
  const float* p0 =
      partial + ((int64_t)slot_off[t] * gridDim.y + blockIdx.y) * size;
  const int64_t stride = (int64_t)gridDim.y * size;  // next chunk's slot
  for (int e = threadIdx.x; e < size; e += blockDim.x) {
    float v = p0[e];
    for (int k = 1; k < n_chunks; ++k) v += p0[k * stride + e];
    const int cell = e / kCS;
    const int y = oy * grid.ty + cell / grid.tx;
    const int x = ox * grid.tx + cell % grid.tx;
    const int64_t ch = (int64_t)blockIdx.y * kCS + e % kCS;
    if (y < grid.h && x < grid.w && ch < c)
      dfeat[(((int64_t)cam * grid.h + y) * grid.w + x) * c + ch] = v;
  }
}

template <typename T, bool kRaw>
auto tile_kernel(int wide) {
  return wide == 16  ? backproject_bwd_tile_kernel<T, kRaw, 16>
         : wide == 8 ? backproject_bwd_tile_kernel<T, kRaw, 8>
                     : backproject_bwd_tile_kernel<T, kRaw, 4>;
}

template <typename T>
int launch(const T* g, const float* coords, const int* order,
           const int* start, const int* chunk_off, const int* slot_off,
           const int* params, float* partial, float* dfeat, int64_t cams,
           int64_t gs, int64_t h, int64_t w, int64_t c, int64_t ldg,
           int64_t n, int64_t ncols, int raw, int64_t ty, int64_t tx,
           void* stream) {
  const size_t smem = kWarps * warp_bytes<T>((int)(ty * tx));
  if (ldg < c || ncols < (raw ? 3 : 2) || cams * n >= INT32_MAX ||
      ty < 1 || tx < 1 || smem > 227 * 1024 || h >= 65535 || w >= 65535)
    return (int)cudaErrorInvalidValue;
  const tiles::Grid grid{(int)cams, (int)h, (int)w, (int)ty, (int)tx};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the widest copy that every row's slice start allows
  const uintptr_t a = reinterpret_cast<uintptr_t>(g);
  const int64_t row_bytes = ldg * (int64_t)sizeof(T);
  const int wide = (a | row_bytes) % 16 == 0 ? 16
                   : (a | row_bytes) % 8 == 0 ? 8 : 4;
  auto kernel = raw ? tile_kernel<T, true>(wide) : tile_kernel<T, false>(wide);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int slices = tiles::ceil_div(c, kCS);
  kernel<<<dim3(tiles::ceil_div(tiles::max_chunks(grid), kWarps), slices),
           kThreads, smem, s>>>(g, coords, order, start, chunk_off, slot_off,
                                params, grid, (int)gs, (int)n, (int)ncols, c,
                                ldg, partial, dfeat);
  backproject_bwd_combine_kernel<<<dim3(grid.n_tiles(), slices), 256, 0,
                                   s>>>(chunk_off, slot_off, grid, c,
                                        partial, dfeat);
  return (int)cudaGetLastError();
}

}  // namespace

// The plan of the (camera, point) pairs of coords [cams, n, ncols] (raw or
// normalised), gated by valid [cams, n] (null: every live point), over
// tiles of ty x tx pixels of the [cams, h, w] map: ws holds the keys
// [cams * n] and tiles::workspace_ints; order [cams * n], start [n_keys +
// 1], chunk_off and slot_off [n_tiles + 1], params [2].
extern "C" int vf_backproject_bwd_plan(const float* coords,
                                       const float* valid, int* ws,
                                       int* order, int* start, int* chunk_off,
                                       int* slot_off, int* params,
                                       int64_t cams, int64_t h, int64_t w,
                                       int64_t n, int64_t ncols, int raw,
                                       int64_t ty, int64_t tx, void* stream) {
  if (cams * n >= INT32_MAX || cams * n < 1 || ncols < (raw ? 3 : 2))
    return (int)cudaErrorInvalidValue;
  const tiles::Grid grid{(int)cams, (int)h, (int)w, (int)ty, (int)tx};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int total = (int)(cams * n), blocks = tiles::ceil_div(total, 256);
  if (raw)
    backproject_bwd_keys_kernel<true><<<blocks, 256, 0, s>>>(
        coords, valid, total, (int)n, (int)ncols, grid, ws);
  else
    backproject_bwd_keys_kernel<false><<<blocks, 256, 0, s>>>(
        coords, valid, total, (int)n, (int)ncols, grid, ws);
  return tiles::plan(ws, total, grid, ws + total, order, start, chunk_off,
                     slot_off, params, tiles::max_slots(grid), s);
}

// K2: g [b, 2, n, ldg] (the forward output's cotangent, ldg >= c), coords
// [b*2*gs, n, 3] and its plan -> dfeat [b*2*gs, h, w, c] f32, written once;
// partial: scratch of max_slots * ceil(c / 256) partial tiles
extern "C" int vf_backproject_grouped_bwd(
    const float* g, const float* coords, const int* order, const int* start,
    const int* chunk_off, const int* slot_off, const int* params,
    float* partial, float* dfeat, int64_t b, int64_t gs, int64_t h,
    int64_t w, int64_t c, int64_t ldg, int64_t n, int raw, int64_t ty,
    int64_t tx, void* stream) {
  if (gs < 1) return (int)cudaErrorInvalidValue;
  return launch(g, coords, order, start, chunk_off, slot_off, params,
                partial, dfeat, b * 2 * gs, gs, h, w, c, ldg, n, 3, raw, ty,
                tx, stream);
}

// K2's bf16 form: g bf16; coords and dfeat f32
extern "C" int vf_backproject_grouped_bwd_bf16(
    const __nv_bfloat16* g, const float* coords, const int* order,
    const int* start, const int* chunk_off, const int* slot_off,
    const int* params, float* partial, float* dfeat, int64_t b, int64_t gs,
    int64_t h, int64_t w, int64_t c, int64_t ldg, int64_t n, int raw,
    int64_t ty, int64_t tx, void* stream) {
  if (gs < 1) return (int)cudaErrorInvalidValue;
  return launch(g, coords, order, start, chunk_off, slot_off, params,
                partial, dfeat, b * 2 * gs, gs, h, w, c, ldg, n, 3, raw, ty,
                tx, stream);
}

// K2b: g [B, n, ldg] (ldg >= c), coords [B, n, ncols] and its plan ->
// dfeat [B, h, w, c] f32, written once
extern "C" int vf_sample2d_bwd(const float* g, const float* coords,
                               const int* order, const int* start,
                               const int* chunk_off, const int* slot_off,
                               const int* params, float* partial,
                               float* dfeat, int64_t B, int64_t h, int64_t w,
                               int64_t c, int64_t ldg, int64_t n,
                               int64_t ncols, int raw, int64_t ty,
                               int64_t tx, void* stream) {
  return launch(g, coords, order, start, chunk_off, slot_off, params,
                partial, dfeat, B, 0, h, w, c, ldg, n, ncols, raw, ty, tx,
                stream);
}

// K2b's bf16 form: g bf16; coords and dfeat f32
extern "C" int vf_sample2d_bwd_bf16(
    const __nv_bfloat16* g, const float* coords, const int* order,
    const int* start, const int* chunk_off, const int* slot_off,
    const int* params, float* partial, float* dfeat, int64_t B, int64_t h,
    int64_t w, int64_t c, int64_t ldg, int64_t n, int64_t ncols, int raw,
    int64_t ty, int64_t tx, void* stream) {
  return launch(g, coords, order, start, chunk_off, slot_off, params,
                partial, dfeat, B, 0, h, w, c, ldg, n, ncols, raw, ty, tx,
                stream);
}
