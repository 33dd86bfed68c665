"""The backward kernels K4 and K2/K2b as their CUDA forms sum, in plain
PyTorch on the CPU: each output tile walks the plan's lists
(``vfdepth_tpu_torch/ops/dest_tiles.py``) chunk by chunk, adds every tap
that lands in the tile in list order, and sums the chunks' partial tiles in
chunk order. Imports no JAX: ``tests/test_torch_backward_plan.py`` holds
these models against the plain versions on the CPU, and
``tests/test_torch_kernels_cuda.py`` holds the kernels against them on the
card.

The bf16-update form's tap planes round every addition to bf16, one
addition at a time, as the kernel does (``index_add_`` on a bf16 tensor
accumulates in f32 and rounds once, which is the plain version's
behaviour); f32 sums use ``index_add_``, which adds in index order.
"""
import torch

from vfdepth_tpu_torch.ops import backproject_sample as bp
from vfdepth_tpu_torch.ops import dest_tiles
from vfdepth_tpu_torch.ops import sample3d as s3


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _tile_origin(grid: dest_tiles.Grid, t: int):
    img = t // (grid.nty * grid.ntx)
    oy, ox = (t // grid.ntx) % grid.nty, t % grid.ntx
    return img, oy * grid.ty, ox * grid.tx


def fold_planes(p: torch.Tensor) -> torch.Tensor:
    """[..., 8, C] planes indexed by the voxel their tap lands on -> the
    f32 sum in ``_packed_bwd``'s fold order."""
    return (((p[..., 0, :] + p[..., 4, :]) + (p[..., 2, :] + p[..., 6, :]))
            + ((p[..., 1, :] + p[..., 5, :]) + (p[..., 3, :] + p[..., 7, :])))


def k4_in_plan_order(g: torch.Tensor, coords: torch.Tensor, vol_shape,
                     bf16_updates: bool, plan=None) -> torch.Tensor:
    """K4 (f32 updates, or bf16 updates) summed as its CUDA form sums:
    dvol [B, H, W, D, C] in g's dtype."""
    nb, h, w, d, c = vol_shape
    grid = s3._grid(vol_shape, bf16_updates)
    if plan is None:
        plan = s3.sample3d_bwd_plan_plain(coords, vol_shape, bf16_updates)
    crd = coords.reshape(-1, 3).cpu()
    gg = g.reshape(-1, c).float().cpu()
    offs = torch.tensor(s3._tap_offsets(w, d))
    out = torch.zeros(nb, h, w, d, c)
    for t in range(grid.n_tiles):
        img, y0, x0 = _tile_origin(grid, t)
        parts = []
        for items in dest_tiles.tile_items(plan, grid, t):
            base, wts = s3._point_taps(crd[items], h, w, d)
            vox = base[:, None] + offs                      # [n, 8]
            wt = torch.stack(wts, 1)
            vy, vx = vox // (w * d), (vox // d) % w
            keep = ((wt != 0) & (vy >= y0) & (vy < y0 + grid.ty)
                    & (vx >= x0) & (vx < x0 + grid.tx))
            prod = wt[..., None] * gg[items][:, None, :]     # [n, 8, C]
            if bf16_updates:
                acc = torch.zeros(h * w * d, 8, c)
                taps = torch.arange(8)
                for i in range(len(items)):      # one bf16 addition at a time
                    k = taps[keep[i]]
                    v = vox[i, k]
                    acc[v, k] = _bf16(acc[v, k] + _bf16(prod[i, k]))
            else:
                acc = torch.zeros(h * w * d, c)
                acc.index_add_(0, vox[keep], prod[keep])
            parts.append(acc)
        total = parts[0]
        for part in parts[1:]:
            total = _bf16(total + part) if bf16_updates else total + part
        if bf16_updates:
            total = fold_planes(total)
        vol = total.reshape(h, w, d, c)
        ys, xs = slice(y0, y0 + grid.ty), slice(x0, x0 + grid.tx)
        out[img, ys, xs] = vol[ys, xs]
    return out.to(g.dtype)


def k2_in_plan_order(g: torch.Tensor, coords: torch.Tensor, valid, h: int,
                     w: int, c: int, group_size: int,
                     raw: bool) -> torch.Tensor:
    """K2 (``group_size`` > 0: each camera reads its group's row of g [b,
    2, N, ldg]) or K2b (0: its own row of g [cams, N, ldg]) summed as the
    CUDA form sums: dfeat [cams, h, w, C] f32."""
    cams, n, ncols = coords.shape
    grid = dest_tiles.Grid(cams, h, w, *bp.K2_TILE)
    plan = bp.backproject_bwd_plan_plain(coords, valid, h, w, raw)
    rows = g[..., :c].reshape(-1, c).float()
    crd = coords.reshape(-1, ncols)
    out = torch.zeros(cams, h, w, c)
    for t in range(grid.n_tiles):
        cam, y0, x0 = _tile_origin(grid, t)
        parts = []
        for items in dest_tiles.tile_items(plan, grid, t):
            _, ix, iy, fx, fy = bp._taps(crd[items], h, w, raw)
            pt = items % n
            row = (items // n // group_size) * n + pt if group_size else items
            cells, vals = [], []
            for dx, dy, wt in ((0, 0, (1 - fx) * (1 - fy)),
                               (1, 0, fx * (1 - fy)), (0, 1, (1 - fx) * fy),
                               (1, 1, fx * fy)):
                cells.append((iy + dy, ix + dx))
                vals.append(wt)
            ty_ = torch.stack([cy for cy, _ in cells], 1)     # [n, 4]
            tx_ = torch.stack([cx for _, cx in cells], 1)
            wt = torch.stack(vals, 1)
            keep = ((ty_ >= y0) & (ty_ < min(y0 + grid.ty, h)) & (tx_ >= x0)
                    & (tx_ < min(x0 + grid.tx, w)))
            acc = torch.zeros(h * w, c)
            acc.index_add_(0, (ty_ * w + tx_)[keep],
                           (wt[..., None] * rows[row][:, None, :])[keep])
            parts.append(acc)
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        img = total.reshape(h, w, c)
        ys, xs = slice(y0, y0 + grid.ty), slice(x0, x0 + grid.tx)
        out[cam, ys, xs] = img[ys, xs]
    return out


def gather_bwd_in_plan_order(g: torch.Tensor, coords: torch.Tensor,
                             vol_shape) -> torch.Tensor:
    """The gather-bf16 backward as its CUDA form sums, one tap at a time:
    the live taps (weight != 0) sorted by (voxel, item) with Python's
    ``sorted``, each voxel's bf16 sum taking its updates in that order,
    each update ``g * w`` formed in f32 and rounded once, each addition
    rounded to bf16. For small sizes (a Python loop over the taps)."""
    nb, h, w, d, c = vol_shape
    wts, keys = s3._gather_bwd_items(coords, vol_shape)
    n_keys = nb * h * w * d
    g_rows = g.reshape(-1, c).float()
    acc = torch.zeros(n_keys, c)
    for key, item in sorted((int(k), i) for i, k in enumerate(keys.tolist())
                            if k < n_keys):
        upd = _bf16(g_rows[item // 8] * wts[item])
        acc[key] = _bf16(acc[key] + upd)
    return acc.to(torch.bfloat16).reshape(tuple(vol_shape))


def gather_voxel_candidates(order: torch.Tensor, start: torch.Tensor,
                            vol_shape):
    """The gather-bf16 reduce's merge on the CPU: from the plan (order,
    start) of ``sample3d_gather_bwd_plan`` (each base voxel's live points
    in point order), each voxel's candidates, the points of the 8 bases
    v - (dx, dy, dz) merged by point, as items point * 8 + tap (tap dx +
    2 dy + 4 dz) -> {voxel: [items]}, voxels with none left out."""
    nb, h, w, d, _ = vol_shape
    order, start = order.long().tolist(), start.long().tolist()
    out = {}
    for img in range(nb):
        for y in range(h):
            for x in range(w):
                for z in range(d):
                    items = []
                    for t in range(8):
                        dx, dy, dz = t & 1, (t >> 1) & 1, t >> 2
                        k = (((img * (h + 1) + y - dy + 1) * (w + 1) + x - dx
                              + 1) * (d + 1) + z - dz + 1)
                        items += [p * 8 + t
                                  for p in order[start[k]:start[k + 1]]]
                    if items:
                        v = ((img * h + y) * w + x) * d + z
                        out[v] = sorted(items, key=lambda i: i // 8)
    return out
