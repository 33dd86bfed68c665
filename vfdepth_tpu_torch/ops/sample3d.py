"""Trilinear frustum sampler (kernel K3) and its backward (kernel K4, in
three forms).

Port of ``vfdepth_tpu/ops/sample3d_packed.py grid_sample_3d_packed(vol,
coords, grad_dtype, "yxz")`` (:257). Forward: the XLA oct build + row gather
+ the TPU combine kernel ``_combine_kernel`` (:101, launched by
``_combine_taps`` :117) become ONE direct 8-tap gather kernel,
``csrc/sample3d.cu``, for an f32 or a bf16 volume (bf16 rows combined in
f32, the output rounded once to bf16, as ``_combine_kernel`` does).
Backward: the TPU update kernel ``_updates_kernel`` (:146, launched by
``_build_updates`` :161) + the XLA scatter and fold (``_packed_bwd``,
:305-340) become ``csrc/sample3d_bwd.cu``, in the form ``grad_dtype`` names:

* f32 updates (``packed_f32grad``; ``sample3d_trilinear_bwd``): f32
  products and f32 sums, dvol in g's dtype; g may be f32 or bf16 (mixed
  precision: the tap products are formed in f32 from the bf16 cotangent,
  summed in f32 and dvol is rounded once to bf16); its plain version sums
  the f32 tap planes and folds them as the bf16-update form's does;
* bf16 updates (``packed``; ``sample3d_trilinear_bwd_bf16``): each tap
  product w_t(n) * g[n] formed in f32 and rounded once to bf16, summed in
  bf16 per tap plane ``acc[b, base(n), t, c]``, then the 8 planes folded
  back into the volume in f32 (dz first, then dx, then dy) and rounded once
  to g's dtype. g may be f32 (an f32 config with ``sampler_3d: packed``) or
  bf16 (mixed precision).

Both CUDA forms are deterministic reductions over destination tiles
(``csrc/dest_tiles.cuh``): ``sample3d_bwd_plan`` sorts the live frustum
points by the voxel column of their base, and each block sums the points
that reach its tile of columns in the plan's order and writes its outputs
once. ``sample3d_bwd_plan_plain`` is the same plan in plain PyTorch.

``Sample3dTrilinear`` ties a forward to a backward as one autograd
Function; only the volume gets a gradient.

Semantics: align_corners=True, zeros padding; per axis the base is clamped
to [0, size-2] and both tap weights are rederived from the clamp offset
(``_kernel_axis_weights``), so every tap read is in bounds; non-finite
coordinates give zeros. Taps combine in the TPU kernel's order (tap t =
dz*4 + dx*2 + dy: dy fastest, dz slowest).

``sampler_3d: gather`` under mixed precision is not a TPU kernel in the
JAX package but its plain XLA gather ``grid_sample_3d`` on the bf16 volume
and the scatter of its VJP ``_gs3d_bwd`` (``vfdepth_tpu/ops/
grid_sample.py``). ``Sample3dGather`` ties their two CUDA forms together:
``sample3d_gather`` (``csrc/sample3d.cu``) in JAX's literal bf16
arithmetic, with per-tap validity and no base clamp, and
``sample3d_gather_bwd`` (``csrc/sample3d_bwd.cu``), each update rounded
once to bf16 and summed into the bf16 voxel in item order, every addition
rounded; each has a plain version with the same roundings and order.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, dest_tiles

_POINT_CHUNK = 1 << 18   # plain version: points per gather
# K4's output tiles, (y, x) voxel columns at full depth, one per block: 4 x 4
# for f32 updates (80 KB of f32 sums at depth 20 and 64 channels), 2 x 2 for
# bf16 updates (the 8 bf16 tap planes of each voxel, 80 KB)
K4_TILES = {False: (4, 4), True: (2, 2)}
_BLOCK_CHANNELS = 64     # csrc/sample3d_bwd.cu kCS
_DTYPES = (torch.float32, torch.bfloat16)
_GATHER_HOT_MIN = 512    # csrc/sample3d_bwd.cu kHotMin


def _axis_weights(coord: torch.Tensor, size: int):
    """Per-axis clamped base and the two tap weights (``_kernel_axis_weights``).
    The clamp of p to [-2, size+1] only keeps the int cast defined: any p
    outside [-1, size] already gives two zero weights."""
    p = torch.clamp((coord + 1.0) * 0.5 * (size - 1), -2.0, size + 1.0)
    p0 = torch.floor(p)
    t = p - p0
    i0 = p0.long()
    base = torch.clamp(i0, 0, size - 2)
    off = i0 - base
    is0 = (off == 0).to(coord.dtype)
    ism1 = (off == -1).to(coord.dtype)
    isp1 = (off == 1).to(coord.dtype)
    return base, (1 - t) * is0 + t * ism1, t * is0 + (1 - t) * isp1


def _point_taps(crd: torch.Tensor, h: int, w: int, d: int):
    """Points [n, 3] -> (flat base voxel [n] of the yxz volume, the 8 tap
    weights [n] in tap order)."""
    finite = torch.isfinite(crd).all(dim=-1, keepdim=True)
    crd = torch.where(finite, crd, -4.0)
    xb, wx0, wx1 = _axis_weights(crd[:, 0], w)
    yb, wy0, wy1 = _axis_weights(crd[:, 1], h)
    zb, wz0, wz1 = _axis_weights(crd[:, 2], d)
    wts = [wz0 * wx0 * wy0, wz0 * wx0 * wy1,
           wz0 * wx1 * wy0, wz0 * wx1 * wy1,
           wz1 * wx0 * wy0, wz1 * wx0 * wy1,
           wz1 * wx1 * wy0, wz1 * wx1 * wy1]
    return (yb * w + xb) * d + zb, wts


def _tap_offsets(w: int, d: int):
    """Flat row offset of tap t = dz*4 + dx*2 + dy from its base voxel."""
    return [(t & 1) * w * d + ((t >> 1) & 1) * d + ((t >> 2) & 1)
            for t in range(8)]


def sample3d_trilinear_plain(vol: torch.Tensor,
                             coords: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version with explicit gathers.

    vol [B, H(y), W(x), D(z), C] f32 or bf16; coords [B, N, 3] (x, y, z) in
    [-1, 1]. Returns [B, N, C] in vol's dtype (taps combined in f32).
    Chunks the points to bound its memory on the card.
    """
    nb, h, w, d, c = vol.shape
    n = coords.shape[1]
    rows = vol.reshape(nb, h * w * d, c)
    out = vol.new_empty(nb, n, c)
    offs = _tap_offsets(w, d)
    for b in range(nb):
        for s in range(0, n, _POINT_CHUNK):
            base, wts = _point_taps(coords[b, s:s + _POINT_CHUNK], h, w, d)
            acc = rows[b, base + offs[0]].float() * wts[0][:, None]
            for t in range(1, 8):
                acc = acc + rows[b, base + offs[t]].float() * wts[t][:, None]
            out[b, s:s + _POINT_CHUNK] = acc
    return out


_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_FWD_ARGS = [_P] * 3 + [_I64] * 6 + [_P]


def _check_volume(h: int, w: int, d: int) -> None:
    if min(h, w, d) < 2:
        raise ValueError(f"every volume axis needs >= 2 samples: {(h, w, d)}")


def _check_cuda(tensors) -> None:
    for name, t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"unsupported device {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def sample3d_trilinear(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of a yxz volume [B, H, W, D, C] (f32 or bf16) at
    coords [B, N, 3] (f32) -> [B, N, C] in vol's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel of
    vol's dtype (``sample3d_trilinear.launches`` counts the f32 form's
    launches, ``.launches_bf16`` the bf16 form's) or raise.
    """
    if vol.dim() != 5 or coords.dim() != 3 or coords.shape[-1] != 3 \
            or coords.shape[0] != vol.shape[0]:
        raise ValueError(f"expected vol [B, H, W, D, C] and coords [B, N, 3], "
                         f"got {tuple(vol.shape)} and {tuple(coords.shape)}")
    nb, h, w, d, c = vol.shape
    _check_volume(h, w, d)
    if vol.dtype not in _DTYPES:
        raise TypeError(f"vol must be float32 or bfloat16, got {vol.dtype}")
    if coords.dtype != torch.float32:
        raise TypeError(f"coords must be float32, got {coords.dtype}")
    if coords.device != vol.device:
        raise ValueError(f"coords on {coords.device}, vol on {vol.device}")
    if vol.device.type == "cpu":
        return sample3d_trilinear_plain(vol, coords)
    _check_cuda((("vol", vol), ("coords", coords)))
    bf16 = vol.dtype == torch.bfloat16
    n = coords.shape[1]
    out = torch.empty(nb, n, c, device=vol.device, dtype=vol.dtype)
    fn = _build.function("sample3d", "vf_sample3d_trilinear_bf16" if bf16
                         else "vf_sample3d_trilinear", _FWD_ARGS)
    with torch.cuda.device(vol.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(vol.data_ptr(), coords.data_ptr(), out.data_ptr(), nb, h, w,
                 d, c, n, stream)
    if err != 0:
        raise RuntimeError(f"sample3d_trilinear launch failed: CUDA error {err}")
    if bf16:
        sample3d_trilinear.launches_bf16 += 1
    else:
        sample3d_trilinear.launches += 1
    return out


sample3d_trilinear.launches = 0
sample3d_trilinear.launches_bf16 = 0


def _check_bwd(g: torch.Tensor, coords: torch.Tensor, vol_shape) -> None:
    nb, h, w, d, c = vol_shape
    if g.dim() != 3 or coords.dim() != 3 or g.shape[0] != nb \
            or g.shape[2] != c or coords.shape != (nb, g.shape[1], 3):
        raise ValueError(f"shape mismatch: g {tuple(g.shape)}, coords "
                         f"{tuple(coords.shape)}, volume {tuple(vol_shape)}")
    _check_volume(h, w, d)
    if coords.dtype != torch.float32:
        raise TypeError(f"coords must be float32, got {coords.dtype}")
    if coords.device != g.device:
        raise ValueError(f"coords on {coords.device}, g on {g.device}")


def sample3d_trilinear_bwd_plain(g: torch.Tensor, coords: torch.Tensor,
                                 vol_shape) -> torch.Tensor:
    """Plain PyTorch version of the f32-update backward kernel, in
    ``_packed_bwd``'s own order: f32 products summed into f32 tap planes,
    then ``fold_tap_planes``. g [B, N, C] f32 or bf16, coords [B, N, 3] ->
    dvol ``vol_shape`` = [B, H, W, D, C] in g's dtype; a bf16 result is the
    f32 sum JAX's is, rounded once, so the two agree exactly where no two
    points share a base voxel (the kernel sums each voxel's taps in its
    plan's order)."""
    return _tap_plane_bwd_plain(g, coords, vol_shape, torch.float32)


def _grid(vol_shape, bf16_updates: bool) -> dest_tiles.Grid:
    nb, h, w, _, _ = vol_shape
    return dest_tiles.Grid(nb, h, w, *K4_TILES[bf16_updates])


def sample3d_bwd_keys(coords: torch.Tensor, vol_shape,
                      bf16_updates: bool) -> torch.Tensor:
    """Each point's plan key (``csrc/dest_tiles.cuh``): the (y, x) column of
    its base voxel in its frameset; dead (``n_keys``) where all 8 weights
    are 0. coords [B, N, 3] -> [B * N] int64."""
    nb, h, w, d, _ = vol_shape
    grid = _grid(vol_shape, bf16_updates)
    keys = []
    for b in range(nb):
        base, wts = _point_taps(coords[b], h, w, d)
        live = torch.stack(wts).ne(0).any(0)
        yb, xb = base // (w * d), (base // d) % w
        keys.append(grid.keys(torch.full_like(yb, b), yb, xb, live))
    return torch.cat(keys)


def sample3d_bwd_plan_plain(coords: torch.Tensor, vol_shape,
                            bf16_updates: bool = False) -> dest_tiles.Plan:
    """K4's plan of the points coords [B, N, 3] in plain PyTorch (bincount,
    cumsum, stable argsort), on coords' device."""
    return dest_tiles.plan_plain(sample3d_bwd_keys(coords, vol_shape,
                                                   bf16_updates),
                                 _grid(vol_shape, bf16_updates))


def sample3d_bwd_plan(coords: torch.Tensor, vol_shape,
                      bf16_updates: bool = False) -> dest_tiles.Plan:
    """K4's plan built on the card (``vf_sample3d_bwd_plan``): equal, element
    for element, to ``sample3d_bwd_plan_plain``. coords [B, N, 3] f32 on a
    CUDA device."""
    _check_cuda((("coords", coords),))
    nb, h, w, d, _ = vol_shape
    _check_volume(h, w, d)
    grid = _grid(vol_shape, bf16_updates)
    n = coords.shape[1]
    plan, ws = dest_tiles.new_plan(nb * n, grid, coords.device)
    fn = _build.function("sample3d_bwd", "vf_sample3d_bwd_plan",
                         [_P] * 7 + [_I64] * 7 + [_P])
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(coords.data_ptr(), *dest_tiles.plan_pointers(plan, ws), nb,
                 h, w, d, n, grid.ty, grid.tx, stream)
    if err != 0:
        raise RuntimeError(f"sample3d_bwd_plan launch failed: CUDA error {err}")
    return plan


_BWD_ARGS = [_P] * 9 + [_I64] * 8


def _bwd_launch(g, coords, vol_shape, bf16_updates: bool,
                plan: dest_tiles.Plan) -> torch.Tensor:
    """The tiled kernel of the form that g's dtype and ``bf16_updates`` name,
    on ``plan``, which must be ``sample3d_bwd_plan(coords, vol_shape,
    bf16_updates)`` -> dvol in g's dtype, written once. The scratch for cut
    tiles is sized for the plan's most slots (``Grid.max_slots``): 52.5 MB
    for f32 updates and 206 MB for bf16 updates at the production shapes."""
    nb, h, w, d, c = vol_shape
    grid = _grid(vol_shape, bf16_updates)
    dest_tiles.check_plan(plan, grid, nb * g.shape[1], g.device)
    bf16_g = g.dtype == torch.bfloat16
    if bf16_updates:
        fn_name, extra = "vf_sample3d_trilinear_bwd_bf16", (int(bf16_g),)
    else:
        fn_name, extra = ("vf_sample3d_trilinear_bwd_f32upd_bf16" if bf16_g
                          else "vf_sample3d_trilinear_bwd"), ()
    cell = _BLOCK_CHANNELS * (16 if bf16_updates else 4)
    slices = -(-c // _BLOCK_CHANNELS)
    partial = torch.empty(grid.max_slots * slices * grid.ty * grid.tx * d
                          * cell, dtype=torch.uint8, device=g.device)
    dvol = torch.empty(tuple(vol_shape), device=g.device, dtype=g.dtype)
    fn = _build.function("sample3d_bwd", fn_name,
                         _BWD_ARGS + [_I] * len(extra) + [_P])
    p = plan
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(g.data_ptr(), coords.data_ptr(), p.order.data_ptr(),
                 p.start.data_ptr(), p.chunk_off.data_ptr(),
                 p.slot_off.data_ptr(), p.params.data_ptr(),
                 partial.data_ptr(), dvol.data_ptr(), nb, h, w, d, c,
                 g.shape[1], grid.ty, grid.tx, *extra, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")
    return dvol


def sample3d_trilinear_bwd(g: torch.Tensor, coords: torch.Tensor,
                           vol_shape) -> torch.Tensor:
    """Volume gradient of ``sample3d_trilinear`` with f32 updates: g [B, N,
    C] float32 or bfloat16 (its output's cotangent) and coords [B, N, 3] ->
    dvol [B, H, W, D, C] in g's dtype (a bf16 g is widened, its products
    summed in f32 and the sum rounded once).

    CPU tensors take the plain version; CUDA tensors build the plan
    (``sample3d_bwd_plan``) and launch the kernel of g's dtype
    (``sample3d_trilinear_bwd.launches`` counts the f32 form's launches,
    ``.launches_bf16`` those with a bf16 g) or raise.
    """
    _check_bwd(g, coords, vol_shape)
    if g.dtype not in _DTYPES:
        raise TypeError(f"g must be float32 or bfloat16, got {g.dtype}")
    if g.device.type == "cpu":
        return sample3d_trilinear_bwd_plain(g, coords, vol_shape)
    _check_cuda((("g", g), ("coords", coords)))
    bf16 = g.dtype == torch.bfloat16
    dvol = _bwd_launch(g, coords, vol_shape, False,
                       sample3d_bwd_plan(coords, vol_shape))
    if bf16:
        sample3d_trilinear_bwd.launches_bf16 += 1
    else:
        sample3d_trilinear_bwd.launches += 1
    return dvol


sample3d_trilinear_bwd.launches = 0
sample3d_trilinear_bwd.launches_bf16 = 0


def _shift_from_lower(a: torch.Tensor, dim: int) -> torch.Tensor:
    """out[i] = a[i - 1] along ``dim``, 0 at i = 0 (``_shift_fwd``): the sum
    a tap plane holds at base i belongs to the voxel at i + 1."""
    pad = torch.zeros_like(a.narrow(dim, 0, 1))
    return torch.cat([pad, a.narrow(dim, 0, a.shape[dim] - 1)], dim=dim)


def fold_tap_planes(acc: torch.Tensor) -> torch.Tensor:
    """The 8 tap planes acc [B, H, W, D, 8, C] (bf16 sums) -> the volume
    gradient [B, H, W, D, C] in f32, folded as ``_packed_bwd`` does: dz
    first, then dx, then dy, each stage adding the plane at the base to the
    one shifted in from the lower neighbour."""
    a = acc.float()
    x4 = a[..., 0:4, :] + _shift_from_lower(a[..., 4:8, :], 3)   # dz
    x2 = x4[..., 0:2, :] + _shift_from_lower(x4[..., 2:4, :], 2)  # dx
    return x2[..., 0, :] + _shift_from_lower(x2[..., 1, :], 1)    # dy


def _tap_plane_bwd_plain(g: torch.Tensor, coords: torch.Tensor, vol_shape,
                         acc_dtype: torch.dtype) -> torch.Tensor:
    """``_packed_bwd`` in plain PyTorch: each tap product formed in f32 and
    rounded once to ``acc_dtype``, ``index_add_``-ed into its tap plane of
    that dtype, then ``fold_tap_planes`` and one rounding to g's dtype."""
    nb, h, w, d, c = vol_shape
    n = coords.shape[1]
    acc = g.new_zeros(nb, 8, h * w * d, c, dtype=acc_dtype)
    for b in range(nb):
        for s in range(0, n, _POINT_CHUNK):
            base, wts = _point_taps(coords[b, s:s + _POINT_CHUNK], h, w, d)
            gg = g[b, s:s + _POINT_CHUNK].float()
            for t in range(8):
                acc[b, t].index_add_(0, base, (gg * wts[t][:, None]).to(
                    acc_dtype))
    planes = acc.reshape(nb, 8, h, w, d, c).permute(0, 2, 3, 4, 1, 5)
    return fold_tap_planes(planes).to(g.dtype)


def sample3d_trilinear_bwd_bf16_plain(g: torch.Tensor, coords: torch.Tensor,
                                      vol_shape) -> torch.Tensor:
    """Plain PyTorch version of the bf16-update backward kernel: each tap
    product formed in f32, rounded once to bf16 and ``index_add_``-ed into
    its bf16 tap plane, then ``fold_tap_planes`` and one rounding to g's
    dtype. g [B, N, C] f32 or bf16, coords [B, N, 3] -> dvol ``vol_shape``
    in g's dtype. ``index_add_`` into a bf16 plane accumulates each call
    in f32 and rounds once, where the kernel rounds every addition (as
    XLA's scatter does): the two agree bit for bit where every plane entry
    takes one addition (distinct base voxels), to a bound elsewhere."""
    return _tap_plane_bwd_plain(g, coords, vol_shape, torch.bfloat16)


def sample3d_trilinear_bwd_bf16(g: torch.Tensor, coords: torch.Tensor,
                                vol_shape) -> torch.Tensor:
    """Volume gradient of ``sample3d_trilinear`` with bf16 updates (the JAX
    package's ``grid_sample_3d_packed(..., "bf16")``): g [B, N, C] float32
    or bfloat16 and coords [B, N, 3] -> dvol [B, H, W, D, C] in g's dtype.

    CPU tensors take the plain version; CUDA tensors build the plan
    (``sample3d_bwd_plan(coords, vol_shape, True)``) and launch the kernel
    (``sample3d_trilinear_bwd_bf16.launches`` counts launches) or raise.
    Each block keeps the bf16 tap planes of its 2 x 2 voxel columns
    in shared memory; nothing is zeroed in device memory.
    """
    _check_bwd(g, coords, vol_shape)
    if g.dtype not in _DTYPES:
        raise TypeError(f"g must be float32 or bfloat16, got {g.dtype}")
    if g.device.type == "cpu":
        return sample3d_trilinear_bwd_bf16_plain(g, coords, vol_shape)
    _check_cuda((("g", g), ("coords", coords)))
    dvol = _bwd_launch(g, coords, vol_shape, True,
                       sample3d_bwd_plan(coords, vol_shape, True))
    sample3d_trilinear_bwd_bf16.launches += 1
    return dvol


sample3d_trilinear_bwd_bf16.launches = 0


class Sample3dTrilinear(torch.autograd.Function):
    """``sample3d_trilinear`` (K3) forward, K4 backward with bf16 updates
    (``bf16_updates``) or f32 ones (of an f32 or a bf16 cotangent);
    ``plain`` runs the plain versions on any device."""

    @staticmethod
    def forward(ctx, vol, coords, plain: bool = False,
                bf16_updates: bool = False):
        fwd = sample3d_trilinear_plain if plain else sample3d_trilinear
        out = fwd(vol, coords)
        ctx.save_for_backward(coords)
        ctx.args = (tuple(vol.shape), plain, bf16_updates)
        return out

    @staticmethod
    def backward(ctx, g):
        (coords,) = ctx.saved_tensors
        vol_shape, plain, bf16_updates = ctx.args
        if bf16_updates:
            bwd = (sample3d_trilinear_bwd_bf16_plain if plain
                   else sample3d_trilinear_bwd_bf16)
        else:
            bwd = (sample3d_trilinear_bwd_plain if plain
                   else sample3d_trilinear_bwd)
        return bwd(g.contiguous(), coords, vol_shape), None, None, None


# --------------------------------------------------------------------------
# 'gather' under mixed precision: JAX's plain XLA trilinear gather and
# scatter on a bf16 volume (vfdepth_tpu/ops/grid_sample.py grid_sample_3d
# :188-235 and its custom VJP _gs3d_bwd :165-184), not a TPU kernel.

def _gather_axis(coord: torch.Tensor, size: int):
    """Per axis of ``grid_sample_3d``: the f32 fraction of the pixel
    coordinate and its floor as an index, clamped to [-2, size + 1] (a
    floor outside [-1, size] makes both taps invalid either way, and the
    clamp keeps the int cast defined)."""
    p = (coord + 1.0) * 0.5 * (size - 1)
    p0 = torch.floor(p)
    return p - p0, torch.clamp(p0, -2.0, size + 1.0).long()


def _gather_taps(crd: torch.Tensor, h: int, w: int, d: int):
    """Points [n, 3] (x, y, z) -> per axis (f32 fraction, floor index);
    non-finite points become -2.0 on every axis, as JAX's do."""
    finite = torch.isfinite(crd).all(dim=-1, keepdim=True)
    crd = torch.where(finite, crd, -2.0)
    return (_gather_axis(crd[:, 0], w), _gather_axis(crd[:, 1], h),
            _gather_axis(crd[:, 2], d))


def _gather_tap_index(ix, iy, iz, dx, dy, dz, h, w, d):
    """(valid, flat yxz voxel index, clipped where not valid) of one tap."""
    x, y, z = ix + dx, iy + dy, iz + dz
    valid = ((x >= 0) & (x < w) & (y >= 0) & (y < h) & (z >= 0) & (z < d))
    idx = ((y.clamp(0, h - 1) * w + x.clamp(0, w - 1)) * d
           + z.clamp(0, d - 1))
    return valid, idx


# JAX's tap order: (dx, dy, dz) = 000, 100, 010, 110, 001, 101, 011, 111
_GATHER_TAPS = [(dx, dy, dz) for dz in (0, 1) for dy in (0, 1)
                for dx in (0, 1)]


def sample3d_gather_plain(vol: torch.Tensor,
                          coords: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the gather-bf16 forward: ``grid_sample_3d``
    on a bf16 yxz volume [B, H, W, D, C] at coords [B, N, 3] f32 -> [B, N,
    C] bf16, in JAX's literal bf16 arithmetic: the fractions rounded to
    bf16, ``1 - w`` and each product of three weights rounded, zeros
    padding by per-tap validity (no base clamp; an invalid tap reads its
    clipped voxel times 0), ``vals * w`` rounded, the 8 taps summed in
    JAX's order, each addition rounded."""
    nb, h, w, d, c = vol.shape
    n = coords.shape[1]
    rows = vol.reshape(nb, h * w * d, c)
    out = vol.new_empty(nb, n, c)
    for b in range(nb):
        for s in range(0, n, _POINT_CHUNK):
            axes = _gather_taps(coords[b, s:s + _POINT_CHUNK], h, w, d)
            wts = [f.to(torch.bfloat16) for f, _ in axes]
            pairs = [(1 - wt, wt) for wt in wts]
            (ix, iy, iz) = (i for _, i in axes)
            acc = None
            for dx, dy, dz in _GATHER_TAPS:
                wgt = pairs[0][dx] * pairs[1][dy] * pairs[2][dz]
                valid, idx = _gather_tap_index(ix, iy, iz, dx, dy, dz, h, w,
                                               d)
                term = rows[b, idx] * (wgt * valid.to(wgt.dtype))[:, None]
                acc = term if acc is None else acc + term
            out[b, s:s + _POINT_CHUNK] = acc
    return out


def sample3d_gather(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """The gather-bf16 forward (``sample3d_gather_plain``'s function):
    vol [B, H, W, D, C] bf16, coords [B, N, 3] f32 -> [B, N, C] bf16.

    CPU tensors take the plain version; CUDA tensors launch
    ``vf_sample3d_gather_bf16`` (``sample3d_gather.launches_bf16`` counts
    its launches) or raise.
    """
    if vol.dim() != 5 or coords.dim() != 3 or coords.shape[-1] != 3 \
            or coords.shape[0] != vol.shape[0]:
        raise ValueError(f"expected vol [B, H, W, D, C] and coords [B, N, 3], "
                         f"got {tuple(vol.shape)} and {tuple(coords.shape)}")
    nb, h, w, d, c = vol.shape
    if vol.dtype != torch.bfloat16:
        raise TypeError(f"vol must be bfloat16, got {vol.dtype}")
    if coords.dtype != torch.float32:
        raise TypeError(f"coords must be float32, got {coords.dtype}")
    if coords.device != vol.device:
        raise ValueError(f"coords on {coords.device}, vol on {vol.device}")
    if vol.device.type == "cpu":
        return sample3d_gather_plain(vol, coords)
    _check_cuda((("vol", vol), ("coords", coords)))
    n = coords.shape[1]
    out = torch.empty(nb, n, c, device=vol.device, dtype=vol.dtype)
    fn = _build.function("sample3d", "vf_sample3d_gather_bf16", _FWD_ARGS)
    with torch.cuda.device(vol.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(vol.data_ptr(), coords.data_ptr(), out.data_ptr(), nb, h, w,
                 d, c, n, stream)
    if err != 0:
        raise RuntimeError(f"sample3d_gather launch failed: CUDA error {err}")
    sample3d_gather.launches_bf16 += 1
    return out


sample3d_gather.launches_bf16 = 0


def _gather_bwd_items(coords: torch.Tensor, vol_shape):
    """``_trilinear_taps`` (grid_sample.py:111-143) of every point: the f32
    weight of each tap (0 where the tap is not valid) and its plan key,
    the voxel index in the batch's volumes (n_keys = B*H*W*D where the
    weight is 0: the tap adds nothing). Items are tap t of point n of
    frameset b at b*N*8 + n*8 + t, t in JAX's order -> (weights [B*N*8]
    f32, keys [B*N*8] int64)."""
    nb, h, w, d, _ = vol_shape
    n = coords.shape[1]
    n_vox = h * w * d
    wts = torch.empty(nb, n, 8, dtype=torch.float32, device=coords.device)
    keys = torch.empty(nb, n, 8, dtype=torch.int64, device=coords.device)
    for b in range(nb):
        for s in range(0, n, _POINT_CHUNK):
            (fx, ix), (fy, iy), (fz, iz) = _gather_taps(
                coords[b, s:s + _POINT_CHUNK], h, w, d)
            pairs = [(1 - f, f) for f in (fx, fy, fz)]
            for t, (dx, dy, dz) in enumerate(_GATHER_TAPS):
                valid, idx = _gather_tap_index(ix, iy, iz, dx, dy, dz, h, w,
                                               d)
                wgt = (pairs[0][dx] * pairs[1][dy] * pairs[2][dz]
                       * valid.to(torch.float32))
                wts[b, s:s + _POINT_CHUNK, t] = wgt
                keys[b, s:s + _POINT_CHUNK, t] = torch.where(
                    wgt != 0, b * n_vox + idx, nb * n_vox)
    return wts.reshape(-1), keys.reshape(-1)


def gather_bwd_base_keys(coords: torch.Tensor, vol_shape):
    """Each point's key in the gather-bf16 backward's plan: its base voxel
    (the floors of its coordinates, each >= -1 where a tap has weight !=
    0) in the [B, H + 1, W + 1, D + 1] grid of bases, ``n_keys`` (that
    grid's size) where all 8 of its ``_trilinear_taps`` weights are 0 ->
    (keys [B*N] int64, n_keys)."""
    nb, h, w, d, _ = vol_shape
    n = coords.shape[1]
    n_keys = nb * (h + 1) * (w + 1) * (d + 1)
    wts, _ = _gather_bwd_items(coords, vol_shape)
    live = wts.reshape(nb, n, 8).ne(0).any(-1)
    keys = torch.empty(nb, n, dtype=torch.int64, device=coords.device)
    for b in range(nb):
        for s in range(0, n, _POINT_CHUNK):
            (_, ix), (_, iy), (_, iz) = _gather_taps(
                coords[b, s:s + _POINT_CHUNK], h, w, d)
            keys[b, s:s + _POINT_CHUNK] = (
                ((b * (h + 1) + iy + 1) * (w + 1) + ix + 1) * (d + 1) + iz + 1)
    return torch.where(live, keys, n_keys).reshape(-1), n_keys


def sample3d_gather_bwd_plan_plain(coords: torch.Tensor, vol_shape):
    """The gather-bf16 backward's plan in plain PyTorch: (order, start) of
    ``dest_tiles.sort_plain`` over the points' base keys
    (``gather_bwd_base_keys``), int32 on coords' device: each base's live
    points in point order. Voxel v's taps in item order are the points of
    the 8 bases v - (dx, dy, dz) merged by point (a point puts at most one
    tap on a voxel), tap t = dx + 2 dy + 4 dz from base v - (dx, dy, dz)."""
    keys, n_keys = gather_bwd_base_keys(coords, vol_shape)
    order, start = dest_tiles.sort_plain(keys, n_keys)
    return order.int(), start.int()


def sample3d_gather_bwd_plain(g: torch.Tensor, coords: torch.Tensor,
                              vol_shape) -> torch.Tensor:
    """Plain PyTorch version of the gather-bf16 backward, ``_gs3d_bwd`` on a
    bf16 cotangent: g [B, N, C] bf16, coords [B, N, 3] -> dvol
    ``vol_shape`` bf16. Each update ``g * w`` is formed in f32 and rounded
    once to bf16; each voxel sums its updates into bf16 in the plan's order
    (item order: point, then tap), every addition rounded; zero-weight taps
    add nothing and are dropped. The additions run rank by rank: the r-th
    update of every voxel that has one, for r = 0, 1, ..."""
    nb, h, w, d, c = vol_shape
    n_keys = nb * h * w * d
    wts, keys = _gather_bwd_items(coords, vol_shape)
    order, start = dest_tiles.sort_plain(keys, n_keys)
    counts = start[1:] - start[:-1]
    g_rows = g.reshape(-1, c)
    acc = torch.zeros(n_keys, c, dtype=torch.bfloat16, device=g.device)
    active = torch.nonzero(counts).reshape(-1)
    r = 0
    while active.numel():
        item = order[start[active] + r]
        upd = (g_rows[item // 8].float() * wts[item][:, None]).to(
            torch.bfloat16)
        acc[active] = (acc[active].float() + upd.float()).to(torch.bfloat16)
        r += 1
        active = active[counts[active] > r]
    return acc.reshape(tuple(vol_shape))


def sample3d_gather_bwd_plan(coords: torch.Tensor, vol_shape):
    """The gather-bf16 backward's plan built on the card
    (``vf_sample3d_gather_bwd_plan``): (order [B*N], start [B*(H+1)*(W+1)*
    (D+1) + 1]) int32, equal element for element to
    ``sample3d_gather_bwd_plan_plain``. coords [B, N, 3] f32 on a CUDA
    device."""
    _check_cuda((("coords", coords),))
    nb, h, w, d, _ = vol_shape
    n = coords.shape[1]
    pts, n_keys = nb * n, nb * (h + 1) * (w + 1) * (d + 1)
    if 8 * pts >= 2 ** 31 or n_keys >= 2 ** 31:
        raise ValueError(f"gather-bf16 backward: {pts} points or {n_keys} "
                         f"bases exceed the plan's int32 indices")
    ints = dict(dtype=torch.int32, device=coords.device)
    order = torch.empty(pts, **ints)
    start = torch.empty(n_keys + 1, **ints)
    blocks = -(-pts // 2048)
    ws = torch.empty(5 * pts + 256 * blocks + -(-256 * blocks // 2048),
                     **ints)
    fn = _build.function("sample3d_bwd", "vf_sample3d_gather_bwd_plan",
                         [_P] * 4 + [_I64] * 5 + [_P])
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(coords.data_ptr(), ws.data_ptr(), order.data_ptr(),
                 start.data_ptr(), nb, h, w, d, n, stream)
    if err != 0:
        raise RuntimeError(f"sample3d_gather_bwd_plan launch failed: CUDA "
                           f"error {err}")
    return order, start


def _gather_bwd_launch(g, coords, vol_shape, order, start) -> torch.Tensor:
    """The gather-bf16 backward's reduce on the plan (order, start) of
    ``sample3d_gather_bwd_plan(coords, vol_shape)`` -> dvol bf16, each
    voxel written once. Its scratch holds each voxel's candidates, the
    points of the 8 bases that reach it merged by point, with their tap
    weights (at most 8 a point), and the points' coordinates in plan order:
    175 MB at the production shapes, batch 2."""
    nb, h, w, d, c = vol_shape
    n = g.shape[1]
    n_vox = nb * h * w * d
    if order.shape != (nb * n,) \
            or start.shape != (nb * (h + 1) * (w + 1) * (d + 1) + 1,) \
            or order.dtype != torch.int32 or start.dtype != torch.int32:
        raise ValueError("the plan does not fit the cotangent and volume")
    dvol = torch.empty(tuple(vol_shape), device=g.device, dtype=g.dtype)
    ws = torch.empty(n_vox + 3 + -(-(n_vox + 1) // 2048) + 19 * nb * n
                     + min(n_vox, 8 * nb * n // _GATHER_HOT_MIN),
                     dtype=torch.int32, device=g.device)
    fn = _build.function("sample3d_bwd", "vf_sample3d_gather_bwd_bf16",
                         [_P] * 6 + [_I64] * 6 + [_P])
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(g.data_ptr(), coords.data_ptr(), order.data_ptr(),
                 start.data_ptr(), ws.data_ptr(), dvol.data_ptr(), nb, h, w,
                 d, c, n, stream)
    if err != 0:
        raise RuntimeError(f"vf_sample3d_gather_bwd_bf16 launch failed: CUDA "
                           f"error {err}")
    return dvol


def sample3d_gather_bwd(g: torch.Tensor, coords: torch.Tensor,
                        vol_shape) -> torch.Tensor:
    """Volume gradient of ``sample3d_gather``
    (``sample3d_gather_bwd_plain``'s function): g [B, N, C] bf16,
    coords [B, N, 3] f32 -> dvol [B, H, W, D, C] bf16.

    CPU tensors take the plain version; CUDA tensors build the plan
    (``sample3d_gather_bwd_plan``) and launch the kernel
    (``sample3d_gather_bwd.launches_bf16`` counts launches) or raise.
    """
    _check_bwd(g, coords, vol_shape)
    if g.dtype != torch.bfloat16:
        raise TypeError(f"g must be bfloat16, got {g.dtype}")
    if g.device.type == "cpu":
        return sample3d_gather_bwd_plain(g, coords, vol_shape)
    _check_cuda((("g", g), ("coords", coords)))
    dvol = _gather_bwd_launch(g, coords, vol_shape,
                              *sample3d_gather_bwd_plan(coords, vol_shape))
    sample3d_gather_bwd.launches_bf16 += 1
    return dvol


sample3d_gather_bwd.launches_bf16 = 0


class Sample3dGather(torch.autograd.Function):
    """``sampler_3d: gather`` on a bf16 volume: the gather-bf16 forward and
    backward (``plain`` runs their plain versions on any device); only
    the volume gets a gradient."""

    @staticmethod
    def forward(ctx, vol, coords, plain: bool = False):
        if vol.dtype != torch.bfloat16:
            raise TypeError(f"Sample3dGather takes a bf16 volume, got "
                            f"{vol.dtype}")
        fwd = sample3d_gather_plain if plain else sample3d_gather
        out = fwd(vol, coords)
        ctx.save_for_backward(coords)
        ctx.args = (tuple(vol.shape), plain)
        return out

    @staticmethod
    def backward(ctx, g):
        (coords,) = ctx.saved_tensors
        vol_shape, plain = ctx.args
        bwd = (sample3d_gather_bwd_plain if plain
               else sample3d_gather_bwd)
        return bwd(g.contiguous(), coords, vol_shape), None, None
