"""Back-projection sampler: grouped (kernel K1) and ungrouped (kernel K1b)
forward, and their backward kernels (K2, K2b).

Port of ``vfdepth_tpu/ops/pallas_sample.py``: the forward TPU kernel
``_fwd_kernel`` :176, launched by ``_fwd_call_grouped`` :431 (grouped) and
``_fwd_call`` :382 (ungrouped), is ``csrc/backproject_sample.cu``; the
backward TPU kernel ``_bwd_kernel`` :301 launched by ``_bwd_call`` :497 is
``csrc/backproject_sample_bwd.cu``. Their headers say what bounds them and
how they are laid out; the tap rule they share is
``csrc/backproject_taps.cuh``.

The JAX package's public entries have counterparts here of the same name
without ``_pallas``: ``sample_bilinear``, ``sample_bilinear_with_nearest_mask``,
``sample_backproject``, ``sample_backproject_raw``,
``sample_backproject_grouped`` and ``sample_backproject_grouped_raw``. Each
is an autograd Function over a kernel wrapper (``backproject_grouped`` for
K1, ``sample2d`` for K1b; backward ``backproject_grouped_bwd`` (K2) and
``sample2d_bwd`` (K2b)); only the features get a gradient.

Semantics, per point and camera:

* raw camera-plane point (u, v, z): x = u / (z + 1e-8), y = v / (z + 1e-8);
  NaN -> 2w, then clip to +-2w on both axes; live iff z > 0 and the
  align-corners pixel lies in [0, w-1] x [0, h-1];
* normalised point (x, y), align corners: non-finite -> pixel -4 (dead);
  pixel = (c + 1) * (0.5 * (size - 1)); live iff floor(x) lies in [-1, w-1]
  and floor(y) in [-1, h-1];
* bilinear feature sample, zeros padding per tap;
* nearest mask pick where an f32 fraction > 0.5 takes the upper tap (NOT
  round-half-even), 0 where the picked tap leaves the image; valid = live
  and picked mask > 0.5;
* back-projection epilogue [feat * valid, rel * valid(, valid)] with rel =
  z * rel_scale (raw) or the third coordinate column (normalised); an
  invalid point gives exact zeros, even where its depth is not finite (XLA
  simplifies the JAX kernel's ``rel * valid`` to a select, and the port
  keeps that). K1 sums it over each camera group (cameras ordered
  group-major) and also returns each camera's validity.

Backward: dfeat[cam, tap pixel] += W_tap * g[row, point, :C] for every point
the forward sampled for that camera (the validity is a select: an invalid
point adds nothing), where the row is the camera's group (K2) or the camera
itself (K2b); the trailing mask, rel and valid columns of the cotangent, the
mask and the coordinates get no gradient. Both backward kernels are
deterministic reductions over destination tiles (``csrc/dest_tiles.cuh``):
``backproject_bwd_plan`` sorts the (camera, point) pairs that add something
by the pixel of their tap base, and each block sums the pairs that reach its
4 x 4 pixels of one camera in the plan's order and writes them once;
``backproject_bwd_plan_plain`` is the same plan in plain PyTorch.

Every kernel has a bf16 form (mixed precision): bf16 features in and
group sums (K1) or rows (K1b) out, a bf16 cotangent in and a bf16 feature
gradient out (K2, K2b); taps, weights and sums stay f32 and each output is
rounded once. Masks, coordinates and the per-camera validity stay f32.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, dest_tiles

_POINT_CHUNK = 32768   # plain versions: points per gather (bounds memory)
MAX_GROUP_SIZE = 8     # csrc/backproject_sample.cu kMaxGroup
MODES = ("bilinear", "mask", "backproject")   # K1b's modes, kernel order
K2_TILE = (4, 4)       # K2 / K2b output tiles: 4 x 4 pixels of one camera
_K2_CHANNELS = 128     # csrc/backproject_sample_bwd.cu kCS


def _taps(q: torch.Tensor, h: int, w: int, raw: bool):
    """Points [n, 2-3] -> (live, ix0, iy0, fx, fy); ix0 and iy0 are long,
    0 where the point is dead."""
    if raw:
        z = q[:, 2]
        zp = z + 1e-8
        big = 2.0 * w
        x = torch.clamp(torch.nan_to_num(q[:, 0] / zp, nan=big, posinf=big,
                                         neginf=-big), -big, big)
        y = torch.clamp(torch.nan_to_num(q[:, 1] / zp, nan=big, posinf=big,
                                         neginf=-big), -big, big)
        live = ((z > 0) & (x >= 0) & (x <= w - 1.0) & (y >= 0)
                & (y <= h - 1.0))
        x0, y0 = torch.floor(x), torch.floor(y)
    else:
        finite = torch.isfinite(q[:, 0]) & torch.isfinite(q[:, 1])
        x = torch.where(finite, (q[:, 0] + 1.0) * (0.5 * (w - 1)), -4.0)
        y = torch.where(finite, (q[:, 1] + 1.0) * (0.5 * (h - 1)), -4.0)
        x0, y0 = torch.floor(x), torch.floor(y)
        # compared as floats: a huge coordinate never reaches the long cast
        live = (x0 >= -1) & (x0 <= w - 1) & (y0 >= -1) & (y0 <= h - 1)
    ix = torch.where(live, x0, 0.0).long()
    iy = torch.where(live, y0, 0.0).long()
    return live, ix, iy, x - x0, y - y0


def _rel(q: torch.Tensor, raw: bool, rel_scale: float) -> torch.Tensor:
    return q[:, 2] * rel_scale if raw else q[:, 2]


def _tap_rows(keep, ix, iy, fx, fy, h: int, w: int):
    """The 4 bilinear taps of the kept points: [(in image, flat pixel index
    (0 where not), weight)]."""
    taps = []
    for dx, dy, wt in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                       (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
        tx, ty = ix + dx, iy + dy
        inb = keep & (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
        taps.append((inb, torch.where(inb, ty * w + tx, 0), wt))
    return taps


def _gather(img: torch.Tensor, taps) -> torch.Tensor:
    """img [h*w, C] sampled at the taps -> [n, C] (taps summed in order)."""
    acc = None
    for inb, idx, wt in taps:
        v = torch.where(inb[:, None], img[idx], 0.0) * wt[:, None]
        acc = v if acc is None else acc + v
    return acc


def _scatter(dfeat: torch.Tensor, g: torch.Tensor, taps) -> None:
    """dfeat [h*w, C] += each tap's weight times g [n, C] (``index_add_``)."""
    for inb, idx, wt in taps:
        dfeat.index_add_(0, idx, torch.where(inb[:, None], g, 0.0)
                         * wt[:, None])


def _nearest(msk: torch.Tensor, live, ix, iy, fx, fy, h: int, w: int):
    """msk [h*w] at each live point's nearest tap, 0 where that tap leaves
    the image."""
    xn = ix + (fx > 0.5).long()
    yn = iy + (fy > 0.5).long()
    ok = live & (xn >= 0) & (xn < w) & (yn >= 0) & (yn < h)
    return torch.where(ok, msk[torch.where(ok, yn * w + xn, 0)], 0.0)


def _check(tensors, dtype_device_of: torch.Tensor,
           bf16: tuple = ()) -> None:
    """float32 tensors on one device; the names in ``bf16`` may also be
    bfloat16 (the kernels' bf16 forms)."""
    for name, t in tensors:
        ok = (torch.float32, torch.bfloat16) if name in bf16 else (
            torch.float32,)
        if t.dtype not in ok:
            raise TypeError(f"{name} must be "
                            f"{' or '.join(map(str, ok))}, got {t.dtype}")
        if t.device != dtype_device_of.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{dtype_device_of.device}")


def _cuda_ready(tensors) -> None:
    for name, t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"unsupported device {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(fn_name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")


_P, _I64, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float


# ------------------------------------------------------ the backward plan

def backproject_bwd_keys(coords: torch.Tensor, valid: Optional[torch.Tensor],
                         h: int, w: int, raw: bool) -> torch.Tensor:
    """Each (camera, point)'s plan key (``csrc/dest_tiles.cuh``): the tile
    of its tap base pixel (floor x, floor y) in its camera's map; dead
    (``n_keys``) where it is not live or not valid. coords [cams, N, 2-3],
    valid [cams, N] or None -> [cams * N] int64."""
    cams, n = coords.shape[:2]
    grid = dest_tiles.Grid(cams, h, w, *K2_TILE)
    keys = []
    for cam in range(cams):
        for s in range(0, n, _POINT_CHUNK):
            sl = slice(s, s + _POINT_CHUNK)
            live, ix, iy, _, _ = _taps(coords[cam, sl], h, w, raw)
            if valid is not None:
                live = live & (valid[cam, sl] != 0)
            keys.append(grid.keys(torch.full_like(ix, cam), iy, ix, live))
    return torch.cat(keys)


def backproject_bwd_plan_plain(coords: torch.Tensor,
                               valid: Optional[torch.Tensor], h: int, w: int,
                               raw: bool = True) -> dest_tiles.Plan:
    """K2's / K2b's plan in plain PyTorch (bincount, cumsum, stable
    argsort), on coords' device."""
    return dest_tiles.plan_plain(
        backproject_bwd_keys(coords, valid, h, w, raw),
        dest_tiles.Grid(coords.shape[0], h, w, *K2_TILE))


def backproject_bwd_plan(coords: torch.Tensor, valid: Optional[torch.Tensor],
                         h: int, w: int, raw: bool = True) -> dest_tiles.Plan:
    """K2's / K2b's plan built on the card (``vf_backproject_bwd_plan``):
    equal, element for element, to ``backproject_bwd_plan_plain``. coords
    [cams, N, 2-3] and valid [cams, N] (or None) f32 on a CUDA device."""
    args = [("coords", coords)] + ([] if valid is None else [("valid",
                                                              valid)])
    _cuda_ready(args)
    cams, n, ncols = coords.shape
    grid = dest_tiles.Grid(cams, h, w, *K2_TILE)
    plan, ws = dest_tiles.new_plan(cams * n, grid, coords.device)
    fn = _build.function("backproject_sample_bwd", "vf_backproject_bwd_plan",
                         [_P] * 8 + [_I64] * 5 + [_I] + [_I64] * 2 + [_P])
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(coords.data_ptr(), 0 if valid is None else valid.data_ptr(),
                 *dest_tiles.plan_pointers(plan, ws), cams, h, w, n, ncols,
                 int(raw), *K2_TILE, stream)
    _launch("backproject_bwd_plan", err)
    return plan


def _bwd_launch(g, coords, valid, raw: bool, h: int, w: int, c: int,
                lead: tuple, plan: dest_tiles.Plan) -> torch.Tensor:
    """The tiled kernel of the form that ``lead`` and g's dtype name, on
    ``plan``, which must be ``backproject_bwd_plan(coords, valid, h, w,
    raw)`` -> dfeat [cams, h, w, c] f32, written once. ``lead``: the C
    entry's arguments before h (K2: b, group size; K2b: the camera count);
    after c it takes ldg and N, then (K2b) the coordinate columns. The
    scratch for cut tiles is sized for the plan's most slots
    (``Grid.max_slots``): 71.6 MB for K2 and 36.2 MB for K2b at the
    production shapes."""
    cams, n, ncols = coords.shape
    grid = dest_tiles.Grid(cams, h, w, *K2_TILE)
    dest_tiles.check_plan(plan, grid, cams * n, g.device)
    fn_name = ("vf_backproject_grouped_bwd" if len(lead) == 2
               else "vf_sample2d_bwd") + (
                   "_bf16" if g.dtype == torch.bfloat16 else "")
    slices = -(-c // _K2_CHANNELS)
    partial = torch.empty(grid.max_slots * slices * grid.ty * grid.tx
                          * _K2_CHANNELS, device=g.device)
    dfeat = torch.empty(cams, h, w, c, device=g.device)
    tail = (ncols,) if len(lead) == 1 else ()
    fn = _build.function("backproject_sample_bwd", fn_name,
                         [_P] * 9 + [_I64] * 7 + [_I] + [_I64] * 2 + [_P])
    p = plan
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(g.data_ptr(), coords.data_ptr(), p.order.data_ptr(),
                 p.start.data_ptr(), p.chunk_off.data_ptr(),
                 p.slot_off.data_ptr(), p.params.data_ptr(),
                 partial.data_ptr(), dfeat.data_ptr(), *lead, h, w, c,
                 g.shape[-1], n, *tail, int(raw), *K2_TILE, stream)
    _launch(fn_name, err)
    return dfeat


# ---------------------------------------------------------------- K1 / K2

def backproject_grouped_plain(feats: torch.Tensor, mask: torch.Tensor,
                              coords: torch.Tensor, rel_scale: float,
                              batch: int, group_size: int, raw: bool = True):
    """Plain PyTorch version of K1, written with explicit gathers.

    feats [b*2*gs, h, w, C] f32 or bf16 (cameras group-major), mask
    [b*2*gs, h, w], coords [b*2*gs, N, 3] (raw (u, v, z) or normalised (x,
    y, rel)). Returns (out [b, 2, N, C+2] in feats' dtype, valid [b*2*gs,
    N] f32). Loops over cameras and chunks the points so it fits in a few
    GB at the production shapes; group sums are taken in f32 in camera
    order, as the kernel does, and rounded once.
    """
    bc, h, w, c = feats.shape
    n = coords.shape[1]
    out = feats.new_zeros(batch, 2, n, c + 2, dtype=torch.float32)
    valid_pc = feats.new_zeros(bc, n, dtype=torch.float32)
    for cam in range(bc):
        bi, g = divmod(cam // group_size, 2)
        img = feats[cam].reshape(h * w, c).float()
        msk = mask[cam].reshape(h * w)
        for s in range(0, n, _POINT_CHUNK):
            q = coords[cam, s:s + _POINT_CHUNK]
            live, ix, iy, fx, fy = _taps(q, h, w, raw)
            valid = live & (_nearest(msk, live, ix, iy, fx, fy, h, w) > 0.5)
            feat = _gather(img, _tap_rows(valid, ix, iy, fx, fy, h, w))
            # invalid points contribute exact zeros (a select, so a
            # non-finite depth behind the camera leaves no NaN behind)
            rel = torch.where(valid, _rel(q, raw, rel_scale), 0.0)
            vf = valid.float()
            out[bi, g, s:s + _POINT_CHUNK] += torch.cat(
                [feat, rel[:, None], vf[:, None]], dim=-1)
            valid_pc[cam, s:s + _POINT_CHUNK] = vf
    return out.to(feats.dtype), valid_pc


def backproject_grouped(feats: torch.Tensor, mask: torch.Tensor,
                        coords: torch.Tensor, rel_scale: float, batch: int,
                        group_size: int, raw: bool = True):
    """K1: group-reduced back-projection.

    feats [b*2*gs, h, w, C] float32 or bfloat16 with cameras PRE-ORDERED
    group-major (group 0's gs cameras, then group 1's), mask [b*2*gs, h, w]
    (the low-res occlusion mask), coords [b*2*gs, N, 3]: raw camera-plane
    points (u, v, z) before the perspective divide, or (``raw=False``)
    normalised (x, y) plus the rel-depth column. Returns (out [b, 2, N,
    C+2] in feats' dtype = group sums of [feat*valid, rel*valid, valid],
    valid [b*2*gs, N] f32 per camera).

    CPU tensors take the plain version; CUDA tensors launch the kernel of
    feats' dtype (``backproject_grouped.launches`` counts the f32 form's
    launches, ``.launches_bf16`` the bf16 form's) or raise.
    """
    bc, h, w, c = feats.shape
    n = coords.shape[1]
    if bc != batch * 2 * group_size or group_size < 1:
        raise ValueError(f"feats has {bc} cameras, expected "
                         f"batch*2*group_size = {batch}*2*{group_size}")
    if mask.shape != (bc, h, w) or coords.shape != (bc, n, 3):
        raise ValueError(f"shape mismatch: feats {tuple(feats.shape)}, mask "
                         f"{tuple(mask.shape)}, coords {tuple(coords.shape)}")
    args = (("feats", feats), ("mask", mask), ("coords", coords))
    _check(args, feats, bf16=("feats",))
    if feats.device.type == "cpu":
        return backproject_grouped_plain(feats, mask, coords, rel_scale,
                                         batch, group_size, raw)
    _cuda_ready(args)
    if group_size > MAX_GROUP_SIZE:
        raise ValueError(f"group_size {group_size} > {MAX_GROUP_SIZE}")
    bf16 = feats.dtype == torch.bfloat16
    out = torch.empty(batch, 2, n, c + 2, device=feats.device,
                      dtype=feats.dtype)
    valid = torch.empty(bc, n, device=feats.device)
    fn = _build.function("backproject_sample", "vf_backproject_grouped_bf16"
                         if bf16 else "vf_backproject_grouped",
                         [_P] * 5 + [_I64] * 6 + [_F, _I, _P])
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(feats.data_ptr(), mask.data_ptr(), coords.data_ptr(),
                 out.data_ptr(), valid.data_ptr(), batch, group_size, h, w, c,
                 n, float(rel_scale), int(raw), stream)
    _launch("backproject_grouped", err)
    if bf16:
        backproject_grouped.launches_bf16 += 1
    else:
        backproject_grouped.launches += 1
    return out, valid


backproject_grouped.launches = 0
backproject_grouped.launches_bf16 = 0


def backproject_grouped_bwd_plain(g: torch.Tensor, coords: torch.Tensor,
                                  valid: torch.Tensor, h: int, w: int, c: int,
                                  group_size: int,
                                  raw: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K2 (``index_add_``).

    g [b, 2, N, >= C] f32 or bf16 (the forward output's cotangent; columns
    past C are ignored), coords [b*2*gs, N, 3], valid [b*2*gs, N] ->
    dfeats [b*2*gs, h, w, C] in g's dtype (summed in f32, rounded once).
    """
    bc, n = valid.shape
    dfeat = g.new_zeros(bc, h * w, c, dtype=torch.float32)
    for cam in range(bc):
        bi, grp = divmod(cam // group_size, 2)
        for s in range(0, n, _POINT_CHUNK):
            sl = slice(s, s + _POINT_CHUNK)
            live, ix, iy, fx, fy = _taps(coords[cam, sl], h, w, raw)
            sel = live & (valid[cam, sl] != 0)
            _scatter(dfeat[cam], g[bi, grp, sl, :c].float(),
                     _tap_rows(sel, ix, iy, fx, fy, h, w))
    return dfeat.reshape(bc, h, w, c).to(g.dtype)


def backproject_grouped_bwd(g: torch.Tensor, coords: torch.Tensor,
                            valid: torch.Tensor, h: int, w: int, c: int,
                            group_size: int, raw: bool = True) -> torch.Tensor:
    """K2, the feature gradient of ``backproject_grouped``: g [b, 2, N, >=
    C] float32 or bfloat16 (its output's cotangent), coords [b*2*gs, N, 3]
    and valid [b*2*gs, N] (its per-camera validity) -> dfeats [b*2*gs, h,
    w, C] in g's dtype (the bf16 form adds in f32 and rounds once).

    CPU tensors take the plain version; CUDA tensors build the plan
    (``backproject_bwd_plan``) and launch the kernel of g's dtype
    (``backproject_grouped_bwd.launches`` counts the f32 form's launches,
    ``.launches_bf16`` the bf16 form's) or raise.
    """
    bc, n = valid.shape
    if g.dim() != 4 or g.shape[1] != 2 or g.shape[2] != n or g.shape[3] < c \
            or bc != g.shape[0] * 2 * group_size or coords.shape != (bc, n, 3):
        raise ValueError(f"shape mismatch: g {tuple(g.shape)}, coords "
                         f"{tuple(coords.shape)}, valid {tuple(valid.shape)}, "
                         f"C={c}, group_size={group_size}")
    args = (("g", g), ("coords", coords), ("valid", valid))
    _check(args, g, bf16=("g",))
    if g.device.type == "cpu":
        return backproject_grouped_bwd_plain(g, coords, valid, h, w, c,
                                             group_size, raw)
    _cuda_ready(args)
    if group_size > MAX_GROUP_SIZE:
        raise ValueError(f"group_size {group_size} > {MAX_GROUP_SIZE}")
    bf16 = g.dtype == torch.bfloat16
    dfeat = _bwd_launch(g, coords, valid, raw, h, w, c,
                        (g.shape[0], group_size),
                        backproject_bwd_plan(coords, valid, h, w, raw))
    if bf16:
        backproject_grouped_bwd.launches_bf16 += 1
        return dfeat.to(torch.bfloat16)
    backproject_grouped_bwd.launches += 1
    return dfeat


backproject_grouped_bwd.launches = 0
backproject_grouped_bwd.launches_bf16 = 0


class BackprojectGrouped(torch.autograd.Function):
    """``backproject_grouped`` (K1) forward, K2 backward; ``plain`` runs
    both plain versions on any device. Returns (out, valid) as the forward
    does; only ``feats`` gets a gradient."""

    @staticmethod
    def forward(ctx, feats, mask, coords, rel_scale: float, batch: int,
                group_size: int, raw: bool = True, plain: bool = False):
        fwd = backproject_grouped_plain if plain else backproject_grouped
        out, valid = fwd(feats, mask, coords, rel_scale, batch, group_size,
                         raw)
        ctx.save_for_backward(coords, valid)
        ctx.args = (feats.shape[1], feats.shape[2], feats.shape[3],
                    group_size, raw, plain)
        ctx.mark_non_differentiable(valid)
        return out, valid

    @staticmethod
    def backward(ctx, g_out, _g_valid):
        coords, valid = ctx.saved_tensors
        h, w, c, gs, raw, plain = ctx.args
        bwd = backproject_grouped_bwd_plain if plain else backproject_grouped_bwd
        dfeats = bwd(g_out.contiguous(), coords, valid, h, w, c, gs, raw)
        return dfeats, None, None, None, None, None, None, None


# -------------------------------------------------------------- K1b / K2b

def sample2d_plain(feats: torch.Tensor, mask: Optional[torch.Tensor],
                   coords: torch.Tensor, mode: str, rel_scale: float = 1.0,
                   raw: bool = False):
    """Plain PyTorch version of K1b, written with explicit gathers.

    feats [B, h, w, C] f32 or bf16, mask [B, h, w] (modes "mask" and
    "backproject"), coords [B, N, 2] (normalised; modes "bilinear" and
    "mask") or [B, N, 3] (mode "backproject": raw (u, v, z), or normalised
    (x, y) plus the rel column). Returns (out, valid): out [B, N, C]
    ("bilinear"), [B, N, C+1] with the nearest mask value last ("mask") or
    [feat*valid, rel*valid] ("backproject"), in feats' dtype (taps combined
    in f32, the mask value and rel in f32, each value rounded once); valid
    [B, N] f32 in mode "backproject", else None.
    """
    b, h, w, c = feats.shape
    n = coords.shape[1]
    m = MODES.index(mode)
    out = feats.new_empty(b, n, c + (m > 0))
    valid = feats.new_zeros(b, n, dtype=torch.float32) if m == 2 else None
    for cam in range(b):
        img = feats[cam].reshape(h * w, c).float()
        for s in range(0, n, _POINT_CHUNK):
            sl = slice(s, s + _POINT_CHUNK)
            q = coords[cam, sl]
            live, ix, iy, fx, fy = _taps(q, h, w, raw)
            keep = live
            if m > 0:
                mval = _nearest(mask[cam].reshape(h * w), live, ix, iy, fx, fy,
                                h, w)
                if m == 1:
                    out[cam, sl, c] = mval
                else:
                    keep = live & (mval > 0.5)
                    # a select: a NaN depth of an invalid point gives 0
                    out[cam, sl, c] = torch.where(keep, _rel(q, raw, rel_scale),
                                                  0.0)
                    valid[cam, sl] = keep.float()
            out[cam, sl, :c] = _gather(img, _tap_rows(keep, ix, iy, fx, fy, h,
                                                      w))
    return out, valid


def _sample2d_shapes(feats, mask, coords, mode, raw):
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}, expected one of {MODES}")
    if raw and mode != "backproject":
        raise ValueError("raw coordinates are a back-projection mode")
    b, h, w, _ = feats.shape
    ncols = 3 if mode == "backproject" else 2
    if coords.dim() != 3 or coords.shape[0] != b or coords.shape[2] != ncols:
        raise ValueError(f"coords {tuple(coords.shape)} for feats "
                         f"{tuple(feats.shape)} in mode {mode!r}: expected "
                         f"[{b}, N, {ncols}]")
    if mode != "bilinear" and (mask is None or mask.shape != (b, h, w)):
        raise ValueError(f"mode {mode!r} needs a mask of shape {(b, h, w)}")


def sample2d(feats: torch.Tensor, mask: Optional[torch.Tensor],
             coords: torch.Tensor, mode: str, rel_scale: float = 1.0,
             raw: bool = False):
    """K1b: the ungrouped sampler, one output row per (camera, point); see
    ``sample2d_plain`` for the arguments and outputs.

    CPU tensors take the plain version; CUDA tensors launch the kernel of
    feats' dtype (``sample2d.launches`` counts the f32 form's launches,
    ``.launches_bf16`` the bf16 form's) or raise.
    """
    _sample2d_shapes(feats, mask, coords, mode, raw)
    args = [("feats", feats), ("coords", coords)]
    if mode != "bilinear":
        args.append(("mask", mask))
    _check(args, feats, bf16=("feats",))
    if feats.device.type == "cpu":
        return sample2d_plain(feats, mask, coords, mode, rel_scale, raw)
    _cuda_ready(args)
    b, h, w, c = feats.shape
    n = coords.shape[1]
    m = MODES.index(mode)
    bf16 = feats.dtype == torch.bfloat16
    out = torch.empty(b, n, c + (m > 0), device=feats.device,
                      dtype=feats.dtype)
    valid = torch.empty(b, n, device=feats.device) if m == 2 else None
    fn = _build.function("backproject_sample",
                         "vf_sample2d_bf16" if bf16 else "vf_sample2d",
                         [_P] * 5 + [_I64] * 6 + [_I, _I, _F, _P])
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(feats.data_ptr(), 0 if m == 0 else mask.data_ptr(),
                 coords.data_ptr(), out.data_ptr(),
                 0 if valid is None else valid.data_ptr(), b, h, w, c, n,
                 coords.shape[2], m, int(raw), float(rel_scale), stream)
    _launch("sample2d", err)
    if bf16:
        sample2d.launches_bf16 += 1
    else:
        sample2d.launches += 1
    return out, valid


sample2d.launches = 0
sample2d.launches_bf16 = 0


def sample2d_bwd_plain(g: torch.Tensor, coords: torch.Tensor,
                       valid: Optional[torch.Tensor], h: int, w: int, c: int,
                       raw: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K2b (``index_add_``).

    g [B, N, >= C] f32 or bf16 (the forward output's cotangent; columns
    past C are ignored), coords [B, N, 2-3], valid [B, N] (the gate) or
    None (every live point) -> dfeats [B, h, w, C] in g's dtype (summed in
    f32, rounded once).
    """
    b, n = g.shape[:2]
    dfeat = g.new_zeros(b, h * w, c, dtype=torch.float32)
    for cam in range(b):
        for s in range(0, n, _POINT_CHUNK):
            sl = slice(s, s + _POINT_CHUNK)
            live, ix, iy, fx, fy = _taps(coords[cam, sl], h, w, raw)
            sel = live if valid is None else live & (valid[cam, sl] != 0)
            _scatter(dfeat[cam], g[cam, sl, :c].float(),
                     _tap_rows(sel, ix, iy, fx, fy, h, w))
    return dfeat.reshape(b, h, w, c).to(g.dtype)


def sample2d_bwd(g: torch.Tensor, coords: torch.Tensor,
                 valid: Optional[torch.Tensor], h: int, w: int, c: int,
                 raw: bool = False) -> torch.Tensor:
    """K2b, the feature gradient of ``sample2d``: g [B, N, >= C] float32 or
    bfloat16 (its output's cotangent), coords [B, N, 2-3] and valid [B, N]
    (its validity, back-projection mode) or None -> dfeats [B, h, w, C] in
    g's dtype (the bf16 form adds in f32 and rounds once).

    CPU tensors take the plain version; CUDA tensors build the plan
    (``backproject_bwd_plan``) and launch the kernel of g's dtype
    (``sample2d_bwd.launches`` counts the f32 form's launches,
    ``.launches_bf16`` the bf16 form's) or raise.
    """
    b, n = coords.shape[:2]
    if (g.dim() != 3 or g.shape[:2] != (b, n) or g.shape[2] < c
            or coords.shape[2] < (3 if raw else 2)
            or (valid is not None and valid.shape != (b, n))):
        raise ValueError(f"shape mismatch: g {tuple(g.shape)}, coords "
                         f"{tuple(coords.shape)}, valid "
                         f"{None if valid is None else tuple(valid.shape)}, "
                         f"C={c}")
    args = [("g", g), ("coords", coords)]
    if valid is not None:
        args.append(("valid", valid))
    _check(args, g, bf16=("g",))
    if g.device.type == "cpu":
        return sample2d_bwd_plain(g, coords, valid, h, w, c, raw)
    _cuda_ready(args)
    bf16 = g.dtype == torch.bfloat16
    dfeat = _bwd_launch(g, coords, valid, raw, h, w, c, (b,),
                        backproject_bwd_plan(coords, valid, h, w, raw))
    if bf16:
        sample2d_bwd.launches_bf16 += 1
        return dfeat.to(torch.bfloat16)
    sample2d_bwd.launches += 1
    return dfeat


sample2d_bwd.launches = 0
sample2d_bwd.launches_bf16 = 0


class Sample2d(torch.autograd.Function):
    """``sample2d`` (K1b) forward, K2b backward; ``plain`` runs both plain
    versions on any device. Returns (out, valid) as the forward does (valid
    None outside the back-projection mode, which is also the backward's
    gate); only ``feats`` gets a gradient, in the dtype of the output's
    cotangent (feats' dtype: bf16 under mixed precision)."""

    @staticmethod
    def forward(ctx, feats, mask, coords, mode: str, rel_scale: float = 1.0,
                raw: bool = False, plain: bool = False):
        fwd = sample2d_plain if plain else sample2d
        out, valid = fwd(feats, mask, coords, mode, rel_scale, raw)
        ctx.save_for_backward(coords, valid)
        ctx.args = (feats.shape[1], feats.shape[2], feats.shape[3], raw,
                    plain)
        if valid is not None:
            ctx.mark_non_differentiable(valid)
        return out, valid

    @staticmethod
    def backward(ctx, g_out, _g_valid):
        coords, valid = ctx.saved_tensors
        h, w, c, raw, plain = ctx.args
        bwd = sample2d_bwd_plain if plain else sample2d_bwd
        dfeats = bwd(g_out.contiguous(), coords, valid, h, w, c, raw)
        return dfeats, None, None, None, None, None, None


# ------------------------------------------ the JAX package's entry names

def sample_bilinear(img: torch.Tensor, coords: torch.Tensor,
                    plain: bool = False) -> torch.Tensor:
    """img [B, H, W, C]; coords [B, N, 2] normalised (x, y), align corners
    -> [B, N, C], zeros padding (``sample_bilinear_pallas``)."""
    return Sample2d.apply(img, None, coords, "bilinear", 1.0, False,
                          plain)[0]


def sample_bilinear_with_nearest_mask(img: torch.Tensor, mask: torch.Tensor,
                                      coords: torch.Tensor,
                                      plain: bool = False) -> torch.Tensor:
    """img [B, H, W, C], mask [B, H, W, 1], coords as ``sample_bilinear``
    -> [B, N, C+1], the nearest mask value last
    (``sample_bilinear_with_nearest_mask_pallas``)."""
    return Sample2d.apply(img, mask[..., 0].contiguous(), coords, "mask", 1.0,
                          False, plain)[0]


def sample_backproject(img: torch.Tensor, mask: torch.Tensor,
                       coords: torch.Tensor, rel: torch.Tensor,
                       plain: bool = False):
    """img [B, H, W, C], mask [B, H, W, 1], coords [B, N, 2] normalised,
    rel [B, N] -> ([B, N, C+1] = [feat*valid, rel*valid], valid [B, N])
    (``sample_backproject_pallas``)."""
    coords3 = torch.cat([coords, rel[..., None].to(coords.dtype)], dim=-1)
    return Sample2d.apply(img, mask[..., 0].contiguous(), coords3,
                          "backproject", 1.0, False, plain)


def sample_backproject_raw(img: torch.Tensor, mask: torch.Tensor,
                           cam_pts: torch.Tensor, rel_scale: float,
                           plain: bool = False):
    """``sample_backproject`` taking camera-plane points cam_pts [B, N, 3] =
    (u, v, z) before the perspective divide; rel = z * rel_scale
    (``sample_backproject_raw_pallas``)."""
    return Sample2d.apply(img, mask[..., 0].contiguous(), cam_pts,
                          "backproject", float(rel_scale), True, plain)


def sample_backproject_grouped(img: torch.Tensor, mask: torch.Tensor,
                               coords: torch.Tensor, rel: torch.Tensor,
                               batch: int, group_size: int,
                               plain: bool = False):
    """img [batch*2*gs, H, W, C] with cameras ordered group-major, mask
    [same, H, W, 1], coords [same, N, 2] normalised, rel [same, N] ->
    group sums ([batch, 2, N, C+1] = [feat*valid, rel*valid], [batch, 2, N]
    = valid) (``sample_backproject_grouped_pallas``)."""
    coords3 = torch.cat([coords, rel[..., None].to(coords.dtype)], dim=-1)
    out, _ = BackprojectGrouped.apply(img, mask[..., 0].contiguous(),
                                      coords3, 1.0, batch, group_size, False,
                                      plain)
    return out[..., :-1], out[..., -1]


def sample_backproject_grouped_raw(img: torch.Tensor, mask: torch.Tensor,
                                   cam_pts: torch.Tensor, rel_scale: float,
                                   batch: int, group_size: int,
                                   plain: bool = False):
    """``sample_backproject_grouped`` taking camera-plane points (see
    ``sample_backproject_raw``) (``sample_backproject_grouped_raw_pallas``)."""
    out, _ = BackprojectGrouped.apply(img, mask[..., 0].contiguous(), cam_pts,
                                      float(rel_scale), batch, group_size,
                                      True, plain)
    return out[..., :-1], out[..., -1]
