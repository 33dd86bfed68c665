"""Grouped raw-mode back-projection sampler (kernel K1) and its backward
(kernel K2).

Port of ``vfdepth_tpu/ops/pallas_sample.py``'s grouped raw mode
(``sample_backproject_grouped_raw_pallas``, pallas_sample.py:806): the
forward TPU kernel ``_fwd_kernel`` :176 launched by ``_fwd_call_grouped``
:431 is ``csrc/backproject_sample.cu``; the backward TPU kernel
``_bwd_kernel`` :301 launched by ``_bwd_call`` :497 is
``csrc/backproject_sample_bwd.cu``. Their headers say what bounds them and
how they are laid out. ``BackprojectGroupedRaw`` ties the two together as
one autograd Function.

Semantics, per voxel point and camera (cameras ordered group-major, ``gs``
per group):

* raw camera-plane point (u, v, z): x = u / (z + 1e-8), y = v / (z + 1e-8);
  NaN -> 2w, then clip to +-2w on both axes;
* live iff z > 0 and the align-corners pixel lies in [0, w-1] x [0, h-1];
* bilinear feature sample, zeros padding;
* nearest mask pick where an f32 fraction > 0.5 takes the upper tap (NOT
  round-half-even); valid = live and picked mask > 0.5;
* epilogue [feat * valid, z * rel_scale * valid, valid], summed over each
  group's cameras, plus each camera's validity. An invalid point adds exact
  zeros, even where its depth is not finite (XLA simplifies the JAX
  kernel's ``rel * valid`` to a select, and the port keeps that).

Backward: only the features get a gradient, dfeat[cam, tap pixel] +=
W_tap * g[group(cam), point, :C] for every point the forward marked valid
for that camera (a select: an invalid point adds nothing); the rel and
valid columns of the cotangent, the mask and the coordinates get none.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_POINT_CHUNK = 32768   # plain version: points per gather (bounds its memory)


def _raw_taps(pts: torch.Tensor, h: int, w: int):
    """Raw camera-plane points [n, 3] -> (live, ix0, iy0, fx, fy, z)."""
    z = pts[:, 2]
    zp = z + 1e-8
    x = pts[:, 0] / zp
    y = pts[:, 1] / zp
    big = 2.0 * w
    x = torch.clamp(torch.nan_to_num(x, nan=big, posinf=big, neginf=-big),
                    -big, big)
    y = torch.clamp(torch.nan_to_num(y, nan=big, posinf=big, neginf=-big),
                    -big, big)
    live = (z > 0) & (x >= 0) & (x <= w - 1.0) & (y >= 0) & (y <= h - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    return live, x0.long(), y0.long(), x - x0, y - y0, z


def backproject_grouped_raw_plain(feats: torch.Tensor, mask: torch.Tensor,
                                  cam3: torch.Tensor, rel_scale: float,
                                  batch: int, group_size: int):
    """Plain PyTorch version of the kernel, written with explicit gathers.

    feats [b*2*gs, h, w, C] f32 (cameras group-major), mask [b*2*gs, h, w],
    cam3 [b*2*gs, N, 3]. Returns (out [b, 2, N, C+2], valid [b*2*gs, N]).
    Loops over cameras and chunks the points so it fits in a few GB at the
    production shapes; group sums are taken in camera order, as the kernel
    does.
    """
    bc, h, w, c = feats.shape
    n = cam3.shape[1]
    gs = group_size
    out = feats.new_zeros(batch, 2, n, c + 2)
    valid_pc = feats.new_zeros(bc, n)
    for cam in range(bc):
        bi, g = divmod(cam // gs, 2)
        img = feats[cam].reshape(h * w, c)
        msk = mask[cam].reshape(h * w)
        for s in range(0, n, _POINT_CHUNK):
            live, ix, iy, fx, fy, z = _raw_taps(cam3[cam, s:s + _POINT_CHUNK],
                                                h, w)
            # nearest mask tap: the upper tap iff the f32 fraction > 0.5
            xn = ix + (fx > 0.5).long()
            yn = iy + (fy > 0.5).long()
            ok = live & (xn < w) & (yn < h)
            m = torch.where(ok, msk[torch.where(ok, yn * w + xn, 0)], 0.0)
            valid = (live & (m > 0.5)).to(feats.dtype)

            def tap(dx, dy, weight):
                tx, ty = ix + dx, iy + dy
                inb = live & (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
                rows = img[torch.where(inb, ty * w + tx, 0)]
                return torch.where(inb[:, None], rows, 0.0) * weight[:, None]

            feat = (tap(0, 0, (1 - fx) * (1 - fy)) + tap(1, 0, fx * (1 - fy))
                    + tap(0, 1, (1 - fx) * fy) + tap(1, 1, fx * fy))
            # invalid points contribute exact zeros (a select, so a
            # non-finite depth behind the camera leaves no NaN behind)
            rel = torch.where(valid > 0, z * rel_scale, 0.0)
            out[bi, g, s:s + _POINT_CHUNK] += torch.cat(
                [feat * valid[:, None], rel[:, None], valid[:, None]], dim=-1)
            valid_pc[cam, s:s + _POINT_CHUNK] = valid
    return out, valid_pc


_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = _build.load("backproject_sample").vf_backproject_grouped_raw
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


MAX_GROUP_SIZE = 8   # csrc/backproject_sample.cu kMaxGroup


def backproject_grouped_raw(feats: torch.Tensor, mask: torch.Tensor,
                            cam3: torch.Tensor, rel_scale: float,
                            batch: int, group_size: int):
    """Group-reduced back-projection of raw camera-plane points.

    feats [b*2*gs, h, w, C] float32 with cameras PRE-ORDERED group-major
    (group 0's gs cameras, then group 1's), mask [b*2*gs, h, w] (the
    low-res occlusion mask), cam3 [b*2*gs, N, 3] = (u, v, z) before the
    perspective divide. Returns (out [b, 2, N, C+2] = group sums of
    [feat*valid, rel*valid, valid], valid [b*2*gs, N] per camera).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``backproject_grouped_raw.launches`` counts launches) or raise.
    """
    bc, h, w, c = feats.shape
    n = cam3.shape[1]
    if bc != batch * 2 * group_size or group_size < 1:
        raise ValueError(f"feats has {bc} cameras, expected "
                         f"batch*2*group_size = {batch}*2*{group_size}")
    if mask.shape != (bc, h, w) or cam3.shape != (bc, n, 3):
        raise ValueError(f"shape mismatch: feats {tuple(feats.shape)}, mask "
                         f"{tuple(mask.shape)}, cam3 {tuple(cam3.shape)}")
    for name, t in (("feats", feats), ("mask", mask), ("cam3", cam3)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != feats.device:
            raise ValueError(f"{name} is on {t.device}, feats on {feats.device}")
    if feats.device.type == "cpu":
        return backproject_grouped_raw_plain(feats, mask, cam3, rel_scale,
                                             batch, group_size)
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    if group_size > MAX_GROUP_SIZE:
        raise ValueError(f"group_size {group_size} > {MAX_GROUP_SIZE}")
    for name, t in (("feats", feats), ("mask", mask), ("cam3", cam3)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty(batch, 2, n, c + 2, device=feats.device)
    valid = torch.empty(bc, n, device=feats.device)
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(feats.data_ptr(), mask.data_ptr(), cam3.data_ptr(),
                           out.data_ptr(), valid.data_ptr(), batch,
                           group_size, h, w, c, n, float(rel_scale), stream)
    if err != 0:
        raise RuntimeError(f"backproject_grouped_raw launch failed: CUDA "
                           f"error {err}")
    backproject_grouped_raw.launches += 1
    return out, valid


backproject_grouped_raw.launches = 0


def backproject_grouped_raw_bwd_plain(g: torch.Tensor, cam3: torch.Tensor,
                                      valid: torch.Tensor, h: int, w: int,
                                      c: int, group_size: int) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel (``index_add_``).

    g [b, 2, N, >= C] (the forward output's cotangent; columns past C are
    ignored), cam3 [b*2*gs, N, 3], valid [b*2*gs, N] -> dfeats [b*2*gs, h,
    w, C].
    """
    bc, n = valid.shape
    dfeat = g.new_zeros(bc, h * w, c)
    for cam in range(bc):
        bi, grp = divmod(cam // group_size, 2)
        for s in range(0, n, _POINT_CHUNK):
            sl = slice(s, s + _POINT_CHUNK)
            live, ix, iy, fx, fy, _ = _raw_taps(cam3[cam, sl], h, w)
            sel = live & (valid[cam, sl] > 0)
            gg = g[bi, grp, sl, :c]
            for dx, dy, weight in ((0, 0, (1 - fx) * (1 - fy)),
                                   (1, 0, fx * (1 - fy)),
                                   (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
                tx, ty = ix + dx, iy + dy
                ok = sel & (tx < w) & (ty < h)
                upd = torch.where(ok[:, None], gg, 0.0) * weight[:, None]
                dfeat[cam].index_add_(0, torch.where(ok, ty * w + tx, 0), upd)
    return dfeat.reshape(bc, h, w, c)


_BWD_FN = None


def _bwd_kernel_fn():
    global _BWD_FN
    if _BWD_FN is None:
        fn = _build.load("backproject_sample_bwd").vf_backproject_grouped_raw_bwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _BWD_FN = fn
    return _BWD_FN


def backproject_grouped_raw_bwd(g: torch.Tensor, cam3: torch.Tensor,
                                valid: torch.Tensor, h: int, w: int, c: int,
                                group_size: int) -> torch.Tensor:
    """Feature gradient of ``backproject_grouped_raw``: g [b, 2, N, >= C]
    (its output's cotangent), cam3 [b*2*gs, N, 3] and valid [b*2*gs, N] (its
    per-camera validity) -> dfeats [b*2*gs, h, w, C] float32.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``backproject_grouped_raw_bwd.launches`` counts launches) or raise.
    """
    bc, n = valid.shape
    if g.dim() != 4 or g.shape[1] != 2 or g.shape[2] != n or g.shape[3] < c \
            or bc != g.shape[0] * 2 * group_size or cam3.shape != (bc, n, 3):
        raise ValueError(f"shape mismatch: g {tuple(g.shape)}, cam3 "
                         f"{tuple(cam3.shape)}, valid {tuple(valid.shape)}, "
                         f"C={c}, group_size={group_size}")
    for name, t in (("g", g), ("cam3", cam3), ("valid", valid)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != g.device:
            raise ValueError(f"{name} is on {t.device}, g on {g.device}")
    if g.device.type == "cpu":
        return backproject_grouped_raw_bwd_plain(g, cam3, valid, h, w, c,
                                                 group_size)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    if group_size > MAX_GROUP_SIZE:
        raise ValueError(f"group_size {group_size} > {MAX_GROUP_SIZE}")
    for name, t in (("g", g), ("cam3", cam3), ("valid", valid)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dfeat = torch.zeros(bc, h, w, c, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_kernel_fn()(g.data_ptr(), cam3.data_ptr(), valid.data_ptr(),
                               dfeat.data_ptr(), g.shape[0], group_size, h, w,
                               c, g.shape[3], n, stream)
    if err != 0:
        raise RuntimeError(f"backproject_grouped_raw_bwd launch failed: CUDA "
                           f"error {err}")
    backproject_grouped_raw_bwd.launches += 1
    return dfeat


backproject_grouped_raw_bwd.launches = 0


class BackprojectGroupedRaw(torch.autograd.Function):
    """``backproject_grouped_raw`` (K1) forward, K2 backward; ``plain`` runs
    both plain versions on any device. Returns (out, valid) as the forward
    does; only ``feats`` gets a gradient."""

    @staticmethod
    def forward(ctx, feats, mask, cam3, rel_scale: float, batch: int,
                group_size: int, plain: bool = False):
        fwd = backproject_grouped_raw_plain if plain else backproject_grouped_raw
        out, valid = fwd(feats, mask, cam3, rel_scale, batch, group_size)
        ctx.save_for_backward(cam3, valid)
        ctx.args = (feats.shape[1], feats.shape[2], feats.shape[3],
                    group_size, plain)
        ctx.mark_non_differentiable(valid)
        return out, valid

    @staticmethod
    def backward(ctx, g_out, _g_valid):
        cam3, valid = ctx.saved_tensors
        h, w, c, gs, plain = ctx.args
        bwd = (backproject_grouped_raw_bwd_plain if plain
               else backproject_grouped_raw_bwd)
        dfeats = bwd(g_out.contiguous(), cam3, valid, h, w, c, gs)
        return dfeats, None, None, None, None, None, None
