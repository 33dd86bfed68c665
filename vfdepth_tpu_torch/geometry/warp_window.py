"""Windows for the spatial and spatio-temporal warps (port of
``vfdepth_tpu/geometry/warp_window.py``).

For a pair of rig cameras only a sub-rectangle of the *target* image can
receive a nonzero warped image, mask or coordinate gradient; outside it the
dense warp computes exact zeros. ``render_views`` (``windows=``) warps only
inside such rectangles and pastes them into a zero canvas.

Why the spatial bound holds: a target pixel's ray projected into the source
camera traces u(d) = (A + B d) / (C + D d) over depth d. Where the
denominator (z_src + 1e-7, affine in d) keeps its sign on [d_lo, d_hi], u
and v are monotone in d, so the projection stays inside the box of its two
depth-endpoint projections; pixels whose denominator can change sign (the
projection pole) are included whatever their coordinates. A 2-pixel
dilation covers the bilinear / nearest footprint and the fringe where tap
weights are 0 but their derivatives are not. Depth endpoints are exact per
target camera: the network depth lies in [min_depth, max_depth] * fx /
focal_length_scale.

Each camera pair gets two windows ("slots"): slot 0 bounds the pixels whose
projection is bounded over the depth range, slot 1 the pixels whose
projection pole lies inside it (unbounded coordinates, warped as they are).
The window *origins* are computed each step from the batch's extrinsics and
the predicted ego-motion; the window *sizes* are static, sized on the host
at set-up (``estimate_window_hw_multi``, ``st_actual_hw``).

The spatio-temporal windows in the default 'actual' mode come from the
step's own predicted depth (``_st_actual_include``): exact for the step, but
the static box only bounds typical spans. A step whose span exceeds its box
(fast ego-motion) truncates the warp: the pixels outside the box read the
zero canvas instead of their dense value, so the loss differs from the
dense one there. ``overflow`` says by how many pixels the largest span
exceeded its box (0: nothing was truncated, and the windowed warps equal
the dense ones); ``training/trainer.py`` falls back to dense warps after two
log checkpoints in a row with overflow.

Geometry runs in float32 whatever the compute dtype, as in the JAX package.
The host-side sizing is numpy, copied from the JAX module, which the port
cannot import (it imports ``jax.numpy``).
"""
from __future__ import annotations

import itertools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .projection import pixel_grid_homo, project_coords

BoxHW = Tuple[Tuple[int, int], Tuple[int, int]]


class WarpWindows(NamedTuple):
    """Window origins (computed each step) and sizes (static) for one set
    of rendered scales.

    spatio_origin: [b, cams, n_nbr, 2 (slot), 2 (y0, x0)] int32, or None
    st_origin:     [b, cams, n_ctx, n_nbr, 2, 2] int32, or None
    spatio_hw / st_hw: ((H0, W0), (H1, W1)) per slot, or None (that kind
      of warp runs densely)
    overflow:      [] float32, the most pixels any span exceeded its box
      (0 = nothing truncated)
    """
    spatio_origin: Optional[torch.Tensor]
    st_origin: Optional[torch.Tensor]
    spatio_hw: Optional[BoxHW]
    st_hw: Optional[BoxHW]
    overflow: torch.Tensor


def _include_masks(rays, pose, src_k, d_lo, d_hi, h: int, w: int):
    """Whether each target pixel can ever matter for a camera pair.

    rays [..., 3, P] unit-depth target rays; pose [..., 4, 4] target ->
    source; src_k [..., 4, 4]; d_lo / d_hi [...] depth endpoints. Returns
    (near, pole), bool [..., P].
    """
    r = pose[..., :3, :3]
    t = pose[..., :3, 3]

    def endpoint(d):
        x = torch.matmul(r, rays) * d[..., None, None] + t[..., :, None]
        z = x[..., 2, :]
        denom = z + 1e-7
        u = (src_k[..., 0, 0, None] * x[..., 0, :]
             + src_k[..., 0, 2, None] * z) / denom
        v = (src_k[..., 1, 1, None] * x[..., 1, :]
             + src_k[..., 1, 2, None] * z) / denom
        return u, v, denom

    u0, v0, den0 = endpoint(d_lo)
    u1, v1, den1 = endpoint(d_hi)
    pole = (den0 * den1) <= 0          # the pole lies inside the depth range
    near = ((torch.maximum(u0, u1) >= -2.0)
            & (torch.minimum(u0, u1) <= w + 1.0)
            & (torch.maximum(v0, v1) >= -2.0)
            & (torch.minimum(v0, v1) <= h + 1.0)) & ~pole
    return near, pole


def _bbox_origin(include: torch.Tensor, h: int, w: int, box_h: int,
                 box_w: int):
    """include [..., H, W] -> (origin [..., 2] int32 (y0, x0), span_h,
    span_w). An empty mask gives origin (0, 0) and spans 0; the origin is
    clipped to [0, max(size - box, 0)] so the box stays in the image."""
    big = 1 << 20
    iy = torch.arange(h, dtype=torch.int32, device=include.device)
    ix = torch.arange(w, dtype=torch.int32, device=include.device)
    any_y = include.any(dim=-1)                      # [..., H]
    any_x = include.any(dim=-2)                      # [..., W]
    y_min = torch.where(any_y, iy, big).amin(dim=-1)
    y_max = torch.where(any_y, iy, -1).amax(dim=-1)
    x_min = torch.where(any_x, ix, big).amin(dim=-1)
    x_max = torch.where(any_x, ix, -1).amax(dim=-1)
    empty = y_max < 0
    span_h = torch.where(empty, 0, y_max - torch.minimum(y_min, y_max) + 1)
    span_w = torch.where(empty, 0, x_max - torch.minimum(x_min, x_max) + 1)
    y0 = torch.clamp(torch.where(empty, 0, y_min), 0, max(h - box_h, 0))
    x0 = torch.clamp(torch.where(empty, 0, x_min), 0, max(w - box_w, 0))
    return torch.stack([y0, x0], dim=-1), span_h, span_w


def _st_actual_include(depth, inv_k, src_k, st_pose, h: int, w: int):
    """Per-pixel include masks of the spatio-temporal warps from the step's
    predicted depth [b, cams, H, W, 1]: (slot 0: finite coordinates inside
    the image with a 2-pixel fringe, slot 1: non-finite coordinates, whose
    dense value is 2.0), each [b, cams, n_ctx, n_nbr, H, W].

    The coordinates are the dense warp's own (``project_coords``), so a
    pixel outside both masks computes exact zeros in the dense warp."""
    b, cams = depth.shape[:2]
    n_ctx, n_nbr = st_pose.shape[2], st_pose.shape[3]
    lead = (b, cams, n_ctx, n_nbr)
    dep = depth[:, :, None, None].expand(lead + depth.shape[2:])
    coords = project_coords(
        dep.float(), st_pose.float(),
        inv_k[:, :, None, None].float().expand(lead + (4, 4)),
        src_k[:, :, None].float().expand(lead + (4, 4)))
    fin = torch.isfinite(coords).all(dim=-1)
    ex = 2.0 * 2.0 / (w - 1)           # the 2-pixel fringe, normalised
    ey = 2.0 * 2.0 / (h - 1)
    cx, cy = coords[..., 0], coords[..., 1]
    in_img = (fin & (cx >= -1.0 - ex) & (cx <= 1.0 + ex)
              & (cy >= -1.0 - ey) & (cy <= 1.0 + ey))
    return in_img, ~fin


def compute_windows(inv_k: torch.Tensor, k: torch.Tensor,
                    spatio_pose: torch.Tensor, st_pose: torch.Tensor,
                    rel_idx: torch.Tensor, nbr_valid: torch.Tensor,
                    height: int, width: int, spatio_hw: Optional[BoxHW],
                    st_hw: Optional[BoxHW], min_depth: float,
                    max_depth: float, focal_length_scale: float,
                    st_depth: Optional[torch.Tensor] = None,
                    src_k: Optional[torch.Tensor] = None) -> WarpWindows:
    """The windows of one step's spatial and spatio-temporal warps.

    inv_k / k [b, cams, 4, 4] (scale 0); spatio_pose [b, cams, n_nbr, 4, 4]
    and st_pose [b, cams, n_ctx, n_nbr, 4, 4] target -> source; rel_idx
    [cams, n_nbr] source cameras (clamped), nbr_valid [cams, n_nbr] bool.
    ``st_depth`` (the step's predicted depth, no gradient) takes the
    spatio-temporal masks from that depth (``_st_actual_include``); without
    it they bound a worst-case motion interval, per context frame. No
    gradient flows: origins are integers and the overflow a count.
    ``src_k`` (the whole rig's, [b, all cams, 4, 4]), where given, holds
    the sources ``rel_idx`` names while the rest holds the target cameras
    only (a rank of the camera-axis grid); by default the sources are
    ``k``'s.
    """
    with torch.no_grad():
        geo = torch.float32
        b, cams = inv_k.shape[:2]
        n_nbr = rel_idx.shape[1]
        n_ctx = st_pose.shape[2]
        rel_idx = torch.as_tensor(rel_idx, device=inv_k.device).long()
        nbr_valid = torch.as_tensor(nbr_valid, device=inv_k.device).bool()

        grid = pixel_grid_homo(height, width).to(inv_k.device)   # [3, P]
        rays = torch.matmul(inv_k[..., :3, :3].to(geo), grid)     # [b,c,3,P]
        fx = k[..., 0, 0].to(geo)                                # [b, cams]
        d_lo = min_depth * fx / focal_length_scale
        d_hi = max_depth * fx / focal_length_scale
        src_k = (k if src_k is None else src_k)[:, rel_idx].to(geo)
        # src_k: [b, cams, n_nbr, 4, 4]

        def windows_for(pose, box_hw):                   # [b, cams, n_nbr, 4, 4]
            near, pole = _include_masks(
                rays[:, :, None], pose.to(geo), src_k, d_lo[:, :, None],
                d_hi[:, :, None], height, width)
            origins, spans = [], []
            for slot, inc in enumerate((near, pole)):
                inc = inc & nbr_valid[None, :, :, None]
                inc = inc.reshape(b, cams, n_nbr, height, width)
                o, sh, sw = _bbox_origin(inc, height, width, *box_hw[slot])
                origins.append(o)
                spans.append((sh - box_hw[slot][0], sw - box_hw[slot][1]))
            return torch.stack(origins, dim=-2), spans   # [..., slot, 2]

        all_spans = []
        sp_origin = st_origin = None
        if spatio_hw is not None:
            sp_origin, spans = windows_for(spatio_pose, spatio_hw)
            all_spans.extend(spans)
        if st_hw is not None and st_depth is not None:
            in_img, nonfin = _st_actual_include(st_depth, inv_k, src_k,
                                                st_pose, height, width)
            nv = nbr_valid[None, :, None, :, None, None]
            origins = []
            for slot, inc in enumerate((in_img & nv, nonfin & nv)):
                o, sh, sw = _bbox_origin(inc, height, width, *st_hw[slot])
                origins.append(o)
                all_spans.append((sh - st_hw[slot][0], sw - st_hw[slot][1]))
            st_origin = torch.stack(origins, dim=-2)     # [b,c,ctx,nbr,slot,2]
        elif st_hw is not None:
            per_frame = []
            for f in range(n_ctx):
                o, spans = windows_for(st_pose[:, :, f], st_hw)
                per_frame.append(o)
                all_spans.extend(spans)
            st_origin = torch.stack(per_frame, dim=2)

        if all_spans:
            worst = torch.stack([torch.maximum(sh.amax(), sw.amax())
                                 for sh, sw in all_spans]).amax()
            overflow = torch.clamp(worst.to(torch.float32), min=0.0)
        else:
            overflow = torch.zeros((), dtype=torch.float32,
                                   device=inv_k.device)
    return WarpWindows(sp_origin, st_origin, spatio_hw, st_hw, overflow)


# ---------------------------------------------------------------------------
# Static window sizes, on the host at set-up (numpy)
# ---------------------------------------------------------------------------

def _round_up(x: int, m: int) -> int:
    return min(int(-(-x // m) * m), 1 << 30)


def st_actual_hw(spatio_hw: BoxHW, height: int, width: int,
                 pad_w: int = 64, pad_h: int = 16) -> BoxHW:
    """Static boxes of the 'actual' spatio-temporal mode: slot 0 is the
    rig's spatial slot 0 widened by a motion-parallax pad (``pad_w``
    columns, ``pad_h`` rows; ``tpu.st_window_pad`` / ``st_window_pad_v``),
    slot 1 (non-finite coordinates, a set of measure zero) a minimal box."""
    (h0, w0), _ = spatio_hw
    slot0 = (min(_round_up(h0 + pad_h, 16), height),
             min(_round_up(w0 + pad_w, 64), width))
    slot1 = (min(16, height), min(64, width))
    return slot0, slot1


def estimate_window_hw(k: np.ndarray, inv_k: np.ndarray,
                       extrinsics: np.ndarray, rel_idx: np.ndarray,
                       nbr_valid: np.ndarray, height: int, width: int,
                       min_depth: float, max_depth: float,
                       focal_length_scale: float, max_trans: float = 4.0,
                       max_rot: float = 0.45, margin: int = 32,
                       with_motion: bool = True) -> BoxHW:
    """Static window size for one rig (k, inv_k, extrinsics [cams, 4, 4],
    camera-to-world): the largest span over its camera pairs and, with
    ``with_motion``, a worst-case ego-motion set (translations up to
    ``max_trans`` m, rotations up to ``max_rot`` rad), on a stride-4 pixel
    subgrid, plus ``margin``, rounded to (16, 64) and capped at the image.
    ``with_motion=False`` sizes the spatial warps, whose pose is the rig's
    fixed relative extrinsics."""
    stride = 4
    ext_inv = np.linalg.inv(extrinsics)
    grid_y, grid_x = np.mgrid[0:height:stride, 0:width:stride]
    pix = np.stack([grid_x.ravel(), grid_y.ravel(),
                    np.ones(grid_x.size)], 0).astype(np.float64)

    def axis_angle_mat(v):
        th = np.linalg.norm(v)
        if th < 1e-12:
            return np.eye(3)
        a = np.asarray(v) / th
        kx = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * (kx @ kx)

    motions = [np.eye(4)]
    if with_motion:
        for rv in itertools.product((-max_rot, 0.0, max_rot), repeat=3):
            for tv in ((0.0, 0.0, 0.0), (max_trans, 0, 0), (-max_trans, 0, 0),
                       (0, max_trans, 0), (0, -max_trans, 0),
                       (0, 0, max_trans), (0, 0, -max_trans)):
                m = np.eye(4)
                m[:3, :3] = axis_angle_mat(rv)
                m[:3, 3] = tv
                motions.append(m)

    best = [[1, 1], [1, 1]]            # per slot (near, pole): [h, w]
    for cam in range(k.shape[0]):
        fx = float(k[cam, 0, 0])
        d_lo = min_depth * fx / focal_length_scale
        d_hi = max_depth * fx / focal_length_scale
        rays = inv_k[cam, :3, :3].astype(np.float64) @ pix
        for j in range(rel_idx.shape[1]):
            if not nbr_valid[cam, j]:
                continue
            src = int(rel_idx[cam, j])
            rel = ext_inv[src] @ extrinsics[cam]
            for m in motions:
                pose = rel @ m
                r, t = pose[:3, :3], pose[:3, 3]
                us, vs, dens = [], [], []
                for d in (d_lo, d_hi):
                    x = r @ rays * d + t[:, None]
                    den = x[2] + 1e-7
                    us.append((k[src, 0, 0] * x[0] + k[src, 0, 2] * x[2])
                              / den)
                    vs.append((k[src, 1, 1] * x[1] + k[src, 1, 2] * x[2])
                              / den)
                    dens.append(den)
                pole = dens[0] * dens[1] <= 0
                near = ((np.maximum(*us) >= -2)
                        & (np.minimum(*us) <= width + 1)
                        & (np.maximum(*vs) >= -2)
                        & (np.minimum(*vs) <= height + 1))
                for slot, inc in enumerate((near & ~pole, pole)):
                    if not inc.any():
                        continue
                    ys = grid_y.ravel()[inc]
                    xs = grid_x.ravel()[inc]
                    best[slot][0] = max(best[slot][0],
                                        int(ys.max() - ys.min() + 1) + stride)
                    best[slot][1] = max(best[slot][1],
                                        int(xs.max() - xs.min() + 1) + stride)

    out = []
    for slot in range(2):
        box_h = min(_round_up(best[slot][0] + margin, 16), height)
        box_w = min(_round_up(best[slot][1] + margin, 64), width)
        out.append((box_h, box_w))
    return out[0], out[1]


def estimate_window_hw_multi(rigs: Sequence[Tuple[np.ndarray, np.ndarray]],
                             rel_idx: np.ndarray, nbr_valid: np.ndarray,
                             height: int, width: int, min_depth: float,
                             max_depth: float, focal_length_scale: float,
                             with_motion: bool = True) -> BoxHW:
    """Static window size covering every rig of ``rigs`` [(K, extrinsics),
    ...]: the elementwise maximum of ``estimate_window_hw`` over them (DDAD's
    calibration varies per scene)."""
    hw = None
    for k, ext in rigs:
        k = np.asarray(k, dtype=np.float64)
        one = estimate_window_hw(
            k, np.linalg.inv(k), np.asarray(ext), rel_idx, nbr_valid,
            height, width, min_depth, max_depth, focal_length_scale,
            with_motion=with_motion)
        hw = one if hw is None else tuple(
            (max(a[0], b[0]), max(a[1], b[1])) for a, b in zip(hw, one))
    return hw
