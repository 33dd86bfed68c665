"""Differentiable view rendering, every camera and neighbour at once (port
of ``vfdepth_tpu/geometry/view_rendering.py``).

Images are channels-last with the camera axis explicit, as in the JAX
package. Every warp of one call goes through ONE launch of the image warp
(kernel K5, ``ops/warp.py``): the temporal warps, the spatio warps and the
spatio-temporal warps of each context frame, 4 calls per step with frames
(0, -1, 1).

With ``windows`` (``geometry/warp_window.py``; the JAX package's default
``tpu.warp_window: true``, sized by ``VFDepthModel.configure_warp_window``)
the spatial and spatio-temporal warps run only inside each camera pair's
windows, two slots per pair: each slot's depth box is sliced from the
target depth (``_slice_boxes``), its coordinates projected with the full
source size (``project_coords_window``), both slots' coordinates warped by
one K5 launch (concatenated along the point axis), and each slot pasted
into a zero canvas in slot order (``_paste_boxes``: where two windows
overlap the later slot's values, and its gradient, win, as
``dynamic_update_slice`` leaves them). Where the windows hold every pixel
with a nonzero value, mask or gradient (overflow 0) this equals the dense
warp; where a window overflowed, the pixels outside it keep the canvas's
zeros, so the windowed loss differs from the dense one there. The K5
launches stay 4 a step.

The depth-synthesis branch (``aug_depth``) warps depth, not colour:
``warp_depth`` samples each source's depth, expressed in the rotated
target frame, with the plain gather sampler of ``ops/grid_sample.py`` (the
JAX package's XLA gathers, not a TPU kernel; K5's rules for non-finite
coordinates and nearest ties differ, and K5 gives no source gradient).

Under mixed precision the colours arrive as bf16 (``training/model.py``):
the warps take bf16 sources and masks and return bf16 images and masks
(K5's bf16 form), and ``intensity_align`` takes its statistics in f32 and
returns the warped image's dtype, as in the JAX package. Coordinates stay
f32.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch

from .projection import backproject, project_coords, project_coords_window
from .se3 import invert_pose
from .warp_window import BoxHW, WarpWindows
from ..ops import ties
from ..ops.grid_sample import grid_sample_2d
from ..ops.warp import warp_image_mask
from ..utils.tracing import span


def warp_image(src_img: torch.Tensor, src_mask: torch.Tensor,
               tar_depth: torch.Tensor, tar_inv_k: torch.Tensor,
               src_k: torch.Tensor, transform: torch.Tensor,
               plain: bool = False):
    """Warp source images / masks [..., H, W, 3|1] into the target views.

    Leading dims match across arguments. Non-finite coordinates give image
    2.0 and mask 0; the mask is 0 where the coordinates leave [-1, 1].
    Returns (warped image, warped mask) in the image's dtype (the mask is
    cast to it before the warp), the mask without gradient.
    """
    coords = project_coords(tar_depth, transform, tar_inv_k, src_k)
    h, w, c = src_img.shape[-3:]
    lead = src_img.shape[:-3]
    img_w, mask_w = warp_image_mask(
        src_img.reshape(-1, h, w, c).contiguous(),
        src_mask.to(src_img.dtype).reshape(-1, h, w, 1).contiguous(),
        coords.reshape(-1, h * w, 2).contiguous(), plain=plain)
    img_w = img_w.reshape(lead + (h, w, c))
    mask_w = mask_w.reshape(lead + (h, w, 1))
    finite = torch.isfinite(coords).all(dim=-1, keepdim=True)
    img_w = torch.where(finite, img_w, 2.0)
    mask_w = mask_w * finite.to(mask_w.dtype)
    in_bounds = ((coords >= -1.0) & (coords <= 1.0)).all(
        dim=-1, keepdim=True).to(src_img.dtype)
    return img_w, in_bounds * mask_w


def _box_index(origin: torch.Tensor, h: int, w: int, box_h: int,
               box_w: int) -> torch.Tensor:
    """Flat pixel indices [n, box_h * box_w] of each box of ``origin`` [...,
    2] (y0, x0), the start clamped so the box stays in the image, as
    ``jax.lax.dynamic_slice`` / ``dynamic_update_slice`` clamp it."""
    if box_h > h or box_w > w:
        raise ValueError(f"window {box_h}x{box_w} exceeds the image {h}x{w}")
    org = origin.reshape(-1, 2).long()
    y0 = org[:, 0].clamp(0, h - box_h)
    x0 = org[:, 1].clamp(0, w - box_w)
    iy = torch.arange(box_h, device=org.device)
    ix = torch.arange(box_w, device=org.device)
    rows = (y0[:, None] + iy) * w                          # [n, box_h]
    return (rows[:, :, None] + (x0[:, None] + ix)[:, None, :]).reshape(
        org.shape[0], box_h * box_w)


def _slice_boxes(img: torch.Tensor, index: torch.Tensor, box_h: int,
                 box_w: int) -> torch.Tensor:
    """img [*lead, H, W, C] -> the windows [*lead, box_h, box_w, C] at
    ``index`` (``_box_index``; a gather: the gradient reaches ``img``)."""
    lead, (h, w, c) = img.shape[:-3], img.shape[-3:]
    flat = img.reshape(-1, h * w, c)
    out = torch.gather(flat, 1, index[..., None].expand(-1, -1, c))
    return out.reshape(lead + (box_h, box_w, c))


def _paste_boxes(canvas: torch.Tensor, boxes: torch.Tensor,
                 index: torch.Tensor) -> torch.Tensor:
    """Overwrite each window of ``canvas`` [*lead, H, W, C] with ``boxes``
    [*lead, Hb, Wb, C] at ``index`` (``_box_index``): one non-accumulating
    write (out of place), so a later paste's values and gradient replace an
    earlier one's where they overlap."""
    h, w, c = canvas.shape[-3:]
    hb, wb = boxes.shape[-3], boxes.shape[-2]
    out = canvas.reshape(-1, h * w, c).scatter(
        1, index[..., None].expand(-1, -1, c), boxes.reshape(-1, hb * wb, c))
    return out.reshape(canvas.shape)


def warp_image_window(src_img: torch.Tensor, src_mask: torch.Tensor,
                      tar_depth: torch.Tensor, tar_inv_k: torch.Tensor,
                      src_k: torch.Tensor, transform: torch.Tensor,
                      origin: torch.Tensor, box_hw: BoxHW,
                      plain: bool = False):
    """``warp_image`` inside each element's windows, pasted into a zero
    canvas.

    ``origin`` [*lead, n_slot, 2] (y0, x0) per slot, ``box_hw[slot]`` the
    slot's static size. Every window computes the dense value of each pixel
    it covers (non-finite coordinates give image 2.0 and mask 0; the mask
    is 0 outside [-1, 1]); the slots go through one K5 launch, their
    coordinates concatenated, and are pasted in slot order. Returns
    (warped image, warped mask) [*lead, H, W, 3|1] in the image's dtype.
    """
    h, w, c = src_img.shape[-3:]
    lead = src_img.shape[:-3]
    n_slot = origin.shape[-2]
    coords, index = [], []
    for slot in range(n_slot):
        box_h, box_w = box_hw[slot]
        org = origin[..., slot, :]
        index.append(_box_index(org, h, w, box_h, box_w))
        dep_box = _slice_boxes(tar_depth, index[slot], box_h, box_w)
        crd = project_coords_window(dep_box, org, transform, tar_inv_k,
                                    src_k, h, w)
        coords.append(crd.reshape(-1, box_h * box_w, 2))
    img_b, mask_b = warp_image_mask(
        src_img.reshape(-1, h, w, c).contiguous(),
        src_mask.to(src_img.dtype).reshape(-1, h, w, 1).contiguous(),
        torch.cat(coords, dim=1).contiguous(), plain=plain)

    img_w = src_img.new_zeros(lead + (h, w, c))
    mask_w = src_img.new_zeros(lead + (h, w, 1))
    start = 0
    for slot in range(n_slot):
        box_h, box_w = box_hw[slot]
        crd = coords[slot]
        part = slice(start, start + crd.shape[1])
        start += crd.shape[1]
        finite = torch.isfinite(crd).all(dim=-1, keepdim=True)
        img_s = torch.where(finite, img_b[:, part], 2.0)
        mask_s = mask_b[:, part] * finite.to(mask_b.dtype)
        in_bounds = ((crd >= -1.0) & (crd <= 1.0)).all(
            dim=-1, keepdim=True).to(src_img.dtype)
        mask_s = in_bounds * mask_s
        img_w = _paste_boxes(img_w, img_s.reshape(lead + (box_h, box_w, c)),
                             index[slot])
        mask_w = _paste_boxes(
            mask_w, mask_s.reshape(lead + (box_h, box_w, 1)), index[slot])
    return img_w, mask_w


def warp_depth(src_depth: torch.Tensor, src_mask: torch.Tensor,
               src_inv_k: torch.Tensor, src_k: torch.Tensor,
               tar_depth: torch.Tensor, tar_inv_k: torch.Tensor,
               transform: torch.Tensor, min_depth: float, max_depth: float):
    """Backward-warp source depth [..., H, W, 1] into the target frame.

    The source depth is first expressed in the target frame (the z of the
    transformed source points), then sampled bilinearly at the coordinates
    projected with the inverse transform and clamped to [min_depth,
    max_depth]. Non-finite coordinates give depth 2.0 (then clamped) and
    mask 0; the mask (the source mask's nearest sample) is 0 where the
    coordinates leave [-1, 1] or the sampled depth is not strictly inside
    the range. Returns (depth, mask); the gradient reaches both depths.
    """
    h, w = src_depth.shape[-3], src_depth.shape[-2]
    src_points = backproject(src_inv_k, src_depth)          # [..., 4, HW]
    warped = torch.einsum("...ij,...jn->...in", transform[..., :3, :],
                          src_points)
    src_depth_t = warped[..., 2, :].reshape(src_depth.shape[:-3] + (h, w, 1))

    coords = project_coords(tar_depth, invert_pose(transform), tar_inv_k,
                            src_k)
    depth_w, finite = grid_sample_2d(src_depth_t, coords, mode="bilinear",
                                     with_finite_mask=True)
    depth_w = torch.where(finite > 0, depth_w, 2.0)
    mask_w = grid_sample_2d(src_mask, coords, mode="nearest") * finite
    in_bounds = ((coords >= -1.0) & (coords <= 1.0)).all(
        dim=-1, keepdim=True).to(src_depth.dtype)
    valid_min = (depth_w > min_depth).to(src_depth.dtype)
    valid_max = (depth_w < max_depth).to(src_depth.dtype)
    depth_w = ties.clip(depth_w, min_depth, max_depth)
    return depth_w, in_bounds * mask_w * valid_min * valid_max


def intensity_align(ref_img: torch.Tensor, ref_mask: torch.Tensor,
                    warp_img: torch.Tensor,
                    warp_mask: torch.Tensor) -> torch.Tensor:
    """Renormalise the warped image to the reference's overlap statistics.

    Statistics (no gradient, as JAX's ``stop_gradient``) over the overlap
    ref_mask * warp_mask > 0 broadcast to RGB; the variance takes the
    squared deviation over ALL pixels around the masked mean and divides
    by the full count (the reference's quirk). Where a sample's overlap is
    empty the warped image passes through unchanged. The statistics and the
    renormalisation run in f32; the result has the warped image's dtype.
    """
    with torch.no_grad():
        mask = ((ref_mask * warp_mask) > 0).float()
        ch = warp_img.shape[-1]
        denom_full = float(warp_img.shape[-3] * warp_img.shape[-2] * ch)
        msum = ch * mask.sum(dim=(-3, -2, -1), keepdim=True)

        def stats(img):
            img = img.float()
            s1m = (img * mask).sum(dim=(-3, -2, -1), keepdim=True)
            s1 = img.sum(dim=(-3, -2, -1), keepdim=True)
            s2 = (img * img).sum(dim=(-3, -2, -1), keepdim=True)
            mean = s1m / (msum + 1e-8)
            var = (s2 - 2.0 * mean * s1 + denom_full * mean * mean) \
                / denom_full
            return mean, torch.sqrt(torch.clamp(var, min=0.0) + 1e-16)

        s_mean, s_std = stats(ref_img)
        w_mean, w_std = stats(warp_img)
    norm = (warp_img - w_mean) / (w_std + 1e-8) * s_std + s_mean
    norm = norm * warp_mask
    return torch.where(msum > 0, norm, warp_img).to(warp_img.dtype)


class RenderOutputs(NamedTuple):
    """All warped tensors of one scale, camera axis explicit.

    temporal_img / temporal_mask: [b, cams, n_ctx, H, W, 3|1]
    overlap_img / overlap_mask:   [b, cams, 1 + n_ctx, H, W, 3|1]
      (index 0 is frame 0 (spatio), then the context frames
      (spatio-temporal))
    tform_depth / tform_depth_mask: [b, cams, n_nbr + 1, H, W, 1], the
      depth-synthesis branch (each camera's neighbours, then itself), None
      without ``aug_depth``
    """
    temporal_img: torch.Tensor
    temporal_mask: torch.Tensor
    overlap_img: Optional[torch.Tensor]
    overlap_mask: Optional[torch.Tensor]
    tform_depth: Optional[torch.Tensor] = None
    tform_depth_mask: Optional[torch.Tensor] = None


def _bcast(x: torch.Tensor, n: int) -> torch.Tensor:
    """[b, cams, ...] -> [b, cams, n, ...] (a view)."""
    return x[:, :, None].expand(x.shape[:2] + (n,) + x.shape[2:])


def render_views(colors: Dict[int, torch.Tensor], mask: torch.Tensor,
                 k: torch.Tensor, inv_k: torch.Tensor, depth: torch.Tensor,
                 cam_t_cam: torch.Tensor, spatio_pose: Optional[torch.Tensor],
                 spatio_tempo_pose: Optional[torch.Tensor],
                 rel_cam: torch.Tensor, frame_ids: Sequence[int],
                 do_intensity_align: bool = True, spatio: bool = True,
                 spatio_temporal: bool = True, aug_depth: bool = False,
                 extrinsics: Optional[torch.Tensor] = None,
                 extrinsics_aug: Optional[torch.Tensor] = None,
                 depth_aug: Optional[torch.Tensor] = None,
                 min_depth: float = 1.5, max_depth: float = 200.0,
                 windows: Optional[WarpWindows] = None,
                 plain: bool = False,
                 src_colors: Optional[Dict[int, torch.Tensor]] = None,
                 src_mask: Optional[torch.Tensor] = None,
                 src_k: Optional[torch.Tensor] = None,
                 src_inv_k: Optional[torch.Tensor] = None,
                 src_depth: Optional[torch.Tensor] = None,
                 first_cam: int = 0) -> RenderOutputs:
    """Render every warped view the losses need for one scale.

    colors: frame id -> [b, cams, H, W, 3]; mask [b, cams, H, W, 1]; k /
    inv_k [b, cams, 4, 4]; depth [b, cams, H, W, 1]; cam_t_cam [b, cams,
    n_ctx, 4, 4]; spatio_pose [b, cams, n_nbr, 4, 4]; spatio_tempo_pose
    [b, cams, n_ctx, n_nbr, 4, 4]; rel_cam [cams, n_nbr] neighbour indices
    (-1 = none). ``aug_depth`` adds the depth-synthesis warps: each
    camera's neighbours' depths and its own, warped into its rotated view
    (``extrinsics_aug``, [b, cams, 4, 4]) at that view's depth
    ``depth_aug`` [b, cams, H, W, 1] by ``warp_depth``. ``windows``
    (``compute_windows``) restricts the spatial warps to its
    ``spatio_origin`` windows and the spatio-temporal ones to its
    ``st_origin`` windows, each kind where it is given, dense otherwise
    (``warp_image_window``). ``plain`` runs the warp kernel's plain version
    on any device.

    ``src_colors`` / ``src_mask`` / ``src_k``, where given, are the
    neighbours' side of the spatial and spatio-temporal warps: the whole
    rig's [b, all cams, ...], which ``rel_cam``'s indices name, while the
    other arguments (and ``rel_cam``'s rows) hold the target cameras only
    (a rank of the camera-axis grid, ``parallel/mesh.py``), the rig's
    cameras [first_cam, first_cam + cams). The depth-synthesis warps read
    their sources (the neighbours and the camera itself) from them too,
    and from ``src_inv_k`` and ``src_depth`` (the rig's depths, gathered
    with their gradient); ``extrinsics`` is always the rig's. By default
    the targets are the whole rig and their own sources.
    """
    if aug_depth and (extrinsics is None or extrinsics_aug is None
                      or depth_aug is None):
        raise ValueError("aug_depth needs extrinsics, extrinsics_aug and "
                         "depth_aug")
    ctx_ids = list(frame_ids[1:])
    n_ctx = len(ctx_ids)
    rel_cam = torch.as_tensor(rel_cam, device=depth.device).long()
    nbr_valid_f = (rel_cam >= 0).to(depth.dtype)[None, :, :, None, None, None]
    rel_idx = torch.clamp(rel_cam, min=0)

    # temporal warps
    src_imgs = torch.stack([colors[f] for f in ctx_ids], dim=2)
    t_img, t_mask = warp_image(src_imgs, _bcast(mask, n_ctx),
                               _bcast(depth, n_ctx), _bcast(inv_k, n_ctx),
                               _bcast(k, n_ctx), cam_t_cam, plain=plain)
    if do_intensity_align:
        t_img = intensity_align(_bcast(colors[0], n_ctx), _bcast(mask, n_ctx),
                                t_img, t_mask)

    overlap_img = overlap_mask = None
    if spatio or spatio_temporal:
        src_colors = colors if src_colors is None else src_colors
        n_nbr = rel_cam.shape[1]
        nbr_mask = (mask if src_mask is None else src_mask)[:, rel_idx]
        nbr_k = (k if src_k is None else src_k)[:, rel_idx]
        depn, invkn = _bcast(depth, n_nbr), _bcast(inv_k, n_nbr)

        def overlap_for(frame_colors, pose, origin=None, box_hw=None):
            if origin is not None:
                w_img, w_mask = warp_image_window(
                    frame_colors[:, rel_idx], nbr_mask, depn, invkn, nbr_k,
                    pose, origin, box_hw, plain=plain)
            else:
                w_img, w_mask = warp_image(frame_colors[:, rel_idx],
                                           nbr_mask, depn, invkn, nbr_k,
                                           pose, plain=plain)
            w_mask = w_mask * nbr_valid_f.to(w_mask.dtype)
            if do_intensity_align:
                w_img = intensity_align(_bcast(colors[0], n_nbr),
                                        _bcast(mask, n_nbr), w_img, w_mask)
            # the valid flags in the image's dtype: a bf16 stack stays bf16
            return ((w_img * nbr_valid_f.to(w_img.dtype)).sum(dim=2),
                    w_mask.sum(dim=2))

        sp_win = windows is not None and windows.spatio_origin is not None
        st_win = windows is not None and windows.st_origin is not None
        outs = [overlap_for(src_colors[0], spatio_pose,
                            windows.spatio_origin if sp_win else None,
                            windows.spatio_hw if sp_win else None)]
        outs += [overlap_for(src_colors[f], spatio_tempo_pose[:, :, fi],
                             windows.st_origin[:, :, fi] if st_win else None,
                             windows.st_hw if st_win else None)
                 for fi, f in enumerate(ctx_ids)]
        overlap_img = torch.stack([o[0] for o in outs], dim=2)
        overlap_mask = torch.stack([o[1] for o in outs], dim=2)

    tform_depth = tform_mask = None
    if aug_depth:
        with span("vf.geometry.warp_depth"):
            cams = depth.shape[1]
            # sources: each camera's neighbours, then itself
            self_idx = torch.arange(first_cam, first_cam + cams,
                                    device=rel_idx.device)[:, None]
            src_idx = torch.cat([rel_idx, self_idx], dim=1)    # [cams, n_src]
            src_valid = torch.cat([rel_cam >= 0, torch.ones_like(
                self_idx, dtype=torch.bool)], dim=1)
            n_src = src_idx.shape[1]
            rel_pose = torch.einsum("bcij,bcnjk->bcnik",
                                    invert_pose(extrinsics_aug),
                                    extrinsics[:, src_idx])
            tform_depth, tform_mask = warp_depth(
                (depth if src_depth is None else src_depth)[:, src_idx],
                (mask if src_mask is None else src_mask)[:, src_idx],
                (inv_k if src_inv_k is None else src_inv_k)[:, src_idx],
                (k if src_k is None else src_k)[:, src_idx],
                _bcast(depth_aug, n_src), _bcast(inv_k, n_src), rel_pose,
                min_depth, max_depth)
            tform_mask = tform_mask * src_valid.to(depth.dtype)[
                None, :, :, None, None, None]
    return RenderOutputs(t_img, t_mask, overlap_img, overlap_mask,
                         tform_depth, tform_mask)
