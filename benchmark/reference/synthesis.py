"""Depth synthesis (``training.aug_depth``) in the plain reference: the
published model's second decode of every camera at a randomly rotated
extrinsic, and its loss.

Each camera's extrinsic is turned by a random rotation
(``augment_extrinsics``); the depth net decodes the same fused voxel volume
a second time along the rotated frusta (``decode_views``: a plain 5-D
``F.grid_sample``, the same reduction and decoder). Each camera's
neighbours' depths and its own are warped into its rotated view
(``warp_depth``), and ``depth_synthesis_loss`` holds the rotated view's
depth to them (consistency) and smooths its disparity. Float32, plain
PyTorch, as the rest of the reference.

It follows the published code (42dot/VFDepth
``network/volumetric_fusionnet.py:269-336``,
``models/geometry/view_rendering.py:84-116, 200-241``,
``models/losses/depth_synthesis_loss.py``). Where it departs, it takes
the configuration's reference package's reading:

* every camera, source and scale at once, where the published code loops
  over cameras and neighbours;
* the rotation's draw is an argument, ``aug_u`` [b, cams, 3] uniform in
  [0, 1), one a frameset and camera, which the benchmark hands to the
  program and to the reference alike; ``(u - 0.5) * aug_angle`` is the
  axis-angle, so the configuration's angles act as radians, as in the
  published code;
* a warp coordinate that is not finite samples nothing: its depth is 2.0
  before the range clamp and its mask 0;
* the mask is the source mask's nearest sample (a half pixel rounds to
  even), and the range clamp's derivative at a bound is split in halves,
  as ``|x|``'s at 0 is +1 (``geometry.clip``, ``geometry.tabs``);
* the decoder and the frustum's reduction hold no BatchNorm, so the order
  of the two decodes changes no number; the main decode runs first.

The warp's bilinear sample is ``F.grid_sample`` (align corners, zeros
outside), whose gradient reaches the coordinates, and through them both
depths, as the published warp's does.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F

from .geometry import backproject, clip, invert, rodrigues, tabs, warp_coords

# a normalised coordinate this far out samples nothing; finite ones are
# clamped to it so that the sampler's index arithmetic stays in range
_FAR = 1e4


def augment_extrinsics(aug_u: torch.Tensor, ext: torch.Tensor,
                       aug_angle: Sequence[float]) -> torch.Tensor:
    """R((aug_u - 0.5) * aug_angle) @ ext, detached: [b, cams, 4, 4]."""
    angle = (aug_u.to(ext.dtype) - 0.5) * torch.tensor(
        [float(a) for a in aug_angle], dtype=ext.dtype, device=ext.device)
    tform = torch.zeros(ext.shape[:2] + (4, 4), dtype=ext.dtype,
                        device=ext.device)
    tform[..., :3, :3] = rodrigues(angle)
    tform[..., 3, 3] = 1.0
    return (tform @ ext).detach()


def decode_views(depth_net, call: Callable, feat: torch.Tensor,
                 count: torch.Tensor, skips, inv_k: torch.Tensor,
                 exts: Sequence[torch.Tensor]):
    """One fused voxel volume of the depth net's back-projected features,
    decoded along the frusta of each extrinsic of ``exts`` in turn -> one
    {'disp/{s}'} a view. ``call`` runs each stage (the model's
    checkpointing)."""
    vfeat = call(depth_net.fusion_net.fuse, feat, count)
    return [call(depth_net.decode_volume, vfeat, skips, inv_k, ext)
            for ext in exts]


def _sample(img: torch.Tensor, coords: torch.Tensor,
            mode: str) -> torch.Tensor:
    """``img`` [..., H, W, C] at normalised ``coords`` [..., H, W, 2]."""
    h, w, c = img.shape[-3:]
    out = F.grid_sample(img.reshape(-1, h, w, c).permute(0, 3, 1, 2),
                        coords.reshape(-1, h, w, 2), mode=mode,
                        padding_mode="zeros", align_corners=True)
    return out.permute(0, 2, 3, 1).reshape(img.shape)


def warp_depth(src_depth, src_mask, src_inv_k, src_k, tar_depth, tar_inv_k,
               transform, min_depth: float, max_depth: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Source depths [..., H, W, 1], expressed in the target frame (the z
    of the source's points moved by ``transform``), sampled at the target
    pixels' coordinates in the source (the target depth moved by the
    inverse) and clamped to [min_depth, max_depth] -> (depth, mask). The
    mask is 0 outside [-1, 1], where a coordinate is not finite and where
    the sampled depth is not strictly inside the range."""
    pts = backproject(src_inv_k, src_depth)                   # [..., 4, HW]
    z = torch.einsum("...ij,...jn->...in", transform[..., :3, :], pts)[
        ..., 2, :].reshape(src_depth.shape)
    coords = warp_coords(tar_depth, invert(transform), tar_inv_k, src_k)
    finite = torch.isfinite(coords).all(dim=-1, keepdim=True)
    crd = torch.clamp(torch.where(finite, coords, -2.0), -_FAR, _FAR)
    depth = torch.where(finite, _sample(z, crd, "bilinear"), 2.0)
    with torch.no_grad():
        mask = _sample(src_mask, crd, "nearest") * finite.float()
        inb = ((coords >= -1.0) & (coords <= 1.0)).all(dim=-1, keepdim=True)
        mask = (mask * inb.float() * (depth > min_depth).float()
                * (depth < max_depth).float())
    return clip(depth, min_depth, max_depth), mask


def depth_synthesis_loss(depth_aug: torch.Tensor, tform_depth: torch.Tensor,
                         tform_mask: torch.Tensor, disp_aug: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(consistency [cams], smoothness [cams]): |d_aug - d_warp| / (d_aug +
    d_warp) clipped to [0, 1], its masked mean over batch, sources and
    pixels; the plain first-order gradients of the rotated view's
    mean-normalised disparity, averaged."""
    da = depth_aug[:, :, None]
    con = clip(tabs(da - tform_depth) / (da + tform_depth + 1e-8), 0.0, 1.0)
    con = (con * tform_mask).sum(dim=(0, 2, 3, 4, 5)) / (
        tform_mask.sum(dim=(0, 2, 3, 4, 5)) + 1e-8)
    nd = disp_aug / (disp_aug.mean(dim=(-3, -2), keepdim=True) + 1e-8)
    gx = tabs(nd[..., :, :-1, :] - nd[..., :, 1:, :]).mean(dim=(0, 2, 3, 4))
    gy = tabs(nd[..., :-1, :, :] - nd[..., 1:, :, :]).mean(dim=(0, 2, 3, 4))
    return con, gx + gy


def synthesis_loss(x: Mapping[str, torch.Tensor],
                   depths: Dict[int, torch.Tensor],
                   depths_aug: Dict[int, torch.Tensor],
                   disps_aug: Dict[int, torch.Tensor],
                   ext_aug: torch.Tensor, rel_cam: torch.Tensor,
                   coeffs: Tuple[float, float], depth_range: Tuple[float, float]
                   ) -> torch.Tensor:
    """The depth-synthesis terms of the training loss, averaged over scales
    and cameras as the rest of it is: at each scale every camera's
    neighbours (``rel_cam`` [cams, n], -1: none) and itself are the
    sources of its rotated view."""
    cams = rel_cam.shape[0]
    idx = torch.cat([torch.clamp(rel_cam, min=0),
                     torch.arange(cams, device=rel_cam.device)[:, None]], 1)
    valid = torch.cat([rel_cam >= 0, torch.ones_like(rel_cam[:, :1],
                                                     dtype=torch.bool)], 1)
    n = idx.shape[1]
    rel_pose = torch.einsum("bcij,bcnjk->bcnik", invert(ext_aug),
                            x["extrinsics"][:, idx])

    def bc(t):
        return t[:, :, None].expand(t.shape[:2] + (n,) + t.shape[2:])
    total = 0.0
    for s, depth in depths.items():
        td, tm = warp_depth(depth[:, idx], x["mask"][:, idx],
                            x["inv_K/0"][:, idx], x["K/0"][:, idx],
                            bc(depths_aug[s]), bc(x["inv_K/0"]), rel_pose,
                            *depth_range)
        tm = tm * valid.float()[None, :, :, None, None, None]
        con, sm = depth_synthesis_loss(depths_aug[s], td, tm, disps_aug[s])
        total = total + coeffs[0] * con + coeffs[1] * sm
    return (total / float(len(depths))).mean()
