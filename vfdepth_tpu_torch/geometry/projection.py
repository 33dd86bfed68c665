"""Pixel / voxel / frustum grids and the pinhole warp coordinates (port of
``vfdepth_tpu/geometry/projection.py``).

Grids are built in float32 on the CPU and moved to the caller's device, so
a CPU run and a CUDA run see bit-identical voxel centres and depth bins (a
voxel centre that moves by an ulp can flip validity at the image edge).
"""
from __future__ import annotations

from typing import Sequence

import torch


def linspace_f32(start: float, stop: float, num: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, num, dtype=float32)``'s formula:
    start*(1 - i/(num-1)) + stop*i/(num-1), with the exact endpoint appended.

    ``torch.linspace`` uses another formula and differs by an ulp at some
    points. (XLA's CPU compiler may still rewrite jnp's division as a
    reciprocal multiply, so the two packages agree to a few ulp, not bit for
    bit — tests/test_torch_geometry.py states the bound.)
    """
    if num == 1:
        return torch.tensor([start], dtype=torch.float32)
    div = num - 1
    step = torch.arange(div, dtype=torch.float32) / float(div)
    a = torch.tensor(start, dtype=torch.float32)
    b = torch.tensor(stop, dtype=torch.float32)
    out = a * (1 - step) + b * step
    return torch.cat([out, b.reshape(1)])


def pixel_grid_homo(height: int, width: int) -> torch.Tensor:
    """Homogeneous pixel grid [3, H*W]: rows (x, y, 1) in pixel units."""
    gy, gx = torch.meshgrid(torch.arange(height, dtype=torch.float32),
                            torch.arange(width, dtype=torch.float32),
                            indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.ones(height * width)], dim=0)


def backproject(inv_k: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Depth [..., H, W, 1] -> homogeneous camera points [..., 4, H*W]
    (rays inv_K[:3, :3] @ (x, y, 1) scaled by depth)."""
    h, w = depth.shape[-3], depth.shape[-2]
    grid = pixel_grid_homo(h, w).to(depth.device, depth.dtype)
    rays = torch.einsum("...ij,jn->...in", inv_k[..., :3, :3], grid)
    pts = rays * depth.reshape(depth.shape[:-3] + (1, h * w))
    return torch.cat([pts, torch.ones_like(pts[..., :1, :])], dim=-2)


def reproject(k: torch.Tensor, points3d: torch.Tensor,
              transform: torch.Tensor, height: int,
              width: int) -> torch.Tensor:
    """Transform + project homogeneous points [..., 4, H*W] to normalised
    sample coordinates [..., H, W, 2]: (K @ T)[:3] @ P, divide by z + 1e-7,
    then x * 2/(W-1) - 1 and y * 2/(H-1) - 1 (align_corners)."""
    proj = torch.einsum("...ij,...jk->...ik", k, transform)[..., :3, :]
    pts2d = torch.einsum("...ij,...jn->...in", proj, points3d)
    xy = pts2d[..., :2, :] / (pts2d[..., 2:3, :] + 1e-7)
    scale = torch.tensor([2.0 / (width - 1), 2.0 / (height - 1)],
                         dtype=xy.dtype, device=xy.device)
    xy = (xy * scale[:, None] - 1.0).transpose(-1, -2)
    return xy.reshape(xy.shape[:-2] + (height, width, 2))


def project_coords(depth: torch.Tensor, transform: torch.Tensor,
                   inv_k: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Warp coordinates of every target pixel: back-project with the
    target's depth and inv_K, transform, project with the source's K."""
    h, w = depth.shape[-3], depth.shape[-2]
    return reproject(k, backproject(inv_k, depth), transform, h, w)


def project_coords_window(depth_box: torch.Tensor, origin: torch.Tensor,
                          transform: torch.Tensor, inv_k: torch.Tensor,
                          k: torch.Tensor, norm_h: int,
                          norm_w: int) -> torch.Tensor:
    """``project_coords`` on a window of the target image: depth_box [...,
    Hb, Wb, 1] holds the target pixels from ``origin`` [..., 2] (y0, x0,
    integers) on. The same arithmetic as the dense version, with the pixel
    grid offset by the origin and the normalisation against the full source
    size ``norm_h`` x ``norm_w``. Returns [..., Hb, Wb, 2]."""
    hb, wb = depth_box.shape[-3], depth_box.shape[-2]
    dtype = depth_box.dtype
    grid = pixel_grid_homo(hb, wb).to(depth_box.device, dtype)  # [3, P]
    off = torch.stack([origin[..., 1], origin[..., 0],
                       torch.zeros_like(origin[..., 0])], dim=-1).to(dtype)
    grid_full = grid + off[..., :, None]                        # [..., 3, P]
    rays = torch.matmul(inv_k[..., :3, :3], grid_full)
    pts = rays * depth_box.reshape(depth_box.shape[:-3] + (1, hb * wb))
    pts_h = torch.cat([pts, torch.ones_like(pts[..., :1, :])], dim=-2)
    proj = torch.matmul(k, transform)[..., :3, :]
    pts2d = torch.matmul(proj, pts_h)
    xy = pts2d[..., :2, :] / (pts2d[..., 2:3, :] + 1e-7)
    scale = torch.tensor([2.0 / (norm_w - 1), 2.0 / (norm_h - 1)],
                         dtype=xy.dtype, device=xy.device)
    xy = (xy * scale[:, None] - 1.0).transpose(-1, -2)
    return xy.reshape(xy.shape[:-2] + (hb, wb, 2))


def voxel_points_homo(voxel_str_p: Sequence[float],
                      voxel_unit_size: Sequence[float],
                      voxel_size: Sequence[int]) -> torch.Tensor:
    """Homogeneous world-frame voxel centres [4, n], flattened in (y, x, z)
    index order with z fastest — the JAX package's flat voxel order, which
    every later stage indexes by (the frustum sampler's volume layout and
    the pose path's z-into-channels fold are plain reshapes of it)."""
    vx, vy, vz = voxel_size
    ends = [voxel_str_p[i] + voxel_unit_size[i] * (voxel_size[i] - 1)
            for i in range(3)]
    gx = linspace_f32(voxel_str_p[0], ends[0], vx)
    gy = linspace_f32(voxel_str_p[1], ends[1], vy)
    gz = linspace_f32(voxel_str_p[2], ends[2], vz)
    n = vx * vy * vz
    yy = gy[:, None, None].expand(vy, vx, vz).reshape(n)
    xx = gx[None, :, None].expand(vy, vx, vz).reshape(n)
    zz = gz[None, None, :].expand(vy, vx, vz).reshape(n)
    return torch.stack([xx, yy, zz, torch.ones(n)], dim=0)


def frustum_world_points(inv_k: torch.Tensor, extrinsics: torch.Tensor,
                         img_h: int, img_w: int,
                         depth_bins: torch.Tensor) -> torch.Tensor:
    """Camera frustum points in the world frame, per depth bin.

    inv_k, extrinsics: [..., 4, 4] (camera-to-world); depth_bins [d].
    Returns [..., d, img_h * img_w, 3] world xyz.
    """
    grid = pixel_grid_homo(img_h, img_w).to(inv_k.device, inv_k.dtype)
    rays = torch.einsum("...ij,jp->...ip", inv_k[..., :3, :3], grid)
    pts = rays[..., None, :, :] * depth_bins.to(rays)[:, None, None]
    pts_h = torch.cat([pts, torch.ones_like(pts[..., :1, :])], dim=-2)
    world = torch.einsum("...ij,...djp->...dip", extrinsics[..., :3, :], pts_h)
    return world.transpose(-1, -2)
