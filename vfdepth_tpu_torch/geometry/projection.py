"""Pixel / voxel / frustum grids (port of ``vfdepth_tpu/geometry/projection.py``).

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
