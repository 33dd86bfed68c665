"""Geometry, resizing and the derivatives at kinks of the plain reference.

The reference is the published VFDepth model written with plain PyTorch
operations in float32 and nothing else: no kernel, no cache, no batching
trick of the program under test. This module holds what every part of it
shares: the kink derivatives the configuration's reference (the JAX
package) defines, the bilinear resize as two interpolation matrices built
in float64, the pixel / voxel / frustum grids, SE(3) algebra and the
distribution of one canonical pose to every camera.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch


# ---------------------------------------------------------------- kinks

def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    """LeakyReLU whose derivative at 0 is 1 (``where(x >= 0, ...)``)."""
    return torch.where(x >= 0, x, x * x.new_full((), slope))


def tabs(x: torch.Tensor) -> torch.Tensor:
    """|x| whose derivative at 0 is +1."""
    return torch.where(x >= 0, x, -x)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """min(max(x, lo), hi): a bound splits the gradient in halves."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


# --------------------------------------------------------------- resize

@functools.lru_cache(maxsize=None)
def _resize_matrix(in_size: int, out_size: int,
                   align_corners: bool) -> np.ndarray:
    """[out, in] row-stochastic bilinear interpolation matrix, float64
    arithmetic rounded once to float32."""
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    out_idx = np.arange(out_size, dtype=np.float64)
    if align_corners and out_size > 1:
        src = out_idx * (in_size - 1) / (out_size - 1)
    else:
        src = np.clip((out_idx + 0.5) * in_size / out_size - 0.5, 0.0,
                      in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = src - lo
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.arange(out_size)
    np.add.at(mat, (rows, lo), 1.0 - w_hi)
    np.add.at(mat, (rows, hi), w_hi)
    return mat


def resize(img: torch.Tensor, out_hw, align_corners: bool,
           channels_last: bool = True) -> torch.Tensor:
    """Bilinear resize of [..., H, W, C] (or [..., C, H, W])."""
    out_h, out_w = out_hw
    in_h, in_w = img.shape[-3:-1] if channels_last else img.shape[-2:]
    if (in_h, in_w) == (out_h, out_w):
        return img
    mh = torch.from_numpy(_resize_matrix(in_h, out_h, align_corners)).to(img)
    mw = torch.from_numpy(_resize_matrix(in_w, out_w, align_corners)).to(img)
    if channels_last:
        return torch.einsum("pw,...owc->...opc", mw,
                            torch.einsum("oh,...hwc->...owc", mh, img))
    return torch.einsum("pw,...ow->...op", mw,
                        torch.einsum("oh,...hw->...ow", mh, img))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 upsample of NCHW."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


# ---------------------------------------------------------------- grids

def linspace(start: float, stop: float, num: int) -> torch.Tensor:
    """start*(1 - i/(num-1)) + stop*i/(num-1) in float32, exact endpoint."""
    if num == 1:
        return torch.tensor([start], dtype=torch.float32)
    step = torch.arange(num - 1, dtype=torch.float32) / float(num - 1)
    a = torch.tensor(start, dtype=torch.float32)
    b = torch.tensor(stop, dtype=torch.float32)
    return torch.cat([a * (1 - step) + b * step, b.reshape(1)])


def pixel_grid(height: int, width: int) -> torch.Tensor:
    """[3, H*W] rows (x, y, 1) in pixels."""
    gy, gx = torch.meshgrid(torch.arange(height, dtype=torch.float32),
                            torch.arange(width, dtype=torch.float32),
                            indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.ones(height * width)], dim=0)


def voxel_centres(str_p: Sequence[float], unit: Sequence[float],
                  size: Sequence[int]) -> torch.Tensor:
    """Homogeneous voxel centres [4, n] in (y, x, z) order, z fastest."""
    vx, vy, vz = size
    g = [linspace(str_p[i], str_p[i] + unit[i] * (size[i] - 1), size[i])
         for i in range(3)]
    n = vx * vy * vz
    yy = g[1][:, None, None].expand(vy, vx, vz).reshape(n)
    xx = g[0][None, :, None].expand(vy, vx, vz).reshape(n)
    zz = g[2][None, None, :].expand(vy, vx, vz).reshape(n)
    return torch.stack([xx, yy, zz, torch.ones(n)], dim=0)


def backproject(inv_k: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Depth [..., H, W, 1] -> homogeneous points [..., 4, H*W]."""
    h, w = depth.shape[-3], depth.shape[-2]
    grid = pixel_grid(h, w).to(depth.device, depth.dtype)
    rays = torch.einsum("...ij,jn->...in", inv_k[..., :3, :3], grid)
    pts = rays * depth.reshape(depth.shape[:-3] + (1, h * w))
    return torch.cat([pts, torch.ones_like(pts[..., :1, :])], dim=-2)


def project(k: torch.Tensor, points: torch.Tensor, transform: torch.Tensor,
            height: int, width: int) -> torch.Tensor:
    """Points [..., 4, H*W] through (K T)[:3] -> normalised align-corners
    coordinates [..., H, W, 2]."""
    proj = torch.einsum("...ij,...jk->...ik", k, transform)[..., :3, :]
    p2 = torch.einsum("...ij,...jn->...in", proj, points)
    xy = p2[..., :2, :] / (p2[..., 2:3, :] + 1e-7)
    scale = torch.tensor([2.0 / (width - 1), 2.0 / (height - 1)],
                         dtype=xy.dtype, device=xy.device)
    xy = (xy * scale[:, None] - 1.0).transpose(-1, -2)
    return xy.reshape(xy.shape[:-2] + (height, width, 2))


def warp_coords(depth, transform, inv_k, k) -> torch.Tensor:
    h, w = depth.shape[-3], depth.shape[-2]
    return project(k, backproject(inv_k, depth), transform, h, w)


# ------------------------------------------------------------------ SE3

def _hat(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    x, y, w = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([torch.stack([z, -w, y], -1),
                        torch.stack([w, z, -x], -1),
                        torch.stack([-y, x, z], -1)], -2)


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation [..., 3, 3], Taylor-stable at 0."""
    t2 = torch.sum(aa * aa, dim=-1, keepdim=True)[..., None]
    t = torch.sqrt(torch.clamp(t2, min=1e-30))
    small = t2 < 1e-8
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(t)) / torch.clamp(t2, min=1e-30))
    k = _hat(aa)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return eye.expand(k.shape) + a * k + b * (k @ k)


def _bottom(top: torch.Tensor) -> torch.Tensor:
    row = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                       device=top.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, row], dim=-2)


def pose_matrix(aa: torch.Tensor, t: torch.Tensor,
                invert: bool = False) -> torch.Tensor:
    """Axis-angle and translation -> SE(3); ``invert`` builds the inverse
    (a past frame's motion)."""
    rot = rodrigues(aa)
    tv = t[..., None]
    if invert:
        rot = rot.transpose(-1, -2)
        return _bottom(torch.cat([rot, rot @ (-tv)], dim=-1))
    return _bottom(torch.cat([rot, tv], dim=-1))


def invert(mat: torch.Tensor) -> torch.Tensor:
    rt = mat[..., :3, :3].transpose(-1, -2)
    return _bottom(torch.cat([rt, -(rt @ mat[..., :3, 3:])], dim=-1))


def euler_xyz(rot: torch.Tensor) -> torch.Tensor:
    """R = Rx Ry Rz -> (ax, ay, az)."""
    ay = torch.asin(clip(rot[..., 0, 2], -1.0, 1.0))
    az = torch.atan2(-rot[..., 0, 1], rot[..., 0, 0])
    ax = torch.atan2(-rot[..., 1, 2], rot[..., 2, 2])
    return torch.stack([ax, ay, az], dim=-1)


def distribute(canon: torch.Tensor, ext: torch.Tensor,
               ext_inv: torch.Tensor) -> torch.Tensor:
    """One canonical motion [b, 4, 4] -> every camera's [b, cams, 4, 4]:
    E_c^-1 E_0 T E_0^-1 E_c."""
    mid = torch.einsum("bij,bjk,bkl->bil", ext[:, 0], canon, ext_inv[:, 0])
    return torch.einsum("bcij,bjk,bckl->bcil", ext_inv, mid, ext)


def relative_poses(ext, ext_inv, cam_t_cam, rel_cam):
    """(spatio [b, cams, n_nbr, 4, 4], spatio-temporal [b, cams, n_ctx,
    n_nbr, 4, 4])."""
    spatio = torch.einsum("bcnij,bcjk->bcnik", ext_inv[:, rel_cam], ext)
    st = torch.einsum("bcnij,bcfjk->bcfnik", spatio, cam_t_cam)
    return spatio, st
