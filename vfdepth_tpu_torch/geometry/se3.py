"""SE(3) / SO(3) primitives on tensors, batched over leading dims.

Port of ``vfdepth_tpu/geometry/se3.py``: axis-angle -> matrix,
``vec_to_matrix`` and ``invert_pose`` (every path), and the "XYZ" Euler
angles of the fsm baseline's pose-consistency loss.
"""
from __future__ import annotations

import torch

from ..ops import ties


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [v]_x for v of shape [..., 3] -> [..., 3, 3]."""
    zeros = torch.zeros_like(v[..., 0])
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([
        torch.stack([zeros, -vz, vy], dim=-1),
        torch.stack([vz, zeros, -vx], dim=-1),
        torch.stack([-vy, vx, zeros], dim=-1),
    ], dim=-2)


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] axis-angle -> [..., 3, 3] rotation matrix.

    Taylor-stable near theta=0:
      R = I + A [a]_x + B [a]_x^2,   A = sin(t)/t,  B = (1-cos(t))/t^2.
    """
    theta2 = torch.sum(axis_angle * axis_angle, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(torch.clamp(theta2, min=1e-30))
    small = theta2 < 1e-8
    a_coef = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b_coef = torch.where(small, 0.5 - theta2 / 24.0,
                         (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=1e-30))
    k = hat(axis_angle)
    eye = torch.eye(3, dtype=axis_angle.dtype, device=axis_angle.device)
    return eye.expand(k.shape) + a_coef * k + b_coef * (k @ k)


def matrix_to_euler_angles_xyz(rot: torch.Tensor) -> torch.Tensor:
    """Inverse of R = Rx(ax) @ Ry(ay) @ Rz(az): [..., 3, 3] -> [..., 3] =
    (ax, ay, az). The clip of R02 into [-1, 1] is ``ties.clip``, so its
    derivative at +-1 is JAX's."""
    ay = torch.asin(ties.clip(rot[..., 0, 2], -1.0, 1.0))
    az = torch.atan2(-rot[..., 0, 1], rot[..., 0, 0])
    ax = torch.atan2(-rot[..., 1, 2], rot[..., 2, 2])
    return torch.stack([ax, ay, az], dim=-1)


def _append_bottom_row(top: torch.Tensor) -> torch.Tensor:
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                          device=top.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def vec_to_matrix(rot_angle: torch.Tensor, trans_vec: torch.Tensor,
                  invert: bool = False) -> torch.Tensor:
    """Axis-angle + translation -> 4x4 SE(3).

    ``invert=True`` builds the inverse transform directly (transpose R,
    negate t, reversed composition) — used for past-frame poses so the
    network always sees frames in temporal order.
    rot_angle, trans_vec: [..., 3]. Returns [..., 4, 4].
    """
    rot = axis_angle_to_matrix(rot_angle)
    t = trans_vec[..., None]
    if invert:
        rot = rot.transpose(-1, -2)
        top = torch.cat([rot, rot @ (-t)], dim=-1)   # R^T @ T(-t)
    else:
        top = torch.cat([rot, t], dim=-1)             # T(t) @ R
    return _append_bottom_row(top)


def invert_pose(mat: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of an SE(3) matrix [..., 4, 4]."""
    rot_t = mat[..., :3, :3].transpose(-1, -2)
    top = torch.cat([rot_t, -(rot_t @ mat[..., :3, 3:])], dim=-1)
    return _append_bottom_row(top)
