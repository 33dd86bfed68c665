"""Lidar point cloud -> sparse per-camera depth map (host-side numpy; a copy
of ``vfdepth_tpu/data/depth_projection.py``).

Re-implements the projection chain both reference datasets rely on
(DGP ``generate_depth_map`` used at ``dataset/ddad_dataset_sf.py:41-72``;
the explicit lidar->world->ego->sensor->image chain at
``dataset/nuscenes_dataset.py:104-210``): transform lidar returns into the
camera frame, pinhole-project, z-buffer closest return per pixel.

Depth maps are cached as ``.npz`` next to the source data, matching the
reference's on-demand caching behavior.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def transform_points(points: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """[N, 3] through a 4x4 transform."""
    return points @ mat[:3, :3].T + mat[:3, 3]


def project_points_to_depth(
    points_cam: np.ndarray,   # [N, 3] in camera frame (+z forward)
    k: np.ndarray,            # [3, 3] or [4, 4]
    height: int,
    width: int,
) -> np.ndarray:
    """Z-buffered sparse depth map [H, W] (0 where no return)."""
    z = points_cam[:, 2]
    valid = z > 0.1
    pts = points_cam[valid]
    z = z[valid]
    u = (k[0, 0] * pts[:, 0] / z + k[0, 2])
    v = (k[1, 1] * pts[:, 1] / z + k[1, 2])
    ui = np.round(u).astype(np.int64)
    vi = np.round(v).astype(np.int64)
    ok = (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
    ui, vi, z = ui[ok], vi[ok], z[ok]

    depth = np.zeros((height, width), dtype=np.float32)
    # z-buffer: sort by depth descending so the closest return wins the write
    order = np.argsort(-z)
    depth[vi[order], ui[order]] = z[order]
    return depth


def lidar_to_camera_depth(
    lidar_points: np.ndarray,       # [N, 3] in lidar sensor frame
    lidar_to_ref: np.ndarray,       # [4, 4] lidar sensor -> common frame
    cam_to_ref: np.ndarray,         # [4, 4] camera -> same common frame
    k: np.ndarray,
    height: int,
    width: int,
) -> np.ndarray:
    """Full chain: lidar frame -> common frame -> camera frame -> depth map."""
    ref_pts = transform_points(lidar_points, lidar_to_ref)
    cam_pts = transform_points(ref_pts, np.linalg.inv(cam_to_ref))
    return project_points_to_depth(cam_pts, k, height, width)


def cached_depth(cache_path: str, compute_fn) -> np.ndarray:
    """npz cache wrapper (reference caches generated depth maps as .npz)."""
    if cache_path and os.path.isfile(cache_path):
        with np.load(cache_path) as f:
            return f["depth"]
    depth = compute_fn()
    if cache_path:
        os.makedirs(os.path.dirname(cache_path), exist_ok=True)
        try:
            np.savez_compressed(cache_path, depth=depth)
        except OSError:  # read-only data dir: skip caching
            pass
    return depth


def quaternion_to_matrix(q: Sequence[float]) -> np.ndarray:
    """Unit quaternion (w, x, y, z) -> 3x3 rotation matrix."""
    w, x, y, z = q
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0.0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1.0 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1.0 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1.0 - (xx + yy)],
    ])


def pose_to_matrix(translation: Sequence[float], rotation_wxyz: Sequence[float]) -> np.ndarray:
    """(t, q) -> 4x4 SE(3)."""
    mat = np.eye(4)
    mat[:3, :3] = quaternion_to_matrix(rotation_wxyz)
    mat[:3, 3] = translation
    return mat
