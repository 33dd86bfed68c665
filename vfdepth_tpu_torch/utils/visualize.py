"""The plasma colormap for depth panels and the depth-synthesis camera
sweep (a copy of ``vfdepth_tpu/utils/visualize.py``).

``aug_depth_params`` is the reference's scripted novel-view sweep (roll
+-10 degrees, pitch +-5 degrees, a focal-length morph, then a full
360-degree yaw): ~788 (inv_K, roll, pitch, yaw) tuples that drive one
decode each at eval time (``training/synthesis.py``).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

_DEGTORAD = 0.0174533


def colormap(vis: np.ndarray, normalize: bool = True) -> np.ndarray:
    """Map a [H, W] (or [..., H, W]) array to plasma RGB [..., H, W, 3];
    grayscale where matplotlib is missing."""
    try:
        import matplotlib.pyplot as plt
        cmap = plt.get_cmap("plasma", 256)
    except ImportError:  # pragma: no cover - grayscale fallback
        cmap = None

    vis = np.asarray(vis, dtype=np.float64)
    if normalize:
        ma, mi = float(vis.max()), float(vis.min())
        d = (ma - mi) if ma != mi else 1e5
        vis = (vis - mi) / d
    if cmap is None:
        return np.repeat(vis[..., None], 3, axis=-1).astype(np.float32)
    return cmap(vis)[..., :3].astype(np.float32)


def aug_depth_params(k: np.ndarray, n_steps: int = 75
                     ) -> List[Tuple[np.ndarray, float, float, float]]:
    """Scripted camera sweep. ``k``: [b, cams, 4, 4] intrinsics (scale
    fusion_level+1). Returns a list of (inv_K [b, cams, 4, 4], ax, ay, az)."""
    params: List[Tuple[np.ndarray, float, float, float]] = []
    inv_k = np.linalg.inv(k)

    # roll sweep: 0 -> +10deg -> -10deg -> 0
    roll = (list(range(0, n_steps + 1, 2))
            + list(range(n_steps, -n_steps - 1, -2))
            + list(range(-n_steps, 1, 2)))
    for a in roll:
        params.append((inv_k, _DEGTORAD * (a / n_steps * 10.0), 0.0, 0.0))

    # pitch sweep: 0 -> +5deg -> -5deg -> 0
    pitch = (list(range(0, 51, 2)) + list(range(50, -51, -2))
             + list(range(-50, 1, 2)))
    for a in pitch:
        params.append((inv_k, 0.0, _DEGTORAD * (a / 10.0), 0.0))

    # focal-length morph: fx -> fx * (fy/fx) / 1.5 and back toward fy/fx
    focal_ratio = k[:, 1, 0, 0] / k[:, 0, 0, 0]
    focal_ratio_aug = focal_ratio / 1.5
    k_aug = k.copy()
    for i in range(101):
        s = (i / 100.0) * focal_ratio_aug + (1 - i / 100.0)
        k_aug = k.copy()
        k_aug[:, :, 0, 0] *= s[:, None]
        k_aug[:, :, 1, 1] *= s[:, None]
        params.append((np.linalg.inv(k_aug), 0.0, 0.0, 0.0))
    for i in range(51):
        s = (i / 50.0) * focal_ratio + (1 - i / 50.0) * focal_ratio_aug
        k_aug = k.copy()
        k_aug[:, :, 0, 0] *= s[:, None]
        k_aug[:, :, 1, 1] *= s[:, None]
        params.append((np.linalg.inv(k_aug), 0.0, 0.0, 0.0))

    # yaw: full revolution at the final morphed intrinsics
    inv_k_aug = np.linalg.inv(k_aug)
    for i in range(360):
        params.append((inv_k_aug, 0.0, 0.0, _DEGTORAD * 360.0 * (i / 360.0)))
    return params
