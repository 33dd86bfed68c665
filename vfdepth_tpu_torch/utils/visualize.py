"""The plasma colormap for depth panels (``colormap`` of
``vfdepth_tpu/utils/visualize.py``, copied).

The depth-synthesis camera sweep (``aug_depth_params``) waits for the
depth-synthesis branch (ROADMAP A5).
"""
from __future__ import annotations

import numpy as np


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
