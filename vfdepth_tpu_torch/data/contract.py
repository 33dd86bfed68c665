"""Batch-dict contract (a copy of ``vfdepth_tpu/data/contract.py``).

The reference collates per-sample dicts keyed by tuples like
``('color', frame_id, scale)`` into ``[B, num_cams, C, H, W]`` tensors.
This rebuild uses flat **string** keys (tuple keys don't sort against plain
strings inside a jax pytree) and **NHWC** layouts:

  color/{f}/{s}, color_aug/{f}/{s} : [b, cams, H/2^s, W/2^s, 3]
      f in frame_ids (0 also at scales 1..fusion_level+1; context only at 0)
  K/{s}, inv_K/{s}                 : [b, cams, 4, 4]  for s in 0..fusion_level+1
  extrinsics, extrinsics_inv       : [b, cams, 4, 4]  (camera-to-world)
  mask                             : [b, cams, H, W, 1] self-occlusion
  depth                            : [b, cams, H, W, 1] GT lidar (val/eval)

Scaled intrinsics follow the reference's pyramid construction
(``dataset/data_util.py:46-91``): K rows 0/1 divided by 2^s, inv via inverse.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def color_key(frame: int, scale: int, aug: bool = False) -> str:
    return f"color{'_aug' if aug else ''}/{frame}/{scale}"


def scale_intrinsics(k: np.ndarray, scale: int) -> np.ndarray:
    """K at pyramid scale s: focal lengths and principal point / 2^s."""
    out = k.copy()
    out[..., 0, :] = out[..., 0, :] / (2 ** scale)
    out[..., 1, :] = out[..., 1, :] / (2 ** scale)
    return out


def build_intrinsics_pyramid(k_full: np.ndarray, num_scales: int) -> Dict[str, np.ndarray]:
    """K/{s} and inv_K/{s} for s in [0, num_scales)."""
    out = {}
    for s in range(num_scales):
        ks = scale_intrinsics(k_full, s)
        out[f"K/{s}"] = ks.astype(np.float32)
        out[f"inv_K/{s}"] = np.linalg.inv(ks).astype(np.float32)
    return out


def required_keys(frame_ids: Sequence[int], fusion_level: int,
                  with_depth: bool = False) -> List[str]:
    keys = ["extrinsics", "extrinsics_inv", "mask"]
    n_scales = fusion_level + 2
    for s in range(n_scales):
        keys += [f"K/{s}", f"inv_K/{s}"]
        keys += [color_key(0, s), color_key(0, s, aug=True)]
    for f in frame_ids:
        if f == 0:
            continue
        keys += [color_key(f, 0), color_key(f, 0, aug=True)]
    if with_depth:
        keys.append("depth")
    return keys
