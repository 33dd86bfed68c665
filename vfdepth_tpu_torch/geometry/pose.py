"""Multi-camera pose algebra (port of ``vfdepth_tpu/geometry/pose.py``).

Only ``distribute_pose`` is on the serving path; ``relative_cam_poses``
belongs to the training slice (view rendering).
"""
from __future__ import annotations

import torch


def distribute_pose(canon_t: torch.Tensor, extrinsics: torch.Tensor,
                    extrinsics_inv: torch.Tensor) -> torch.Tensor:
    """Distribute one canonical pose to every camera:
    T_c = E_c^-1 E_0 T E_0^-1 E_c.

    canon_t [b, 4, 4]; extrinsics / extrinsics_inv [b, cams, 4, 4]
    (camera-to-world). Returns [b, cams, 4, 4] per-camera cam_T_cam.
    """
    mid = torch.einsum("bij,bjk,bkl->bil", extrinsics[:, 0], canon_t,
                       extrinsics_inv[:, 0])
    return torch.einsum("bcij,bjk,bckl->bcil", extrinsics_inv, mid, extrinsics)
