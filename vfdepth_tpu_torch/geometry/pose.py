"""Multi-camera pose algebra (port of ``vfdepth_tpu/geometry/pose.py``).

``distribute_pose`` (serving and training) and ``relative_cam_poses``
(view rendering, training).
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


def relative_cam_poses(extrinsics: torch.Tensor, extrinsics_inv: torch.Tensor,
                       cam_t_cam: torch.Tensor, rel_cam: torch.Tensor):
    """Spatio and spatio-temporal transforms for every camera pair.

    extrinsics / extrinsics_inv [b, cams, 4, 4]; cam_t_cam [b, cams, n_ctx,
    4, 4]; rel_cam [cams, n_nbr] neighbour indices (>= 0). Returns
    (spatio [b, cams, n_nbr, 4, 4] = E_nbr^-1 E_cam, spatio_tempo [b, cams,
    n_ctx, n_nbr, 4, 4] = spatio @ T_cam).
    """
    nbr_ext_inv = extrinsics_inv[:, rel_cam]
    spatio = torch.einsum("bcnij,bcjk->bcnik", nbr_ext_inv, extrinsics)
    spatio_tempo = torch.einsum("bcnij,bcfjk->bcfnik", spatio, cam_t_cam)
    return spatio, spatio_tempo
