"""The novel-view depth-synthesis sweep (port of
``vfdepth_tpu/training/synthesis.py``), an eval-time visualisation.

At one eval batch the depth net fuses its voxel volume once
(``FusedDepthNet.fuse_voxel``: encoder, back-projection K1, fusion), then
decodes camera 0's disparity at each of the ~788 scripted viewpoints of
``utils/visualize.py aug_depth_params`` (roll and pitch sweeps, a focal
morph, a 360-degree yaw): one ``decode_view`` a view, each one frustum
sample (kernel K3) of camera 0 plus the reduction and the decoder.
BatchNorm runs in eval mode and no gradient is kept.
"""
from __future__ import annotations

from typing import List, Mapping, Optional

import numpy as np
import torch

from ..models.nets import FusedDepthNet
from ..utils.visualize import aug_depth_params


def synthesize_sweep(model, batch: Mapping, n_steps: int = 75,
                     max_views: Optional[int] = None) -> List[np.ndarray]:
    """``model`` a ``VFDepthModel`` with the fusion depth net, ``batch`` a
    batch dict (numpy or tensors) -> one [b, H', W', 1] f32 disparity (the
    finest scale) a view, on the host. ``max_views`` caps the sweep (tests,
    quick previews); None renders all of it."""
    net = model.depth_net
    if not isinstance(net, FusedDepthNet):
        raise ValueError("the sweep needs the fusion depth net")
    lev = model.fusion_level + 1
    k = batch[f"K/{lev}"]
    k = (k.detach().float().cpu().numpy() if isinstance(k, torch.Tensor)
         else np.asarray(k, np.float32))
    params = aug_depth_params(k, n_steps)
    if max_views is not None:
        params = params[:max_views]
    iks = torch.from_numpy(np.stack([np.asarray(p[0], np.float32)
                                     for p in params])).to(model.device)
    rots = torch.from_numpy(np.asarray([[p[1], p[2], p[3]] for p in params],
                                       np.float32)).to(model.device)

    x = model._to_device(batch, {"color_aug/0/0", "mask", f"K/{lev}",
                                 "extrinsics", "extrinsics_inv"})
    plain = model.plain_samplers
    disps: List[np.ndarray] = []
    with torch.no_grad(), model._bn_mode(False):
        voxel_feat = net.fuse_voxel(x["color_aug/0/0"], x["mask"],
                                    x[f"K/{lev}"], x["extrinsics_inv"],
                                    plain=plain)
        for ik, rot in zip(iks, rots):
            disp = net.decode_view(voxel_feat, ik, rot, x["extrinsics"],
                                   plain=plain)
            disps.append(disp.float().cpu().numpy())
    return disps
