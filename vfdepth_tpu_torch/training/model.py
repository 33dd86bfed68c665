"""The serving path of the surround-fusion model (port of
``vfdepth_tpu/training/model.py``).

``VFDepthModel.predict(batch)`` returns the prediction part of the JAX
``VFDepthModel.forward`` outputs — ``cam_T_cam`` and ``disp/{s}``,
``depth/{s}`` per scale — computed as ``predict_pose_depth`` does: both
nets' aggregated feature maps go through ONE merged, group-reduced
back-projection (kernel K1), the pose branch takes its channels plus the
shared rel-depth channel, the depth branch the rest, then the frustum
sample (kernel K3), the decoder and ``to_depth``'s fx/300 metric scale. No
loss and no view rendering: those belong to the training slice. BatchNorm
runs in eval mode.

Not ported yet (raise ``NotImplementedError``): the 'fsm' nets, rigs whose
overlap groups are unequal (the ungrouped sampler, K1b),
``merge_backprojection: false``, unbatched pose frames, mixed precision.
The ``tpu.sampler_2d`` / ``tpu.sampler_3d`` keys name TPU alternates of one
function: every value maps onto the port's one implementation (the CUDA
kernel for CUDA tensors, its plain version for CPU tensors).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import torch
from torch import nn

from ..config import Config
from ..device import resolve_device
from ..geometry import distribute_pose, invert_pose, vec_to_matrix
from ..models import (FusedDepthNet, FusedPoseNet, backproject_features_grouped,
                      grouped_backprojection_ok)
from ..ops.resize import resize_bilinear
from ..weights import init_random

_SAMPLERS_2D = (None, "auto", "pallas", "matmul", "gather")
_SAMPLERS_3D = (None, "packed", "packed_f32grad", "gather")


class VFDepthModel(nn.Module):
    """Depth net + pose net built from a ``Config``, on one device.

    ``device`` defaults to CUDA and raises without it; pass "cpu" for the
    plain PyTorch versions of the kernels (tests). Parameters start from a
    seeded random init (``weights.init_random``); ``weights.load_flax_params``
    carries the JAX package's parameters over. Setting ``plain_samplers``
    runs the kernels' plain versions on any device (a reference run on the
    card).
    """

    def __init__(self, cfg: Config,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0):
        super().__init__()
        self.device = resolve_device(device)
        if cfg.depth_model != "fusion" or cfg.pose_model != "fusion":
            raise NotImplementedError("only the fusion nets are ported")
        if cfg.get("mixed_precision", False):
            raise NotImplementedError("mixed precision is not ported")
        if not cfg.get("merge_backprojection", True):
            raise NotImplementedError(
                "separate pose / depth back-projections are not ported")
        self.frame_ids = tuple(cfg.frame_ids)
        if not cfg.get("batch_pose_frames", True) and len(self.frame_ids) > 2:
            raise NotImplementedError("unbatched pose frames are not ported")
        if cfg.get("sampler_2d") not in _SAMPLERS_2D:
            raise ValueError(f"unknown sampler_2d {cfg.get('sampler_2d')!r}")
        if cfg.get("sampler_3d") not in _SAMPLERS_3D:
            raise ValueError(f"unknown sampler_3d {cfg.get('sampler_3d')!r}")
        self.groups = tuple(map(tuple, cfg.overlap_groups))
        if not grouped_backprojection_ok(self.groups, cfg.num_cams):
            raise NotImplementedError(
                f"overlap groups {self.groups} do not split the rig equally; "
                "the ungrouped back-projection is not ported")

        self.scales = tuple(cfg.scales)
        self.height, self.width = cfg.height, cfg.width
        self.fusion_level = cfg.fusion_level
        self.min_depth, self.max_depth = cfg.min_depth, cfg.max_depth
        self.focal_length_scale = cfg.focal_length_scale
        self.plain_samplers = False
        self.voxel = dict(voxel_str_p=tuple(cfg.voxel_str_p),
                          voxel_unit_size=tuple(cfg.voxel_unit_size),
                          voxel_size=tuple(cfg.voxel_size))
        vfnet_kwargs = dict(
            **self.voxel, proj_d_bins=cfg.proj_d_bins,
            proj_d_str=cfg.proj_d_str, proj_d_end=cfg.proj_d_end,
            num_cams=cfg.num_cams, height=cfg.height, width=cfg.width)
        self.depth_net = FusedDepthNet(
            cfg.num_layers, cfg.fusion_level, cfg.fusion_feat_in_dim,
            use_skips=cfg.use_skips, scales=self.scales,
            voxel_pre_dim=tuple(cfg.voxel_pre_dim), **vfnet_kwargs)
        self.pose_net = FusedPoseNet(cfg.num_layers, cfg.fusion_level,
                                     cfg.fusion_feat_in_dim, **vfnet_kwargs)
        # weights_init (ImageNet encoders) needs a weight file the repository
        # does not hold; the JAX package skips it in that case too
        init_random(self, torch.Generator().manual_seed(seed))
        self.to(self.device)
        self.eval()

    def to_depth(self, disp: torch.Tensor, k0: torch.Tensor) -> torch.Tensor:
        """Disparity [b, cams, h, w, 1] -> metric depth at full resolution:
        1 / (1/max_d + (1/min_d - 1/max_d) * disp), bilinearly upsampled
        (align_corners=False), scaled by fx / focal_length_scale."""
        min_disp = 1.0 / self.max_depth
        max_disp = 1.0 / self.min_depth
        disp_full = resize_bilinear(disp, (self.height, self.width),
                                    align_corners=False)
        depth = 1.0 / (min_disp + (max_disp - min_disp) * disp_full)
        fx = k0[..., 0:1, 0:1]                 # [b, cams, 1, 1]
        return depth * fx[..., None] / self.focal_length_scale

    @torch.inference_mode()
    def predict(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """Batch dict (NHWC numpy arrays or tensors, the JAX package's
        contract) -> {'cam_T_cam' [b, cams, n_ctx, 4, 4], 'disp/{s}',
        'depth/{s}' [b, cams, H, W, 1]} on this model's device."""
        fk = f"K/{self.fusion_level + 1}"
        fik = f"inv_K/{self.fusion_level + 1}"
        ctx = self.frame_ids[1:]
        keys = {fk, fik, "K/0", "mask", "extrinsics", "color_aug/0/0",
                *(f"color_aug/{f}/0" for f in ctx)}
        if "extrinsics_inv" in batch:
            keys.add("extrinsics_inv")
        x = {k: torch.as_tensor(batch[k]).to(self.device, torch.float32)
             for k in keys}
        if "extrinsics_inv" not in x:
            x["extrinsics_inv"] = invert_pose(x["extrinsics"])
        n_ctx = len(ctx)
        bsz = x["color_aug/0/0"].shape[0]

        # time-ordered context pairs, group-major along batch
        curs = torch.cat([x[f"color_aug/{f if f < 0 else 0}/0"] for f in ctx])
        nxts = torch.cat([x[f"color_aug/{0 if f < 0 else f}/0"] for f in ctx])
        pose_feats = self.pose_net.encode_aggregate(curs, nxts, n_ctx=n_ctx)
        dfeats, depth_feats = self.depth_net.encode_aggregate(
            x["color_aug/0/0"])

        # ONE back-projection for both nets: their projected coordinates are
        # identical, so the feature maps concatenate on channels
        cp = pose_feats.shape[-1]
        feat, count = backproject_features_grouped(
            torch.cat([pose_feats, depth_feats], dim=-1), x["mask"], x[fk],
            x["extrinsics_inv"], groups=self.groups, plain=self.plain_samplers,
            **self.voxel)
        # the trailing rel-depth channel is shared by both branches
        feat_pose = torch.cat([feat[..., :cp], feat[..., -1:]], dim=-1)
        feat_depth = feat[..., cp:]

        axisangle, translation = self.pose_net.pose_from_backprojection(
            feat_pose, count, n_ctx=n_ctx)
        aa = axisangle[:, 0, 0].reshape(n_ctx, bsz, 3)
        tr = translation[:, 0, 0].reshape(n_ctx, bsz, 3)
        mats = [distribute_pose(vec_to_matrix(aa[i], tr[i], invert=(f < 0)),
                                x["extrinsics"], x["extrinsics_inv"])
                for i, f in enumerate(ctx)]
        outputs = {"cam_T_cam": torch.stack(mats, dim=2)}

        skips = [dfeats[i] for i in range(self.fusion_level)]
        disps = self.depth_net.decode_from_backprojection(
            feat_depth, count, skips, x[fik], x["extrinsics"],
            plain=self.plain_samplers)
        for s in self.scales:
            outputs[f"disp/{s}"] = disps[f"disp/{s}"]
            outputs[f"depth/{s}"] = self.to_depth(disps[f"disp/{s}"],
                                                  x["K/0"])
        return outputs
