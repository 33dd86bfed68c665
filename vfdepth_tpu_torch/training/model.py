"""The surround-fusion model (port of ``vfdepth_tpu/training/model.py``).

Both entry points compute the prediction as the JAX ``predict_pose_depth``
does: both nets' aggregated feature maps go through ONE merged
back-projection, the pose branch takes its channels plus the shared
rel-depth channel, the depth branch the rest, then the frustum sample
(kernel K3), the decoder and ``to_depth``'s fx/300 metric scale. The
back-projection is group-reduced (kernel K1) where the rig's two overlap
groups are equal (the 6-camera rig) and per camera (kernel K1b) otherwise
(the 3-camera rig). ``tpu.merge_backprojection: false`` runs the JAX
``predict_pose`` / ``predict_depth`` instead: each net back-projects its
own features (``FusedPoseNet.forward``, ``FusedDepthNet.forward``). So does
``tpu.batch_pose_frames: false`` with more than one context frame: the
pose net then runs once per context frame, as the reference VFDepth
predicts pose.

* ``predict(batch)`` serves: BatchNorm in eval mode, under
  ``torch.inference_mode``; returns ``cam_T_cam`` and ``disp/{s}``,
  ``depth/{s}`` per scale.
* ``forward(batch, step, noise)`` trains, the counterpart of JAX
  ``forward(train=True)``: BatchNorm in train mode (flax's running
  statistics), then ``relative_cam_poses``, ``render_views`` (kernel K5)
  and ``total_loss``; returns (outputs, loss, logs). Its backward runs the
  kernels K2 (of K1) or K2b (of K1b), K4 (of K3) and K5's coordinate
  gradient.

``tpu.mixed_precision: true`` computes every network in bf16 as the JAX
package does (``compute_dtype``; parameters, BatchNorm statistics and Adam
state stay f32, ``models/blocks.py`` says where each layer casts): the
back-projected features, the voxel volume and the frustum sample are bf16
(the bf16 forms of kernels K1 / K1b, K2 / K2b, K3), the colours are cast to
bf16 before rendering (K5's bf16 form; the loss targets stay f32), and the
disparity sigmoid, the pose head and every sampling coordinate stay f32.

``tpu.sampler_3d`` picks the frustum sampler's backward (K4) as the JAX
package does: 'packed' sums bf16 updates (K4's bf16-update form, in an f32
config too), 'packed_f32grad' f32 ones (of a bf16 cotangent too, under
mixed precision), 'gather' f32 ones in an f32 config (the same function up
to summation order), and None means 'packed' under mixed precision and
'packed_f32grad' otherwise.

Not ported yet (raise ``NotImplementedError``): the 'fsm' nets,
``sampler_3d: gather`` under mixed precision (JAX's backward is an XLA
scatter of bf16 updates into a bf16 volume, not a TPU kernel), the
depth-synthesis branch (``predict`` skips it, ``forward`` raises). Config
keys that name TPU alternates of one
function map onto the port's one implementation (the CUDA kernel for CUDA
tensors, its plain version for CPU tensors): ``tpu.sampler_2d``,
``tpu.warp_op`` and ``tpu.warp_window`` (the port's warps are dense; the
JAX windows give the same loss by construction).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from ..config import Config
from ..device import resolve_device
from ..geometry import (distribute_pose, invert_pose, relative_cam_poses,
                        vec_to_matrix)
from ..geometry.view_rendering import render_views
from ..losses import LossConfig, total_loss
from ..models import (FusedDepthNet, FusedPoseNet, backproject_features,
                      backproject_features_grouped, grouped_backprojection_ok)
from ..ops.resize import resize_bilinear
from ..weights import init_random

_SAMPLERS_2D = (None, "auto", "pallas", "matmul", "gather")
_SAMPLERS_3D = (None, "packed", "packed_f32grad", "gather")
_WARP_OPS = (None, "auto", "mxu", "quad")


def loss_config_from(cfg: Config) -> LossConfig:
    return LossConfig(
        frame_ids=tuple(cfg.frame_ids),
        scales=tuple(cfg.scales),
        disparity_smoothness=cfg.disparity_smoothness,
        spatio_coeff=cfg.spatio_coeff,
        spatio_tempo_coeff=cfg.spatio_tempo_coeff,
        pose_loss_coeff=cfg.pose_loss_coeff,
        depth_con_coeff=cfg.get("depth_con_coeff", 0.03),
        depth_sm_coeff=cfg.get("depth_sm_coeff", 0.05),
        spatio=cfg.spatio,
        spatio_temporal=cfg.spatio_temporal,
        aug_depth=cfg.aug_depth,
        pose_model=cfg.pose_model,
        warmup_steps=int(cfg.get("cold_start_warmup_steps", 0)),
        ramp_steps=int(cfg.get("cold_start_ramp_steps", 0)),
        stagger_ramps=bool(cfg.get("cold_start_stagger_ramps", False)),
        pose_prior_coeff=float(cfg.get("cold_start_pose_coeff", 1.0)),
        pose_prior_floor=float(cfg.get("cold_start_pose_floor", 0.1)),
        pose_prior_ceil=float(cfg.get("cold_start_pose_ceil", 1.0)),
        disp_anchor_coeff=float(cfg.get("cold_start_disp_coeff", 0.1)),
    )


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
        self.cfg = cfg
        if cfg.depth_model != "fusion" or cfg.pose_model != "fusion":
            raise NotImplementedError("only the fusion nets are ported")
        self.compute_dtype = (torch.bfloat16
                              if cfg.get("mixed_precision", False) else None)
        self.frame_ids = tuple(cfg.frame_ids)
        # one pose-net pass for all context frames, or one per frame
        self.batch_pose_frames = bool(cfg.get("batch_pose_frames", True))
        # one back-projection for both nets (JAX _can_merge_backproject,
        # whose net-type conditions the port meets whenever it builds)
        self.merge_backproject = bool(cfg.get("merge_backprojection", True))
        if cfg.get("sampler_2d") not in _SAMPLERS_2D:
            raise ValueError(f"unknown sampler_2d {cfg.get('sampler_2d')!r}")
        if cfg.get("sampler_3d") not in _SAMPLERS_3D:
            raise ValueError(f"unknown sampler_3d {cfg.get('sampler_3d')!r}")
        if cfg.get("warp_op") not in _WARP_OPS:
            raise ValueError(f"unknown warp_op {cfg.get('warp_op')!r}")
        # the JAX rule (training/model.py:177-182): bf16 backward updates
        # for an explicit 'packed', and by default under mixed precision
        self.sampler_3d = cfg.get("sampler_3d") or (
            "packed" if self.compute_dtype is not None else "packed_f32grad")
        self.groups = tuple(map(tuple, cfg.overlap_groups))
        # K1 where the two overlap groups split the rig equally, else K1b
        self.grouped = grouped_backprojection_ok(self.groups, cfg.num_cams)
        if self.compute_dtype is not None and self.sampler_3d == "gather":
            raise NotImplementedError(
                "mixed precision with sampler_3d 'gather' (an XLA scatter of "
                "bf16 updates into the bf16 volume) is not ported; 'packed' "
                "and 'packed_f32grad' are (ROADMAP A5)")

        self.scales = tuple(cfg.scales)
        self.height, self.width = cfg.height, cfg.width
        self.fusion_level = cfg.fusion_level
        self.min_depth, self.max_depth = cfg.min_depth, cfg.max_depth
        self.focal_length_scale = cfg.focal_length_scale
        self.loss_cfg = loss_config_from(cfg)
        self.intensity_align = bool(cfg.intensity_align)
        self.plain_samplers = False
        self.voxel = dict(voxel_str_p=tuple(cfg.voxel_str_p),
                          voxel_unit_size=tuple(cfg.voxel_unit_size),
                          voxel_size=tuple(cfg.voxel_size))
        vfnet_kwargs = dict(
            **self.voxel, proj_d_bins=cfg.proj_d_bins,
            proj_d_str=cfg.proj_d_str, proj_d_end=cfg.proj_d_end,
            num_cams=cfg.num_cams, height=cfg.height, width=cfg.width,
            dtype=self.compute_dtype)
        self.depth_net = FusedDepthNet(
            cfg.num_layers, cfg.fusion_level, cfg.fusion_feat_in_dim,
            use_skips=cfg.use_skips, scales=self.scales,
            voxel_pre_dim=tuple(cfg.voxel_pre_dim),
            overlap_groups=self.groups, sampler_3d=self.sampler_3d,
            **vfnet_kwargs)
        self.pose_net = FusedPoseNet(cfg.num_layers, cfg.fusion_level,
                                     cfg.fusion_feat_in_dim, **vfnet_kwargs)
        # weights_init (ImageNet encoders) needs a weight file the repository
        # does not hold; the JAX package skips it in that case too
        init_random(self, torch.Generator().manual_seed(seed))
        self.to(self.device)
        # [cams, 2] neighbour indices, -1 = none (not a buffer: no state)
        self.rel_cam = torch.as_tensor(cfg.rel_cam_array,
                                       device=self.device).long()
        self.eval()

    @contextlib.contextmanager
    def _bn_mode(self, train: bool):
        """BatchNorm (the only mode-dependent layer) in train or eval mode
        for the block, restored after it."""
        was = self.training
        self.train(train)
        try:
            yield
        finally:
            self.train(was)

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

    def _to_device(self, batch: Mapping, keys=None) -> Dict[str, torch.Tensor]:
        """The batch's arrays (those named by ``keys``, else all) as f32
        tensors on this model's device."""
        keys = batch.keys() if keys is None else keys & batch.keys()
        x = {k: torch.as_tensor(batch[k]).to(self.device, torch.float32)
             for k in keys}
        if "extrinsics_inv" not in x:
            x["extrinsics_inv"] = invert_pose(x["extrinsics"])
        return x

    def _predict_pose_depth(self, x: Mapping[str, torch.Tensor]
                            ) -> Tuple[torch.Tensor, Dict[int, torch.Tensor]]:
        """(cam_T_cam [b, cams, n_ctx, 4, 4], {scale: disp [b, cams, h, w,
        1]}) from a batch already on the device."""
        fk = f"K/{self.fusion_level + 1}"
        fik = f"inv_K/{self.fusion_level + 1}"
        ctx = self.frame_ids[1:]
        n_ctx = len(ctx)
        bsz = x["color_aug/0/0"].shape[0]

        # time-ordered context pairs, group-major along batch (one BatchNorm
        # batch for all pairs, as in the JAX package)
        curs = torch.cat([x[f"color_aug/{f if f < 0 else 0}/0"] for f in ctx])
        nxts = torch.cat([x[f"color_aug/{0 if f < 0 else f}/0"] for f in ctx])
        pose_feats = self.pose_net.encode_aggregate(curs, nxts, n_ctx=n_ctx)
        dfeats, depth_feats = self.depth_net.encode_aggregate(
            x["color_aug/0/0"])

        # ONE back-projection for both nets: their projected coordinates are
        # identical, so the feature maps concatenate on channels
        cp = pose_feats.shape[-1]
        merged = torch.cat([pose_feats, depth_feats], dim=-1)
        if self.grouped:
            feat, count = backproject_features_grouped(
                merged, x["mask"], x[fk], x["extrinsics_inv"],
                groups=self.groups, plain=self.plain_samplers, **self.voxel)
        else:
            feat, _, count = backproject_features(
                merged, x["mask"], x[fk], x["extrinsics_inv"],
                plain=self.plain_samplers, **self.voxel)
        # the trailing rel-depth channel is shared by both branches. Autograd
        # of these slices and this cat already gives the merged cotangent as
        # the JAX package's custom VJP writes it (_split_merged_channels: one
        # concat plus the rel-column add), so no Function is needed here.
        feat_pose = torch.cat([feat[..., :cp], feat[..., -1:]], dim=-1)
        feat_depth = feat[..., cp:]

        axisangle, translation = self.pose_net.pose_from_backprojection(
            feat_pose, count, n_ctx=n_ctx, grouped=self.grouped)
        skips = [dfeats[i] for i in range(self.fusion_level)]
        disps = self.depth_net.decode_from_backprojection(
            feat_depth, count, skips, x[fik], x["extrinsics"],
            grouped=self.grouped, plain=self.plain_samplers)
        return (self._cam_t_cam(axisangle, translation, x, bsz),
                {s: disps[f"disp/{s}"] for s in self.scales})

    def _cam_t_cam(self, axisangle: torch.Tensor, translation: torch.Tensor,
                   x: Mapping[str, torch.Tensor], bsz: int) -> torch.Tensor:
        """The pose net's canonical motions [n_ctx*b, 1, 1, 3] (context
        frames group-major) -> cam_T_cam [b, cams, n_ctx, 4, 4]; a past
        frame's motion is inverted."""
        ctx = self.frame_ids[1:]
        aa = axisangle[:, 0, 0].reshape(len(ctx), bsz, 3)
        tr = translation[:, 0, 0].reshape(len(ctx), bsz, 3)
        return torch.stack(
            [distribute_pose(vec_to_matrix(aa[i], tr[i], invert=(f < 0)),
                             x["extrinsics"], x["extrinsics_inv"])
             for i, f in enumerate(ctx)], dim=2)

    def predict_pose(self, x: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The pose net alone, on its own back-projection (JAX
        ``predict_pose``): cam_T_cam [b, cams, n_ctx, 4, 4] from a batch
        already on the device. With batched pose frames the context pairs
        go through one pass; otherwise through one pass each, in the order
        of ``frame_ids[1:]`` (pairs in time order, a past frame's motion
        inverted), and in train mode each pass normalises with its own
        batch statistics and updates the running ones in turn."""
        lev = self.fusion_level + 1
        ctx = self.frame_ids[1:]
        calib = (x["mask"], x[f"K/{lev}"], x[f"inv_K/{lev}"], x["extrinsics"],
                 x["extrinsics_inv"])
        pairs = [(x[f"color_aug/{f if f < 0 else 0}/0"],
                  x[f"color_aug/{0 if f < 0 else f}/0"]) for f in ctx]
        if self.batch_pose_frames or len(ctx) < 2:
            outs = [self.pose_net(torch.cat([c for c, _ in pairs]),
                                  torch.cat([n for _, n in pairs]), *calib,
                                  n_ctx=len(ctx), plain=self.plain_samplers)]
        else:
            outs = [self.pose_net(c, n, *calib, plain=self.plain_samplers)
                    for c, n in pairs]
        # per-frame passes stack group-major, as one batched pass returns
        return self._cam_t_cam(torch.cat([o[0] for o in outs]),
                               torch.cat([o[1] for o in outs]), x,
                               x["color_aug/0/0"].shape[0])

    def predict_depth(self, x: Mapping[str, torch.Tensor]
                      ) -> Dict[int, torch.Tensor]:
        """The depth net alone, on its own back-projection (JAX
        ``predict_depth``): {scale: disp [b, cams, h, w, 1]}."""
        lev = self.fusion_level + 1
        out = self.depth_net(x["color_aug/0/0"], x["mask"], x[f"K/{lev}"],
                             x[f"inv_K/{lev}"], x["extrinsics"],
                             x["extrinsics_inv"], plain=self.plain_samplers)
        return {s: out[f"disp/{s}"] for s in self.scales}

    def _can_merge_backproject(self) -> bool:
        # an instance-level predict_pose override must keep routing through
        # predict_pose: the merged path would silently bypass it
        return (self.merge_backproject and "predict_pose" not in self.__dict__
                and (self.batch_pose_frames or len(self.frame_ids) <= 2))

    def _predict(self, x: Mapping[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[int, torch.Tensor]]:
        """(cam_T_cam, {scale: disp}) through the merged back-projection,
        or through each net's own where the two are not merged."""
        if self._can_merge_backproject():
            return self._predict_pose_depth(x)
        return self.predict_pose(x), self.predict_depth(x)

    @torch.inference_mode()
    def predict(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """Batch dict (NHWC numpy arrays or tensors, the JAX package's
        contract) -> {'cam_T_cam' [b, cams, n_ctx, 4, 4], 'disp/{s}',
        'depth/{s}' [b, cams, H, W, 1]} on this model's device. BatchNorm
        runs in eval mode. Raises under ``aug_depth`` (the depth-synthesis
        outputs ``disp/{s}/aug`` and ``depth/{s}/aug`` are not ported)."""
        if self.loss_cfg.aug_depth:
            raise NotImplementedError("the depth-synthesis branch is not "
                                      "ported")
        lev = self.fusion_level + 1
        keys = {f"K/{lev}", f"inv_K/{lev}", "K/0", "mask", "extrinsics",
                "extrinsics_inv",
                *(f"color_aug/{f}/0" for f in self.frame_ids)}
        x = self._to_device(batch, keys)
        with self._bn_mode(False):
            cam_t_cam, disps = self._predict(x)
        outputs = {"cam_T_cam": cam_t_cam}
        for s in self.scales:
            outputs[f"disp/{s}"] = disps[s]
            outputs[f"depth/{s}"] = self.to_depth(disps[s], x["K/0"])
        return outputs

    def noise_shape(self, batch: Mapping) -> Tuple[int, ...]:
        """Shape of ``forward``'s tie-break noise: [n_scales, b, cams,
        n_ctx, H, W, 1]."""
        b, cams, h, w = batch["color/0/0"].shape[:4]
        return (len(self.scales), b, cams, len(self.frame_ids) - 1, h, w, 1)

    def forward(self, batch: Mapping, step=None,
                noise: Optional[torch.Tensor] = None):
        """One training forward with the loss -> (outputs, loss, logs).

        BatchNorm runs in train mode: batch statistics, running statistics
        updated in place. ``step`` drives the cold-start schedule when the
        config sets one. ``noise`` [n_scales, b, cams, n_ctx, H, W, 1]
        (``noise_shape``) holds the standard normals of the identity-loss
        tie-break (the JAX package draws them from its key; see
        ``training/step.py train_step``).
        """
        if self.loss_cfg.aug_depth:
            raise NotImplementedError("the depth-synthesis branch is not "
                                      "ported")
        x = self._to_device(batch)
        if noise is None or tuple(noise.shape) != self.noise_shape(x):
            raise ValueError(f"noise must have shape {self.noise_shape(x)}")
        with self._bn_mode(True):
            cam_t_cam, disps = self._predict(x)
        k0 = x["K/0"]
        depths = {s: self.to_depth(disps[s], k0) for s in self.scales}
        spatio_pose, st_pose = relative_cam_poses(
            x["extrinsics"], x["extrinsics_inv"], cam_t_cam, self.rel_cam)
        # the warp sources in the compute dtype; the loss targets stay f32
        colors = {f: x[f"color/{f}/0"].to(self.compute_dtype or torch.float32)
                  for f in self.frame_ids}
        rendered = {s: render_views(
            colors, x["mask"], k0, x["inv_K/0"], depths[s], cam_t_cam,
            spatio_pose, st_pose, self.rel_cam, self.frame_ids,
            do_intensity_align=self.intensity_align,
            spatio=self.loss_cfg.spatio,
            spatio_temporal=self.loss_cfg.spatio_temporal,
            plain=self.plain_samplers) for s in self.scales}
        loss, logs = total_loss(noise.to(self.device), self.loss_cfg, x,
                                disps, depths, cam_t_cam, rendered,
                                step=step)
        outputs = {"cam_T_cam": cam_t_cam}
        for s in self.scales:
            outputs[f"disp/{s}"] = disps[s]
            outputs[f"depth/{s}"] = depths[s]
        return outputs, loss, logs
