"""Fusion depth / pose networks (port of ``vfdepth_tpu/models/nets.py``).

Inputs and outputs at the nets' boundaries are NHWC with an explicit camera
axis, as in the JAX package; the convolutions inside run NCHW on the
camera-packed batch. The Monodepth2 baselines ('fsm') are not ported yet.

Each net's ``forward`` is the JAX ``__call__``: its own back-projection,
group-reduced (kernel K1) where the rig's two overlap groups are equal,
per camera (kernel K1b) otherwise. The model merges the two nets'
back-projections into one by default and calls the halves
(``encode_aggregate``, ``*_from_backprojection``) itself. Where the
``grouped`` flag of a half says whether ``feat`` holds the two group sums
([b, 2, n, C+1]) or one row per camera ([b, cams, n, C+1]), it defaults to
the group sums (the JAX package defaults to per camera).

``dtype`` is the compute dtype of every layer (``models/blocks.py``);
``sampler_3d`` (the depth net's) picks the update dtype of the frustum
sampler's backward (``models/vfnet.py``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .blocks import ConvBlock, pack_cam_feat, unpack_cam_feat
from .decoders import FusionDepthDecoder, PoseDecoder
from .resnet import ResnetEncoder, num_ch_enc
from .vfnet import VFNet
from ..ops import ties
from ..ops.resize import resize_bilinear


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def _to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def _aggregate(feats: List[torch.Tensor], lev: int,
               conv1x1: ConvBlock) -> torch.Tensor:
    """Encoder levels >= fusion_level, bilinearly upsampled (align_corners)
    to the fusion resolution, concatenated and 1x1-reduced (NCHW)."""
    up = tuple(feats[lev].shape[-2:])
    agg = [feats[lev]] + [resize_bilinear(f, up, align_corners=True,
                                          channels_last=False)
                          for f in feats[lev + 1:]]
    return conv1x1(torch.cat(agg, dim=1))


class FusedDepthNet(nn.Module):
    """Packed 6-cam ResNet encoder -> level aggregation -> VFNet voxel
    round-trip -> fusion depth decoder -> sigmoid disparity."""

    def __init__(self, num_layers: int = 18, fusion_level: int = 2,
                 fusion_feat_in_dim: int = 256, use_skips: bool = False,
                 scales: Sequence[int] = (0,),
                 dtype: Optional[torch.dtype] = None, **vfnet_kwargs):
        super().__init__()
        self.fusion_level = lev = fusion_level
        enc = num_ch_enc(num_layers)
        self.encoder = ResnetEncoder(num_layers, 1, dtype=dtype)
        self.conv1x1 = ConvBlock(sum(enc[lev:]), fusion_feat_in_dim, 1,
                                 dtype=dtype)
        self.fusion_net = VFNet(fusion_feat_in_dim, enc[lev], "depth",
                                fusion_level=lev, dtype=dtype, **vfnet_kwargs)
        self.decoder = FusionDepthDecoder(lev, enc[:lev + 1],
                                          scales=tuple(scales),
                                          use_skips=use_skips, dtype=dtype)

    def encode_aggregate(self, images: torch.Tensor):
        """images [b, cams, H, W, 3] -> (encoder features, packed NCHW;
        aggregated features [b, cams, h, w, C] NHWC)."""
        b, cams = images.shape[:2]
        feats = self.encoder(_to_nchw(pack_cam_feat(images)))
        agg = _aggregate(feats, self.fusion_level, self.conv1x1)
        return feats, unpack_cam_feat(_to_nhwc(agg), b, cams)

    def forward(self, images: torch.Tensor, mask: torch.Tensor,
                intrinsics: torch.Tensor, inv_k: torch.Tensor,
                extrinsics: torch.Tensor, extrinsics_inv: torch.Tensor,
                plain: bool = False) -> Dict[str, torch.Tensor]:
        """images [b, cams, H, W, 3] (frame 0), mask [b, cams, H, W, 1],
        intrinsics and inv_k at the fusion scale -> {'disp/{s}'}."""
        feats, feats_agg = self.encode_aggregate(images)
        fn = self.fusion_net
        grouped = fn.grouped_backprojection
        if grouped:
            feat, count = fn.backproject_into_voxel_grouped(
                feats_agg, mask, intrinsics, extrinsics_inv, plain=plain)
        else:
            feat, _, count = fn.backproject_into_voxel(
                feats_agg, mask, intrinsics, extrinsics_inv, plain=plain)
        return self.decode_from_backprojection(
            feat, count, feats[:self.fusion_level], inv_k, extrinsics,
            grouped=grouped, plain=plain)

    def decode_from_backprojection(self, feat: torch.Tensor,
                                   count: torch.Tensor,
                                   skip_feats: Sequence[torch.Tensor],
                                   inv_k: torch.Tensor,
                                   extrinsics: torch.Tensor,
                                   grouped: bool = True,
                                   plain: bool = False
                                   ) -> Dict[str, torch.Tensor]:
        """Back-projected voxel features feat (camera-group sums [b, 2, n,
        C+1], or per camera [b, cams, n, C+1] unless ``grouped``) and count
        [b, n] -> {'disp/{s}': [b, cams, H/2^s, W/2^s, 1]}."""
        b, cams = inv_k.shape[:2]
        voxel_feat = self.fusion_net.fuse_depth(feat, count, grouped=grouped)
        proj = self.fusion_net.project_voxel_into_image(
            voxel_feat, inv_k, extrinsics, plain=plain)
        dec = self.decoder(list(skip_feats) + [proj])
        return {k: unpack_cam_feat(_to_nhwc(v), b, cams)
                for k, v in dec.items()}


class FusedPoseNet(nn.Module):
    """Two stacked frames per camera -> encoder -> aggregation -> VFNet pose
    (BEV) -> PoseDecoder -> one canonical (axisangle, translation)."""

    def __init__(self, num_layers: int = 18, fusion_level: int = 2,
                 fusion_feat_in_dim: int = 256,
                 dtype: Optional[torch.dtype] = None, **vfnet_kwargs):
        super().__init__()
        self.fusion_level = lev = fusion_level
        enc = num_ch_enc(num_layers)
        self.encoder = ResnetEncoder(num_layers, 2, dtype=dtype)
        self.conv1x1 = ConvBlock(sum(enc[lev:]), fusion_feat_in_dim, 1,
                                 dtype=dtype)
        self.fusion_net = VFNet(fusion_feat_in_dim, enc[lev], "pose",
                                fusion_level=lev, dtype=dtype, **vfnet_kwargs)
        self.pose_decoder = PoseDecoder(enc[lev], 1, stride=2, dtype=dtype)

    def encode_aggregate(self, cur_images: torch.Tensor,
                         next_images: torch.Tensor,
                         n_ctx: int = 1) -> torch.Tensor:
        """Stacked-pair encoder + aggregation. The inputs stack ``n_ctx``
        context pairs group-major along batch ([n_ctx*b, cams, H, W, 3]);
        the output merges them into channel groups [b, cams, h, w, n_ctx*C]
        for the shared-coordinate back-projection."""
        gb, cams = cur_images.shape[:2]
        b = gb // n_ctx
        pair = torch.cat([cur_images, next_images], dim=-1)
        feats = self.encoder(_to_nchw(pack_cam_feat(pair)))
        agg = _aggregate(feats, self.fusion_level, self.conv1x1)
        feats_agg = unpack_cam_feat(_to_nhwc(agg), gb, cams)
        if n_ctx > 1:
            c = feats_agg.shape[-1]
            f = feats_agg.reshape((n_ctx, b) + tuple(feats_agg.shape[1:]))
            f = torch.movedim(f, 0, -2)
            feats_agg = f.reshape(tuple(f.shape[:-2]) + (n_ctx * c,))
        return feats_agg

    def forward(self, cur_images: torch.Tensor, next_images: torch.Tensor,
                mask: torch.Tensor, intrinsics: torch.Tensor,
                inv_k: torch.Tensor, extrinsics: torch.Tensor,
                extrinsics_inv: torch.Tensor, n_ctx: int = 1,
                plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Context pairs stacked group-major along batch ([n_ctx*b, cams, H,
        W, 3] each), mask and calibration at the true batch -> (axisangle,
        translation), each [n_ctx*b, 1, 1, 3]. ``inv_k`` and ``extrinsics``
        are unused (the JAX signature)."""
        feats_agg = self.encode_aggregate(cur_images, next_images,
                                          n_ctx=n_ctx)
        fn = self.fusion_net
        grouped = fn.grouped_backprojection
        if grouped:
            feat, count = fn.backproject_into_voxel_grouped(
                feats_agg, mask, intrinsics, extrinsics_inv, plain=plain)
        else:
            feat, _, count = fn.backproject_into_voxel(
                feats_agg, mask, intrinsics, extrinsics_inv, plain=plain)
        return self.pose_from_backprojection(feat, count, n_ctx=n_ctx,
                                             grouped=grouped)

    def pose_from_backprojection(self, feat: torch.Tensor, count: torch.Tensor,
                                 n_ctx: int = 1, grouped: bool = True
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Back-projected voxel features (camera-group sums [b, 2, n,
        n_ctx*C + 1], or per camera [b, cams, ...] unless ``grouped``) ->
        (axisangle, translation), each [n_ctx*b, 1, 1, 3]; translation
        clipped to +-4 m."""
        bev = self.fusion_net.pose_voxel_to_bev(feat, count,
                                                frame_groups=n_ctx,
                                                grouped=grouped)
        axisangle, translation = self.pose_decoder(bev)
        return axisangle, ties.clip(translation, -4.0, 4.0)
