"""Depth / pose networks (port of ``vfdepth_tpu/models/nets.py``): the
surround-fusion nets and the Monodepth2 baselines ('fsm').

Inputs and outputs at the nets' boundaries are NHWC, as in the JAX package:
the fusion nets' with an explicit camera axis, the fsm nets' on a
camera-packed batch [b*cams, H, W, 3] (each camera alone); the convolutions
inside run NCHW.

Each net's ``forward`` is the JAX ``__call__``: its own back-projection,
group-reduced (kernel K1) where the rig's two overlap groups are equal,
per camera (kernel K1b) otherwise. The model merges the two nets'
back-projections into one by default and calls the halves
(``encode_aggregate``, ``*_from_backprojection``) itself. Where the
``grouped`` flag of a half says whether ``feat`` holds the two group sums
([b, 2, n, C+1]) or one row per camera ([b, cams, n, C+1]), it defaults to
the group sums (the JAX package defaults to per camera).

The depth-synthesis branch: given rotated extrinsics, the depth net
decodes the same voxel volume a second time along the rotated frusta
(kernel K3 again, ``disp/{s}/aug``), with the same reduction and decoder;
``fuse_voxel`` and ``decode_view`` split the net for the eval sweep
(``training/synthesis.py``).

``dtype`` is the compute dtype of every layer (``models/blocks.py``);
``sampler_3d`` (the depth net's) picks the update dtype of the frustum
sampler's backward (``models/vfnet.py``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .blocks import ConvBlock, pack_cam_feat, unpack_cam_feat
from .decoders import FusionDepthDecoder, MonoDepthDecoder, PoseDecoder
from .resnet import ResnetEncoder, num_ch_enc
from .vfnet import VFNet
from ..geometry.se3 import axis_angle_to_matrix
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


def _own_backprojection(fn: VFNet, feats_agg, mask, intrinsics,
                        extrinsics_inv, plain: bool):
    """A net's own back-projection: (feat, count, grouped), group sums (K1)
    where ``fn`` allows them, else one row per camera (K1b)."""
    if fn.grouped_backprojection:
        feat, count = fn.backproject_into_voxel_grouped(
            feats_agg, mask, intrinsics, extrinsics_inv, plain=plain)
        return feat, count, True
    feat, _, count = fn.backproject_into_voxel(
        feats_agg, mask, intrinsics, extrinsics_inv, plain=plain)
    return feat, count, False


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
                extrinsics_aug: Optional[torch.Tensor] = None,
                plain: bool = False) -> Dict[str, torch.Tensor]:
        """images [b, cams, H, W, 3] (frame 0), mask [b, cams, H, W, 1],
        intrinsics and inv_k at the fusion scale -> {'disp/{s}'}, and
        {'disp/{s}/aug'} where ``extrinsics_aug`` is given."""
        feats, feats_agg = self.encode_aggregate(images)
        feat, count, grouped = _own_backprojection(
            self.fusion_net, feats_agg, mask, intrinsics, extrinsics_inv,
            plain)
        return self.decode_from_backprojection(
            feat, count, feats[:self.fusion_level], inv_k, extrinsics,
            extrinsics_aug=extrinsics_aug, grouped=grouped, plain=plain)

    def decode_from_backprojection(self, feat: torch.Tensor,
                                   count: torch.Tensor,
                                   skip_feats: Sequence[torch.Tensor],
                                   inv_k: torch.Tensor,
                                   extrinsics: torch.Tensor,
                                   extrinsics_aug: Optional[
                                       torch.Tensor] = None,
                                   grouped: bool = True,
                                   plain: bool = False
                                   ) -> Dict[str, torch.Tensor]:
        """Back-projected voxel features feat (camera-group sums [b, 2, n,
        C+1], or per camera [b, cams, n, C+1] unless ``grouped``) and count
        [b, n] -> {'disp/{s}': [b, cams, H/2^s, W/2^s, 1]}; with
        ``extrinsics_aug`` also {'disp/{s}/aug'}, the volume decoded along
        the rotated frusta after the main decode (so a train-mode step
        updates BatchNorm's statistics in the JAX package's order)."""
        b, cams = inv_k.shape[:2]
        voxel_feat = self.fusion_net.fuse_depth(feat, count, grouped=grouped)
        outputs = {}
        views = [(extrinsics, "")]
        if extrinsics_aug is not None:
            views.append((extrinsics_aug, "/aug"))
        for ext, tag in views:
            proj = self.fusion_net.project_voxel_into_image(
                voxel_feat, inv_k, ext, plain=plain)
            dec = self.decoder(list(skip_feats) + [proj])
            outputs.update({k + tag: unpack_cam_feat(_to_nhwc(v), b, cams)
                            for k, v in dec.items()})
        return outputs

    def fuse_voxel(self, images: torch.Tensor, mask: torch.Tensor,
                   intrinsics: torch.Tensor, extrinsics_inv: torch.Tensor,
                   plain: bool = False) -> torch.Tensor:
        """Encoder, back-projection and fusion only -> the voxel volume [b,
        n_voxels, C]: the first half of the depth-synthesis sweep."""
        _, feats_agg = self.encode_aggregate(images)
        feat, count, grouped = _own_backprojection(
            self.fusion_net, feats_agg, mask, intrinsics, extrinsics_inv,
            plain)
        return self.fusion_net.fuse_depth(feat, count, grouped=grouped)

    def decode_view(self, voxel_feat: torch.Tensor, inv_k_aug: torch.Tensor,
                    rot: torch.Tensor, extrinsics: torch.Tensor,
                    plain: bool = False) -> torch.Tensor:
        """Camera 0's disparity at a novel viewpoint: the rotation ``rot``
        [3] (axis-angle) applied on top of the extrinsics [b, cams, 4, 4],
        inv_k_aug [b, cams, 4, 4] at the fusion scale -> [b, H', W', 1] at
        the finest scale. The JAX package decodes every camera and keeps
        camera 0; with BatchNorm in eval mode every camera decodes alone,
        so only camera 0 is decoded here (one K3 launch a view)."""
        tform = torch.eye(4, dtype=extrinsics.dtype, device=extrinsics.device)
        tform[:3, :3] = axis_angle_to_matrix(rot.to(extrinsics.dtype))
        ext_aug = tform @ extrinsics[:, :1]
        proj = self.fusion_net.project_voxel_into_image(
            voxel_feat, inv_k_aug[:, :1], ext_aug, plain=plain)
        disp = self.decoder([proj])[f"disp/{min(self.decoder.scales)}"]
        return _to_nhwc(disp)


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
        feat, count, grouped = _own_backprojection(
            self.fusion_net, feats_agg, mask, intrinsics, extrinsics_inv,
            plain)
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


class MonoDepthNet(nn.Module):
    """Monodepth2-style per-camera depth (the 'fsm' baseline; reference
    ``mono_depthnet.py``): ResNet encoder + Monodepth2 decoder on a packed
    image batch [n, H, W, 3] -> {'disp/{s}': [n, H/2^s, W/2^s, 1]}."""

    def __init__(self, num_layers: int = 18,
                 scales: Sequence[int] = (0, 1, 2, 3),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.encoder = ResnetEncoder(num_layers, 1, dtype=dtype)
        self.decoder = MonoDepthDecoder(num_ch_enc(num_layers),
                                        scales=tuple(scales), dtype=dtype)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        dec = self.decoder(self.encoder(_to_nchw(images)))
        return {k: _to_nhwc(v) for k, v in dec.items()}


class MonoPoseNet(nn.Module):
    """Monodepth2-style per-camera pose (reference ``mono_posenet.py``): two
    frames stacked on channels -> ResNet encoder -> pose decoder (stride 1)
    -> (axisangle, translation), each [n, 1, 1, 3], translation clipped to
    +-4 m."""

    def __init__(self, num_layers: int = 18,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.encoder = ResnetEncoder(num_layers, 2, dtype=dtype)
        self.pose_decoder = PoseDecoder(num_ch_enc(num_layers)[-1], 1,
                                        stride=1, dtype=dtype)

    def forward(self, cur_images: torch.Tensor, next_images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        pair = torch.cat([cur_images, next_images], dim=-1)
        axisangle, translation = self.pose_decoder(
            self.encoder(_to_nchw(pair))[-1])
        return axisangle, ties.clip(translation, -4.0, 4.0)
