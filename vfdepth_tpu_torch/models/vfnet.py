"""Volumetric fusion (port of ``vfdepth_tpu/models/vfnet.py``, serving path).

Layouts as in the JAX package: voxel features are channels-last
``[b, n, C]`` with the flat voxel order (y, x, z), z fastest (so the
frustum sampler's yxz volume and the pose path's z-into-channels fold are
plain reshapes), and the frustum sample is ``[b, cams, h, w, d*C]`` with
channel index ``d*C + c`` (``reduce_dim_0``'s weights transfer unpermuted).

Ported: ``_project_cam_points``, the grouped back-projection (kernel K1,
backward K2) for rigs whose two overlap groups are equal, the ungrouped one
(kernel K1b, backward K2b: the 3-camera rig), ``fuse_depth`` and
``pose_voxel_to_bev`` in both forms, ``project_voxel_into_image`` (kernel
K3, backward K4 in the update dtype ``sampler_3d`` names; ``gather`` on a
bf16 volume: the gather-bf16 forms of K3 and K4, ``Sample3dGather``),
``BEVFold`` and ``augment_extrinsics`` (the depth-synthesis branch's
random rotation). Under the camera-axis grid (``parallel/mesh.py``) a rank
back-projects its own cameras per camera (K1b) and sums its members of
each overlap group (``local_group_sums``); the cam group's all-reduce then
gives every rank the two group sums, and the fusion, the pose branch's
BEV and the frustum sample of its cameras run on them as on K1's.

``dtype`` is the compute dtype (``models/blocks.py``). Under mixed
precision the back-projected features, the voxel volume and the frustum
sample are bf16 (the samplers take and return the features' dtype); every
sampling coordinate stays f32. The per-camera rows are summed as JAX sums
them: each overlap group camera by camera in bf16 (``_GroupSums``, each add
rounding), the all-camera sum and the count with one rounding (``sum``
accumulates bf16 in f32, as ``jnp.sum`` does).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import ConvBlock, PointwiseBlock
from ..geometry.projection import (frustum_world_points, linspace_f32,
                                   voxel_points_homo)
from ..geometry.se3 import axis_angle_to_matrix
from ..ops.backproject_sample import (sample_backproject_grouped_raw,
                                      sample_backproject_raw)
from ..ops import ties
from ..ops.resize import resize_bilinear
from ..ops.sample3d import Sample3dGather, Sample3dTrilinear


def _reflect_conv(x: torch.Tensor, weight: torch.Tensor,
                  stride: int) -> torch.Tensor:
    return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), weight,
                    stride=stride)


class BEVFold(nn.Module):
    """Pose-path ``reduce_dim_0``: z-into-channels fold + reflect-padded 3x3
    conv (stride 2), LeakyReLU 0.1.

    ``weight`` covers the vz*gc folded feature channels, (z, c) z-major
    (channel z*gc + c); ``weight_rel`` the vz rel-depth channels, computed
    once and added to every frame group. Frame groups run as a group-major
    batch through one conv. The convs compute in ``dtype``, else in the
    input's dtype, as the JAX ``BEVFold`` does.
    """

    def __init__(self, out_ch: int, gc: int, vz: int, vy: int, vx: int,
                 stride: int = 2, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.gc, self.vz, self.vy, self.vx, self.stride = gc, vz, vy, vx, stride
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_ch, vz * gc, 3, 3))
        self.weight_rel = nn.Parameter(torch.empty(out_ch, vz, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, voxel_feat: torch.Tensor, groups: int = 1) -> torch.Tensor:
        """voxel_feat [b, n((y,x,z)-flat), G*gc + 1] ((G, gc) channel chunks,
        shared rel-depth last) -> [G*b, out_ch, hy, hx] (group-major batch)."""
        b = voxel_feat.shape[0]
        g, gc, vz, vy, vx = groups, self.gc, self.vz, self.vy, self.vx
        dt = self.dtype or voxel_feat.dtype
        main = voxel_feat[..., :-1].reshape(b, vy, vx, vz, g, gc)
        main = main.permute(4, 0, 3, 5, 1, 2).reshape(g * b, vz * gc, vy, vx)
        rel = voxel_feat[..., -1].reshape(b, vy, vx, vz).permute(0, 3, 1, 2)
        y = _reflect_conv(main.to(dt), self.weight.to(dt), self.stride)
        yr = _reflect_conv(rel.to(dt), self.weight_rel.to(dt), self.stride) \
            + self.bias.to(dt)[:, None, None]
        y = (y.reshape((g, b) + y.shape[1:]) + yr[None]).reshape(
            (g * b,) + y.shape[1:])
        return ties.leaky_relu(y, 0.1)


def _project_cam_points(mask: torch.Tensor, intrinsics: torch.Tensor,
                        extrinsics_inv: torch.Tensor, h_dim: int, w_dim: int, *,
                        voxel_str_p: Sequence[float],
                        voxel_unit_size: Sequence[float],
                        voxel_size: Sequence[int]):
    """Raw camera-plane voxel points for the sampler's in-kernel divide.

    (K[:3,:3] @ E^-1[:3,:]) is a per-camera [3, 4] constant, so
    cam3 = proj34 @ vox; cam3[..., 2] is the camera-frame depth.
    mask [b, cams, H, W, 1]; intrinsics at the fusion scale.
    Returns (cam3 [b, cams, n, 3], mask_lowres [b, cams, h, w, 1]).
    """
    vox = voxel_points_homo(voxel_str_p, voxel_unit_size,
                            voxel_size).to(intrinsics.device)
    proj34 = torch.einsum("bcij,bcjk->bcik", intrinsics[..., :3, :3].float(),
                          extrinsics_inv[..., :3, :].float())
    cam3 = torch.einsum("bcij,jn->bcni", proj34, vox)
    mask_lowres = resize_bilinear(mask, (h_dim, w_dim), align_corners=True)
    return cam3, mask_lowres


def grouped_backprojection_ok(groups, num_cams: int) -> bool:
    """Whether the group-reduced back-projection applies: the two static
    camera groups partition the rig with EQUAL sizes."""
    g1 = [c for c in groups[0] if c < num_cams]
    g2 = [c for c in groups[1] if c < num_cams]
    return (len(g1) == len(g2) and len(g1) > 0
            and sorted(g1 + g2) == list(range(num_cams)))


def backproject_features(feats_agg: torch.Tensor, mask: torch.Tensor,
                         intrinsics: torch.Tensor,
                         extrinsics_inv: torch.Tensor, *,
                         voxel_str_p: Sequence[float],
                         voxel_unit_size: Sequence[float],
                         voxel_size: Sequence[int], plain: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Image features [b, cams, h, w, C] -> per-camera masked voxel
    features (kernel K1b; its backward, K2b, gives ``feats_agg`` its
    gradient).

    Returns (feat [b, cams, n, C+1] incl. the rel-depth channel, valid [b,
    cams, n], count [b, n] = cameras that see each voxel), all three in
    the features' dtype, as the JAX package returns them (the bf16 count is
    exact, and the pose branch's camera mean divides by it in bf16).
    ``plain`` runs the kernels' plain PyTorch versions on any device.
    """
    h_dim, w_dim = feats_agg.shape[-3], feats_agg.shape[-2]
    cam3, mask_lowres = _project_cam_points(
        mask, intrinsics, extrinsics_inv, h_dim, w_dim,
        voxel_str_p=voxel_str_p, voxel_unit_size=voxel_unit_size,
        voxel_size=voxel_size)
    b, cams = feats_agg.shape[:2]
    feat, valid = sample_backproject_raw(
        feats_agg.reshape((b * cams,) + feats_agg.shape[2:]).contiguous(),
        mask_lowres.reshape(b * cams, h_dim, w_dim, 1),
        cam3.reshape(b * cams, -1, 3).contiguous(), 1.0 / voxel_size[0],
        plain)
    feat = feat.reshape(b, cams, -1, feat.shape[-1])
    valid = valid.reshape(b, cams, -1).to(feat.dtype)
    return feat, valid, valid.sum(dim=1)


def backproject_features_grouped(feats_agg: torch.Tensor, mask: torch.Tensor,
                                 intrinsics: torch.Tensor,
                                 extrinsics_inv: torch.Tensor, *,
                                 voxel_str_p: Sequence[float],
                                 voxel_unit_size: Sequence[float],
                                 voxel_size: Sequence[int], groups,
                                 plain: bool = False
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Image features [b, cams, h, w, C] -> camera-group sums of the masked
    voxel features (kernel K1; its backward, K2, gives ``feats_agg`` its
    gradient). Requires ``grouped_backprojection_ok``.

    Returns (feat_g [b, 2, n, C+1] incl. the rel-depth channel, count
    [b, n] = cameras that see each voxel). ``plain`` runs the kernels' plain
    PyTorch versions on any device (a reference run on the card).
    """
    h_dim, w_dim = feats_agg.shape[-3], feats_agg.shape[-2]
    g1 = [c for c in groups[0] if c < feats_agg.shape[1]]
    g2 = [c for c in groups[1] if c < feats_agg.shape[1]]
    order = g1 + g2
    # static group-major camera reorder
    feats_agg = feats_agg[:, order]
    mask = mask[:, order]
    intrinsics = intrinsics[:, order]
    extrinsics_inv = extrinsics_inv[:, order]
    cam3, mask_lowres = _project_cam_points(
        mask, intrinsics, extrinsics_inv, h_dim, w_dim,
        voxel_str_p=voxel_str_p, voxel_unit_size=voxel_unit_size,
        voxel_size=voxel_size)
    b, cams = feats_agg.shape[:2]
    feat, cnt = sample_backproject_grouped_raw(
        feats_agg.reshape((b * cams,) + feats_agg.shape[2:]).contiguous(),
        mask_lowres.reshape(b * cams, h_dim, w_dim, 1),
        cam3.reshape(b * cams, -1, 3).contiguous(),
        1.0 / voxel_size[0], b, len(g1), plain)
    return feat, cnt.sum(dim=1)


class _GroupSums(torch.autograd.Function):
    """Static camera-group sums of per-camera feat [b, cams, n, C] ->
    (feat1, feat2), each summed in camera order. The backward gives every
    camera its group's cotangent in one stack, as the JAX package's custom
    VJP does (autograd of the per-camera slices would add a zero-padded
    [b, cams, n, C] copy per camera)."""

    @staticmethod
    def forward(ctx, feat, g1, g2):
        ctx.groups = (tuple(g1), tuple(g2), feat.shape[1])

        def one(idx):
            if not idx:
                return feat.new_zeros(feat.shape[:1] + feat.shape[2:])
            s = feat[:, idx[0]].clone()
            for cam in idx[1:]:
                s = s + feat[:, cam]
            return s
        return one(g1), one(g2)

    @staticmethod
    def backward(ctx, d1, d2):
        g1, g2, cams = ctx.groups
        zero = torch.zeros_like(d1 if d1 is not None else d2)
        d1 = zero if d1 is None else d1
        d2 = zero if d2 is None else d2

        def per_cam(cam):
            if cam in g1 and cam in g2:
                return d1 + d2
            return d1 if cam in g1 else d2 if cam in g2 else zero
        return torch.stack([per_cam(c) for c in range(cams)], dim=1), None, None


def local_group_sums(feat: torch.Tensor, groups, cams: range
                     ) -> torch.Tensor:
    """One rank's part of the two overlap-group sums under the camera-axis
    grid (``parallel/mesh.py``): per-camera feat [b, len(cams), n, C] of
    the rig's cameras ``cams``, a contiguous block -> [b, 2, n, C], each
    group summed over its members among ``cams`` in camera order, zeros
    where it has none there (``_GroupSums``), laid out as K1's group sums.
    The cam group's all-reduce completes them."""
    g1 = [c - cams.start for c in groups[0] if c in cams]
    g2 = [c - cams.start for c in groups[1] if c in cams]
    return torch.stack(_GroupSums.apply(feat, g1, g2), dim=1)


class VFNet(nn.Module):
    """Surround fusion: fuse back-projected voxel features and re-project
    them into each camera's frustum (depth), or collapse them to a BEV
    feature (pose)."""

    def __init__(self, feat_in_dim: int, feat_out_dim: int,
                 model: str = "depth", *,
                 voxel_str_p=(-50.0, -50.0, -15.0),
                 voxel_unit_size=(1.0, 1.0, 1.5), voxel_size=(100, 100, 20),
                 voxel_pre_dim=(64,), proj_d_bins: int = 50,
                 proj_d_str: float = 2.0, proj_d_end: float = 50.0,
                 num_cams: int = 6, fusion_level: int = 2,
                 height: int = 384, width: int = 640,
                 overlap_groups=((0, 3, 4), (1, 2, 5)),
                 dtype: Optional[torch.dtype] = None,
                 sampler_3d: str = "packed_f32grad"):
        super().__init__()
        if sampler_3d not in ("packed", "packed_f32grad", "gather"):
            raise ValueError(f"unknown sampler_3d {sampler_3d!r}")
        self.overlap_groups = tuple(map(tuple, overlap_groups))
        # the frustum sampler's backward (K4) sums its updates in bf16 for
        # 'packed' (the JAX package's bf16 scatter updates), in f32 otherwise
        # ('gather' is the same function up to summation order); 'gather'
        # on a bf16 volume is JAX's bf16 XLA gather and scatter instead
        self.bf16_updates = sampler_3d == "packed"
        self.gather = sampler_3d == "gather"
        self.voxel_str_p = tuple(voxel_str_p)
        self.voxel_unit_size = tuple(voxel_unit_size)
        self.voxel_size = tuple(voxel_size)
        self.proj_d_bins = proj_d_bins
        self.proj_d_str, self.proj_d_end = proj_d_str, proj_d_end
        self.num_cams = num_cams
        self.img_h = height // (2 ** (fusion_level + 1))
        self.img_w = width // (2 ** (fusion_level + 1))
        vz, vy, vx = self.vol_dims
        if model == "depth":
            cin = feat_in_dim + 1    # + rel depth
            self.n_pre = len(voxel_pre_dim)
            for j, ch in enumerate(voxel_pre_dim):
                self.add_module(f"conv_non_overlap_{j}",
                                PointwiseBlock(cin, ch, dtype=dtype))
                self.add_module(f"conv_overlap_{j}",
                                PointwiseBlock(2 * cin if j == 0 else cin, ch,
                                               dtype=dtype))
                cin = ch
            self.reduce_dim_0 = ConvBlock(proj_d_bins * voxel_pre_dim[-1],
                                          256, 3, stride=1, dtype=dtype)
            self.reduce_dim_1 = ConvBlock(256, feat_out_dim, 3, stride=1,
                                          dtype=dtype)
        else:
            self.reduce_dim_0 = BEVFold(256, feat_in_dim, vz, vy, vx,
                                        stride=2, dtype=dtype)
            self.reduce_dim_1 = ConvBlock(256, feat_out_dim, 3, stride=2,
                                          dtype=dtype)

    @property
    def vol_dims(self) -> Tuple[int, int, int]:
        """(z, y, x) counts."""
        vx, vy, vz = self.voxel_size
        return vz, vy, vx

    @property
    def _voxel(self):
        return dict(voxel_str_p=self.voxel_str_p,
                    voxel_unit_size=self.voxel_unit_size,
                    voxel_size=self.voxel_size)

    @property
    def grouped_backprojection(self) -> bool:
        """Whether back-projection runs group-reduced (kernel K1) rather
        than per camera (kernel K1b)."""
        return grouped_backprojection_ok(self.overlap_groups, self.num_cams)

    def backproject_into_voxel(self, feats_agg, mask, intrinsics,
                               extrinsics_inv, plain: bool = False):
        """Per-camera back-projection (K1b): (feat [b, cams, n, C+1], valid
        [b, cams, n], count [b, n]); see ``backproject_features``."""
        return backproject_features(feats_agg, mask, intrinsics,
                                    extrinsics_inv, plain=plain, **self._voxel)

    def backproject_into_voxel_grouped(self, feats_agg, mask, intrinsics,
                                       extrinsics_inv, plain: bool = False):
        """Group-reduced back-projection (K1): (feat_g [b, 2, n, C+1],
        count [b, n]). Requires ``self.grouped_backprojection``."""
        return backproject_features_grouped(
            feats_agg, mask, intrinsics, extrinsics_inv,
            groups=self.overlap_groups, plain=plain, **self._voxel)

    def _camera_group_sums(self, feat: torch.Tensor):
        """Per-camera feat [b, cams, n, C] -> (feat1, feat2, total): the two
        overlap groups' sums, and their sum where the groups partition the
        rig (else the sum over all cameras)."""
        g1 = [c for c in self.overlap_groups[0] if c < self.num_cams]
        g2 = [c for c in self.overlap_groups[1] if c < self.num_cams]
        feat1, feat2 = _GroupSums.apply(feat, g1, g2)
        total = (feat1 + feat2 if sorted(g1 + g2) == list(range(self.num_cams))
                 else feat.sum(dim=1))
        return feat1, feat2, total

    def fuse_depth(self, feat: torch.Tensor, count: torch.Tensor,
                   grouped: bool = True) -> torch.Tensor:
        """Overlap-aware fusion: voxels seen by exactly one camera go
        through one MLP (on the sum over cameras), voxels seen by exactly
        two through another (on the two overlap-group sums concatenated).
        ``feat`` is per camera [b, cams, n, C], or (``grouped``) the group
        sums [b, 2, n, C]. Returns [b, n, voxel_pre_dim[-1]]."""
        non_overlap = (count == 1).to(feat.dtype)[..., None]
        overlap = (count == 2).to(feat.dtype)[..., None]
        if grouped:
            feat1, feat2 = feat[:, 0], feat[:, 1]
            total = feat1 + feat2
        else:
            feat1, feat2, total = self._camera_group_sums(feat)
        x_no = total * non_overlap
        x_o = torch.cat([feat1, feat2], dim=-1)
        for j in range(self.n_pre):
            x_no = getattr(self, f"conv_non_overlap_{j}")(x_no)
            x_o = getattr(self, f"conv_overlap_{j}")(x_o)
        return x_no * non_overlap + x_o * overlap

    def frustum_coords(self, inv_k: torch.Tensor,
                       extrinsics: torch.Tensor) -> torch.Tensor:
        """Every camera's frustum points (pixel-major, depth bins fastest) in
        the volume's NDC: [b, cams*h*w*d, 3] (x, y, z) in [-1, 1] inside."""
        b = inv_k.shape[0]
        dev = inv_k.device
        bins = linspace_f32(self.proj_d_str, self.proj_d_end, self.proj_d_bins)
        world = frustum_world_points(inv_k.float(), extrinsics.float(),
                                     self.img_h, self.img_w,
                                     bins.to(dev))     # [b, cams, d, P, 3]
        str_p = torch.tensor(self.voxel_str_p, dtype=torch.float32)
        end_p = str_p + torch.tensor(self.voxel_unit_size,
                                     dtype=torch.float32) * (
            torch.tensor(self.voxel_size, dtype=torch.float32) - 1.0)
        ndc = ((world - str_p.to(dev)) / (end_p - str_p).to(dev)) * 2.0 - 1.0
        # pixel-major points: the sample comes out as [b, cams, h, w, d*C]
        return ndc.transpose(-3, -2).reshape(b, -1, 3).contiguous()

    def project_voxel_into_image(self, voxel_feat: torch.Tensor,
                                 inv_k: torch.Tensor, extrinsics: torch.Tensor,
                                 plain: bool = False) -> torch.Tensor:
        """Voxel volume [b, n, C] -> the frustum features of the cameras
        that inv_k / extrinsics [b, cams, 4, 4] describe (kernel K3,
        backward K4) -> reduced 2-D feature, packed NCHW [b*cams,
        feat_out_dim, h, w]. ``plain`` runs the kernels' plain versions on
        any device."""
        b, c = voxel_feat.shape[0], voxel_feat.shape[-1]
        vz, vy, vx = self.vol_dims
        vol = voxel_feat.reshape(b, vy, vx, vz, c).contiguous()
        coords = self.frustum_coords(inv_k, extrinsics)
        if self.gather and vol.dtype == torch.bfloat16:
            sampled = Sample3dGather.apply(vol, coords, plain)
        else:
            sampled = Sample3dTrilinear.apply(vol, coords, plain,
                                              self.bf16_updates)
        feat2d = sampled.reshape(b * inv_k.shape[1], self.img_h, self.img_w,
                                 self.proj_d_bins * c)
        return self.reduce_dim_1(self.reduce_dim_0(feat2d.permute(0, 3, 1, 2)))

    def pose_voxel_to_bev(self, feat: torch.Tensor, count: torch.Tensor,
                          frame_groups: int = 1,
                          grouped: bool = True) -> torch.Tensor:
        """Per-camera feat [b, cams, n, C] (or ``grouped``: the two group
        sums [b, 2, n, C], which partition the rig) -> visibility-weighted
        camera mean -> BEVFold -> [G*b, feat_out_dim, hy, hx] (NCHW,
        group-major)."""
        total = feat[:, 0] + feat[:, 1] if grouped else feat.sum(dim=1)
        voxel_feat = total / (count[..., None] + 1e-7)
        return self.reduce_dim_1(
            self.reduce_dim_0(voxel_feat, groups=frame_groups))


def augment_extrinsics(aug_u: torch.Tensor, extrinsics: torch.Tensor,
                       aug_angle: Sequence[float]) -> torch.Tensor:
    """The depth-synthesis branch's random rotation of each camera:
    R(aug_angle * (aug_u - 0.5)) @ extrinsics, detached.

    aug_u [b, cams, 3] is the random draw, uniform in [0, 1) (the JAX
    package draws it from its key). As in the JAX package and the
    reference, ``(u - 0.5) * aug_angle`` goes straight into the axis-angle
    rotation, so the config's angles act as radians here (the eval sweep's
    ``aug_depth_params`` uses degrees).
    """
    angle = (aug_u.to(extrinsics.dtype) - 0.5) * torch.tensor(
        [float(a) for a in aug_angle], dtype=extrinsics.dtype,
        device=extrinsics.device)
    tform = torch.zeros(extrinsics.shape[:2] + (4, 4),
                        dtype=extrinsics.dtype, device=extrinsics.device)
    tform[..., :3, :3] = axis_angle_to_matrix(angle)
    tform[..., 3, 3] = 1.0
    return (tform @ extrinsics).detach()
