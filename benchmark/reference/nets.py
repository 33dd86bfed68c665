"""The networks of the plain reference: ResNet encoders, the surround-fusion
voxel stages, the decoders and the per-camera (fsm) baselines, in float32
with plain ``torch.nn`` layers.

Module and parameter names follow the published model's tree as the
program under test names it, so one set of weights made by the benchmark
loads into both by name. The samplers are plain PyTorch: the voxel
back-projection is ``F.grid_sample`` per camera with the visibility rule
applied to its result, and the frustum sample is a 5-D ``F.grid_sample``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .geometry import (clip, leaky_relu, linspace, resize,
                       upsample2x, voxel_centres)

ENC_CH = [64, 64, 128, 256, 512]     # ResNet-18 / 34 feature widths
RESNET_LAYERS = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3]}


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm (eps 1e-5) of NCHW: batch statistics in train mode,
    running statistics in eval mode."""

    def __init__(self, ch: int):
        super().__init__(ch, eps=1e-5)

    def forward(self, x):
        if self.training:
            return F.batch_norm(x, None, None, self.weight, self.bias,
                                training=True, eps=self.eps)
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=self.eps)


class _Norm(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.bn = BatchNorm(ch)

    def forward(self, x):
        return self.bn(x)


def _conv(cin, cout, k, stride=1):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int):
        super().__init__()
        self.conv1 = _conv(cin, planes, 3, stride)
        self.bn1 = _Norm(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = _Norm(planes)
        self.has_down = stride != 1 or cin != planes
        if self.has_down:
            self.downsample_conv = _conv(cin, planes, 1, stride)
            self.downsample_bn = _Norm(planes)

    def forward(self, x):
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        idt = self.downsample_bn(self.downsample_conv(x)) if self.has_down \
            else x
        return F.relu(out + idt)


class ResnetEncoder(nn.Module):
    """[n, 3*images, H, W] -> features at strides 2, 4, 8, 16, 32."""

    def __init__(self, num_layers: int, images: int):
        super().__init__()
        self.conv1 = nn.Conv2d(3 * images, 64, 7, stride=2, padding=3,
                               bias=False)
        self.bn1 = _Norm(64)
        self.stages: List[List[str]] = []
        cin = 64
        for s, (n, width) in enumerate(zip(RESNET_LAYERS[num_layers],
                                           [64, 128, 256, 512])):
            names = []
            for blk in range(n):
                name = f"layer{s + 1}_{blk}"
                self.add_module(name, BasicBlock(
                    cin, width, 2 if (s > 0 and blk == 0) else 1))
                cin = width
                names.append(name)
            self.stages.append(names)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1((x - 0.45) / 0.225)))
        feats = [x]
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            feats.append(x)
        return feats


class ConvBlock(nn.Module):
    """Reflect pad, conv with bias, activation."""

    def __init__(self, cin, cout, k=3, stride=1, nonlin: Optional[str] = "LRU"):
        super().__init__()
        self.pad = (k - 1) // 2
        self.nonlin = nonlin
        self.conv = nn.Conv2d(cin, cout, k, stride=stride)

    def forward(self, x):
        if self.pad:
            x = F.pad(x, (self.pad,) * 4, mode="reflect")
        x = self.conv(x)
        if self.nonlin == "LRU":
            return leaky_relu(x)
        if self.nonlin == "ELU":
            return F.elu(x)
        return x


class PointwiseBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.dense = nn.Linear(cin, cout)

    def forward(self, x):
        return leaky_relu(self.dense(x))


class BEVFold(nn.Module):
    """z folded into channels, reflect-padded 3x3 conv (stride 2); the
    rel-depth channels' part computed once for every frame group."""

    def __init__(self, out_ch, gc, vz, vy, vx, stride=2):
        super().__init__()
        self.gc, self.vz, self.vy, self.vx, self.stride = gc, vz, vy, vx, stride
        self.weight = nn.Parameter(torch.empty(out_ch, vz * gc, 3, 3))
        self.weight_rel = nn.Parameter(torch.empty(out_ch, vz, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, vfeat: torch.Tensor, groups: int) -> torch.Tensor:
        b = vfeat.shape[0]
        g, gc, vz, vy, vx = groups, self.gc, self.vz, self.vy, self.vx
        main = vfeat[..., :-1].reshape(b, vy, vx, vz, g, gc)
        main = main.permute(4, 0, 3, 5, 1, 2).reshape(g * b, vz * gc, vy, vx)
        rel = vfeat[..., -1].reshape(b, vy, vx, vz).permute(0, 3, 1, 2)

        def conv(x, w):
            return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), w,
                            stride=self.stride)
        y = conv(main, self.weight)
        yr = conv(rel, self.weight_rel) + self.bias[:, None, None]
        y = (y.reshape((g, b) + y.shape[1:]) + yr[None]).reshape(
            (g * b,) + y.shape[1:])
        return leaky_relu(y)


class DepthDecoder(nn.Module):
    """Decoder from pyramid level ``level_in`` to full scale, sigmoid
    disparity at ``scales``; ``skips`` concatenates the encoder's levels."""

    def __init__(self, level_in: int, enc_ch: Sequence[int],
                 scales: Sequence[int], skips: bool):
        super().__init__()
        dec = (16, 32, 64, 128, 256)
        self.level_in, self.scales, self.skips = level_in, tuple(scales), skips
        ch = enc_ch[-1]
        for i in range(level_in, -1, -1):
            self.add_module(f"upconv_{i}_0", ConvBlock(ch, dec[i], 3,
                                                       nonlin="ELU"))
            cin = dec[i] + (enc_ch[i - 1] if skips and i > 0 else 0)
            self.add_module(f"upconv_{i}_1", ConvBlock(cin, dec[i], 3,
                                                       nonlin="ELU"))
            if i in self.scales:
                self.add_module(f"dispconv_{i}", ConvBlock(dec[i], 1, 3,
                                                           nonlin=None))
            ch = dec[i]

    def forward(self, feats: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        out, x = {}, feats[-1]
        for i in range(self.level_in, -1, -1):
            x = upsample2x(getattr(self, f"upconv_{i}_0")(x))
            if self.skips and i > 0:
                x = torch.cat([x, feats[i - 1]], dim=1)
            x = getattr(self, f"upconv_{i}_1")(x)
            if i in self.scales:
                out[f"disp/{i}"] = torch.sigmoid(
                    getattr(self, f"dispconv_{i}")(x))
        return out


class PoseDecoder(nn.Module):
    def __init__(self, cin: int, stride: int):
        super().__init__()
        self.squeeze = nn.Conv2d(cin, 256, 1)
        self.pose_0 = nn.Conv2d(256, 256, 3, stride=stride, padding=1)
        self.pose_1 = nn.Conv2d(256, 256, 3, stride=stride, padding=1)
        self.pose_2 = nn.Conv2d(256, 6, 1)

    def forward(self, x):
        x = F.relu(self.pose_1(F.relu(self.pose_0(F.relu(self.squeeze(x))))))
        x = 0.01 * self.pose_2(x).mean(dim=(-2, -1)).reshape(-1, 1, 1, 6)
        return x[..., :3], clip(x[..., 3:], -4.0, 4.0)


def _aggregate(feats, lev: int, conv1x1: ConvBlock) -> torch.Tensor:
    up = tuple(feats[lev].shape[-2:])
    agg = [feats[lev]] + [resize(f, up, True, channels_last=False)
                          for f in feats[lev + 1:]]
    return conv1x1(torch.cat(agg, dim=1))


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class VoxelSpec:
    """The voxel grid and the frustum's depth bins of one configuration."""

    def __init__(self, m: dict, height: int, width: int):
        self.str_p = tuple(float(v) for v in m["voxel_str_p"])
        self.unit = tuple(float(v) for v in m["voxel_unit_size"])
        self.size = tuple(int(v) for v in m["voxel_size"])
        self.bins = (float(m["proj_d_str"]), float(m["proj_d_end"]),
                     int(m["proj_d_bins"]))
        lev = int(m["fusion_level"])
        self.img_h = height // 2 ** (lev + 1)
        self.img_w = width // 2 ** (lev + 1)

    @property
    def zyx(self) -> Tuple[int, int, int]:
        vx, vy, vz = self.size
        return vz, vy, vx


def visibility(mask: torch.Tensor, k: torch.Tensor, ext_inv: torch.Tensor,
               spec: VoxelSpec, h: int, w: int):
    """Which camera sees which voxel, and where: (valid [b, cams, n] 0/1,
    x, y [b, cams, n] pixels at the features' resolution, z [b, cams, n]
    camera-plane depth).

    A camera sees a voxel where its depth is positive, its pixel (after
    the perspective divide, align corners) lies inside the image and the
    mask's nearest pixel (the upper one where a fraction exceeds 0.5) is
    above 0.5."""
    b, cams = k.shape[:2]
    vox = voxel_centres(spec.str_p, spec.unit, spec.size).to(k.device)
    proj = torch.einsum("bcij,bcjk->bcik", k[..., :3, :3], ext_inv[..., :3, :])
    cam3 = torch.einsum("bcij,jn->bcni", proj, vox)          # [b, cams, n, 3]
    m_low = resize(mask, (h, w), True)[..., 0]               # [b, cams, h, w]
    z = cam3[..., 2]
    big = 2.0 * w
    x = torch.clamp(torch.nan_to_num(cam3[..., 0] / (z + 1e-8), nan=big,
                                     posinf=big, neginf=-big), -big, big)
    y = torch.clamp(torch.nan_to_num(cam3[..., 1] / (z + 1e-8), nan=big,
                                     posinf=big, neginf=-big), -big, big)
    live = (z > 0) & (x >= 0) & (x <= w - 1.0) & (y >= 0) & (y <= h - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    xn = torch.where(live, x0 + ((x - x0) > 0.5).float(), 0.0).long()
    yn = torch.where(live, y0 + ((y - y0) > 0.5).float(), 0.0).long()
    inb = live & (xn < w) & (yn < h)
    pick = torch.gather(m_low.reshape(b, cams, h * w), 2,
                        (yn.clamp(0, h - 1) * w + xn.clamp(0, w - 1)))
    valid = (inb & (torch.where(inb, pick, 0.0) > 0.5)).float()
    return valid, x, y, z


def backproject_grouped(feats: torch.Tensor, mask: torch.Tensor,
                        k: torch.Tensor, ext_inv: torch.Tensor,
                        groups, spec: VoxelSpec):
    """Image features [b, cams, h, w, C] -> (the two overlap groups' sums of
    every camera's masked voxel features [b, 2, n, C+1], the rel-depth
    channel last; the number of cameras that see each voxel [b, n]). A
    seen voxel's feature is the bilinear sample at its pixel
    (``visibility``), an unseen one's 0."""
    b, cams, h, w, c = feats.shape
    valid, x, y, z = visibility(mask, k, ext_inv, spec, h, w)
    grid = torch.stack([x / (w - 1) * 2 - 1, y / (h - 1) * 2 - 1], dim=-1)
    rel = torch.where(valid > 0, z * (1.0 / spec.size[0]), 0.0)
    sums = []
    for grp in groups:
        rows = []
        for bi in range(b):
            acc = None
            for ci in grp:       # one camera at a time bounds the memory
                samp = F.grid_sample(
                    feats[bi, ci].permute(2, 0, 1)[None],
                    grid[bi, ci][None, None], mode="bilinear",
                    padding_mode="zeros", align_corners=True)[0, :, 0].t()
                row = torch.cat([samp * valid[bi, ci][:, None],
                                 rel[bi, ci][:, None]], dim=-1)
                acc = row if acc is None else acc + row
            rows.append(acc)
        sums.append(torch.stack(rows))
    return torch.stack(sums, 1), valid.sum(dim=1)


def frustum_ndc(inv_k: torch.Tensor, ext: torch.Tensor,
                spec: VoxelSpec) -> torch.Tensor:
    """Every camera's frustum points [b, cams, h, w, d, 3] in the volume's
    normalised coordinates (x, y, z)."""
    lo, hi, nb = spec.bins
    bins = linspace(lo, hi, nb).to(inv_k.device)
    grid = torch.stack(torch.meshgrid(
        torch.arange(spec.img_h, dtype=torch.float32),
        torch.arange(spec.img_w, dtype=torch.float32), indexing="ij")[::-1]
        + (torch.ones(spec.img_h, spec.img_w),), 0).reshape(3, -1)
    rays = torch.einsum("bcij,jp->bcip", inv_k[..., :3, :3],
                        grid.to(inv_k.device))
    pts = rays[:, :, None] * bins[:, None, None]             # [b, c, d, 3, P]
    pts = torch.cat([pts, torch.ones_like(pts[..., :1, :])], dim=-2)
    world = torch.einsum("bcij,bcdjp->bcdpi", ext[..., :3, :], pts)
    str_p = torch.tensor(spec.str_p, dtype=torch.float32)
    end_p = str_p + torch.tensor(spec.unit, dtype=torch.float32) * (
        torch.tensor(spec.size, dtype=torch.float32) - 1.0)
    ndc = ((world - str_p.to(world.device)) / (end_p - str_p).to(
        world.device)) * 2.0 - 1.0                            # [b, c, d, P, 3]
    b, cams = ndc.shape[:2]
    return ndc.permute(0, 1, 3, 2, 4).reshape(b, cams, spec.img_h,
                                              spec.img_w, nb, 3)


class VFNet(nn.Module):
    def __init__(self, feat_in: int, feat_out: int, kind: str,
                 spec: VoxelSpec, pre_dim: Sequence[int]):
        super().__init__()
        self.spec = spec
        vz, vy, vx = spec.zyx
        if kind == "depth":
            cin = feat_in + 1
            self.n_pre = len(pre_dim)
            for j, ch in enumerate(pre_dim):
                self.add_module(f"conv_non_overlap_{j}",
                                PointwiseBlock(cin, ch))
                self.add_module(f"conv_overlap_{j}",
                                PointwiseBlock(2 * cin if j == 0 else cin, ch))
                cin = ch
            self.reduce_dim_0 = ConvBlock(spec.bins[2] * pre_dim[-1], 256, 3)
            self.reduce_dim_1 = ConvBlock(256, feat_out, 3)
        else:
            self.reduce_dim_0 = BEVFold(256, feat_in, vz, vy, vx)
            self.reduce_dim_1 = ConvBlock(256, feat_out, 3, stride=2)

    def fuse(self, feat: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
        """Group sums [b, 2, n, C] -> fused voxel features [b, n, C']: one
        MLP where one camera sees a voxel, another where two do."""
        one = (count == 1).float()[..., None]
        two = (count == 2).float()[..., None]
        f1, f2 = feat[:, 0], feat[:, 1]
        x_no, x_o = (f1 + f2) * one, torch.cat([f1, f2], dim=-1)
        for j in range(self.n_pre):
            x_no = getattr(self, f"conv_non_overlap_{j}")(x_no)
            x_o = getattr(self, f"conv_overlap_{j}")(x_o)
        return x_no * one + x_o * two

    def to_image(self, vfeat: torch.Tensor, inv_k, ext) -> torch.Tensor:
        """Fused voxels [b, n, C] sampled along each camera's frustum
        (trilinear, align corners, zeros outside) -> reduced [b*cams, C',
        h, w]."""
        b, c = vfeat.shape[0], vfeat.shape[-1]
        vz, vy, vx = self.spec.zyx
        vol = vfeat.reshape(b, vy, vx, vz, c).permute(0, 4, 3, 1, 2)
        ndc = frustum_ndc(inv_k, ext, self.spec)         # [b, cams, h, w, d, 3]
        cams, h, w, d = ndc.shape[1:5]
        out = F.grid_sample(vol, ndc.reshape(b, 1, 1, -1, 3), mode="bilinear",
                            padding_mode="zeros", align_corners=True)
        out = out.reshape(b, c, cams, h, w, d).permute(0, 2, 5, 1, 3, 4)
        out = out.reshape(b * cams, d * c, h, w)
        return self.reduce_dim_1(self.reduce_dim_0(out))

    def to_bev(self, feat, count, groups: int):
        vfeat = (feat[:, 0] + feat[:, 1]) / (count[..., None] + 1e-7)
        return self.reduce_dim_1(self.reduce_dim_0(vfeat, groups))


class FusedDepthNet(nn.Module):
    def __init__(self, m: dict, spec: VoxelSpec, scales):
        super().__init__()
        lev = self.lev = int(m["fusion_level"])
        self.encoder = ResnetEncoder(int(m["num_layers"]), 1)
        self.conv1x1 = ConvBlock(sum(ENC_CH[lev:]), int(m["fusion_feat_in_dim"]),
                                 1)
        self.fusion_net = VFNet(int(m["fusion_feat_in_dim"]), ENC_CH[lev],
                                "depth", spec, m["voxel_pre_dim"])
        self.decoder = DepthDecoder(lev, ENC_CH[:lev + 1], scales,
                                    bool(m.get("use_skips", False)))

    def encode(self, images):
        b, cams = images.shape[:2]
        feats = self.encoder(images.flatten(0, 1).permute(0, 3, 1, 2))
        agg = _aggregate(feats, self.lev, self.conv1x1)
        return feats, _nhwc(agg).reshape((b, cams) + _nhwc(agg).shape[1:])

    def decode(self, feat, count, skips, inv_k, ext):
        return self.decode_volume(self.fusion_net.fuse(feat, count), skips,
                                  inv_k, ext)

    def decode_volume(self, vfeat, skips, inv_k, ext):
        """The fused voxels sampled along the frusta of the cameras at
        ``ext`` and decoded -> {'disp/{s}': [b, cams, h, w, 1]}."""
        b, cams = inv_k.shape[:2]
        proj = self.fusion_net.to_image(vfeat, inv_k, ext)
        dec = self.decoder(list(skips) + [proj])
        return {k: _nhwc(v).reshape((b, cams) + _nhwc(v).shape[1:])
                for k, v in dec.items()}


class FusedPoseNet(nn.Module):
    def __init__(self, m: dict, spec: VoxelSpec):
        super().__init__()
        lev = self.lev = int(m["fusion_level"])
        self.encoder = ResnetEncoder(int(m["num_layers"]), 2)
        self.conv1x1 = ConvBlock(sum(ENC_CH[lev:]), int(m["fusion_feat_in_dim"]),
                                 1)
        self.fusion_net = VFNet(int(m["fusion_feat_in_dim"]), ENC_CH[lev],
                                "pose", spec, ())
        self.pose_decoder = PoseDecoder(ENC_CH[lev], 2)

    def encode(self, cur, nxt, n_ctx: int):
        """Context pairs stacked frame-major on the batch -> [b, cams, h, w,
        n_ctx*C] (each frame's features a channel group)."""
        gb, cams = cur.shape[:2]
        pair = torch.cat([cur, nxt], dim=-1).flatten(0, 1).permute(0, 3, 1, 2)
        agg = _nhwc(_aggregate(self.encoder(pair), self.lev, self.conv1x1))
        agg = agg.reshape((n_ctx, gb // n_ctx, cams) + agg.shape[1:])
        agg = torch.movedim(agg, 0, -2)
        return agg.reshape(agg.shape[:-2] + (n_ctx * agg.shape[-1],))

    def pose(self, feat, count, n_ctx: int):
        return self.pose_decoder(self.fusion_net.to_bev(feat, count, n_ctx))


class MonoDepthNet(nn.Module):
    def __init__(self, m: dict, scales):
        super().__init__()
        self.encoder = ResnetEncoder(int(m["num_layers"]), 1)
        self.decoder = DepthDecoder(4, ENC_CH, scales, True)

    def forward(self, images):            # [n, H, W, 3]
        dec = self.decoder(self.encoder(images.permute(0, 3, 1, 2)))
        return {k: _nhwc(v) for k, v in dec.items()}


class MonoPoseNet(nn.Module):
    def __init__(self, m: dict):
        super().__init__()
        self.encoder = ResnetEncoder(int(m["num_layers"]), 2)
        self.pose_decoder = PoseDecoder(ENC_CH[-1], 1)

    def forward(self, cur, nxt):          # [n, H, W, 3] each
        pair = torch.cat([cur, nxt], dim=-1).permute(0, 3, 1, 2)
        return self.pose_decoder(self.encoder(pair)[-1])


__all__ = ["FusedDepthNet", "FusedPoseNet", "MonoDepthNet", "MonoPoseNet",
           "VoxelSpec", "backproject_grouped", "frustum_ndc", "visibility"]
