"""ResNet encoder with the Monodepth2 feature-pyramid contract (port of
``vfdepth_tpu/models/resnet.py``).

NCHW in and out. Returns 5 feature maps at strides 2/4/8/16/32 with
``num_ch_enc`` channels; input normalised as ``(x - 0.45) / 0.225``; the
multi-image variant stacks N RGB frames on the channel axis. Module names
follow the flax tree (``layer{stage}_{block}``, ``bn1`` wrapping its
BatchNorm as ``_Norm`` does). ``dtype`` is the compute dtype
(``models/blocks.py``); the input is cast to it after the normalisation,
as in the JAX package.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import Conv2d, batch_norm

RESNET_SPECS = {
    18: dict(block="basic", layers=[2, 2, 2, 2]),
    34: dict(block="basic", layers=[3, 4, 6, 3]),
    50: dict(block="bottleneck", layers=[3, 4, 6, 3]),
}


def num_ch_enc(num_layers: int) -> List[int]:
    if RESNET_SPECS[num_layers]["block"] == "basic":
        return [64, 64, 128, 256, 512]
    return [64, 256, 512, 1024, 2048]


class _Norm(nn.Module):
    """The flax ``_Norm`` wrapper: one BatchNorm named ``bn``."""

    def __init__(self, ch: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.bn = batch_norm(ch, dtype)

    def forward(self, x):
        return self.bn(x)


def _conv(cin, cout, k, stride=1, dtype=None):
    return Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False,
                  dtype=dtype)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = _conv(in_ch, planes, 3, stride, dtype)
        self.bn1 = _Norm(planes, dtype)
        self.conv2 = _conv(planes, planes, 3, dtype=dtype)
        self.bn2 = _Norm(planes, dtype)
        self.has_down = stride != 1 or in_ch != planes
        if self.has_down:
            self.downsample_conv = _conv(in_ch, planes, 1, stride, dtype)
            self.downsample_bn = _Norm(planes, dtype)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = (self.downsample_bn(self.downsample_conv(x))
                    if self.has_down else x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = _conv(in_ch, planes, 1, dtype=dtype)
        self.bn1 = _Norm(planes, dtype)
        self.conv2 = _conv(planes, planes, 3, stride, dtype)
        self.bn2 = _Norm(planes, dtype)
        self.conv3 = _conv(planes, out_ch, 1, dtype=dtype)
        self.bn3 = _Norm(out_ch, dtype)
        self.has_down = stride != 1 or in_ch != out_ch
        if self.has_down:
            self.downsample_conv = _conv(in_ch, out_ch, 1, stride, dtype)
            self.downsample_bn = _Norm(out_ch, dtype)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = (self.downsample_bn(self.downsample_conv(x))
                    if self.has_down else x)
        return F.relu(out + identity)


class ResnetEncoder(nn.Module):
    """[n, 3*num_input_images, H, W] -> [feat_s2, ..., feat_s32] (NCHW)."""

    def __init__(self, num_layers: int = 18, num_input_images: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        spec = RESNET_SPECS[num_layers]
        block_cls = BasicBlock if spec["block"] == "basic" else Bottleneck
        self.dtype = dtype
        self.conv1 = Conv2d(3 * num_input_images, 64, 7, stride=2, padding=3,
                            bias=False, dtype=dtype)
        self.bn1 = _Norm(64, dtype)
        self.blocks = []
        in_ch = 64
        for stage, (n_blocks, width) in enumerate(
                zip(spec["layers"], [64, 128, 256, 512])):
            names = []
            for blk in range(n_blocks):
                stride = 2 if (stage > 0 and blk == 0) else 1
                name = f"layer{stage + 1}_{blk}"
                self.add_module(name, block_cls(in_ch, width, stride, dtype))
                in_ch = width * block_cls.expansion
                names.append(name)
            self.blocks.append(names)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = (x - 0.45) / 0.225
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = F.relu(self.bn1(self.conv1(x)))
        features = [x]
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for names in self.blocks:
            for name in names:
                x = getattr(self, name)(x)
            features.append(x)
        return features
