"""Conv blocks shared by the depth / pose networks (port of
``vfdepth_tpu/models/blocks.py``).

Convolutions run NCHW inside the modules. Attribute names follow the flax
tree (``Conv_0`` -> ``conv``, ``BatchNorm_0`` -> ``bn``, ``Dense_0`` ->
``dense``) so ``weights.load_flax_params`` maps parameters by path. The
JAX package's ``fast_pad`` ablation is not ported (off by default there).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def pack_cam_feat(x: torch.Tensor) -> torch.Tensor:
    """[b, cams, ...] -> [b*cams, ...]."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def unpack_cam_feat(x: torch.Tensor, b: int, n_cam: int) -> torch.Tensor:
    """[b*cams, ...] -> [b, cams, ...]."""
    return x.reshape((b, n_cam) + tuple(x.shape[1:]))


def activation(x: torch.Tensor, name: Optional[str]) -> torch.Tensor:
    if name == "LRU":
        return F.leaky_relu(x, negative_slope=0.1)
    if name == "ELU":
        return F.elu(x)
    if name is None or name == "none":
        return x
    raise ValueError(f"unknown nonlinearity {name!r}")


def batch_norm(num_features: int) -> nn.BatchNorm2d:
    """BatchNorm as the JAX package configures it (eps 1e-5; flax momentum
    0.9 is torch momentum 0.1)."""
    return nn.BatchNorm2d(num_features, eps=1e-5, momentum=0.1)


class ConvBlock(nn.Module):
    """Reflect-padded Conv2d + optional BatchNorm + activation (NCHW).
    Bias unless ``norm``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1,
                 nonlin: Optional[str] = "LRU", norm: bool = False):
        super().__init__()
        self.pad = ((kernel_size - 1) * dilation) // 2
        self.nonlin = nonlin
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride=stride,
                              dilation=dilation, bias=not norm)
        self.bn = batch_norm(out_ch) if norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pad:
            x = F.pad(x, (self.pad,) * 4, mode="reflect")
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return activation(x, self.nonlin)


class PointwiseBlock(nn.Module):
    """Linear over the channel axis + activation: [..., C_in] -> [..., C_out]
    (the voxel fusion MLPs)."""

    def __init__(self, in_ch: int, out_ch: int, nonlin: Optional[str] = "LRU"):
        super().__init__()
        self.nonlin = nonlin
        self.dense = nn.Linear(in_ch, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return activation(self.dense(x), self.nonlin)
