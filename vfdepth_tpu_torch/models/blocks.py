"""Conv blocks shared by the depth / pose networks (port of
``vfdepth_tpu/models/blocks.py``).

Convolutions run NCHW inside the modules. Attribute names follow the flax
tree (``Conv_0`` -> ``conv``, ``BatchNorm_0`` -> ``bn``, ``Dense_0`` ->
``dense``) so ``weights.load_flax_params`` maps parameters by path. The
JAX package's ``fast_pad`` ablation is not ported (off by default there).
LeakyReLU takes JAX's derivative at 0 (``ops/ties.py``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import ties


def pack_cam_feat(x: torch.Tensor) -> torch.Tensor:
    """[b, cams, ...] -> [b*cams, ...]."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def unpack_cam_feat(x: torch.Tensor, b: int, n_cam: int) -> torch.Tensor:
    """[b*cams, ...] -> [b, cams, ...]."""
    return x.reshape((b, n_cam) + tuple(x.shape[1:]))


def activation(x: torch.Tensor, name: Optional[str]) -> torch.Tensor:
    if name == "LRU":
        return ties.leaky_relu(x, 0.1)
    if name == "ELU":
        return F.elu(x)
    if name is None or name == "none":
        return x
    raise ValueError(f"unknown nonlinearity {name!r}")


class BatchNorm(nn.BatchNorm2d):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` on NCHW tensors.

    Eval mode normalises with the running statistics, as
    ``nn.BatchNorm2d`` does. Train mode normalises with the batch's mean
    and biased variance (as both frameworks do) and moves the running
    statistics as flax does: ``ra = 0.9 ra + 0.1 batch`` with the BIASED
    batch variance, where ``nn.BatchNorm2d`` would take the unbiased one.
    """

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.mul_(0.9).add_(mean, alpha=0.1)
            self.running_var.mul_(0.9).add_(var, alpha=0.1)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias,
                            training=True, eps=self.eps)


def batch_norm(num_features: int) -> BatchNorm:
    """BatchNorm as the JAX package configures it (eps 1e-5, momentum 0.9)."""
    return BatchNorm(num_features)


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
