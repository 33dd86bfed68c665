"""Conv blocks shared by the depth / pose networks (port of
``vfdepth_tpu/models/blocks.py``).

Convolutions run NCHW inside the modules. Attribute names follow the flax
tree (``Conv_0`` -> ``conv``, ``BatchNorm_0`` -> ``bn``, ``Dense_0`` ->
``dense``) so ``weights.load_flax_params`` maps parameters by path. The
JAX package's ``fast_pad`` ablation is not ported (off by default there).
LeakyReLU takes JAX's derivative at 0 (``ops/ties.py``).

``dtype`` is the compute dtype of the flax modules' ``dtype`` attribute
(``torch.bfloat16`` under ``tpu.mixed_precision``, None for f32):
parameters stay f32, and each layer casts where flax does. A conv or dense
layer casts its input, weight and bias to ``dtype`` (flax's
``promote_dtype``) and adds the bias after the product, in ``dtype``;
BatchNorm takes its statistics and normalises in f32 and returns ``dtype``.

Activation checkpointing (``tpu.remat``, ``training/model.py``) runs a
train-mode forward a second time in the backward pass. BatchNorm moves its
running statistics in place, so that recompute runs under
``recomputing()``: it normalises with the batch statistics, as the first
forward did, and leaves the running statistics as the first forward left
them (JAX's functional recompute discards its statistics).

Under a process group (data parallelism, ``parallel/``), BatchNorm in train
mode, and in its recompute, normalises with the GLOBAL batch's statistics,
as JAX's BatchNorm over a batch sharded across devices does: see
``BatchNorm``. Under the camera-axis grid (``parallel/mesh.py``) the same
world sum is right: every BatchNorm layer is in an encoder, which runs per
camera on a rank's own cameras, so the ranks hold disjoint (sample,
camera) pairs; the voxel stages that run replicated over a cam group hold
no BatchNorm (``tests/test_torch_cam_parallel.py`` checks both).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import ties
from ..parallel.distributed import all_reduce_sum, is_active


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


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``dtype`` as flax's ``nn.Conv(dtype=...)``
    does: input, weight and bias cast to ``dtype``, the bias added after
    the convolution. ``dtype=None`` is ``nn.Conv2d`` itself."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return super().forward(x)
        y = self._conv_forward(x.to(self.dtype), self.weight.to(self.dtype),
                               None)
        if self.bias is None:
            return y
        return y + self.bias.to(self.dtype)[:, None, None]


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` as flax's ``nn.Dense(dtype=...)``
    does (see ``Conv2d``)."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return super().forward(x)
        return (F.linear(x.to(self.dtype), self.weight.to(self.dtype))
                + self.bias.to(self.dtype))


_RECOMPUTING = contextvars.ContextVar("bn_recomputing", default=False)


@contextlib.contextmanager
def recomputing():
    """The block is a checkpoint's recompute of a train-mode forward:
    BatchNorm normalises with the batch statistics, whatever its mode, and
    leaves its running statistics alone."""
    token = _RECOMPUTING.set(True)
    try:
        yield
    finally:
        _RECOMPUTING.reset(token)


class BatchNorm(nn.BatchNorm2d):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=dtype)`` on
    NCHW tensors.

    Statistics and normalisation run in f32 whatever the input's dtype (as
    flax's ``_compute_stats`` / ``_normalize`` do); the output is ``dtype``,
    or f32 when it is None. Eval mode normalises with the running
    statistics, as ``nn.BatchNorm2d`` does. Train mode normalises with the
    batch's mean and biased variance (as both frameworks do) and moves the
    running statistics as flax does: ``ra = 0.9 ra + 0.1 batch`` with the
    BIASED batch variance, where ``nn.BatchNorm2d`` would take the unbiased
    one.

    With a process group active, train mode takes the statistics of the
    global batch (every rank's): the per-channel sum, sum of squares and
    count in f32, summed over the ranks by a differentiable all-reduce,
    then ``var = max(E[x^2] - E[x]^2, 0)`` as flax's ``_compute_stats``
    has it. The running statistics move with them, identically on every
    rank. A recompute all-reduces again (every rank recomputes the same
    blocks in the same order) and moves nothing; eval mode holds no
    collective.
    """

    def __init__(self, num_features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        recompute = _RECOMPUTING.get()
        if not (self.training or recompute):
            y = super().forward(x)
        elif is_active():
            y = self._global_batch_norm(x, recompute)
        else:
            if not recompute:
                with torch.no_grad():
                    var, mean = torch.var_mean(x, dim=(0, 2, 3),
                                               unbiased=False)
                    self._move_running(mean, var)
            y = F.batch_norm(x, None, None, self.weight, self.bias,
                             training=True, eps=self.eps)
        return y if self.dtype is None else y.to(self.dtype)

    def _move_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.running_mean.mul_(0.9).add_(mean, alpha=0.1)
        self.running_var.mul_(0.9).add_(var, alpha=0.1)
        self.num_batches_tracked.add_(1)

    def _global_batch_norm(self, x: torch.Tensor,
                           recompute: bool) -> torch.Tensor:
        count = x.new_full((x.shape[1],), x.numel() / x.shape[1])
        stats = all_reduce_sum(torch.stack(
            [x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3)), count]),
            "batch_norm")
        mean = stats[0] / stats[2]
        var = torch.clamp(stats[1] / stats[2] - mean * mean, min=0.0)
        if not recompute:
            with torch.no_grad():
                self._move_running(mean, var)
        inv = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None, None]) * inv[:, None, None]
                + self.bias[:, None, None])


def batch_norm(num_features: int,
               dtype: Optional[torch.dtype] = None) -> BatchNorm:
    """BatchNorm as the JAX package configures it (eps 1e-5, momentum 0.9)."""
    return BatchNorm(num_features, dtype)


class ConvBlock(nn.Module):
    """Reflect-padded Conv2d + optional BatchNorm + activation (NCHW).
    Bias unless ``norm``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1,
                 nonlin: Optional[str] = "LRU", norm: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.pad = ((kernel_size - 1) * dilation) // 2
        self.nonlin = nonlin
        self.conv = Conv2d(in_ch, out_ch, kernel_size, stride=stride,
                           dilation=dilation, bias=not norm, dtype=dtype)
        self.bn = batch_norm(out_ch, dtype) if norm else None

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

    def __init__(self, in_ch: int, out_ch: int, nonlin: Optional[str] = "LRU",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.nonlin = nonlin
        self.dense = Linear(in_ch, out_ch, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return activation(self.dense(x), self.nonlin)
