"""Image resizing on NHWC tensors (port of ``vfdepth_tpu/ops/resize.py``).

Bilinear resizes are the same two separable contractions as the JAX
package, ``out = A_h @ img @ A_w^T``, with the interpolation matrices built
on the host in float64 and rounded once to float32. That keeps the port's
numbers next to the reference's (the mask downsample feeds a > 0.5
validity test), which ``F.interpolate`` would only approximate.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _linear_resize_matrix(in_size: int, out_size: int,
                          align_corners: bool) -> np.ndarray:
    """[out_size, in_size] row-stochastic bilinear interpolation matrix."""
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    out_idx = np.arange(out_size, dtype=np.float64)
    if align_corners and out_size > 1:
        src = out_idx * (in_size - 1) / (out_size - 1)
    else:
        scale = in_size / out_size
        src = np.clip((out_idx + 0.5) * scale - 0.5, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = src - lo
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.arange(out_size)
    np.add.at(mat, (rows, lo), 1.0 - w_hi)
    np.add.at(mat, (rows, hi), w_hi)
    return mat


def resize_bilinear(img: torch.Tensor, out_hw, align_corners: bool = False,
                    channels_last: bool = True) -> torch.Tensor:
    """Bilinear resize of [..., H, W, C] to [..., H', W', C] (of
    [..., C, H, W] with ``channels_last=False``, for NCHW tensors)."""
    out_h, out_w = out_hw
    in_h, in_w = img.shape[-3:-1] if channels_last else img.shape[-2:]
    if (in_h, in_w) == (out_h, out_w):
        return img
    mat_h = torch.from_numpy(
        _linear_resize_matrix(in_h, out_h, align_corners)).to(img)
    mat_w = torch.from_numpy(
        _linear_resize_matrix(in_w, out_w, align_corners)).to(img)
    if channels_last:
        out = torch.einsum("oh,...hwc->...owc", mat_h, img)
        return torch.einsum("pw,...owc->...opc", mat_w, out)
    out = torch.einsum("oh,...hw->...ow", mat_h, img)
    return torch.einsum("pw,...ow->...op", mat_w, out)


def upsample2x_nearest(img: torch.Tensor,
                       channels_last: bool = True) -> torch.Tensor:
    """Nearest x2 upsample of [..., H, W, C] (of [..., C, H, W] with
    ``channels_last=False``)."""
    dh, dw = (-3, -2) if channels_last else (-2, -1)
    return img.repeat_interleave(2, dim=dh).repeat_interleave(2, dim=dw)
