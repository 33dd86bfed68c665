"""Loss primitives (port of ``vfdepth_tpu/losses/primitives.py``).

Channels-last maps [..., H, W, C] with any leading dims, as in the JAX
package. Kinks take JAX's derivative (``ops/ties.py``): the SSIM clip, the
L1 and smoothness ``abs``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import ties


def _avg_pool3x3_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 mean with reflect padding on [..., H, W, C]."""
    h, w, c = x.shape[-3:]
    nchw = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    out = F.avg_pool2d(F.pad(nchw, (1, 1, 1, 1), mode="reflect"), 3, stride=1)
    return out.permute(0, 2, 3, 1).reshape(x.shape)


def ssim_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """SSIM dissimilarity clip((1 - SSIM) / 2, 0, 1) per pixel and channel
    (C1 = 0.01^2, C2 = 0.03^2, +1e-8 in the denominator)."""
    mu_p = _avg_pool3x3_same(pred)
    mu_t = _avg_pool3x3_same(target)
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    sigma_p = _avg_pool3x3_same(pred * pred) - mu_pp
    sigma_t = _avg_pool3x3_same(target * target) - mu_tt
    sigma_pt = _avg_pool3x3_same(pred * target) - mu_pt
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim = ((2 * mu_pt + c1) * (2 * sigma_pt + c2)) / (
        (mu_pp + mu_tt + c1) * (sigma_p + sigma_t + c2) + 1e-8)
    return ties.clip((1.0 - ssim) / 2.0, 0.0, 1.0)


def photometric_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """0.85 * SSIM + 0.15 * L1, averaged over channels -> [..., H, W, 1],
    computed in f32."""
    pred, target = pred.float(), target.float()
    l1 = ties.abs(target - pred).mean(dim=-1, keepdim=True)
    ssim = ssim_loss(pred, target).mean(dim=-1, keepdim=True)
    return 0.85 * ssim + 0.15 * l1


def _smoothness_maps(rgb: torch.Tensor, disp: torch.Tensor):
    grad_rgb_x = (rgb[..., :, :-1, :] - rgb[..., :, 1:, :]).abs().mean(
        dim=-1, keepdim=True)
    grad_rgb_y = (rgb[..., :-1, :, :] - rgb[..., 1:, :, :]).abs().mean(
        dim=-1, keepdim=True)
    grad_d_x = ties.abs(disp[..., :, :-1, :] - disp[..., :, 1:, :])
    grad_d_y = ties.abs(disp[..., :-1, :, :] - disp[..., 1:, :, :])
    return grad_d_x * torch.exp(-grad_rgb_x), grad_d_y * torch.exp(-grad_rgb_y)


def edge_aware_smoothness(rgb: torch.Tensor, disp: torch.Tensor
                          ) -> torch.Tensor:
    """Edge-aware first-order disparity smoothness: rgb [..., H, W, 3], disp
    [..., H, W, 1] -> one scalar (the means of the x and y terms)."""
    gx, gy = _smoothness_maps(rgb, disp)
    return gx.mean() + gy.mean()


def masked_mean(loss: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (loss * mask).sum() / (mask.sum() + 1e-8)


def auto_mask(reproj_loss: torch.Tensor,
              identity_loss: torch.Tensor) -> torch.Tensor:
    """Monodepth2 auto-mask: 1 where reprojection beats identity; ties go to
    the reprojection (``<=``)."""
    return (reproj_loss <= identity_loss).to(reproj_loss.dtype)


def mean_normalized_disp(disp: torch.Tensor) -> torch.Tensor:
    """disp / (spatial mean + 1e-8) over [..., H, W, 1]."""
    return disp / (disp.mean(dim=(-3, -2), keepdim=True) + 1e-8)
