"""Image + mask warp for view rendering (kernel K5).

Port of ``vfdepth_tpu/ops/warp_mxu.py warp_image_mask_mxu`` (:365; TPU
kernel ``_fwd_kernel`` :75 launched by ``_fwd_call`` :267), which has the
same taps as the XLA form ``ops/warp_quad.py warp_image_mask_quad``. The
CUDA kernel is ``csrc/warp_image_mask.cu``; its header says what bounds it
and how it is laid out.

Semantics, per warp and target pixel with normalised coordinates (x, y)
(align_corners):

* non-finite coordinates -> -4 (every tap dead); pixel = (c + 1) * (0.5 *
  (size - 1)), clipped to +-1e6;
* RGB: bilinear, taps at floor and floor + 1 with weights (1 - t, t), an
  out-of-image tap reads 0 (zeros padding);
* mask: per axis the upper tap iff t > 0.5 (nearest), 0 out of the image;
* the kernel also emits d img / d x and d img / d y in pixel units, so the
  backward is an elementwise dot with the upstream gradient: dcoords =
  (sum_c g * ddx * (w - 1) / 2, sum_c g * ddy * (h - 1) / 2), 0 where the
  coordinates are not finite. Images and masks are inputs of the loss and
  get no gradient.

The f32 form computes everything in f32 (the TPU kernel rounds sources and
ddx / ddy to bf16). The bf16 form (mixed precision: bf16 sources) takes a
bf16 image and mask, keeps the coordinates and the arithmetic f32, and
returns the warped image, the mask and ddx / ddy in bf16, the dtypes of the
TPU kernel's outputs (``warp_mxu.py:313-330``); the backward's dot runs in
f32.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_POINT_CHUNK = 1 << 20   # plain version: target pixels per gather


def _pixel(c: torch.Tensor, size: int) -> torch.Tensor:
    return torch.clamp((c + 1.0) * (0.5 * (size - 1)), -1e6, 1e6)


def warp_image_mask_maps_plain(img: torch.Tensor, mask: torch.Tensor,
                               coords: torch.Tensor):
    """Plain PyTorch version of the kernel, written with explicit gathers.

    img [B, H, W, 3], mask [B, H, W, 1] (f32, or both bf16), coords [B, N,
    2] f32 -> (img_w [B, N, 3], mask_w [B, N, 1], ddx [B, N, 3], ddy [B, N,
    3]) in img's dtype, computed in f32.
    """
    nb, h, w, c = img.shape
    n = coords.shape[1]
    src = img.reshape(nb, h * w, c).float()
    msk = mask.reshape(nb, h * w).float()
    outs = [img.new_empty(nb, n, k) for k in (c, 1, c, c)]
    for b in range(nb):
        for s in range(0, n, _POINT_CHUNK):
            crd = coords[b, s:s + _POINT_CHUNK]
            finite = torch.isfinite(crd).all(dim=-1, keepdim=True)
            crd = torch.where(finite, crd, -4.0)
            x, y = _pixel(crd[:, 0], w), _pixel(crd[:, 1], h)
            x0, y0 = torch.floor(x), torch.floor(y)
            tx, ty = (x - x0)[:, None], (y - y0)[:, None]
            ix, iy = x0.long(), y0.long()

            def tap(tx_, ty_, table):
                ok = (tx_ >= 0) & (tx_ < w) & (ty_ >= 0) & (ty_ < h)
                rows = table[torch.where(ok, ty_ * w + tx_, 0)]
                return torch.where(ok if rows.dim() == 1 else ok[:, None],
                                   rows, 0.0)

            v00 = tap(ix, iy, src[b])
            v10 = tap(ix + 1, iy, src[b])
            v01 = tap(ix, iy + 1, src[b])
            v11 = tap(ix + 1, iy + 1, src[b])
            top = (1.0 - tx) * v00 + tx * v10
            bot = (1.0 - tx) * v01 + tx * v11
            m = tap(ix + (tx[:, 0] > 0.5).long(), iy + (ty[:, 0] > 0.5).long(),
                    msk[b])
            sl = slice(s, s + _POINT_CHUNK)
            outs[0][b, sl] = (1.0 - ty) * top + ty * bot
            outs[1][b, sl] = m[:, None]
            outs[2][b, sl] = (1.0 - ty) * (v10 - v00) + ty * (v11 - v01)
            outs[3][b, sl] = bot - top
    return tuple(outs)


_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 4 + [ctypes.c_void_p]


def warp_image_mask_maps(img: torch.Tensor, mask: torch.Tensor,
                         coords: torch.Tensor):
    """(img_w, mask_w, ddx, ddy) of ``img`` [B, H, W, 3] and ``mask`` [B, H,
    W, 1] at ``coords`` [B, N, 2] float32: img and mask both float32 or
    both bfloat16, the outputs in their dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel of
    img's dtype (``warp_image_mask_maps.launches`` counts the f32 form's
    launches, ``.launches_bf16`` the bf16 form's) or raise.
    """
    if img.dim() != 4 or img.shape[-1] != 3:
        raise ValueError(f"img must be [B, H, W, 3], got {tuple(img.shape)}")
    nb, h, w, _ = img.shape
    if mask.shape != (nb, h, w, 1) or coords.dim() != 3 \
            or coords.shape[0] != nb or coords.shape[-1] != 2:
        raise ValueError(f"shape mismatch: img {tuple(img.shape)}, mask "
                         f"{tuple(mask.shape)}, coords {tuple(coords.shape)}")
    if img.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"img must be float32 or bfloat16, got {img.dtype}")
    for name, t, dtype in (("img", img, img.dtype), ("mask", mask, img.dtype),
                           ("coords", coords, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != img.device:
            raise ValueError(f"{name} is on {t.device}, img on {img.device}")
    if img.device.type == "cpu":
        return warp_image_mask_maps_plain(img, mask, coords)
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    for name, t in (("img", img), ("mask", mask), ("coords", coords)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n = coords.shape[1]
    bf16 = img.dtype == torch.bfloat16
    img_w, mask_w, ddx, ddy = (torch.empty(nb, n, k, device=img.device,
                                           dtype=img.dtype)
                               for k in (3, 1, 3, 3))
    fn = _build.function("warp_image_mask", "vf_warp_image_mask_bf16" if bf16
                         else "vf_warp_image_mask", _ARGS)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(img.data_ptr(), mask.data_ptr(), coords.data_ptr(),
                 img_w.data_ptr(), mask_w.data_ptr(), ddx.data_ptr(),
                 ddy.data_ptr(), nb, h, w, n, stream)
    if err != 0:
        raise RuntimeError(f"warp_image_mask launch failed: CUDA error {err}")
    if bf16:
        warp_image_mask_maps.launches_bf16 += 1
    else:
        warp_image_mask_maps.launches += 1
    return img_w, mask_w, ddx, ddy


warp_image_mask_maps.launches = 0
warp_image_mask_maps.launches_bf16 = 0


class WarpImageMask(torch.autograd.Function):
    """(img_w, mask_w) with a gradient for the coordinates only; ``plain``
    runs the plain version on any device."""

    @staticmethod
    def forward(ctx, img, mask, coords, plain: bool = False):
        maps = warp_image_mask_maps_plain if plain else warp_image_mask_maps
        img_w, mask_w, ddx, ddy = maps(img, mask, coords)
        ctx.save_for_backward(ddx, ddy, coords)
        ctx.hw = img.shape[1:3]
        ctx.mark_non_differentiable(mask_w)
        return img_w, mask_w

    @staticmethod
    def backward(ctx, g_img, _g_mask):
        # the XLA dot behind the TPU kernel (warp_mxu.py:347-355), in f32
        ddx, ddy, coords = ctx.saved_tensors
        h, w = ctx.hw
        g_img = g_img.float()
        gx = (g_img * ddx.float()).sum(dim=-1) * (0.5 * (w - 1))
        gy = (g_img * ddy.float()).sum(dim=-1) * (0.5 * (h - 1))
        finite = torch.isfinite(coords).all(dim=-1, keepdim=True)
        return (None, None,
                torch.where(finite, torch.stack([gx, gy], dim=-1), 0.0), None)


def warp_image_mask(img: torch.Tensor, mask: torch.Tensor,
                    coords: torch.Tensor, plain: bool = False):
    """Differentiable warp: img [B, H, W, 3] bilinear and mask [B, H, W, 1]
    nearest at coords [B, N, 2] -> (img_w [B, N, 3], mask_w [B, N, 1]).
    Gradient flows to ``coords`` only."""
    return WarpImageMask.apply(img, mask, coords, plain)
