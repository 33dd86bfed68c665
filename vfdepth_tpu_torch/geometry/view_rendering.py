"""Differentiable view rendering, every camera and neighbour at once (port
of ``vfdepth_tpu/geometry/view_rendering.py``, its dense path).

Images are channels-last with the camera axis explicit, as in the JAX
package. Every warp of one call goes through ONE launch of the image warp
(kernel K5, ``ops/warp.py``): the temporal warps, the spatio warps and the
spatio-temporal warps of each context frame, 4 calls per step with frames
(0, -1, 1).

The JAX package can restrict the overlap warps to windows
(``tpu.warp_window``, ``geometry/warp_window.py``); by construction a window
covers every target pixel with a nonzero value, mask or gradient, so the
windowed loss equals the dense one. The port runs the dense warps for every
value of that key. The depth-synthesis branch (``aug_depth``,
``warp_depth``) is not ported and raises.

Under mixed precision the colours arrive as bf16 (``training/model.py``):
the warps take bf16 sources and masks and return bf16 images and masks
(K5's bf16 form), and ``intensity_align`` takes its statistics in f32 and
returns the warped image's dtype, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch

from .projection import project_coords
from ..ops.warp import warp_image_mask


def warp_image(src_img: torch.Tensor, src_mask: torch.Tensor,
               tar_depth: torch.Tensor, tar_inv_k: torch.Tensor,
               src_k: torch.Tensor, transform: torch.Tensor,
               plain: bool = False):
    """Warp source images / masks [..., H, W, 3|1] into the target views.

    Leading dims match across arguments. Non-finite coordinates give image
    2.0 and mask 0; the mask is 0 where the coordinates leave [-1, 1].
    Returns (warped image, warped mask) in the image's dtype (the mask is
    cast to it before the warp), the mask without gradient.
    """
    coords = project_coords(tar_depth, transform, tar_inv_k, src_k)
    h, w, c = src_img.shape[-3:]
    lead = src_img.shape[:-3]
    img_w, mask_w = warp_image_mask(
        src_img.reshape(-1, h, w, c).contiguous(),
        src_mask.to(src_img.dtype).reshape(-1, h, w, 1).contiguous(),
        coords.reshape(-1, h * w, 2).contiguous(), plain=plain)
    img_w = img_w.reshape(lead + (h, w, c))
    mask_w = mask_w.reshape(lead + (h, w, 1))
    finite = torch.isfinite(coords).all(dim=-1, keepdim=True)
    img_w = torch.where(finite, img_w, 2.0)
    mask_w = mask_w * finite.to(mask_w.dtype)
    in_bounds = ((coords >= -1.0) & (coords <= 1.0)).all(
        dim=-1, keepdim=True).to(src_img.dtype)
    return img_w, in_bounds * mask_w


def intensity_align(ref_img: torch.Tensor, ref_mask: torch.Tensor,
                    warp_img: torch.Tensor,
                    warp_mask: torch.Tensor) -> torch.Tensor:
    """Renormalise the warped image to the reference's overlap statistics.

    Statistics (no gradient, as JAX's ``stop_gradient``) over the overlap
    ref_mask * warp_mask > 0 broadcast to RGB; the variance takes the
    squared deviation over ALL pixels around the masked mean and divides
    by the full count (the reference's quirk). Where a sample's overlap is
    empty the warped image passes through unchanged. The statistics and the
    renormalisation run in f32; the result has the warped image's dtype.
    """
    with torch.no_grad():
        mask = ((ref_mask * warp_mask) > 0).float()
        ch = warp_img.shape[-1]
        denom_full = float(warp_img.shape[-3] * warp_img.shape[-2] * ch)
        msum = ch * mask.sum(dim=(-3, -2, -1), keepdim=True)

        def stats(img):
            img = img.float()
            s1m = (img * mask).sum(dim=(-3, -2, -1), keepdim=True)
            s1 = img.sum(dim=(-3, -2, -1), keepdim=True)
            s2 = (img * img).sum(dim=(-3, -2, -1), keepdim=True)
            mean = s1m / (msum + 1e-8)
            var = (s2 - 2.0 * mean * s1 + denom_full * mean * mean) \
                / denom_full
            return mean, torch.sqrt(torch.clamp(var, min=0.0) + 1e-16)

        s_mean, s_std = stats(ref_img)
        w_mean, w_std = stats(warp_img)
    norm = (warp_img - w_mean) / (w_std + 1e-8) * s_std + s_mean
    norm = norm * warp_mask
    return torch.where(msum > 0, norm, warp_img).to(warp_img.dtype)


class RenderOutputs(NamedTuple):
    """All warped tensors of one scale, camera axis explicit.

    temporal_img / temporal_mask: [b, cams, n_ctx, H, W, 3|1]
    overlap_img / overlap_mask:   [b, cams, 1 + n_ctx, H, W, 3|1]
      (index 0 is frame 0 (spatio), then the context frames
      (spatio-temporal))
    tform_depth / tform_depth_mask: the depth-synthesis branch; always None
    in the port.
    """
    temporal_img: torch.Tensor
    temporal_mask: torch.Tensor
    overlap_img: Optional[torch.Tensor]
    overlap_mask: Optional[torch.Tensor]
    tform_depth: Optional[torch.Tensor] = None
    tform_depth_mask: Optional[torch.Tensor] = None


def _bcast(x: torch.Tensor, n: int) -> torch.Tensor:
    """[b, cams, ...] -> [b, cams, n, ...] (a view)."""
    return x[:, :, None].expand(x.shape[:2] + (n,) + x.shape[2:])


def render_views(colors: Dict[int, torch.Tensor], mask: torch.Tensor,
                 k: torch.Tensor, inv_k: torch.Tensor, depth: torch.Tensor,
                 cam_t_cam: torch.Tensor, spatio_pose: Optional[torch.Tensor],
                 spatio_tempo_pose: Optional[torch.Tensor],
                 rel_cam: torch.Tensor, frame_ids: Sequence[int],
                 do_intensity_align: bool = True, spatio: bool = True,
                 spatio_temporal: bool = True, aug_depth: bool = False,
                 plain: bool = False) -> RenderOutputs:
    """Render every warped view the losses need for one scale.

    colors: frame id -> [b, cams, H, W, 3]; mask [b, cams, H, W, 1]; k /
    inv_k [b, cams, 4, 4]; depth [b, cams, H, W, 1]; cam_t_cam [b, cams,
    n_ctx, 4, 4]; spatio_pose [b, cams, n_nbr, 4, 4]; spatio_tempo_pose
    [b, cams, n_ctx, n_nbr, 4, 4]; rel_cam [cams, n_nbr] neighbour indices
    (-1 = none). ``plain`` runs the warp kernel's plain version on any
    device. (The JAX function's window and depth-synthesis arguments have
    no counterpart: the port's warps are dense.)
    """
    if aug_depth:
        raise NotImplementedError("the depth-synthesis branch is not ported")
    ctx_ids = list(frame_ids[1:])
    n_ctx = len(ctx_ids)
    rel_cam = torch.as_tensor(rel_cam, device=depth.device).long()
    nbr_valid_f = (rel_cam >= 0).to(depth.dtype)[None, :, :, None, None, None]
    rel_idx = torch.clamp(rel_cam, min=0)

    # temporal warps
    src_imgs = torch.stack([colors[f] for f in ctx_ids], dim=2)
    t_img, t_mask = warp_image(src_imgs, _bcast(mask, n_ctx),
                               _bcast(depth, n_ctx), _bcast(inv_k, n_ctx),
                               _bcast(k, n_ctx), cam_t_cam, plain=plain)
    if do_intensity_align:
        t_img = intensity_align(_bcast(colors[0], n_ctx), _bcast(mask, n_ctx),
                                t_img, t_mask)

    overlap_img = overlap_mask = None
    if spatio or spatio_temporal:
        n_nbr = rel_cam.shape[1]
        nbr_mask = mask[:, rel_idx]
        nbr_k = k[:, rel_idx]
        depn, invkn = _bcast(depth, n_nbr), _bcast(inv_k, n_nbr)

        def overlap_for(frame_colors, pose):
            w_img, w_mask = warp_image(frame_colors[:, rel_idx], nbr_mask,
                                       depn, invkn, nbr_k, pose, plain=plain)
            w_mask = w_mask * nbr_valid_f.to(w_mask.dtype)
            if do_intensity_align:
                w_img = intensity_align(_bcast(colors[0], n_nbr),
                                        _bcast(mask, n_nbr), w_img, w_mask)
            # the valid flags in the image's dtype: a bf16 stack stays bf16
            return ((w_img * nbr_valid_f.to(w_img.dtype)).sum(dim=2),
                    w_mask.sum(dim=2))

        outs = [overlap_for(colors[0], spatio_pose)]
        outs += [overlap_for(colors[f], spatio_tempo_pose[:, :, fi])
                 for fi, f in enumerate(ctx_ids)]
        overlap_img = torch.stack([o[0] for o in outs], dim=2)
        overlap_mask = torch.stack([o[1] for o in outs], dim=2)
    return RenderOutputs(t_img, t_mask, overlap_img, overlap_mask)
