"""View rendering and the training loss of the plain reference.

Every warp of the published loss: each camera's context frames into it
(temporal), its neighbours at frame 0 (spatial) and at the context frames
(spatio-temporal), all dense. A source image is sampled bilinearly with
``F.grid_sample`` (align corners, zeros outside), its mask at the nearest
pixel (the upper one where a fraction exceeds 0.5); the gradient reaches
the warp coordinates, and through them the depth and the poses. Then the
photometric terms (SSIM and L1), the identity auto-mask, the edge-aware
smoothness, the overlap losses and, for the fsm baseline, the pose
consistency.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from .geometry import clip, euler_xyz, tabs, warp_coords

_TIE_EPS = 1e-5     # the identity loss's tie-break noise scale


def _pixel(c: torch.Tensor, size: int) -> torch.Tensor:
    return torch.clamp((c + 1.0) * (0.5 * (size - 1)), -1e6, 1e6)


def warp(src: torch.Tensor, src_mask: torch.Tensor, depth, inv_k, k, tform):
    """Sources [..., H, W, 3] and masks [..., H, W, 1] warped into the
    targets -> (image, mask); non-finite coordinates give image 2 and mask
    0, and the mask is 0 outside [-1, 1]."""
    coords = warp_coords(depth, tform, inv_k, k)              # [..., H, W, 2]
    h, w = src.shape[-3], src.shape[-2]
    lead = src.shape[:-3]
    finite = torch.isfinite(coords).all(dim=-1, keepdim=True)
    crd = torch.where(finite, coords, -4.0)
    px, py = _pixel(crd[..., 0], w), _pixel(crd[..., 1], h)
    img = F.grid_sample(
        src.reshape(-1, h, w, 3).permute(0, 3, 1, 2),
        torch.stack([px / (0.5 * (w - 1)) - 1.0, py / (0.5 * (h - 1)) - 1.0],
                    dim=-1).reshape(-1, h, w, 2),
        mode="bilinear", padding_mode="zeros", align_corners=True)
    img = img.permute(0, 2, 3, 1).reshape(lead + (h, w, 3))
    with torch.no_grad():
        x0, y0 = torch.floor(px), torch.floor(py)
        xn = x0 + ((px - x0) > 0.5).float()
        yn = y0 + ((py - y0) > 0.5).float()
        ok = (xn >= 0) & (xn < w) & (yn >= 0) & (yn < h)
        idx = torch.where(ok, yn * w + xn, 0.0).long().reshape(-1, h * w)
        m = torch.gather(src_mask.reshape(-1, h * w), 1, idx)
        m = torch.where(ok.reshape(-1, h * w), m, 0.0).reshape(lead + (h, w, 1))
    img = torch.where(finite, img, 2.0)
    inb = ((coords >= -1.0) & (coords <= 1.0)).all(dim=-1, keepdim=True)
    return img, (m * finite.float() * inb.float()).detach()


def intensity_align(ref, ref_mask, wimg, wmask):
    """Renormalise the warped image to the reference's overlap statistics
    (no gradient through them); the variance takes the deviation over all
    pixels around the masked mean, over the full count."""
    with torch.no_grad():
        mask = ((ref_mask * wmask) > 0).float()
        ch = wimg.shape[-1]
        full = float(wimg.shape[-3] * wimg.shape[-2] * ch)
        msum = ch * mask.sum(dim=(-3, -2, -1), keepdim=True)

        def stats(img):
            s1m = (img * mask).sum(dim=(-3, -2, -1), keepdim=True)
            s1 = img.sum(dim=(-3, -2, -1), keepdim=True)
            s2 = (img * img).sum(dim=(-3, -2, -1), keepdim=True)
            mean = s1m / (msum + 1e-8)
            var = (s2 - 2.0 * mean * s1 + full * mean * mean) / full
            return mean, torch.sqrt(torch.clamp(var, min=0.0) + 1e-16)
        s_mean, s_std = stats(ref)
        w_mean, w_std = stats(wimg)
    norm = ((wimg - w_mean) / (w_std + 1e-8) * s_std + s_mean) * wmask
    return torch.where(msum > 0, norm, wimg)


def _bc(x, n):
    return x[:, :, None].expand(x.shape[:2] + (n,) + x.shape[2:])


def render(colors: Dict[int, torch.Tensor], mask, k, inv_k, depth, cam_t_cam,
           spatio, st, rel_cam, frame_ids: Sequence[int], align: bool):
    """(temporal image, mask [b, cams, n_ctx, H, W, .], overlap image, mask
    [b, cams, 1 + n_ctx, H, W, .]) of one scale."""
    ctx = list(frame_ids[1:])
    n = len(ctx)
    t_img, t_mask = warp(torch.stack([colors[f] for f in ctx], 2),
                         _bc(mask, n), _bc(depth, n), _bc(inv_k, n),
                         _bc(k, n), cam_t_cam)
    if align:
        t_img = intensity_align(_bc(colors[0], n), _bc(mask, n), t_img, t_mask)
    nbr_ok = (rel_cam >= 0).float()[None, :, :, None, None, None]
    idx = torch.clamp(rel_cam, min=0)
    nn_ = rel_cam.shape[1]

    def overlap(src, pose):
        wi, wm = warp(src[:, idx], mask[:, idx], _bc(depth, nn_),
                      _bc(inv_k, nn_), k[:, idx], pose)
        wm = wm * nbr_ok
        if align:
            wi = intensity_align(_bc(colors[0], nn_), _bc(mask, nn_), wi, wm)
        return (wi * nbr_ok).sum(dim=2), wm.sum(dim=2)
    outs = [overlap(colors[0], spatio)] + [overlap(colors[f], st[:, :, i])
                                          for i, f in enumerate(ctx)]
    return (t_img, t_mask, torch.stack([o[0] for o in outs], 2),
            torch.stack([o[1] for o in outs], 2))


# ---------------------------------------------------------------- losses

def _pool3(x):
    h, w, c = x.shape[-3:]
    y = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.avg_pool2d(F.pad(y, (1, 1, 1, 1), mode="reflect"), 3, stride=1)
    return y.permute(0, 2, 3, 1).reshape(x.shape)


def photometric(pred, target):
    """0.85 SSIM dissimilarity + 0.15 L1, channel mean -> [..., H, W, 1]."""
    mp, mt = _pool3(pred), _pool3(target)
    sp = _pool3(pred * pred) - mp * mp
    st = _pool3(target * target) - mt * mt
    spt = _pool3(pred * target) - mp * mt
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim = ((2 * mp * mt + c1) * (2 * spt + c2)) / (
        (mp * mp + mt * mt + c1) * (sp + st + c2) + 1e-8)
    ssim = clip((1.0 - ssim) / 2.0, 0.0, 1.0).mean(dim=-1, keepdim=True)
    return 0.85 * ssim + 0.15 * tabs(target - pred).mean(dim=-1, keepdim=True)


def _masked(loss, mask):
    """Masked mean per camera over batch and pixels -> [cams]."""
    return (loss * mask).sum(dim=(0, 2, 3, 4)) / (
        mask.sum(dim=(0, 2, 3, 4)) + 1e-8)


def smoothness(color, disp):
    nd = disp / (disp.mean(dim=(-3, -2), keepdim=True) + 1e-8)
    grx = (color[..., :, :-1, :] - color[..., :, 1:, :]).abs().mean(
        -1, keepdim=True)
    gry = (color[..., :-1, :, :] - color[..., 1:, :, :]).abs().mean(
        -1, keepdim=True)
    gx = tabs(nd[..., :, :-1, :] - nd[..., :, 1:, :]) * torch.exp(-grx)
    gy = tabs(nd[..., :-1, :, :] - nd[..., 1:, :, :]) * torch.exp(-gry)
    return gx.mean(dim=(0, 2, 3, 4)) + gy.mean(dim=(0, 2, 3, 4))


def pose_consistency(cam_t_cam, ext, ext_inv):
    """Each camera's motion aligned into camera 0's frame against camera
    0's: translation L2 + 10 x Euler-angle L2 -> [cams], camera 0 zero."""
    ref = cam_t_cam[:, 0]
    inner = torch.einsum("bcij,bcfjk,bckl->bcfil", ext, cam_t_cam, ext_inv)
    al = torch.einsum("bij,bcfjk,bkl->bcfil", ext_inv[:, 0], inner, ext[:, 0])
    ang = torch.linalg.vector_norm(euler_xyz(ref[..., :3, :3])[:, None]
                                   - euler_xyz(al[..., :3, :3]), dim=-1)
    tr = torch.linalg.vector_norm(ref[:, None, ..., :3, 3] - al[..., :3, 3],
                                  dim=-1)
    per = tr.mean(dim=(0, 2)) + 10.0 * ang.mean(dim=(0, 2))
    return torch.cat([per.new_zeros(1), per[1:]])


def total_loss(noise, loss_cfg: dict, x: Dict[str, torch.Tensor],
               disps, cam_t_cam, rendered: Dict[int, List[torch.Tensor]]
               ) -> torch.Tensor:
    """The published training loss of every scale, averaged over scales
    and cameras."""
    ctx = list(loss_cfg["frame_ids"][1:])
    tgt = x["color/0/0"]
    ref_mask = x["mask"]
    context = torch.stack([x[f"color/{f}/0"] for f in ctx], dim=2)
    cam_loss = 0.0
    for si, s in enumerate(loss_cfg["scales"]):
        t_img, _, o_img, o_mask = rendered[s]
        t5 = tgt[:, :, None]
        reproj = torch.amin(photometric(t_img, t5.expand_as(t_img)), dim=2)
        ident = photometric(context, t5.expand_as(context))
        ident = torch.amin(ident + _TIE_EPS * noise[si], dim=2)
        amask = (reproj <= ident).float() * ref_mask
        loss = _masked(reproj, amask) + loss_cfg["disparity_smoothness"] * \
            smoothness(x[f"color/0/{s}"], disps[s]) / (2.0 ** s)
        if loss_cfg["spatio"] or loss_cfg["spatio_temporal"]:
            sp = _masked(photometric(o_img[:, :, 0], tgt),
                         ref_mask * o_mask[:, :, 0])
            st_img, st_mask = o_img[:, :, 1:], o_mask[:, :, 1:]
            st_l = torch.amin(photometric(st_img, t5.expand_as(st_img)), 2)
            st_m = torch.amax(ref_mask[:, :, None] * st_mask
                              * amask[:, :, None], dim=2)
            loss = loss + loss_cfg["spatio_coeff"] * sp \
                + loss_cfg["spatio_tempo_coeff"] * _masked(st_l, st_m)
        if loss_cfg["pose_model"] == "fsm" and loss_cfg["pose_loss_coeff"] > 0:
            loss = loss + loss_cfg["pose_loss_coeff"] * pose_consistency(
                cam_t_cam, x["extrinsics"], x["extrinsics_inv"])
        cam_loss = cam_loss + loss
    return (cam_loss / float(len(loss_cfg["scales"]))).mean()
