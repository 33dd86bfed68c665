"""Composite training losses for all cameras at once (port of
``vfdepth_tpu/losses/composite.py``).

Each term is a masked mean per camera (over batch and pixels), averaged
over scales, then over cameras. The identity-loss tie-break noise enters as
an explicit tensor of standard normals (``total_loss``'s ``noise``), so a
test can hand in the JAX package's draws; the port's training step draws it
from a ``torch.Generator``. Minima over context frames are ``torch.amin``,
which splits a tied gradient as ``jnp.min`` does. Under ``aug_depth`` the
depth-synthesis loss (consistency of the rotated view's depth with the
warped depths, and its smoothness) joins each scale's sum.

Data parallelism (``parallel/``): inside ``parallel.global_batch()``, as
the training forward runs the loss under a process group, every reduction
over the batch is the global batch's. The masked means sum their
numerator and denominator over the ranks (``batch_sum``, a differentiable
all-reduce of both: its backward sums the cotangents over the ranks, so
after the gradient average each rank's share is the global masked mean's
gradient; the masks carry no gradient either way). The cold-start priors
take their batch means over the ranks (``batch_mean``). The plain batch
means (smoothness, pose consistency, the synthesis smoothness) stay
per rank: every rank holds the same batch size, so the ranks' mean of
them is the global one, and ``parallel.reduce_logs`` averages the logs.

The camera-axis grid (``parallel/mesh.py``): inside its
``camera_shard()``, as its training forward runs the loss, the batch holds
this rank's cameras and the renders warp into them. Every per-camera
vector is then assembled into the rig's before the camera mean: the
masked means' numerators and denominators (``percam_sum``) and the
smoothness's batch means (``percam_mean``), each by one world all-reduce
of the vector at its cameras' places. Every rank so computes the whole
global loss, and the mean of the ranks' gradients is its gradient.
``cam_t_cam`` stays the whole rig's (a fusion net's pose is replicated,
an fsm net's per-camera poses are gathered over the cam group), so the
pose logs, the cold-start priors and the fsm pose-consistency term read
every camera (the latter with the rig's extrinsics, ``total_loss``'s
``rig``), and the priors' batch means average over the world. The
pose-consistency term stays this rank's batch shard's, as under data
parallelism: every rank of a cam group computes the same vector, the
gather's backward sums their cotangents over the group and the gradient
average divides by the world, so each (sample, camera) pair counts once
and the ranks' mean of the term is the global batch's. The depth
synthesis's consistency sums and smoothness means assemble over every
rank like the other per-camera terms.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .primitives import (_smoothness_maps, auto_mask, mean_normalized_disp,
                         photometric_loss)
from ..geometry.se3 import matrix_to_euler_angles_xyz
from ..ops import ties
from ..parallel.data_parallel import batch_mean
from ..parallel.mesh import percam_mean, percam_sum
from ..utils.tracing import span

_EPSILON = 1e-5  # identity-loss tie-break noise scale


def _percam_masked_mean(loss: torch.Tensor, mask: torch.Tensor
                        ) -> torch.Tensor:
    """Masked mean per camera: [b, cams, H, W, 1] -> [cams], over the global
    batch inside ``global_batch()`` (and over the rig's cameras inside
    ``camera_shard()``)."""
    num = percam_sum((loss * mask).sum(dim=(0, 2, 3, 4)))
    den = percam_sum(mask.sum(dim=(0, 2, 3, 4)))
    return num / (den + 1e-8)


class LossConfig(NamedTuple):
    """The JAX package's ``LossConfig`` (see its docstring for the cold-start
    recipe: warm-up, ramps and priors)."""
    frame_ids: Tuple[int, ...] = (0, -1, 1)
    scales: Tuple[int, ...] = (0,)
    disparity_smoothness: float = 0.001
    spatio_coeff: float = 0.03
    spatio_tempo_coeff: float = 0.1
    pose_loss_coeff: float = 0.0
    depth_con_coeff: float = 0.03
    depth_sm_coeff: float = 0.05
    spatio: bool = True
    spatio_temporal: bool = True
    aug_depth: bool = False
    pose_model: str = "fusion"
    warmup_steps: int = 0
    ramp_steps: int = 0
    stagger_ramps: bool = False
    pose_prior_coeff: float = 1.0
    pose_prior_floor: float = 0.1
    pose_prior_ceil: float = 1.0
    disp_anchor_coeff: float = 0.1


def cold_start_schedule(cfg: LossConfig, step):
    """(ramp, st_ramp, amask_blend) as f32 scalar tensors at ``step``, all
    None when the schedule is off (warmup and ramp 0) or ``step`` is None."""
    if not (cfg.warmup_steps or cfg.ramp_steps) or step is None:
        return None, None, None
    s = torch.as_tensor(step, dtype=torch.float32)
    ramp_len = float(max(cfg.ramp_steps, 1))
    ramp = torch.clamp((s - float(cfg.warmup_steps)) / ramp_len, 0.0, 1.0)
    st_ramp = (torch.clamp((s - float(cfg.warmup_steps + cfg.ramp_steps))
                           / ramp_len, 0.0, 1.0)
               if cfg.stagger_ramps else ramp)
    amask_blend = torch.clamp(s / float(max(cfg.warmup_steps, 1)), 0.0, 1.0)
    return ramp, st_ramp, amask_blend


def reprojection_loss(noise: torch.Tensor, target: torch.Tensor,
                      context: torch.Tensor, warped: torch.Tensor,
                      ref_mask: torch.Tensor,
                      amask_blend: Optional[torch.Tensor] = None):
    """Min-reprojection with identity auto-masking.

    noise: standard normals shaped like the identity losses [b, cams,
    n_ctx, H, W, 1]; target [b, cams, H, W, 3]; context / warped [b, cams,
    n_ctx, H, W, 3]; ref_mask [b, cams, H, W, 1]. Returns (per-camera loss
    [cams], masked loss map, auto mask).
    """
    tgt = target[:, :, None]
    reproj_min = torch.amin(photometric_loss(warped, tgt.expand_as(warped)),
                            dim=2)
    ident = photometric_loss(context, tgt.expand_as(context))
    ident_min = torch.amin(ident + _EPSILON * noise.to(ident.dtype), dim=2)
    auto = auto_mask(reproj_min, ident_min)
    if amask_blend is not None:
        auto = (1.0 - amask_blend) + amask_blend * auto
    amask = auto * ref_mask
    return _percam_masked_mean(reproj_min, amask), amask * reproj_min, amask


def smoothness_loss(color: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """Edge-aware smoothness of the mean-normalised disparity, per camera
    ([b, cams, h, w, 3|1] -> [cams])."""
    gx, gy = _smoothness_maps(color, mean_normalized_disp(disp))
    return gx.mean(dim=(0, 2, 3, 4)) + gy.mean(dim=(0, 2, 3, 4))


def spatio_loss_fn(target: torch.Tensor, overlap_img: torch.Tensor,
                   overlap_mask: torch.Tensor, ref_mask: torch.Tensor):
    """Same-time cross-camera loss -> ([cams], combined mask)."""
    sp_mask = ref_mask * overlap_mask
    loss = photometric_loss(overlap_img, target)
    return _percam_masked_mean(loss, sp_mask), sp_mask


def spatio_tempo_loss_fn(target: torch.Tensor, overlap_img: torch.Tensor,
                         overlap_mask: torch.Tensor, ref_mask: torch.Tensor,
                         reproj_mask: torch.Tensor) -> torch.Tensor:
    """Spatio-temporal loss over the context-frame entries [b, cams, n_ctx,
    H, W, .]: min of the losses and max of the masks over frames, then the
    masked mean -> [cams]."""
    tgt = target[:, :, None]
    losses = photometric_loss(overlap_img, tgt.expand_as(overlap_img))
    masks = ref_mask[:, :, None] * overlap_mask * reproj_mask[:, :, None]
    return _percam_masked_mean(torch.amin(losses, dim=2),
                               torch.amax(masks, dim=2))


def pose_consistency_loss(cam_t_cam: torch.Tensor, extrinsics: torch.Tensor,
                          extrinsics_inv: torch.Tensor) -> torch.Tensor:
    """The fsm baseline's pose consistency, per camera -> [cams]: each
    camera's pose [b, cams, n_ctx, 4, 4] is aligned into camera 0's frame
    (E0^-1 Ec Tc Ec^-1 E0) and held against camera 0's own by translation
    L2 + 10 x "XYZ" Euler-angle L2, averaged over batch and context frames.
    Camera 0 gives 0."""
    ref_t = cam_t_cam[:, 0]                                # [b, n_ctx, 4, 4]
    inner = torch.einsum("bcij,bcfjk,bckl->bcfil", extrinsics, cam_t_cam,
                         extrinsics_inv)
    aligned = torch.einsum("bij,bcfjk,bkl->bcfil", extrinsics_inv[:, 0],
                           inner, extrinsics[:, 0])
    ref_ang = matrix_to_euler_angles_xyz(ref_t[..., :3, :3])
    cur_ang = matrix_to_euler_angles_xyz(aligned[..., :3, :3])
    ang_diff = torch.linalg.vector_norm(ref_ang[:, None] - cur_ang,
                                        dim=-1).mean(dim=(0, 2))
    t_diff = torch.linalg.vector_norm(
        ref_t[:, None, ..., :3, 3] - aligned[..., :3, 3], dim=-1
    ).mean(dim=(0, 2))
    percam = t_diff + 10.0 * ang_diff
    return torch.cat([percam.new_zeros(1), percam[1:]])


def depth_synthesis_loss(depth_aug: torch.Tensor, tform_depth: torch.Tensor,
                         tform_mask: torch.Tensor, disp_aug: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Novel-view depth consistency and smoothness, per camera -> ([cams],
    [cams]).

    depth_aug [b, cams, H, W, 1]; tform_depth / tform_mask [b, cams, n_src,
    H, W, 1]. Consistency: |d_aug - d_warp| / (d_aug + d_warp) clipped to
    [0, 1], the masked mean over batch, sources and pixels. Smoothness: the
    plain (not edge-aware) first-order gradients of the mean-normalised
    aug disparity. ``abs`` and the clip take JAX's derivative at ties. The
    consistency's sums are the global batch's inside ``global_batch()``,
    and both vectors the rig's inside ``camera_shard()``.
    """
    da = depth_aug[:, :, None]
    con = ties.abs(da - tform_depth) / (da + tform_depth + 1e-8)
    con = ties.clip(con, 0.0, 1.0)
    num = percam_sum((con * tform_mask).sum(dim=(0, 2, 3, 4, 5)))
    den = percam_sum(tform_mask.sum(dim=(0, 2, 3, 4, 5)))
    depth_con = num / (den + 1e-8)

    nd = mean_normalized_disp(disp_aug)
    gx = ties.abs(nd[..., :, :-1, :] - nd[..., :, 1:, :]).mean(
        dim=(0, 2, 3, 4))
    gy = ties.abs(nd[..., :-1, :, :] - nd[..., 1:, :, :]).mean(
        dim=(0, 2, 3, 4))
    return depth_con, percam_mean(gx + gy)


def total_loss(noise: torch.Tensor, cfg: LossConfig,
               batch: Dict[str, torch.Tensor],
               disps: Dict[int, torch.Tensor],
               depths: Dict[int, torch.Tensor], cam_t_cam: torch.Tensor,
               rendered: Dict[int, "RenderOutputs"],  # noqa: F821
               disps_aug: Optional[Dict[int, torch.Tensor]] = None,
               depths_aug: Optional[Dict[int, torch.Tensor]] = None,
               step=None, rig: Optional[Dict[str, torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The full training loss -> (scalar, logs).

    noise: [len(cfg.scales), b, cams, n_ctx, H, W, 1] standard normals, one
    slice per scale in ``cfg.scales`` order (JAX draws them from one key
    split per scale). ``disps_aug`` / ``depths_aug`` (scale -> the rotated
    views' disparity and depth) feed the depth-synthesis loss under
    ``cfg.aug_depth``. ``step`` drives the cold-start schedule when it is
    configured; None (eval) means full coefficients. ``rig`` (the
    camera-axis grid's training forward, where ``batch`` holds this rank's
    cameras) gives the whole rig's ``extrinsics`` and ``extrinsics_inv``
    that the pose-consistency term aligns ``cam_t_cam``'s every camera
    with; by default ``batch``'s.
    """
    ctx_ids = list(cfg.frame_ids[1:])
    target = batch["color/0/0"]
    ref_mask = batch["mask"]
    context = torch.stack([batch[f"color/{f}/0"] for f in ctx_ids], dim=2)

    ramp, st_ramp, amask_blend = cold_start_schedule(cfg, step)
    sp_coeff = cfg.spatio_coeff if ramp is None else cfg.spatio_coeff * ramp
    st_coeff = (cfg.spatio_tempo_coeff if st_ramp is None
                else cfg.spatio_tempo_coeff * st_ramp)

    cam_loss = 0.0
    logs: Dict[str, torch.Tensor] = {}
    for si, scale in enumerate(cfg.scales):
        r = rendered[scale]
        reproj, reproj_map, amask = reprojection_loss(
            noise[si], target, context, r.temporal_img, ref_mask,
            amask_blend=amask_blend)
        smooth = percam_mean(smoothness_loss(batch[f"color/0/{scale}"],
                                             disps[scale]))
        scale_loss = reproj + cfg.disparity_smoothness * smooth / (2.0 ** scale)

        if cfg.spatio or cfg.spatio_temporal:
            sp, _ = spatio_loss_fn(target, r.overlap_img[:, :, 0],
                                   r.overlap_mask[:, :, 0], ref_mask)
            st = spatio_tempo_loss_fn(target, r.overlap_img[:, :, 1:],
                                      r.overlap_mask[:, :, 1:], ref_mask,
                                      amask)
            scale_loss = scale_loss + sp_coeff * sp + st_coeff * st
            if scale == 0:
                logs["spatio_loss"] = sp.mean()
                logs["spatio_tempo_loss"] = st.mean()
                if ramp is not None:
                    logs["overlap_ramp"] = ramp
                    logs["st_ramp"] = st_ramp
        if cfg.pose_model == "fsm" and cfg.pose_loss_coeff > 0:
            calib = batch if rig is None else rig
            pose_l = pose_consistency_loss(cam_t_cam, calib["extrinsics"],
                                           calib["extrinsics_inv"])
            scale_loss = scale_loss + cfg.pose_loss_coeff * pose_l
            if scale == 0:
                logs["pose"] = pose_l.mean()
        if cfg.aug_depth:
            with span("vf.losses.synthesis"):
                con, sm = depth_synthesis_loss(
                    depths_aug[scale], r.tform_depth, r.tform_depth_mask,
                    disps_aug[scale])
                scale_loss = (scale_loss + cfg.depth_con_coeff * con
                              + cfg.depth_sm_coeff * sm)
                if scale == 0:
                    logs["depth_con_loss"] = con.mean()
                    logs["depth_sm_loss"] = sm.mean()
                    logs["depth_loss"] = (cfg.depth_con_coeff * con
                                          + cfg.depth_sm_coeff * sm).mean()
        cam_loss = cam_loss + scale_loss

        if scale == 0:
            logs["reproj_loss"] = reproj.mean()
            logs["amask_cover"] = amask.mean()
            logs["smooth"] = smooth.mean()
            logs["reproj_map"] = reproj_map
            logs["reproj_mask"] = amask
            d0 = depths[0].detach()
            logs["depth/mean"] = d0.mean()
            logs["depth/max"] = d0.max()
            logs["depth/min"] = d0.min()
            t0 = cam_t_cam[:, 0, 0].detach()
            logs["pose/tx"] = t0[:, 0, 3].abs().mean()
            logs["pose/ty"] = t0[:, 1, 3].abs().mean()
            logs["pose/tz"] = t0[:, 2, 3].abs().mean()

    total = (cam_loss / float(len(cfg.scales))).mean()
    if ramp is not None:
        prior_scale = 1.0 - st_ramp
        t_norm = batch_mean(torch.linalg.norm(cam_t_cam[..., :3, 3].float(),
                                              dim=-1).mean())
        pose_prior = (F.relu(cfg.pose_prior_floor - t_norm)
                      + F.relu(t_norm - cfg.pose_prior_ceil))
        disp_anchor = (batch_mean(torch.log(disps[0].float() + 1e-3).mean())
                       - math.log(0.5)) ** 2
        prior = prior_scale * (cfg.pose_prior_coeff * pose_prior
                               + cfg.disp_anchor_coeff * disp_anchor)
        total = total + prior.to(total.dtype)
        logs["cold_start/pose_prior"] = pose_prior
        logs["cold_start/disp_anchor"] = disp_anchor
    logs["total_loss"] = total
    return total, logs
