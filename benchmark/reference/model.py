"""The plain reference's model: serving (``predict``) and the training step
(forward, loss, backward, Adam) of the published VFDepth configurations,
read from a configuration file of the benchmark.

Two nets: the surround-fusion depth and pose nets (both back-project
their features into one voxel grid, merged into one back-projection) or
the per-camera fsm baselines. Float32 throughout; BatchNorm takes batch
statistics in training and running statistics in serving. Under
``training.aug_depth`` the training step adds depth synthesis
(``synthesis.py``): a second decode at rotated extrinsics and its loss.

``draws`` lists the random draws of the program's training step, in the
order it takes them from its generator, so that the benchmark hands the
same numbers to the reference.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .geometry import distribute, invert, pose_matrix, relative_poses, resize
from .nets import (FusedDepthNet, FusedPoseNet, MonoDepthNet, MonoPoseNet,
                   VoxelSpec, backproject_grouped)
from .render import render, total_loss
from .synthesis import augment_extrinsics, decode_views, synthesis_loss

CAMERA_NAMES = ["camera_01", "camera_05", "camera_06", "camera_07",
                "camera_08", "camera_09"]
NEIGHBOURS = {0: [1, 2], 1: [0, 3], 2: [0, 4], 3: [1, 5], 4: [2, 5],
              5: [3, 4]}
GROUPS_6CAM = ((0, 3, 4), (1, 2, 5))


def neighbours(cameras) -> torch.Tensor:
    """[cams, 2] neighbour indices of a rig (-1: none)."""
    idx = [CAMERA_NAMES.index(c) for c in cameras]
    rows = [[n for n in NEIGHBOURS[i] if n in idx][:2] for i in idx]
    return torch.tensor([r + [-1] * (2 - len(r)) for r in rows], device="cpu")


class RefModel(nn.Module):
    def __init__(self, cfg: Mapping):
        super().__init__()
        m, t, data = cfg["model"], cfg["training"], cfg["data"]
        self.cfg = cfg
        self.cams = len(data["cameras"])
        if self.cams != 6:
            raise ValueError("the reference runs the 6-camera rig")
        self.height, self.width = int(t["height"]), int(t["width"])
        self.scales = tuple(t["scales"])
        self.frame_ids = tuple(t["frame_ids"])
        self.min_depth, self.max_depth = float(t["min_depth"]), float(
            t["max_depth"])
        self.fl_scale = float(t["focal_length_scale"])
        self.lev = int(m["fusion_level"])
        self.fusion = m["depth_model"] == "fusion"
        if (m["pose_model"] == "fusion") != self.fusion:
            raise ValueError("the reference pairs fusion with fusion, fsm "
                             "with fsm")
        self.loss_cfg = dict(frame_ids=self.frame_ids, scales=self.scales,
                             spatio=bool(t["spatio"]),
                             spatio_temporal=bool(t["spatio_temporal"]),
                             pose_model=m["pose_model"], **cfg["loss"])
        self.align = bool(t["intensity_align"])
        self.aug_depth = bool(t.get("aug_depth", False))
        if self.aug_depth:
            if not self.fusion:
                raise ValueError("aug_depth needs the fusion nets")
            self.aug_angle = tuple(float(a) for a in t["aug_angle"])
            self.syn_coeffs = (float(cfg["loss"]["depth_con_coeff"]),
                               float(cfg["loss"]["depth_sm_coeff"]))
        if self.fusion:
            self.spec = VoxelSpec(m, self.height, self.width)
            self.depth_net = FusedDepthNet(m, self.spec, self.scales)
            self.pose_net = FusedPoseNet(m, self.spec)
        else:
            self.depth_net = MonoDepthNet(m, self.scales)
            self.pose_net = MonoPoseNet(m)
        self.rel_cam_rows = neighbours(data["cameras"])
        # recompute the nets' activations in the backward pass (the same
        # numbers, less memory)
        self.checkpoint = False

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @classmethod
    def on(cls, cfg: Mapping, device) -> "RefModel":
        """The model's tensors allocated on ``device``, uninitialised (the
        benchmark loads its weights)."""
        with torch.device("meta"):
            model = cls(cfg)
        return model.to_empty(device=device)

    # ------------------------------------------------------------ nets
    def _call(self, fn, *args):
        if self.checkpoint and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def _predict(self, x: Dict[str, torch.Tensor],
                 ext_aug: Optional[torch.Tensor] = None):
        """(cam_T_cam [b, cams, n_ctx, 4, 4], {scale: disp}, and with
        ``ext_aug`` the rotated views' {scale: disp}, else None)."""
        ctx = self.frame_ids[1:]
        b = x["color_aug/0/0"].shape[0]
        curs = torch.cat([x[f"color_aug/{f if f < 0 else 0}/0"] for f in ctx])
        nxts = torch.cat([x[f"color_aug/{0 if f < 0 else f}/0"] for f in ctx])
        if self.fusion:
            lev = self.lev + 1
            pose_feats = self._call(self.pose_net.encode, curs, nxts,
                                    len(ctx))
            dfeats, depth_feats = self._call(self.depth_net.encode,
                                             x["color_aug/0/0"])
            cp = pose_feats.shape[-1]
            feat, count = backproject_grouped(
                torch.cat([pose_feats, depth_feats], -1), x["mask"],
                x[f"K/{lev}"], x["extrinsics_inv"], GROUPS_6CAM, self.spec)
            aa, tr = self.pose_net.pose(
                torch.cat([feat[..., :cp], feat[..., -1:]], -1), count,
                len(ctx))
            if ext_aug is None:
                disps = self._call(self.depth_net.decode, feat[..., cp:],
                                   count, dfeats[:self.lev],
                                   x[f"inv_K/{lev}"], x["extrinsics"])
            else:
                disps, disps_aug = decode_views(
                    self.depth_net, self._call, feat[..., cp:], count,
                    dfeats[:self.lev], x[f"inv_K/{lev}"],
                    (x["extrinsics"], ext_aug))
        else:
            aa, tr = self._call(self.pose_net, curs.flatten(0, 1),
                                nxts.flatten(0, 1))
            out = self._call(self.depth_net, x["color_aug/0/0"].flatten(0, 1))
            disps = {k: v.reshape((b, self.cams) + v.shape[1:])
                     for k, v in out.items()}
        aa = aa[:, 0, 0].reshape(len(ctx), -1, 3)
        tr = tr[:, 0, 0].reshape(len(ctx), -1, 3)
        mats = []
        for i, f in enumerate(ctx):
            mat = pose_matrix(aa[i], tr[i], invert=f < 0)
            mats.append(distribute(mat, x["extrinsics"], x["extrinsics_inv"])
                        if self.fusion else
                        mat.reshape((b, self.cams) + mat.shape[1:]))
        return (torch.stack(mats, dim=2),
                {s: disps[f"disp/{s}"] for s in self.scales},
                None if ext_aug is None else
                {s: disps_aug[f"disp/{s}"] for s in self.scales})

    def to_depth(self, disp: torch.Tensor, k0: torch.Tensor) -> torch.Tensor:
        lo, hi = 1.0 / self.max_depth, 1.0 / self.min_depth
        full = resize(disp, (self.height, self.width), False)
        depth = 1.0 / (lo + (hi - lo) * full)
        return depth * k0[..., 0:1, 0:1][..., None] / self.fl_scale

    @staticmethod
    def inputs(batch: Mapping, device) -> Dict[str, torch.Tensor]:
        x = {k: torch.as_tensor(v).to(device, torch.float32)
             for k, v in batch.items()}
        if "extrinsics_inv" not in x:
            x["extrinsics_inv"] = invert(x["extrinsics"])
        return x

    @torch.no_grad()
    def predict(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """Serving: BatchNorm on running statistics -> cam_T_cam and the
        metric depth of every scale."""
        was = self.training
        self.eval()
        try:
            x = self.inputs(batch, self.device)
            cam_t_cam, disps, _ = self._predict(x)
        finally:
            self.train(was)
        out = {"cam_T_cam": cam_t_cam}
        for s in self.scales:
            out[f"depth/{s}"] = self.to_depth(disps[s], x["K/0"])
        return out

    def loss(self, batch: Mapping, noise: torch.Tensor,
             aug_u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The training forward (BatchNorm on batch statistics) and loss;
        ``noise`` [n_scales, b, cams, n_ctx, H, W, 1] breaks the identity
        loss's ties, ``aug_u`` [b, cams, 3] (under ``aug_depth``) draws the
        rotated views. The finest scale's depth statistics are kept in
        ``self.depth_stats`` (mean, max, min), as the program logs them."""
        self.train()
        x = self.inputs(batch, self.device)
        rel_cam = self.rel_cam_rows.to(self.device)
        ext_aug = None
        if self.aug_depth:
            if aug_u is None:
                raise ValueError("aug_depth: the step needs aug_u")
            ext_aug = augment_extrinsics(aug_u.to(self.device),
                                         x["extrinsics"], self.aug_angle)
        cam_t_cam, disps, disps_aug = self._predict(x, ext_aug)
        spatio, st = relative_poses(x["extrinsics"], x["extrinsics_inv"],
                                    cam_t_cam, rel_cam)
        colors = {f: x[f"color/{f}/0"] for f in self.frame_ids}
        depths = {s: self.to_depth(disps[s], x["K/0"]) for s in self.scales}
        d0 = depths[min(self.scales)].detach()
        self.depth_stats = {"mean": d0.mean(), "max": d0.max(),
                            "min": d0.min()}
        rendered = {s: render(colors, x["mask"], x["K/0"], x["inv_K/0"],
                              depths[s], cam_t_cam, spatio, st, rel_cam,
                              self.frame_ids, self.align)
                    for s in self.scales}
        loss = total_loss(noise, self.loss_cfg, x, disps, cam_t_cam,
                          rendered)
        if not self.aug_depth:
            return loss
        depths_aug = {s: self.to_depth(disps_aug[s], x["K/0"])
                      for s in self.scales}
        return loss + synthesis_loss(x, depths, depths_aug, disps_aug,
                                     ext_aug, rel_cam, self.syn_coeffs,
                                     (self.min_depth, self.max_depth))


def noise_shape(model: RefModel, batch: Mapping) -> Tuple[int, ...]:
    b, cams, h, w = batch["color/0/0"].shape[:4]
    return (len(model.scales), b, cams, len(model.frame_ids) - 1, h, w, 1)


class Draw(NamedTuple):
    """One random draw of the training step: the keyword it is handed in
    as, uniform in [0, 1) or standard normal, its shape and its batch
    axis."""
    name: str
    uniform: bool
    shape: Tuple[int, ...]
    batch_axis: int

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        fn = torch.rand if self.uniform else torch.randn
        return fn(self.shape, generator=generator, device=generator.device)


def draws(model: RefModel, batch: Mapping) -> List[Draw]:
    """The draws the program's training step takes from its generator, in
    its order: the identity loss's tie-break noise, then, under
    ``aug_depth``, the rotated views' ``aug_u`` [b, cams, 3]."""
    out = [Draw("noise", False, noise_shape(model, batch), 1)]
    if model.aug_depth:
        out.append(Draw("aug_u", True,
                        tuple(batch["color/0/0"].shape[:2]) + (3,), 0))
    return out


def draw(model: RefModel, batch: Mapping,
         generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """``draws``' numbers from ``generator``, by keyword."""
    return {d.name: d.sample(generator) for d in draws(model, batch)}


class RefTrainer:
    """The reference's training step: forward, loss, backward and Adam
    (betas 0.9 / 0.999, eps 1e-8) at the configuration's learning rate.
    Records each step's loss and the first step's gradient per parameter
    (a leaf's norm) and each step's depth statistics."""

    def __init__(self, model: RefModel, lr: float):
        self.model = model
        self.params = dict(model.named_parameters())
        self.opt = torch.optim.Adam(list(self.params.values()), lr=lr,
                                    betas=(0.9, 0.999), eps=1e-8)
        self.losses = []
        self.depth_stats = []
        self.first_grad_norms: Optional[Dict[str, float]] = None

    def step(self, batch: Mapping, noise: torch.Tensor,
             aug_u: Optional[torch.Tensor] = None) -> float:
        self.opt.zero_grad(set_to_none=True)
        loss = self.model.loss(batch, noise, aug_u)
        loss.backward()
        if self.first_grad_norms is None:
            self.first_grad_norms = {
                k: float(p.grad.norm()) if p.grad is not None else 0.0
                for k, p in self.params.items()}
        self.opt.step()
        self.losses.append(float(loss.detach()))
        self.depth_stats.append({k: float(v) for k, v in
                                 self.model.depth_stats.items()})
        return self.losses[-1]
