"""What the port's kernels must read and write at a cell's shapes, from
the rig's geometry: the variables of the operation files in
``benchmark/kernels/``.

The voxel back-projection reads the features once and writes the two
group sums; its backward reads the cotangent rows of the voxels some
camera of their group sees. The frustum sample reads the voxel rows that a
live tap (a nonzero trilinear weight) reads; its backward the cotangent
rows of the live points. Which voxels and points those are depends on the
rig, so they are counted here with the plain reference's own geometry,
from the first batch's calibration.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from .reference.model import GROUPS_6CAM
from .reference.nets import VoxelSpec, frustum_ndc, visibility


def _axis_live(p: torch.Tensor, size: int) -> torch.Tensor:
    return (p > -1.0) & (p < size)


def frustum_counts(ndc: torch.Tensor, size) -> Tuple[int, int]:
    """(live points, voxel rows read) of trilinear samples at ``ndc`` [b,
    ..., 3] (x, y, z in [-1, 1] align corners) of ``size`` (vx, vy, vz)
    volumes: a point is live where a tap weight is not zero; a row is read
    where a tap inside the volume has a weight that is not zero, counted
    once a volume."""
    vx, vy, vz = size
    b = ndc.shape[0]
    p = [(ndc[..., i] + 1.0) * 0.5 * (n - 1)
         for i, n in enumerate((vx, vy, vz))]
    live = _axis_live(p[0], vx) & _axis_live(p[1], vy) & _axis_live(p[2], vz)
    rows = 0
    for bi in range(b):
        keys = []
        base = [torch.floor(q[bi][live[bi]]) for q in p]
        frac = [q[bi][live[bi]] - f for q, f in zip(p, base)]
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    ix, iy, iz = base[0] + dx, base[1] + dy, base[2] + dz
                    ok = ((ix >= 0) & (ix < vx) & (iy >= 0) & (iy < vy)
                          & (iz >= 0) & (iz < vz)
                          & ((frac[0] > 0) | (dx == 0))
                          & ((frac[1] > 0) | (dy == 0))
                          & ((frac[2] > 0) | (dz == 0)))
                    keys.append(((iy * vx + ix) * vz + iz)[ok].long())
        rows += int(torch.unique(torch.cat(keys)).numel())
    return int(live.sum()), rows


def variables(cfg: Mapping, batch: Mapping, device) -> Dict[str, float]:
    """The shapes and data-dependent counts of one rank's step at this
    batch (a dict of numbers)."""
    m, t = cfg["model"], cfg["training"]
    b, cams = batch["color_aug/0/0"].shape[:2]
    h, w = int(t["height"]), int(t["width"])
    n_ctx = len(t["frame_ids"]) - 1
    out = dict(b=b, cams=cams, bc=b * cams, H=h, W=w,
               k5_nb=b * cams * n_ctx)
    if m["depth_model"] != "fusion":
        return out
    spec = VoxelSpec(m, h, w)
    lev = int(m["fusion_level"]) + 1
    fh, fw = spec.img_h, spec.img_w
    x = {k: torch.as_tensor(v).to(device, torch.float32)
         for k, v in batch.items()
         if k in (f"K/{lev}", f"inv_K/{lev}", "extrinsics", "extrinsics_inv",
                  "mask")}
    valid = visibility(x["mask"], x[f"K/{lev}"], x["extrinsics_inv"], spec,
                       fh, fw)[0]                            # [b, cams, n]
    seen = sum(int((valid[:, list(g)].sum(dim=1) > 0).sum())
               for g in GROUPS_6CAM)
    live, rows = frustum_counts(frustum_ndc(x[f"inv_K/{lev}"],
                                            x["extrinsics"], spec), spec.size)
    c_in = int(m["fusion_feat_in_dim"])
    vx, vy, vz = spec.size
    out.update(fh=fh, fw=fw, C=c_in * (n_ctx + 1), nvox=vx * vy * vz,
               valid=float(valid.sum()), seen=seen,
               fpts=b * cams * fh * fw * spec.bins[2],
               live=live, rows=rows,
               vc=int(m["voxel_pre_dim"][-1]))
    return out
