"""Synthetic surround-view framesets, made on the device from a seed.

The published configurations train on DDAD, whose images and calibration
are not in the repository. A frameset here is the analytic rendering of a
procedurally textured ground plane (a copy of the program's
``data/synthetic_scene.py``) seen by a 6-camera rig with thin overlaps
between neighbours (the "nuscenes" mounting of the program's
``data/fake.py``: yaws 0, +-55, +-110 and 180 degrees, fx 0.791 W, the back
camera 0.506 W), at frames 0, -1 and +1 of a forward ego-motion. The seed
picks each frameset's texture phases and the order of a fixed set of ego
speeds, so every seed gives the same sizes and the same mix of motions.

A frameset carries the program's batch-dict contract (NHWC, flat string
keys): ``color/{f}/{s}``, ``color_aug/{f}/{s}``, ``K/{s}``, ``inv_K/{s}``,
``extrinsics``, ``extrinsics_inv`` and the self-occlusion ``mask``, whose
bottom rows are masked where the vehicle's body would be.
"""
from __future__ import annotations

import random
from typing import Dict, List, Sequence

import numpy as np
import torch

RIG_YAWS_DEG = [0.0, 55.0, -55.0, 110.0, -110.0, 180.0]
RIG_FX_FRAC = [0.791, 0.791, 0.791, 0.791, 0.791, 0.506]
# rows at the bottom of each camera covered by the vehicle's body (share
# of the height; assumed, in the spirit of DDAD's self-occlusion masks)
BODY_ROWS = [0.0, 0.08, 0.08, 0.12, 0.12, 0.10]
EGO_SPEEDS = [0.6, 0.9, 1.2, 1.5]      # metres a frame
SKY = (0.35, 0.55, 0.85)


def rig(num_cams: int, height: int, width: int):
    """(K [cams, 4, 4] at full resolution, camera-to-world extrinsics
    [cams, 4, 4]) of the thin-overlap rig, float32 numpy."""
    k = np.tile(np.eye(4, dtype=np.float32), (num_cams, 1, 1))
    fx = np.asarray(RIG_FX_FRAC[:num_cams], np.float32) * width
    k[:, 0, 0], k[:, 1, 1] = fx, fx
    k[:, 0, 2], k[:, 1, 2] = width / 2.0, height / 2.0
    exts = []
    for c in range(num_cams):
        yaw = np.deg2rad(RIG_YAWS_DEG[c])
        fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        right = np.array([np.sin(yaw), -np.cos(yaw), 0.0])
        ext = np.eye(4)
        ext[:3, :3] = np.stack([right, [0.0, 0.0, -1.0], fwd], axis=1)
        ext[:3, 3] = fwd * 1.5 + np.array([0.0, 0.0, 1.5])
        exts.append(ext)
    return k, np.stack(exts).astype(np.float32)


def _texture(wx, wy, ph):
    r = (0.45 + 0.3 * torch.sin(0.9 * wx + ph[0]) * torch.cos(0.7 * wy + ph[1])
         + 0.2 * torch.sin(3.1 * wx + ph[2]) * torch.sin(2.7 * wy + ph[3]))
    g = (0.45 + 0.3 * torch.sin(0.45 * wx + ph[4]) * torch.sin(0.6 * wy + ph[5])
         + 0.2 * torch.cos(2.3 * wx + ph[6]) * torch.sin(3.3 * wy + ph[7]))
    b = (0.45 + 0.3 * torch.cos(0.33 * wx + ph[8]) * torch.cos(0.52 * wy + ph[9])
         + 0.2 * torch.sin(2.9 * wx + ph[10]) * torch.cos(2.1 * wy + ph[11]))
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 1.0)


def _render(k, ext, ego_x, phases, height, width):
    """Every camera at ego position (ego_x, 0, 0) -> [cams, H, W, 3]."""
    dev = phases.device
    gy, gx = torch.meshgrid(torch.arange(height, device=dev,
                                         dtype=torch.float64),
                            torch.arange(width, device=dev,
                                         dtype=torch.float64), indexing="ij")
    k = torch.as_tensor(k, device=dev, dtype=torch.float64)
    ext = torch.as_tensor(ext, device=dev, dtype=torch.float64)
    rx = (gx[None] - k[:, 0, 2, None, None]) / k[:, 0, 0, None, None]
    ry = (gy[None] - k[:, 1, 2, None, None]) / k[:, 1, 1, None, None]
    rays = torch.stack([rx, ry, torch.ones_like(rx)], dim=-1)
    world = torch.einsum("chwj,cij->chwi", rays, ext[:, :3, :3])
    origin = ext[:, :3, 3] + torch.tensor([ego_x, 0.0, 0.0], device=dev,
                                          dtype=torch.float64)
    rz = world[..., 2]
    t = torch.where(rz < -1e-6, -origin[:, 2, None, None]
                    / torch.clamp(rz, max=-1e-6), torch.zeros_like(rz))
    hit = t > 0
    wx = origin[:, 0, None, None] + t * world[..., 0]
    wy = origin[:, 1, None, None] + t * world[..., 1]
    tex = _texture(torch.where(hit, wx, 0.0), torch.where(hit, wy, 0.0),
                   phases.double())
    sky = torch.tensor(SKY, device=dev, dtype=torch.float64)
    return torch.where(hit[..., None], tex, sky).float()


def intrinsics_pyramid(k_full: np.ndarray, num_scales: int
                       ) -> Dict[str, np.ndarray]:
    out = {}
    for s in range(num_scales):
        ks = k_full.copy()
        ks[..., 0, :] /= 2 ** s
        ks[..., 1, :] /= 2 ** s
        out[f"K/{s}"] = ks.astype(np.float32)
        out[f"inv_K/{s}"] = np.linalg.inv(ks).astype(np.float32)
    return out


def make_framesets(n: int, seed: int, cfg: dict, device,
                   indices: Sequence[int] = None) -> List[Dict]:
    """Framesets ``indices`` (all ``n`` by default) of the ``n`` distinct
    ones of ``seed``, as host dicts of float32 CPU tensors without a batch
    axis: texture phases drawn on the device, ego speeds the fixed set in
    the seed's order."""
    t = cfg["training"]
    height, width = int(t["height"]), int(t["width"])
    cams = len(cfg["data"]["cameras"])
    frames: Sequence[int] = t["frame_ids"]
    n_scales = int(cfg["model"].get("fusion_level", 2)) + 2
    k_full, ext = rig(cams, height, width)
    calib = intrinsics_pyramid(k_full, n_scales)
    calib["extrinsics"] = ext
    calib["extrinsics_inv"] = np.linalg.inv(ext).astype(np.float32)
    mask = np.ones((cams, height, width, 1), np.float32)
    for c in range(cams):
        rows = int(round(BODY_ROWS[c] * height))
        if rows:
            mask[c, height - rows:] = 0.0
    calib["mask"] = mask
    calib = {key: torch.from_numpy(v) for key, v in calib.items()}

    gen = torch.Generator(device).manual_seed(seed)
    phases = torch.rand((n, 12), generator=gen, device=device) * 2 * np.pi
    order = random.Random(seed).sample(range(len(EGO_SPEEDS)),
                                       len(EGO_SPEEDS))
    out = []
    for i in (range(n) if indices is None else indices):
        speed = EGO_SPEEDS[order[i % len(order)]]
        sample = dict(calib)
        for f in frames:
            img = _render(k_full, ext, (2.0 * i + f * speed), phases[i],
                          height, width).cpu()
            sample[f"color/{f}/0"] = img
            sample[f"color_aug/{f}/0"] = img
        for s in range(1, n_scales):
            small = sample["color/0/0"][:, ::2 ** s, ::2 ** s][
                :, :height // 2 ** s, :width // 2 ** s].contiguous()
            sample[f"color/0/{s}"] = small
            sample[f"color_aug/0/{s}"] = small
        out.append(sample)
    return out


def collate(samples: Sequence[Dict], keys=None) -> Dict[str, torch.Tensor]:
    """Framesets -> one batch (a new leading axis), of ``keys`` or all."""
    keys = samples[0].keys() if keys is None else keys
    return {k: torch.stack([s[k] for s in samples]) for k in keys}
