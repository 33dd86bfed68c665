"""Synthetic in-memory dataset (a copy of ``vfdepth_tpu/data/fake.py``).

Lets the full train/eval loop, tests, and benchmarks run without DDAD /
nuScenes on disk (the reference has no such capability — SURVEY.md §4 calls
it out as a required addition). Geometry is a plausible 6-camera rig: cameras
at 60-degree yaw increments around the vehicle, slight forward motion between
frames.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from .contract import build_intrinsics_pyramid, color_key


# Surround-rig camera yaws (deg, + = left) in the reference camera-list
# order (front, front-left, front-right, back-left, back-right, back).
# "even": cameras at uniform 60-degree increments (large cross-camera
# overlap — a stress rig). "nuscenes": the publicly documented nuScenes
# mounting (devkit calibrated_sensor: FL/FR at ~+-55 deg, BL/BR at
# ~+-110 deg), whose adjacent-camera overlaps are thin edge strips —
# the realistic production geometry for the surround benchmarks.
_RIG_YAWS_DEG = {
    "even": [0.0, 60.0, -60.0, 120.0, -120.0, 180.0],
    "nuscenes": [0.0, 55.0, -55.0, 110.0, -110.0, 180.0],
}
# fx as a fraction of image width, per camera. nuScenes: 1266 px at
# W=1600 for the five 70-degree cameras, 809 px for the 110-degree
# back camera (public devkit calibration, scale-invariant as fx/W).
_RIG_FX_FRAC = {
    "even": [0.55] * 6,
    "nuscenes": [0.791, 0.791, 0.791, 0.791, 0.791, 0.506],
}


def make_rig_extrinsics(num_cams: int, radius: float = 1.5,
                        rig: str = "even") -> np.ndarray:
    """[cams, 4, 4] camera-to-world. Camera looks outward; world x-fwd/y-left/z-up.

    Camera frame: +z optical axis (forward), +x right, +y down.
    """
    if rig != "even" and num_cams > len(_RIG_YAWS_DEG[rig]):
        raise ValueError(f"rig '{rig}' defines 6 cameras, got {num_cams}")
    exts = []
    for c in range(num_cams):
        if rig == "even":
            yaw = 2.0 * np.pi * c / max(num_cams, 1)
        else:
            yaw = np.deg2rad(_RIG_YAWS_DEG[rig][c])
        # world-frame camera axes
        fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])     # optical axis
        right = np.array([np.sin(yaw), -np.cos(yaw), 0.0])  # camera +x
        down = np.array([0.0, 0.0, -1.0])                   # camera +y
        rot = np.stack([right, down, fwd], axis=1)  # columns = cam axes in world
        ext = np.eye(4)
        ext[:3, :3] = rot
        ext[:3, 3] = fwd * radius + np.array([0.0, 0.0, 1.5])
        exts.append(ext)
    return np.stack(exts).astype(np.float32)


def rig_fx_fractions(num_cams: int, rig: str = "even") -> np.ndarray:
    """Per-camera fx as a fraction of image width for the named rig."""
    if rig == "even":
        return np.full((num_cams,), 0.55, np.float32)
    return np.asarray(_RIG_FX_FRAC[rig][:num_cams], np.float32)


class FakeDataset:
    """Deterministic random dataset with the full batch-dict contract."""

    def __init__(self, num_samples: int = 32, num_cams: int = 6,
                 height: int = 384, width: int = 640,
                 frame_ids: Sequence[int] = (0, -1, 1),
                 fusion_level: int = 2, with_depth: bool = False,
                 seed: int = 0, max_depth: float = 200.0,
                 rig: str = "even"):
        self.num_samples = num_samples
        self.num_cams = num_cams
        self.height = height
        self.width = width
        self.frame_ids = tuple(frame_ids)
        self.fusion_level = fusion_level
        self.with_depth = with_depth
        self.seed = seed
        self.max_depth = max_depth

        fx = rig_fx_fractions(num_cams, rig) * width
        self.k_full = np.tile(np.eye(4, dtype=np.float32),
                              (num_cams, 1, 1))
        self.k_full[:, 0, 0] = fx
        self.k_full[:, 1, 1] = fx
        self.k_full[:, 0, 2] = width / 2.0
        self.k_full[:, 1, 2] = height / 2.0
        self.extrinsics = make_rig_extrinsics(num_cams, rig=rig)
        self.extrinsics_inv = np.linalg.inv(self.extrinsics).astype(np.float32)

    def __len__(self) -> int:
        return self.num_samples

    def rig_calibrations(self, max_rigs: int = 16):
        """Single synthetic rig, already at the train resolution."""
        return [(self.k_full.copy(), self.extrinsics.copy())]

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed * 100003 + idx)
        c, h, w = self.num_cams, self.height, self.width
        n_scales = self.fusion_level + 2

        sample: Dict[str, np.ndarray] = {}
        # smooth low-frequency images (upsampled coarse noise) so photometric
        # warp losses carry gradient signal, unlike per-pixel noise
        coarse = rng.rand(c, max(h // 8, 2), max(w // 8, 2), 3).astype(np.float32)
        reps_h = -(-h // coarse.shape[1])
        reps_w = -(-w // coarse.shape[2])
        base = np.repeat(np.repeat(coarse, reps_h, axis=1), reps_w, axis=2)[:, :h, :w]
        # light blur along each axis to avoid blocky gradients
        base = 0.5 * base + 0.25 * np.roll(base, 1, axis=1) + 0.25 * np.roll(base, 1, axis=2)
        for f in self.frame_ids:
            # context frames: shifted + slightly re-exposed copies. The
            # asymmetric shift and brightness break exact photometric ties
            # between the context frames — argmin/automask losses are
            # discontinuous at ties, which makes equivalence tests flaky
            # under different reduction layouts (sharded vs unsharded).
            if f:
                img = np.roll(base, shift=f * 2 + (1 if f > 0 else 0), axis=2)
                img = np.clip(img * (1.0 + 0.03 * f), 0.0, 1.0)
            else:
                img = base
            sample[color_key(f, 0)] = img
            sample[color_key(f, 0, aug=True)] = img
        for s in range(1, n_scales):
            hs, ws = h // (2 ** s), w // (2 ** s)
            small = sample[color_key(0, 0)][:, ::2 ** s, ::2 ** s][:, :hs, :ws]
            sample[color_key(0, s)] = np.ascontiguousarray(small)
            sample[color_key(0, s, aug=True)] = np.ascontiguousarray(small)

        sample.update(build_intrinsics_pyramid(self.k_full, n_scales))
        sample["extrinsics"] = self.extrinsics
        sample["extrinsics_inv"] = self.extrinsics_inv
        sample["mask"] = np.ones((c, h, w, 1), dtype=np.float32)
        if self.with_depth:
            depth = rng.uniform(2.0, 0.45 * self.max_depth, size=(c, h, w, 1))
            sample["depth"] = depth.astype(np.float32)
        return sample

    def batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        samples = [self[i] for i in indices]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
