"""Analytic multi-view scene: textured ground plane rendered per camera (a
copy of ``vfdepth_tpu/data/synthetic_scene.py``).

Unlike ``FakeDataset`` (random images), this dataset renders a procedurally
textured ground plane with exact multi-view geometry: every camera image at
every timestep is the analytic projection of the same world texture, so
temporal/spatial photometric consistency holds exactly at the true depth and
ego-motion. Training on it is a correctness probe for the whole pipeline —
the photometric losses should drive predicted depth toward the analytic
ground-truth depth map, and the pose net toward the scripted ego-motion.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from .contract import build_intrinsics_pyramid, color_key
from .fake import make_rig_extrinsics


def _texture(wx: np.ndarray, wy: np.ndarray) -> np.ndarray:
    """Procedural RGB texture over world ground coordinates.

    Mixes low- and mid-frequency components: enough high-frequency detail
    that the identity (no-motion) photometric loss clearly exceeds the
    true-reprojection loss — otherwise auto-masking can collapse training
    (textureless scenes are degenerate for self-supervised depth).
    """
    r = (0.45 + 0.3 * np.sin(0.9 * wx) * np.cos(0.7 * wy)
         + 0.2 * np.sin(3.1 * wx + 0.4) * np.sin(2.7 * wy))
    g = (0.45 + 0.3 * np.sin(0.45 * wx + 1.1) * np.sin(0.6 * wy + 0.3)
         + 0.2 * np.cos(2.3 * wx) * np.sin(3.3 * wy + 1.2))
    b = (0.45 + 0.3 * np.cos(0.33 * wx - 0.8) * np.cos(0.52 * wy + 1.7)
         + 0.2 * np.sin(2.9 * wx + 2.0) * np.cos(2.1 * wy - 0.5))
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0).astype(np.float32)


class SyntheticSceneDataset:
    """Ground-plane scene with scripted forward ego-motion.

    World frame: x forward, y left, z up; ground plane z = 0. Cameras sit on
    the standard outward rig ~1.5 m up. Ego moves +x by ``speed`` per frame.
    """

    def __init__(self, num_samples: int = 16, num_cams: int = 6,
                 height: int = 64, width: int = 96,
                 frame_ids: Sequence[int] = (0, -1, 1), fusion_level: int = 2,
                 with_depth: bool = True, speed: float = 1.5,
                 max_depth: float = 80.0, seed: int = 0, **_):
        self.num_samples = num_samples
        self.num_cams = num_cams
        self.height = height
        self.width = width
        self.frame_ids = tuple(frame_ids)
        self.fusion_level = fusion_level
        self.with_depth = with_depth
        self.speed = speed
        self.max_depth = max_depth

        k = np.eye(4, dtype=np.float32)
        k[0, 0] = 0.6 * width
        k[1, 1] = 0.6 * width
        k[0, 2] = width / 2.0
        k[1, 2] = height / 2.0
        self.k_full = np.tile(k, (num_cams, 1, 1))
        self.extrinsics = make_rig_extrinsics(num_cams)  # camera -> vehicle

    def __len__(self) -> int:
        return self.num_samples

    def _render(self, ego_x: float):
        """Render all cameras at ego position (ego_x, 0, 0).

        Returns (images [cams, H, W, 3], depth [cams, H, W, 1])."""
        h, w, cams = self.height, self.width, self.num_cams
        gx, gy = np.meshgrid(np.arange(w, dtype=np.float64),
                             np.arange(h, dtype=np.float64), indexing="xy")
        imgs = np.zeros((cams, h, w, 3), np.float32)
        depths = np.zeros((cams, h, w, 1), np.float32)
        for c in range(cams):
            k = self.k_full[c]
            ext = self.extrinsics[c].astype(np.float64)
            # rays in camera frame
            rx = (gx - k[0, 2]) / k[0, 0]
            ry = (gy - k[1, 2]) / k[1, 1]
            rays_cam = np.stack([rx, ry, np.ones_like(rx)], axis=-1)
            rays_world = rays_cam @ ext[:3, :3].T
            origin = ext[:3, 3] + np.array([ego_x, 0.0, 0.0])
            # intersect ground z=0: origin_z + t * ray_z = 0
            rz = rays_world[..., 2]
            t = np.where(rz < -1e-6, -origin[2] / np.minimum(rz, -1e-6), np.inf)
            hit = np.isfinite(t) & (t > 0)
            t_hit = np.where(hit, t, 0.0)  # keep inf out of the multiplies
            wx = origin[0] + t_hit * rays_world[..., 0]
            wy = origin[1] + t_hit * rays_world[..., 1]
            tex = _texture(np.where(hit, wx, 0.0), np.where(hit, wy, 0.0))
            sky = np.array([0.35, 0.55, 0.85], np.float32)
            imgs[c] = np.where(hit[..., None], tex, sky)
            # depth = z in camera frame = t * ||ray_cam z-component|| -> t is
            # along the unnormalized ray whose camera-z component is 1
            d = np.where(hit, t, 0.0)
            depths[c] = np.clip(d, 0.0, self.max_depth)[..., None].astype(np.float32)
        return imgs, depths

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        ego0 = idx * 2.0
        sample: Dict[str, np.ndarray] = {}
        depth0 = None
        for f in self.frame_ids:
            imgs, depths = self._render(ego0 + f * self.speed)
            sample[color_key(f, 0)] = imgs
            sample[color_key(f, 0, aug=True)] = imgs
            if f == 0:
                depth0 = depths
        n_scales = self.fusion_level + 2
        for s in range(1, n_scales):
            hs, ws = self.height // (2 ** s), self.width // (2 ** s)
            small = sample[color_key(0, 0)][:, ::2 ** s, ::2 ** s][:, :hs, :ws]
            sample[color_key(0, s)] = np.ascontiguousarray(small)
            sample[color_key(0, s, aug=True)] = np.ascontiguousarray(small)
        sample.update(build_intrinsics_pyramid(self.k_full, n_scales))
        sample["extrinsics"] = self.extrinsics
        sample["extrinsics_inv"] = np.linalg.inv(self.extrinsics).astype(np.float32)
        sample["mask"] = np.ones((self.num_cams, self.height, self.width, 1),
                                 np.float32)
        if self.with_depth:
            sample["depth"] = depth0
        return sample

    def batch(self, indices):
        samples = [self[i] for i in indices]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
