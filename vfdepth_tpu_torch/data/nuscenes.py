"""nuScenes dataset reader (raw JSON tables, nuscenes-devkit-free; a copy
of ``vfdepth_tpu/data/nuscenes.py``, numpy and PIL only, PIL imported
lazily).

Re-implements the slice of the devkit the reference uses
(``dataset/nuscenes_dataset.py:17-281``): the v1.0-trainval relational
tables (sample, sample_data, calibrated_sensor, sensor, ego_pose) loaded
directly from JSON, keyframe camera bundles addressed by sample token,
temporal context through ``sample_data.prev/next`` (the ~12 Hz sweeps;
val mode reuses the current frame like reference :90-101), camera extrinsics
from the calibrated-sensor quaternion (sensor-to-ego), and the full
lidar->ego->global->ego->camera depth projection chain (:104-210) cached as
``.npz``. Split token lists ship in ``splits/{train,val}.txt`` under the
data root (reference ships 20,095 / 5,416 tokens).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .depth_projection import (
    cached_depth,
    pose_to_matrix,
    project_points_to_depth,
    transform_points,
)
from .transforms import assemble_sample, resize_mask

_LIDAR_CHANNEL = "LIDAR_TOP"


def _load_table(root: str, version: str, name: str) -> List[dict]:
    with open(os.path.join(root, version, f"{name}.json")) as f:
        return json.load(f)


def _load_image(path: str) -> np.ndarray:
    import PIL.Image as pil
    with pil.open(path) as img:
        return np.asarray(img.convert("RGB")).astype(np.float32) / 255.0


def _load_lidar_bin(path: str) -> np.ndarray:
    """nuScenes .pcd.bin: float32 (x, y, z, intensity, ring)."""
    pts = np.fromfile(path, dtype=np.float32).reshape(-1, 5)
    return pts[:, :3].astype(np.float64)


class NuScenesDataset:
    def __init__(self, data_path: str, cameras: Sequence[str],
                 split: str = "train", version: str = "v1.0-trainval",
                 height: int = 352, width: int = 640,
                 frame_ids: Sequence[int] = (0, -1, 1), fusion_level: int = 2,
                 with_depth: bool = False,
                 jitter: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0),
                 mask_dir: Optional[str] = None, seed: int = 42,
                 split_file: Optional[str] = None, cache_depth: bool = True):
        self.root = os.path.abspath(data_path)
        self.cameras = list(cameras)
        self.split = split
        self.height = height
        self.width = width
        self.frame_ids = tuple(frame_ids)
        self.fusion_level = fusion_level
        self.with_depth = with_depth
        self.jitter = jitter
        self.mask_dir = mask_dir
        self.seed = seed
        self.cache_depth = cache_depth
        self.epoch = 0
        sensors = {s["token"]: s for s in _load_table(self.root, version, "sensor")}
        self.calibrated = {c["token"]: c for c in
                           _load_table(self.root, version, "calibrated_sensor")}
        self.ego_poses = {p["token"]: p for p in
                          _load_table(self.root, version, "ego_pose")}
        self.sample_data = {d["token"]: d for d in
                            _load_table(self.root, version, "sample_data")}
        samples = _load_table(self.root, version, "sample")

        # channel of each sample_data via its calibrated sensor
        def channel_of(sd: dict) -> str:
            cs = self.calibrated[sd["calibrated_sensor_token"]]
            return sensors[cs["sensor_token"]]["channel"]

        # sample token -> {channel: keyframe sample_data token}
        self.keyframes: Dict[str, Dict[str, str]] = {}
        wanted = set(self.cameras) | {_LIDAR_CHANNEL}
        for token, sd in self.sample_data.items():
            if not sd.get("is_key_frame"):
                continue
            ch = channel_of(sd)
            if ch in wanted:
                self.keyframes.setdefault(sd["sample_token"], {})[ch] = token

        # split token list
        tokens: List[str] = []
        if split_file is None:
            cand = os.path.join(self.root, "splits", f"{split}.txt")
            split_file = cand if os.path.isfile(cand) else None
        if split_file:
            with open(split_file) as f:
                tokens = [line.strip() for line in f if line.strip()]
        else:
            tokens = [s["token"] for s in samples]

        self.index: List[str] = []
        for tok in tokens:
            kf = self.keyframes.get(tok, {})
            if not all(c in kf for c in self.cameras):
                continue
            if split == "train":
                # require prev+next sweeps for every camera
                ok = all(
                    self.sample_data[kf[c]]["prev"] and self.sample_data[kf[c]]["next"]
                    for c in self.cameras)
                if not ok:
                    continue
            self.index.append(tok)

        self._masks: Optional[np.ndarray] = None


    def set_epoch(self, epoch: int) -> None:
        """Fold the epoch into per-sample augmentation seeds (called by
        BatchLoader.set_epoch each epoch, like the reference's
        DistributedSampler.set_epoch)."""
        self.epoch = int(epoch)

    def __len__(self) -> int:
        return len(self.index)

    def rig_calibrations(self, max_rigs: int = 16):
        """Distinct rig calibrations for static warp-window sizing: up to
        ``max_rigs`` samples spread over the split, each ``(K [cams,4,4]
        scaled to the train resolution, extrinsics [cams,4,4])``. Uses the
        sample_data width/height fields — no image IO."""
        out, seen = [], set()
        n = len(self.index)
        if n == 0:
            return out
        picks = sorted({int(i * n / min(max_rigs, n))
                        for i in range(min(max_rigs, n))})
        for idx in picks:
            kf = self.keyframes[self.index[idx]]
            ks, exts = [], []
            for cam in self.cameras:
                sd = self.sample_data[kf[cam]]
                k, ext = self._cam_matrices(kf[cam])
                raw_w = float(sd.get("width") or self.width)
                raw_h = float(sd.get("height") or self.height)
                k = k.copy()
                k[0, :] *= self.width / raw_w
                k[1, :] *= self.height / raw_h
                ks.append(k)
                exts.append(ext)
            k = np.stack(ks).astype(np.float32)
            ext = np.stack(exts).astype(np.float32)
            key = (k[:, :2].round(4).tobytes(), ext[:, :3].round(5).tobytes())
            if key not in seen:
                seen.add(key)
                out.append((k, ext))
        return out

    # ------------------------------------------------------------------
    def _context_token(self, token: str, f: int) -> str:
        """Neighbor sweep token (val mode reuses the current frame)."""
        if f == 0:
            return token
        sd = self.sample_data[token]
        nbr = sd["prev"] if f < 0 else sd["next"]
        if not nbr or self.split != "train":
            return token
        return nbr

    def _cam_matrices(self, sd_token: str) -> Tuple[np.ndarray, np.ndarray]:
        """(K [4,4], extrinsics sensor-to-ego [4,4]) for a sample_data."""
        cs = self.calibrated[self.sample_data[sd_token]["calibrated_sensor_token"]]
        k = np.eye(4)
        ci = np.asarray(cs["camera_intrinsic"], dtype=np.float64)
        k[:3, :3] = ci
        ext = pose_to_matrix(cs["translation"],
                             [cs["rotation"][0], cs["rotation"][1],
                              cs["rotation"][2], cs["rotation"][3]])
        return k, ext

    def _ego_pose(self, sd_token: str) -> np.ndarray:
        p = self.ego_poses[self.sample_data[sd_token]["ego_pose_token"]]
        return pose_to_matrix(p["translation"], p["rotation"])

    def _load_masks(self) -> np.ndarray:
        if self._masks is not None:
            return self._masks
        masks = []
        for cam in self.cameras:
            p = os.path.join(self.mask_dir or "", f"{cam}_mask.png")
            if self.mask_dir and os.path.isfile(p):
                import PIL.Image as pil
                with pil.open(p) as img:
                    m = np.asarray(img.convert("L")).astype(np.float32) / 255.0
                masks.append(resize_mask(m > 0.5, (self.height, self.width)))
            else:
                masks.append(np.ones((self.height, self.width, 1), np.float32))
        self._masks = np.stack(masks)
        return self._masks

    def _depth_for(self, sample_token: str) -> Optional[np.ndarray]:
        kf = self.keyframes[sample_token]
        lidar_tok = kf.get(_LIDAR_CHANNEL)
        if lidar_tok is None:
            return None
        lidar_sd = self.sample_data[lidar_tok]
        lidar_path = os.path.join(self.root, lidar_sd["filename"])
        lidar_cs = self.calibrated[lidar_sd["calibrated_sensor_token"]]
        lidar_to_ego = pose_to_matrix(lidar_cs["translation"], lidar_cs["rotation"])
        ego_at_lidar = self._ego_pose(lidar_tok)

        depths = []
        for cam in self.cameras:
            cam_tok = kf[cam]
            cam_sd = self.sample_data[cam_tok]
            k, cam_to_ego = self._cam_matrices(cam_tok)
            ego_at_cam = self._ego_pose(cam_tok)
            cache = (os.path.splitext(lidar_path)[0] + f"_{cam}_depth.npz"
                     if self.cache_depth else "")

            def compute(lidar_path=lidar_path, lidar_to_ego=lidar_to_ego,
                        ego_at_lidar=ego_at_lidar, cam_to_ego=cam_to_ego,
                        ego_at_cam=ego_at_cam, k=k, cam_sd=cam_sd):
                pts = _load_lidar_bin(lidar_path)
                # lidar -> ego(t_l) -> global -> ego(t_c) -> camera
                pts = transform_points(pts, lidar_to_ego)
                pts = transform_points(pts, ego_at_lidar)
                pts = transform_points(pts, np.linalg.inv(ego_at_cam))
                pts = transform_points(pts, np.linalg.inv(cam_to_ego))
                return project_points_to_depth(pts, k, cam_sd["height"],
                                               cam_sd["width"])

            depths.append(cached_depth(cache, compute))
        return np.stack(depths)

    # ------------------------------------------------------------------
    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        token = self.index[idx]
        kf = self.keyframes[token]

        images: Dict[int, np.ndarray] = {}
        for f in self.frame_ids:
            frames = []
            for cam in self.cameras:
                tok = self._context_token(kf[cam], f)
                frames.append(_load_image(
                    os.path.join(self.root, self.sample_data[tok]["filename"])))
            images[f] = np.stack(frames)

        mats = [self._cam_matrices(kf[cam]) for cam in self.cameras]
        k_full = np.stack([m[0] for m in mats])
        extrinsics = np.stack([m[1] for m in mats])
        mask = self._load_masks()

        depth = self._depth_for(token) if self.with_depth else None

        # fold the epoch into the seed so augmentation differs per
        # epoch (loader.set_epoch propagates here; ADVICE r1 #2)
        rng = np.random.RandomState(
            (self.seed * 99991 + self.epoch * 7919 + idx) % (2 ** 31))
        return assemble_sample(
            rng, images, k_full, extrinsics, mask,
            (self.height, self.width), self.fusion_level,
            jitter=self.jitter, depth=depth)
