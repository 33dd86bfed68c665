"""DDAD dataset reader (DGP scene-dataset format, devkit-free; a copy of
``vfdepth_tpu/data/ddad.py``, numpy and PIL only, PIL imported lazily).

Re-implements the slice of TRI's DGP that the reference consumes through
``SynchronizedSceneDataset`` (reference ``dataset/ddad_dataset_sf.py:13-155``,
SURVEY.md §7 hard part 5): the scene-dataset JSON (split -> scene JSON
files), per-scene synchronized samples over the requested cameras + lidar,
calibration files (intrinsics + sensor-to-vehicle extrinsics), temporal
back/forward context via sample indices, and on-demand lidar->depth-map
generation cached as ``.npz``.

Self-occlusion masks: ``mask_dir/<mask_set>/CAMERA_XX_mask.png`` selected per
scene by ``mask_dir/mask_idx_dict.json`` (or ``.pkl``) mapping scene index ->
mask-set id, mirroring the reference's hand-made mask assets
(``dataset/ddad_mask``). Missing masks degrade to all-ones.

Proto-JSON key style differs across DGP versions (snake_case vs camelCase);
``_g`` reads either.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .depth_projection import (
    cached_depth,
    lidar_to_camera_depth,
    pose_to_matrix,
)
from .transforms import assemble_sample, resize_mask

_SPLIT_IDS = {"train": "0", "val": "1", "test": "2"}
_LIDAR_NAMES = ("LIDAR", "lidar")


def _g(d: dict, *names, default=None):
    """Get the first present key among snake_case/camelCase variants."""
    for n in names:
        if n in d:
            return d[n]
        camel = "".join(w.capitalize() if i else w
                        for i, w in enumerate(n.split("_")))
        if camel in d:
            return d[camel]
    return default


def _load_image(path: str) -> np.ndarray:
    import PIL.Image as pil
    with pil.open(path) as img:
        return np.asarray(img.convert("RGB")).astype(np.float32) / 255.0


def _load_point_cloud(path: str) -> np.ndarray:
    """DGP point clouds: .npz with a structured 'data' array (X, Y, Z, ...)."""
    with np.load(path) as f:
        data = f["data"]
    if data.dtype.names:  # structured
        return np.stack([data["X"], data["Y"], data["Z"]], axis=1).astype(np.float64)
    return np.asarray(data)[:, :3].astype(np.float64)


class _Scene:
    """Parsed DGP scene: synchronized sample index over cameras + lidar."""

    def __init__(self, scene_dir: str, scene_json: str, cameras: Sequence[str]):
        self.dir = scene_dir
        with open(scene_json, "r") as f:
            proto = json.load(f)
        self.cameras = list(cameras)

        # datum key -> datum record
        self.datums: Dict[str, dict] = {}
        for d in _g(proto, "data", default=[]):
            self.datums[_g(d, "key")] = d

        # samples: list of {sensor name -> datum key}; keep calibration key
        self.samples: List[Dict[str, str]] = []
        self.calibration_keys: List[str] = []
        for s in _g(proto, "samples", default=[]):
            by_name: Dict[str, str] = {}
            for key in _g(s, "datum_keys", default=[]):
                datum = self.datums.get(key)
                if datum is None:
                    continue
                name = _g(_g(datum, "id", default={}), "name", default="")
                by_name[name] = key
            self.samples.append(by_name)
            self.calibration_keys.append(_g(s, "calibration_key", default=""))

        self._calibrations: Dict[str, dict] = {}

    def calibration(self, key: str) -> dict:
        """name -> (K [4,4], extrinsics sensor->vehicle [4,4])."""
        if key not in self._calibrations:
            path = os.path.join(self.dir, "calibration", f"{key}.json")
            with open(path, "r") as f:
                calib = json.load(f)
            names = _g(calib, "names", default=[])
            intr = _g(calib, "intrinsics", default=[])
            extr = _g(calib, "extrinsics", default=[])
            table = {}
            for i, name in enumerate(names):
                k = np.eye(4)
                ci = intr[i] if i < len(intr) else {}
                k[0, 0] = float(_g(ci, "fx", default=0.0))
                k[1, 1] = float(_g(ci, "fy", default=0.0))
                k[0, 2] = float(_g(ci, "cx", default=0.0))
                k[1, 2] = float(_g(ci, "cy", default=0.0))
                k[0, 1] = float(_g(ci, "skew", default=0.0))
                ce = extr[i] if i < len(extr) else {}
                t = _g(ce, "translation", default={}) or {}
                r = _g(ce, "rotation", default={}) or {}
                ext = pose_to_matrix(
                    [float(t.get("x", 0.0)), float(t.get("y", 0.0)), float(t.get("z", 0.0))],
                    [float(r.get("qw", 1.0)), float(r.get("qx", 0.0)),
                     float(r.get("qy", 0.0)), float(r.get("qz", 0.0))])
                table[name] = (k, ext)
            self._calibrations[key] = table
        return self._calibrations[key]

    def datum_filename(self, key: str) -> Tuple[str, str]:
        """Returns (kind, absolute path) for a datum key."""
        datum = self.datums[key]
        body = _g(datum, "datum", default={})
        img = _g(body, "image")
        if img is not None:
            return "image", os.path.join(self.dir, _g(img, "filename"))
        pc = _g(body, "point_cloud")
        if pc is not None:
            return "point_cloud", os.path.join(self.dir, _g(pc, "filename"))
        raise ValueError(f"datum {key} has no image/point_cloud")

    def lidar_name(self, sample_idx: int) -> Optional[str]:
        for name in self.samples[sample_idx]:
            if name in _LIDAR_NAMES:
                return name
        return None


class DDADDataset:
    """Synchronized surround-view DDAD samples with temporal context.

    Yields the batch contract of ``contract.py``. Samples are scene-interior
    frames (both back and forward context available), like the reference's
    back/forward context 1 (``configs/ddad/ddad_surround_fusion.yaml:27-28``).
    """

    def __init__(self, dataset_json: str, cameras: Sequence[str],
                 split: str = "train", height: int = 384, width: int = 640,
                 frame_ids: Sequence[int] = (0, -1, 1), fusion_level: int = 2,
                 with_depth: bool = False,
                 jitter: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0),
                 mask_dir: Optional[str] = None,
                 depth_type: str = "lidar", seed: int = 42,
                 cache_depth: bool = True):
        self.root = os.path.dirname(os.path.abspath(dataset_json))
        self.cameras = list(cameras)
        self.height = height
        self.width = width
        self.frame_ids = tuple(frame_ids)
        self.fusion_level = fusion_level
        self.with_depth = with_depth
        self.jitter = jitter
        self.mask_dir = mask_dir
        self.depth_type = depth_type
        self.seed = seed
        self.cache_depth = cache_depth
        self.epoch = 0
        with open(dataset_json, "r") as f:
            ds = json.load(f)
        splits = _g(ds, "scene_splits", default={})
        entry = splits.get(_SPLIT_IDS.get(split, split), {})
        scene_files = _g(entry, "filenames", default=[])

        self.scenes: List[_Scene] = []
        self.index: List[Tuple[int, int]] = []  # (scene_idx, sample_idx)
        back = max([-f for f in frame_ids if f < 0] + [0])
        fwd = max([f for f in frame_ids if f > 0] + [0])
        for si, rel in enumerate(scene_files):
            scene_json = os.path.join(self.root, rel)
            scene_dir = os.path.dirname(scene_json)
            scene = _Scene(scene_dir, scene_json, cameras)
            self.scenes.append(scene)
            n = len(scene.samples)
            for t in range(back, n - fwd):
                if all(c in scene.samples[t] for c in self.cameras):
                    self.index.append((si, t))

        self._mask_idx: Dict[str, int] = {}
        if mask_dir:
            for name in ("mask_idx_dict.json",):
                p = os.path.join(mask_dir, name)
                if os.path.isfile(p):
                    with open(p) as f:
                        self._mask_idx = {str(k): int(v) for k, v in json.load(f).items()}
            if not self._mask_idx:
                p = os.path.join(mask_dir, "mask_idx_dict.pkl")
                if os.path.isfile(p):
                    import pickle
                    with open(p, "rb") as f:
                        self._mask_idx = {str(k): int(v)
                                          for k, v in pickle.load(f).items()}


    def set_epoch(self, epoch: int) -> None:
        """Fold the epoch into per-sample augmentation seeds (called by
        BatchLoader.set_epoch each epoch, like the reference's
        DistributedSampler.set_epoch)."""
        self.epoch = int(epoch)

    def rig_calibrations(self, max_rigs: int = 16):
        """Per-scene rig calibrations for static warp-window sizing:
        up to ``max_rigs`` scenes spread over the split, each as
        ``(K [cams,4,4] scaled to the train resolution, extrinsics
        [cams,4,4])``. Loads calibration JSONs and one image *header* per
        scene (PIL reads only the size) — no pixel decode."""
        out = []
        n = len(self.scenes)
        if n == 0:
            return out
        picks = sorted({int(i * n / min(max_rigs, n))
                        for i in range(min(max_rigs, n))})
        for si in picks:
            scene = self.scenes[si]
            # first indexed sample of this scene (guaranteed all cams)
            t = next((tt for ss, tt in self.index if ss == si), None)
            if t is None:
                continue
            calib = scene.calibration(scene.calibration_keys[t])
            _, path = scene.datum_filename(scene.samples[t][self.cameras[0]])
            from PIL import Image
            with Image.open(path) as im:
                raw_w, raw_h = im.size
            k = np.stack([calib[cam][0] for cam in self.cameras]).astype(
                np.float64).copy()
            k[:, 0, :] *= self.width / raw_w
            k[:, 1, :] *= self.height / raw_h
            ext = np.stack([calib[cam][1] for cam in self.cameras])
            out.append((k.astype(np.float32), ext.astype(np.float32)))
        return out

    def __len__(self) -> int:
        return len(self.index)

    # ------------------------------------------------------------------
    def _load_mask(self, scene_idx: int) -> np.ndarray:
        """[cams, H, W, 1] self-occlusion mask for the scene (ones fallback)."""
        if self.mask_dir:
            mask_set = self._mask_idx.get(str(scene_idx), 0)
            masks = []
            ok = True
            for cam in self.cameras:
                name = f"{cam.upper()}_mask.png"
                p = os.path.join(self.mask_dir, str(mask_set), name)
                if not os.path.isfile(p):
                    ok = False
                    break
                import PIL.Image as pil
                with pil.open(p) as img:
                    m = np.asarray(img.convert("L")).astype(np.float32) / 255.0
                masks.append(resize_mask(m > 0.5, (self.height, self.width)))
            if ok:
                return np.stack(masks)
        return np.ones((len(self.cameras), self.height, self.width, 1),
                       dtype=np.float32)

    def _depth_for(self, scene: _Scene, scene_idx: int, t: int,
                   calib: dict) -> Optional[np.ndarray]:
        lidar = scene.lidar_name(t)
        if lidar is None:
            # keep the batch contract consistent across samples: a frame
            # without a lidar sweep yields an all-zero (= no returns) map
            # at each camera's native resolution
            import PIL.Image as pil
            depths = []
            for cam in self.cameras:
                _, img_path = scene.datum_filename(scene.samples[t][cam])
                with pil.open(img_path) as im:
                    w0, h0 = im.size
                depths.append(np.zeros((h0, w0), np.float32))
            return np.stack(depths)
        kind, pc_path = scene.datum_filename(scene.samples[t][lidar])
        assert kind == "point_cloud"
        lidar_k, lidar_ext = None, calib[lidar][1]

        depths = []
        for cam in self.cameras:
            k, cam_ext = calib[cam]
            cache = (os.path.splitext(pc_path)[0] + f"_{cam}_depth.npz"
                     if self.cache_depth else "")

            def compute(pc_path=pc_path, lidar_ext=lidar_ext, cam_ext=cam_ext, k=k):
                pts = _load_point_cloud(pc_path)
                # native resolution of this camera image
                img_kind, img_path = scene.datum_filename(scene.samples[t][cam])
                import PIL.Image as pil
                with pil.open(img_path) as im:
                    w0, h0 = im.size
                return lidar_to_camera_depth(pts, lidar_ext, cam_ext, k, h0, w0)

            depths.append(cached_depth(cache, compute))
        return np.stack(depths)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        scene_idx, t = self.index[idx]
        scene = self.scenes[scene_idx]
        calib = scene.calibration(scene.calibration_keys[t])

        images: Dict[int, np.ndarray] = {}
        for f in self.frame_ids:
            frames = []
            for cam in self.cameras:
                kind, path = scene.datum_filename(scene.samples[t + f][cam])
                frames.append(_load_image(path))
            images[f] = np.stack(frames)

        k_full = np.stack([calib[cam][0] for cam in self.cameras])
        extrinsics = np.stack([calib[cam][1] for cam in self.cameras])
        mask = self._load_mask(scene_idx)

        depth = None
        if self.with_depth and self.depth_type == "lidar":
            depth = self._depth_for(scene, scene_idx, t, calib)

        # fold the epoch into the seed so augmentation differs per
        # epoch (loader.set_epoch propagates here; ADVICE r1 #2)
        rng = np.random.RandomState(
            (self.seed * 99991 + self.epoch * 7919 + idx) % (2 ** 31))
        return assemble_sample(
            rng, images, k_full, extrinsics, mask,
            (self.height, self.width), self.fusion_level,
            jitter=self.jitter, depth=depth)
