"""Dataset factory (port of ``vfdepth_tpu/data/factory.py``, the reference's
``dataset/base_dataset.py:5-50``).

Dispatches on ``cfg.dataset`` with the JAX package's arguments: 'ddad'
(the DGP scene-dataset reader, ``cfg.data_path`` its dataset JSON, split
'train' in train mode and 'val' otherwise, ``mask_dir``, ``depth_type``),
'nuscenes' (the devkit-free table reader; its split file is
``<split_dir>/<split>.txt`` where that exists, else the data root's
``splits/``), 'fake' (in-memory random frames) and 'synthetic' (the
analytic ground-plane scene). Ground-truth depth everywhere but in train
mode ('synthetic' always has it); train mode's readers colour-jitter by
(0.2, 0.2, 0.2, 0.05), the others not at all (reference
``models/vfdepth.py:99-138``).
"""
from __future__ import annotations

import os

from .fake import FakeDataset
from .synthetic_scene import SyntheticSceneDataset


def construct_dataset(cfg, mode: str):
    name = cfg.dataset
    jitter = (0.2, 0.2, 0.2, 0.05) if mode == "train" else (0.0, 0.0, 0.0, 0.0)
    common = dict(
        height=cfg.height,
        width=cfg.width,
        frame_ids=tuple(cfg.frame_ids),
        fusion_level=cfg.fusion_level,
        with_depth=(mode != "train"),
    )
    if name == "fake":
        return FakeDataset(num_samples=cfg.get("num_fake_samples", 64),
                           num_cams=cfg.num_cams, **common)
    if name == "synthetic":
        return SyntheticSceneDataset(
            num_samples=cfg.get("num_fake_samples", 64),
            num_cams=cfg.num_cams,
            speed=cfg.get("synthetic_speed", 0.5),
            max_depth=min(cfg.max_depth, 80.0),
            **{**common, "with_depth": True})
    if name == "ddad":
        from .ddad import DDADDataset
        return DDADDataset(cfg.data_path, cameras=tuple(cfg.cameras),
                           split=("train" if mode == "train" else "val"),
                           jitter=jitter, mask_dir=cfg.get("mask_dir"),
                           depth_type=cfg.get("depth_type", "lidar"), **common)
    if name == "nuscenes":
        from .nuscenes import NuScenesDataset
        split = "train" if mode == "train" else "val"
        split_file = None
        if cfg.get("split_dir"):
            cand = os.path.join(cfg.split_dir, f"{split}.txt")
            split_file = cand if os.path.isfile(cand) else None
        return NuScenesDataset(cfg.data_path, cameras=tuple(cfg.cameras),
                               split=split, jitter=jitter,
                               mask_dir=cfg.get("mask_dir"),
                               split_file=split_file, **common)
    raise ValueError(f"unknown dataset {name!r}")
