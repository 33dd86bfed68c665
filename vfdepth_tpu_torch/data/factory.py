"""Dataset factory (port of ``vfdepth_tpu/data/factory.py``, the reference's
``dataset/base_dataset.py:5-50``).

Dispatches on ``cfg.dataset``: 'fake' (in-memory random frames) and
'synthetic' (the analytic ground-plane scene), with the JAX package's
rules: ground-truth depth everywhere but in train mode ('synthetic' always
has it). The DDAD and nuScenes readers, with train mode's colour jitter
(0.2, 0.2, 0.2, 0.05), are not ported yet (ROADMAP A3) and raise.
"""
from __future__ import annotations

from .fake import FakeDataset
from .synthetic_scene import SyntheticSceneDataset


def construct_dataset(cfg, mode: str):
    name = cfg.dataset
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
    if name in ("ddad", "nuscenes"):
        raise NotImplementedError(
            f"the {name} reader is not ported yet (ROADMAP A3); the port "
            "reads the 'fake' and 'synthetic' datasets")
    raise ValueError(f"unknown dataset {name!r}")
