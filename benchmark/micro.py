"""Micro-size versions of the benchmark's configurations and traffic, for
the CPU tests: 64x96 images, a 24x24x8 voxel grid, 12 depth bins and
32 fusion channels, the structure of the published models otherwise."""
from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def config(name: str) -> dict:
    with open(HERE / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    cfg["training"].update(height=64, width=96)
    if cfg["model"]["depth_model"] == "fusion":
        cfg["model"].update(fusion_feat_in_dim=32,
                            voxel_unit_size=[4.0, 4.0, 3.0],
                            voxel_size=[24, 24, 8],
                            voxel_str_p=[-46.0, -46.0, -10.5],
                            voxel_pre_dim=[16], proj_d_bins=12)
    return cfg


def traffic(name: str, **over) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        out = json.load(f)
    out.update(over)
    return out
