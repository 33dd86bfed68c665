"""Configuration system (a copy of ``vfdepth_tpu/config.py``).

Copied whole so the port reads the same YAML files without importing the
JAX package.

Reads the same YAML schema as the reference (sections ``ddp, model, data,
training, loss, eval, load, logging`` — see reference ``utils/misc.py:44-72``)
so reference configs port 1:1, but exposes a single typed-ish object instead
of the reference's "flatten everything into every class" idiom
(reference ``models/vfdepth.py:37-40``).

Derived keys reproduced from the reference loader:
  * ``log_path``, ``save_weights_root``, ``load_weights_dir``
  * ``num_cams`` from the camera list
  * ``rel_cam_list`` — static camera adjacency (reference ``utils/misc.py:8-41``)
  * eval mode forces ``world_size=1`` and ``batch_size=eval_batch_size``
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import yaml

# Camera naming/adjacency tables (reference utils/misc.py:8-10).
NUSC_CAM_LIST = [
    "CAM_FRONT", "CAM_FRONT_LEFT", "CAM_FRONT_RIGHT",
    "CAM_BACK_LEFT", "CAM_BACK_RIGHT", "CAM_BACK",
]
DDAD_CAM_LIST = [
    "camera_01", "camera_05", "camera_06",
    "camera_07", "camera_08", "camera_09",
]
# index order: front, front-left, front-right, back-left, back-right, back
REL_CAM_DICT = {0: [1, 2], 1: [0, 3], 2: [0, 4], 3: [1, 5], 4: [2, 5], 5: [3, 4]}

# Camera groups used by the overlap-fusion MLP (reference
# network/volumetric_fusionnet.py:209-230).
OVERLAP_GROUPS_6CAM = ([0, 3, 4], [1, 2, 5])
OVERLAP_GROUPS_3CAM = ([0], [1, 2])


def camera2ind(cameras: List[str]) -> List[Optional[int]]:
    """Map camera names to canonical rig indices (reference utils/misc.py:13-26)."""
    indices: List[Optional[int]] = []
    for cam in cameras:
        if cam in DDAD_CAM_LIST:
            indices.append(DDAD_CAM_LIST.index(cam))
        elif cam in NUSC_CAM_LIST:
            indices.append(NUSC_CAM_LIST.index(cam))
        else:
            indices.append(None)
    return indices


def get_relcam(cameras: List[str]) -> Dict[int, List[int]]:
    """Adjacent-camera lists for the given rig subset (reference utils/misc.py:29-41)."""
    indices = camera2ind(cameras)
    relcam: Dict[int, List[int]] = {}
    for ind in indices:
        relcam[ind] = [c for c in REL_CAM_DICT[ind] if c in indices]
    return relcam


class Config:
    """Nested-dict config with flat attribute access.

    ``cfg.batch_size`` resolves across all sections (the key set is globally
    unique in the reference schema); ``cfg['training']['batch_size']`` also
    works. Mutation goes through ``set(key, value)``.
    """

    def __init__(self, data: Dict[str, Dict[str, Any]]):
        object.__setattr__(self, "_data", data)
        flat: Dict[str, Any] = {}
        for section, kv in data.items():
            if not isinstance(kv, dict):
                continue
            for k, v in kv.items():
                flat[k] = v
        object.__setattr__(self, "_flat", flat)

    def __getattr__(self, name: str) -> Any:
        flat = object.__getattribute__(self, "_flat")
        if name in flat:
            return flat[name]
        raise AttributeError(f"config has no key {name!r}")

    def __getitem__(self, section: str) -> Dict[str, Any]:
        return self._data[section]

    def __contains__(self, name: str) -> bool:
        return name in self._flat

    def get(self, name: str, default: Any = None) -> Any:
        return self._flat.get(name, default)

    def set(self, key: str, value: Any, section: Optional[str] = None) -> None:
        """Set a key; updates both the nested dict and the flat view."""
        if section is None:
            for sec, kv in self._data.items():
                if isinstance(kv, dict) and key in kv:
                    section = sec
                    break
        if section is None:
            section = "_derived"
        self._data.setdefault(section, {})[key] = value
        self._flat[key] = value

    def to_dict(self) -> Dict[str, Any]:
        return self._data

    # ---- derived helpers -------------------------------------------------
    @property
    def overlap_groups(self):
        if self.num_cams == 6:
            return OVERLAP_GROUPS_6CAM
        if self.num_cams == 3:
            return OVERLAP_GROUPS_3CAM
        raise NotImplementedError(f"no overlap groups for {self.num_cams} cameras")

    @property
    def rel_cam_array(self):
        """[num_cams, 2] neighbor indices (−1 padding for missing neighbors)."""
        import numpy as np
        rel = self.rel_cam_list
        out = np.full((self.num_cams, 2), -1, dtype=np.int32)
        for cam in range(self.num_cams):
            for j, n in enumerate(rel.get(cam, [])[:2]):
                out[cam, j] = n
        return out


def get_config(path: str, mode: str = "train", weight_path: Optional[str] = None) -> Config:
    """Load a YAML config and attach derived keys (reference utils/misc.py:44-72)."""
    with open(path, "r") as stream:
        data = yaml.safe_load(stream)

    cfg_name = os.path.splitext(os.path.basename(path))[0]
    log_path = os.path.join(data["data"]["log_dir"], cfg_name)
    data["data"]["log_path"] = log_path
    data["data"]["save_weights_root"] = os.path.join(log_path, "models")
    if weight_path is None:
        weight_path = os.path.join(log_path, "models", data["load"]["weights"])
    data["data"]["load_weights_dir"] = weight_path
    data["data"]["num_cams"] = len(data["data"]["cameras"])
    data["model"]["mode"] = mode
    data["data"]["rel_cam_list"] = get_relcam(data["data"]["cameras"])
    data["data"]["exp_name"] = cfg_name

    if mode == "train":
        data["eval"]["syn_visualize"] = False
    elif mode == "eval":
        data["ddp"]["world_size"] = 1
        data["ddp"]["gpus"] = [0]
        data["training"]["batch_size"] = data["eval"]["eval_batch_size"]
        data["training"]["depth_flip"] = False

    # TPU-rebuild extras with safe defaults (absent from reference YAMLs).
    data.setdefault("tpu", {})
    tpu = data["tpu"]
    tpu.setdefault("mixed_precision", False)   # bf16 compute in the networks
    tpu.setdefault("data_axis", "data")        # mesh axis name for DP sharding
    tpu.setdefault("prefetch_depth", 2)        # device prefetch buffer
    tpu.setdefault("use_pallas", True)         # pallas samplers on TPU backend
    # sampler_2d: 'auto'|'pallas'|'matmul'|'gather' (None -> derived from
    # use_pallas); sampler_3d: 'packed' (bf16 backward-scatter updates) |
    # 'packed_f32grad' (exact f32 accumulation) | 'gather' | None (auto:
    # packed, with the bf16 update rounding only under mixed precision)
    tpu.setdefault("sampler_2d", None)
    tpu.setdefault("sampler_3d", None)
    tpu.setdefault("batch_pose_frames", True)  # one pose pass for all frames
    # one back-projection kernel pass for the pose AND depth paths (their
    # projected coordinates are identical; models/vfnet.py
    # backproject_features). false = separate per-net passes.
    tpu.setdefault("merge_backprojection", True)
    tpu.setdefault("warp_op", "auto")          # auto | mxu | quad
    tpu.setdefault("warp_window", True)        # windowed spatio/st warps (quad)
    tpu.setdefault("warp_window_hw", None)     # [h, w] override (None = auto)
    # Staged cold-start recipe for training WITHOUT pretrained encoders
    # (losses/composite.py LossConfig): temporal-only photometric warmup for
    # `cold_start_warmup_steps`, then the spatio/spatio-temporal overlap
    # coefficients fade in linearly over `cold_start_ramp_steps`. Both 0
    # (default) = the reference schedule (full coefficients from step 0,
    # which relies on ImageNet init to escape the depth-saturation minimum).
    tr = data["training"]
    tr.setdefault("cold_start_warmup_steps", 0)
    tr.setdefault("cold_start_ramp_steps", 0)
    # Staggered ST ramp (losses/composite.py LossConfig stagger_ramps):
    # default off — the joint schedule is the one validated at the
    # canonical regime; stagger is a knob for weak/fast-parallax regimes.
    tr.setdefault("cold_start_stagger_ramps", False)
    # Cold-start priors (losses/composite.py LossConfig docstring): active
    # only while the staged schedule ramps, scaled by (1 - ramp). The hinge
    # floor is in meters of per-camera translation per frame pair; the disp
    # anchor pulls the mean sigmoid toward 0.5 (mid-range depth).
    tr.setdefault("cold_start_pose_coeff", 1.0)
    tr.setdefault("cold_start_pose_floor", 0.1)
    tr.setdefault("cold_start_pose_ceil", 1.0)
    tr.setdefault("cold_start_disp_coeff", 0.1)
    # Optimizer-level pose-net LR multiplier while the staged schedule is
    # active, fading linearly to exactly 1.0 with the spatio-temporal ramp
    # (training/step.py make_optimizer). Adam's update magnitude is ~lr
    # regardless of gradient scale, so a from-scratch pose head's |t| grows
    # at most ~lr/step; at fast ego-motion (>= ~1.5 m/frame) the reference
    # lr needs ~7500 steps to reach scale — the boost closes that gap
    # without touching the converged (reference) optimizer. Default OFF:
    # at nominal speeds the un-boosted pose already reaches scale within
    # the ramp, and a measured 5x run at 0.5 m/frame REGRESSED the
    # validated recipe (docs/PERF.md round-5 stress table) — set it only
    # for fast-ego-motion datasets. Ignored when the staged schedule is
    # off.
    tr.setdefault("cold_start_pose_lr_boost", 1.0)
    return Config(data)
