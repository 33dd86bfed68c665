"""Programmatic config presets (a copy of ``vfdepth_tpu/presets.py``).

Copied whole so the port builds the same configurations without importing
the JAX package.

``full_config`` mirrors configs/ddad/ddad_surround_fusion.yaml; ``tiny`` and
``micro`` shrink images/voxels for CPU smoke tests and the multi-device dry
run (the dry-run host may give all virtual devices a single core).
"""
from __future__ import annotations

from .config import Config, get_relcam, DDAD_CAM_LIST


def build_config(*, cameras=None, height=384, width=640, batch_size=2,
                 depth_model="fusion", pose_model="fusion",
                 fusion_feat_in_dim=256, voxel_unit_size=(1.0, 1.0, 1.5),
                 voxel_size=(100, 100, 20), voxel_str_p=(-50.0, -50.0, -15.0),
                 voxel_pre_dim=(64,), proj_d_bins=50,
                 aug_depth=False, weights_init=False, mixed_precision=False,
                 learning_rate=1e-4, num_fake_samples=8,
                 max_depth=200.0, eval_max_depth=200) -> Config:
    cameras = list(cameras) if cameras is not None else list(DDAD_CAM_LIST)
    return Config({
        "ddp": {"ddp_enable": False, "world_size": 1, "gpus": [0]},
        "model": {
            "num_layers": 18, "weights_init": weights_init,
            "depth_model": depth_model, "pose_model": pose_model,
            "fusion_level": 2, "fusion_feat_in_dim": fusion_feat_in_dim,
            "use_skips": False,
            "voxel_unit_size": list(voxel_unit_size),
            "voxel_size": list(voxel_size),
            "voxel_str_p": list(voxel_str_p),
            "voxel_pre_dim": list(voxel_pre_dim),
            "proj_d_bins": proj_d_bins, "proj_d_str": 2, "proj_d_end": 50,
            "mode": "train",
        },
        "data": {
            "dataset": "fake", "data_path": "", "log_dir": "./results/",
            "cameras": cameras, "num_cams": len(cameras),
            "rel_cam_list": get_relcam(cameras),
            "num_fake_samples": num_fake_samples,
            "log_path": "./results/preset", "save_weights_root": "./results/preset/models",
            "load_weights_dir": "./results/preset/models/weights_0",
            "exp_name": "preset",
        },
        "training": {
            "height": height, "width": width, "scales": [0],
            "frame_ids": [0, -1, 1], "batch_size": batch_size,
            "num_workers": 0, "learning_rate": learning_rate,
            "num_epochs": 1, "scheduler_step_size": 15,
            "min_depth": 1.5, "max_depth": max_depth,
            "spatio": True, "spatio_temporal": True, "intensity_align": True,
            "focal_length_scale": 300,
            "aug_depth": aug_depth, "aug_angle": [15, 15, 40],
            "cold_start_warmup_steps": 0, "cold_start_ramp_steps": 0,
            "cold_start_pose_coeff": 1.0, "cold_start_pose_floor": 0.1,
            "cold_start_pose_ceil": 1.0, "cold_start_disp_coeff": 0.1,
        },
        "loss": {"disparity_smoothness": 0.001, "spatio_coeff": 0.03,
                 "spatio_tempo_coeff": 0.1, "pose_loss_coeff": 0.0,
                 "depth_con_coeff": 0.03, "depth_sm_coeff": 0.05},
        "eval": {"eval_batch_size": batch_size, "eval_num_workers": 0,
                 "eval_min_depth": 0, "eval_max_depth": eval_max_depth,
                 "eval_visualize": False, "syn_visualize": False, "syn_idx": 0},
        "load": {"pretrain": False, "weights": "weights_0",
                 "models_to_load": ["depth_net", "pose_net"]},
        "logging": {"early_phase": 2000, "log_frequency": 100,
                    "late_log_frequency": 1000, "save_frequency": 1},
        "tpu": {"mixed_precision": mixed_precision, "data_axis": "data",
                "prefetch_depth": 2, "use_pallas": True},
    })


def tiny_config(**over) -> Config:
    """6-cam complete fusion model at 64x96 (CPU smoke tests)."""
    defaults = dict(height=64, width=96, batch_size=1,
                    fusion_feat_in_dim=32,
                    voxel_unit_size=(4.0, 4.0, 3.0), voxel_size=(24, 24, 8),
                    voxel_str_p=(-46.0, -46.0, -10.5), voxel_pre_dim=(16,),
                    proj_d_bins=12)
    defaults.update(over)
    return build_config(**defaults)


def micro_config(**over) -> Config:
    """3-cam minimal fusion model at 32x64 (multi-device dry runs)."""
    defaults = dict(cameras=DDAD_CAM_LIST[:3], height=32, width=64,
                    batch_size=1, fusion_feat_in_dim=16,
                    voxel_unit_size=(8.0, 8.0, 6.0), voxel_size=(12, 12, 4),
                    voxel_str_p=(-44.0, -44.0, -9.0), voxel_pre_dim=(8,),
                    proj_d_bins=6, learning_rate=1e-3)
    defaults.update(over)
    return build_config(**defaults)


def ddad_bench_config(batch_size=1, mixed_precision=False) -> Config:
    """Full DDAD-shaped fusion model (384x640, 6 cams) for benchmarking."""
    return build_config(batch_size=batch_size, mixed_precision=mixed_precision)
