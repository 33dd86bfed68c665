"""Benchmark: 6-camera training framesets/s on one NVIDIA H100 (the port's
counterpart of the root ``bench.py``, which times the JAX package).

    python -m vfdepth_tpu_torch.bench [--cpu]

The cell is the root bench's: the whole training step (fusion depth and
pose nets, voxel fusion, view rendering, losses, backward, Adam) on the
6-camera rig at 384x640 (``configs/ddad/ddad_surround_fusion.yaml``'s
model), ``FakeDataset``'s "nuscenes" rig (its thin cross-camera overlap
strips make the warp windows engage), bf16, batch 1, ``sampler_3d:
packed``, warp windows on and sized through ``create_train_state`` from the
batch. The same ``BENCH_*`` variables pick the same variants:
``BENCH_BATCH`` (1), ``BENCH_HEIGHT`` (384), ``BENCH_WIDTH`` (640),
``BENCH_STEPS`` (10), ``BENCH_BF16`` (1), ``BENCH_RIG`` ("nuscenes";
"even" is the stress rig whose full-image overlaps turn the windows off),
``BENCH_REMAT`` ("0", "1", "all", "depth_net", "pose_net"), ``BENCH_WARP_OP``
("auto"; every value is K5, the port's one warp), ``BENCH_WARP_WINDOW``
(1), ``BENCH_ST_WINDOW`` ("actual", "interval", "dense"),
``BENCH_SAMPLER_3D`` ("packed"), ``BENCH_POSE_BATCH`` (1),
``BENCH_MERGE_BACKPROJ`` (1) and ``BENCH_EXTRAS`` (1).

Timing: ``WARMUP_STEPS`` steps first (the kernels' build, cuDNN's
autotuning), then ``BENCH_STEPS`` steps ``REPEATS`` times, each step's
loss read one step late (the read waits for that step; the lag lets the
host queue the next one); each window's ms a step goes to stderr, the JSON
line on stdout carries their median. Without ``--cpu`` the step runs on the
card and there is no fallback to the CPU; ``--cpu`` runs the kernels'
plain versions (a rehearsal: its numbers are not a device's).

``vs_baseline`` divides by 2.0 framesets/s, the root bench's estimate of
the reference on one A100 (BASELINE.md, "Throughput denominator").
``mfu_pct_bf16_peak`` counts BASELINE.md's analytic 2.1 TFLOP a frameset
over ``PEAK_BF16_FLOPS``. The extras are the root bench's: the "even" rig
and batch 2. Only ``torch.cuda.OutOfMemoryError`` moves a batch down to 1
(or drops an extra); any other error raises.

To see where a step's time goes, trace it: wrap steps in
``torch.profiler.profile(activities=[CPU, CUDA])`` and read the program's
``vf.*`` spans (``utils/tracing.py``), or run the repository's benchmark
with ``--trace 1``.
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import time
from typing import Optional

import torch

from .config import DDAD_CAM_LIST, Config, get_relcam

# the root bench's estimate of the reference: 2.0 6-camera framesets/s per
# A100 at f32 (BASELINE.md, "Throughput denominator: derivation")
BASELINE_SAMPLES_PER_SEC = 2.0
# BASELINE.md's FLOP count of one training step of one frameset (~0.7
# TFLOP forward, x3)
FLOPS_PER_FRAMESET = 2.1e12
# NVIDIA H100 SXM, dense bf16 tensor-core peak (NVIDIA's data sheet, at the
# full 700 W power limit)
PEAK_BF16_FLOPS = 989e12
WARMUP_STEPS = 2
REPEATS = 3


def _env_flag(name: str, default: str = "1") -> bool:
    return os.environ.get(name, default) == "1"


def bench_config(batch_size: int, height: int, width: int,
                 use_bf16: bool) -> Config:
    """The root bench's configuration, with its ``BENCH_*`` knobs."""
    cameras = DDAD_CAM_LIST
    remat = os.environ.get("BENCH_REMAT", "0")
    return Config({
        "model": {
            "num_layers": 18, "weights_init": False,
            "depth_model": "fusion", "pose_model": "fusion",
            "fusion_level": 2, "fusion_feat_in_dim": 256, "use_skips": False,
            "voxel_unit_size": [1.0, 1.0, 1.5], "voxel_size": [100, 100, 20],
            "voxel_str_p": [-50.0, -50.0, -15.0], "voxel_pre_dim": [64],
            "proj_d_bins": 50, "proj_d_str": 2, "proj_d_end": 50,
            "mode": "train",
        },
        "data": {"cameras": cameras, "num_cams": 6,
                 "rel_cam_list": get_relcam(cameras)},
        "training": {
            "height": height, "width": width, "scales": [0],
            "frame_ids": [0, -1, 1], "batch_size": batch_size,
            "min_depth": 1.5, "max_depth": 200.0,
            "spatio": True, "spatio_temporal": True, "intensity_align": True,
            "focal_length_scale": 300, "aug_depth": False,
            "aug_angle": [15, 15, 40], "learning_rate": 1e-4,
            "num_epochs": 20, "scheduler_step_size": 15,
        },
        "loss": {"disparity_smoothness": 0.001, "spatio_coeff": 0.03,
                 "spatio_tempo_coeff": 0.1, "pose_loss_coeff": 0.0},
        "eval": {"eval_batch_size": 1, "eval_min_depth": 0,
                 "eval_max_depth": 200, "eval_visualize": False,
                 "syn_visualize": False, "syn_idx": 0},
        "tpu": {"mixed_precision": use_bf16,
                "remat": {"0": False, "1": True}.get(remat, remat),
                "warp_op": os.environ.get("BENCH_WARP_OP", "auto"),
                "warp_window": _env_flag("BENCH_WARP_WINDOW"),
                "st_window_mode": os.environ.get("BENCH_ST_WINDOW", "actual"),
                "sampler_3d": os.environ.get("BENCH_SAMPLER_3D", "packed"),
                "batch_pose_frames": _env_flag("BENCH_POSE_BATCH"),
                "merge_backprojection": _env_flag("BENCH_MERGE_BACKPROJ")},
    })


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_bench(batch_size: int, height: int, width: int, n_steps: int,
              use_bf16: bool, rig: Optional[str] = None, device=None
              ) -> float:
    """Seconds a training step: the median of ``REPEATS`` windows of
    ``n_steps`` steps after ``WARMUP_STEPS`` warm-up steps."""
    from .data import FakeDataset
    from .device import resolve_device
    from .training import VFDepthModel, create_train_state, train_step

    device = resolve_device(device)
    cfg = bench_config(batch_size, height, width, use_bf16)
    model = VFDepthModel(cfg, device=device, seed=0)
    rig = rig or os.environ.get("BENCH_RIG", "nuscenes")
    ds = FakeDataset(num_samples=batch_size, num_cams=6, height=height,
                     width=width, fusion_level=2, rig=rig)
    host = ds.batch(list(range(batch_size)))
    # the windows are sized on the host from the batch's rig, then the
    # batch is uploaded once and every step reuses it
    opt = create_train_state(model, steps_per_epoch=1000, batch=host)
    batch = {k: torch.as_tensor(v).to(device, torch.float32)
             for k, v in host.items()}
    windows = model.warp_window_hw if model.warp_window else None
    gen = torch.Generator(device).manual_seed(0)
    step = 0

    def one():
        nonlocal step
        logs = train_step(model, opt, batch, step, gen)
        step += 1
        return logs

    for _ in range(WARMUP_STEPS):
        logs = one()
    float(logs["total_loss"])
    _sync(device)
    times = []
    for r in range(REPEATS):
        prev = None
        t0 = time.perf_counter()
        for _ in range(n_steps):
            logs = one()
            if prev is not None:
                float(prev)
            prev = logs["total_loss"]
        float(prev)
        times.append((time.perf_counter() - t0) / n_steps)
        over = logs.get("warp_window_overflow")
        sys.stderr.write(
            f"bench {rig} batch {batch_size}: window {r}: "
            f"{times[-1] * 1e3:.3f} ms a step over {n_steps} steps; loss "
            f"{float(prev):.6f}; windows {windows}; overflow "
            f"{'-' if over is None else float(over)}\n")
    return statistics.median(times)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else None
    batch_size = int(os.environ.get("BENCH_BATCH", "1"))
    height = int(os.environ.get("BENCH_HEIGHT", "384"))
    width = int(os.environ.get("BENCH_WIDTH", "640"))
    n_steps = int(os.environ.get("BENCH_STEPS", "10"))
    use_bf16 = _env_flag("BENCH_BF16")

    dt = None
    for bs in dict.fromkeys((batch_size, 1)):
        try:
            dt = run_bench(bs, height, width, n_steps, use_bf16,
                           device=device)
            batch_size = bs
            break
        except torch.cuda.OutOfMemoryError as e:
            sys.stderr.write(f"bench at batch {bs} ran out of device "
                             f"memory: {str(e)[:200]}\n")
            torch.cuda.empty_cache()
            if bs == 1:
                raise

    samples_per_sec = batch_size / dt
    result = {
        "metric": "6cam_samples_per_sec_per_chip",
        "value": round(samples_per_sec, 4),
        "unit": f"6-camera framesets/s (batch {batch_size}, {height}x{width}, "
                f"{'bf16' if use_bf16 else 'f32'} train step)",
        "vs_baseline": round(samples_per_sec / BASELINE_SAMPLES_PER_SEC, 3),
    }
    extras = {"step_ms": round(dt * 1e3, 1),
              "mfu_pct_bf16_peak": round(
                  100.0 * FLOPS_PER_FRAMESET * batch_size / dt
                  / PEAK_BF16_FLOPS, 2)}
    if ("BENCH_RIG" not in os.environ and batch_size == 1
            and _env_flag("BENCH_EXTRAS")):
        for key, kwargs in (("even_rig", dict(batch_size=1, rig="even")),
                            ("batch2", dict(batch_size=2, rig="nuscenes"))):
            try:
                dt_x = run_bench(n_steps=n_steps, height=height, width=width,
                                 use_bf16=use_bf16, device=device, **kwargs)
            except torch.cuda.OutOfMemoryError as e:
                sys.stderr.write(f"bench extra {key} ran out of device "
                                 f"memory: {str(e)[:200]}\n")
                torch.cuda.empty_cache()
                continue
            extras[f"{key}_samples_per_sec"] = round(
                kwargs["batch_size"] / dt_x, 4)
    result["extra"] = extras
    result["device"] = (torch.cuda.get_device_name(0) if device is None
                        else "cpu (plain versions; not a device time)")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
