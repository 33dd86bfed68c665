"""The rank side of the camera-axis option tests
(``tests/test_torch_cam_parallel_options.py``, ``tests/
test_torch_cam_parallel_fsm_aug.py``): what each gloo rank of a grid runs
on the CPU for every training option of that grid (torch, numpy and the
port only; the JAX side stays in the test modules' own process).

``run_rank`` joins a world of ``data * cam`` ranks through a ``FileStore``
under the test's ``tmp_path``, builds the grid by JAX's rule
(``parallel.cam_grid_for``, ``tpu.cam_parallel_size`` set) and, for each
option of the grid in turn, takes one ``train_step`` from the parent's
weights (ranks other than 0 start from other weights, so the set-up
broadcast must replace them), the parent's global batch (its data shard's
rows), global tie-break noise and, under ``aug_depth``, global rotated-view
draw, with a carried Adam state. It saves, per option, the reduced logs,
the collectives by site, the digests of the gradients and the state after
Adam, and on rank 0 the gradients and the state themselves.

The options (``OPTIONS``: option -> (grid, config overrides)):

* on the 3-camera micro rig, (data 1, cam 3): ``merge_backprojection:
  false``, ``batch_pose_frames: false`` (frames 0, -1, 1) and
  ``merge_backprojection: false`` under ``remat: true``;
* on the 6-camera rig at micro widths, (data 2, cam 2): the fsm nets and
  ``aug_depth``; in a second spawn of the same grid, both mixed pairs.
"""
import os
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

import helpers_torch_parallel as P
from vfdepth_tpu_torch import presets
from vfdepth_tpu_torch.config import DDAD_CAM_LIST
from vfdepth_tpu_torch.data import FakeDataset
from vfdepth_tpu_torch.geometry import vec_to_matrix
from vfdepth_tpu_torch.losses import composite
from vfdepth_tpu_torch.parallel import (COUNTS, cam_grid_for,
                                        maybe_initialize_distributed,
                                        reduce_logs)
from vfdepth_tpu_torch.training import (VFDepthModel, create_train_state,
                                        train_step)

STEP = P.STEP
COLLECTIVE_TIMEOUT_S = 240
# name -> (data, cam, cameras, FakeDataset rig); the two (2, 2) grids are
# one layout, spawned apart so their test files run side by side
GRIDS = {"1x3": (1, 3, DDAD_CAM_LIST[:3], "nuscenes"),
         "2x2": (2, 2, DDAD_CAM_LIST, "nuscenes"),
         "2x2_mixed": (2, 2, DDAD_CAM_LIST, "nuscenes")}
FSM = dict(pose_loss_coeff=0.1)
OPTIONS = {
    "unmerged": ("1x3", dict(merge_backprojection=False)),
    "unbatched": ("1x3", dict(batch_pose_frames=False)),
    "unmerged_remat": ("1x3", dict(merge_backprojection=False, remat=True)),
    "fsm": ("2x2", dict(depth_model="fsm", pose_model="fsm", **FSM)),
    "fusion_depth_fsm_pose": ("2x2_mixed", dict(pose_model="fsm", **FSM)),
    "fsm_depth_fusion_pose": ("2x2_mixed", dict(depth_model="fsm")),
    "aug": ("2x2", dict(aug_depth=True)),
}
# the options with the fsm depth net run at 64x96, the others at the micro
# 32x64: its decoder pads the encoder's 1/32 map by reflection, which
# needs 2 rows
FSM_HW = (64, 96)
# the pose head's ego-motion bias of each grid (helpers_torch_step.
# with_motion, 0.01 m a unit): test_torch_cam_parallel.py's
MOTIONS = {"1x3": (40.0, 20.0, 60.0), "2x2": (100.0, 50.0, 150.0),
           "2x2_mixed": (100.0, 50.0, 150.0)}
# samples a data shard where not one: each unbatched pose pass normalises
# the pose encoder's layers 3 and 4 over 8 and 2 values a camera and
# sample at 32x64, and at one sample a ReLU input within 1e-7 of 0 there
# (its derivative picked by rounding) moved a gradient by 0.5-2% between
# the grid and one process, with the ranks' thread count
PER_SHARD = {"unbatched": 2}


def motion(option):
    return MOTIONS[OPTIONS[option][0]]


# each option's collectives of one step by site on every rank: the
# cam-group sums of each back-projection (2 a back-projection: the merged
# one, or each net's and each pose pass's), the gather of an fsm pose net's
# poses, each scale's depth gathered under aug_depth; the loss's world sums
# (7 a scale, 3 more under aug_depth: the synthesis's num, den and
# smoothness)
SITES = {
    "unmerged": dict(cam_fusion=4, loss=7),
    "unbatched": dict(cam_fusion=6, loss=7),
    "unmerged_remat": dict(cam_fusion=4, loss=7),
    "fsm": dict(cam_poses=1, loss=7),
    "fusion_depth_fsm_pose": dict(cam_fusion=2, cam_poses=1, loss=7),
    "fsm_depth_fusion_pose": dict(cam_fusion=2, loss=7),
    "aug": dict(cam_fusion=2, cam_depths=1, loss=10),
}
# the rig yawed by 0.1 rad: on FakeDataset's rig JAX's pose-consistency
# gradient is nan (camera 0 aligned into its own frame exactly;
# tests/test_torch_fsm_model.py)
YAW = 0.1


def grid_options(name):
    return [o for o, (g, _) in OPTIONS.items() if g == name]


def world(name) -> int:
    data, cam = GRIDS[name][:2]
    return data * cam


def option_config(option, cam_parallel: bool = True, make=None):
    """The micro model (micro widths and voxels, the grid's image size) on
    the option's grid's rig at the focal-length scale 15 (overlap losses
    live), the option's keys, ``cam_parallel_size`` the grid's. ``make``
    builds the base config (the port's ``presets.micro_config`` by
    default; the tests pass the JAX package's)."""
    name, over = OPTIONS[option]
    data, cam, cams, _ = GRIDS[name]
    nets = {k: over[k] for k in ("depth_model", "pose_model", "aug_depth")
            if k in over}
    if nets.get("depth_model") == "fsm":
        nets["height"], nets["width"] = FSM_HW
    cfg = (make or presets.micro_config)(cameras=list(cams), **nets)
    cfg.set("focal_length_scale", 15.0)
    for key, value in over.items():
        if key not in nets:
            cfg.set(key, value)
    if cam_parallel:
        cfg.set("cam_parallel_size", cam, section="tpu")
    return cfg


def global_batch(option):
    """The option's global batch: the first ``data * PER_SHARD`` samples
    of the grid's rig, yawed."""
    data, _, _, rig = GRIDS[OPTIONS[option][0]]
    n = data * PER_SHARD.get(option, 1)
    cfg = option_config(option, cam_parallel=False)
    batch = FakeDataset(num_samples=n, num_cams=cfg.num_cams,
                        height=cfg.height, width=cfg.width,
                        fusion_level=cfg.fusion_level,
                        rig=rig).batch(list(range(n)))
    yaw = vec_to_matrix(torch.tensor([0.0, 0.0, YAW]),
                        torch.zeros(3)).numpy()
    batch["extrinsics"] = (yaw @ batch["extrinsics"]).astype(np.float32)
    batch["extrinsics_inv"] = np.linalg.inv(batch["extrinsics"]).astype(
        np.float32)
    return batch


def _step(option, rank, grid, inputs):
    """One step of ``option`` from the parent's weights, global batch (its
    data shard's rows) and draws, with the reference's auto-masks
    imposed on the rank's rows and cameras."""
    cfg = option_config(option)
    d = grid.d
    loc = grid.local_cams(cfg.num_cams)
    per = PER_SHARD.get(option, 1)
    rows = slice(d * per, (d + 1) * per)
    batch = {k: v[rows] for k, v in inputs[option]["batch"].items()}
    model = VFDepthModel(cfg, device="cpu", seed=rank)
    if rank == 0:
        model.load_state_dict(inputs[option]["state"])
    model.shard_cameras(grid)
    before = dict(COUNTS)
    opt = create_train_state(model)
    P.carry_adam_state(opt, model)
    masks = P.impose_auto_masks(inputs[option]["amask"], rows,
                                slice(loc.start, loc.stop))
    with mock.patch.object(composite, "auto_mask", masks):
        logs = train_step(model, opt, batch, STEP, torch.Generator(),
                          noise=inputs[option]["noise"],
                          aug_u=inputs[option].get("aug_u"))
    counts = {k: v - before.get(k, 0) for k, v in COUNTS.items()
              if v != before.get(k, 0)}
    grads = {n: p.grad for n, p in model.named_parameters()}
    state = model.state_dict()
    out = dict(logs=reduce_logs(logs), counts=counts,
               digests=(P.digest(grads), P.digest(state)),
               own_masks=torch.stack(masks.own), place=(rows.start, loc.start))
    if rank == 0:       # the others are held to rank 0's by their digests
        out.update(grads={n: g.clone() for n, g in grads.items()},
                   state={k: v.clone() for k, v in state.items()})
    return out


def run_rank(rank: int, name: str, work: str) -> None:
    """One rank of grid ``name``: join the group, run every option's step,
    save the results to ``<work>/rank<rank>.pt``."""
    torch.set_num_threads(P.THREADS)
    work = Path(work)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world(name)))
    maybe_initialize_distributed(
        "cpu", init_method=f"file://{work / 'store'}",
        timeout_s=COLLECTIVE_TIMEOUT_S)
    inputs = torch.load(work / "inputs.pt", weights_only=False)
    grid = cam_grid_for(option_config(grid_options(name)[0]))
    out = {option: _step(option, rank, grid, inputs)
           for option in grid_options(name)}
    dist.barrier()
    dist.destroy_process_group()
    torch.save(out, work / f"rank{rank}.pt")
