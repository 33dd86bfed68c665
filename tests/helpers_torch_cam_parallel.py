"""The rank side of ``tests/test_torch_cam_parallel.py``: what each gloo
rank of a camera-axis grid runs on the CPU (torch, numpy and the port
only; the JAX side stays in the test module's own process).

``run_rank`` joins a world of ``data * cam`` ranks through a ``FileStore``
under the test's ``tmp_path``, builds the grid by JAX's rule
(``parallel.cam_grid_for``, ``tpu.cam_parallel_size`` set), runs every
rank-side check and saves what it saw to ``rank<r>.pt``:

* ``grid``: its (d, c), its cameras, its loader shard, the ranks of its
  two groups, and the gradient of a cam-group sum;
* ``step``: its data shard's first batch and one ``train_step`` from the
  parent's weights (ranks other than 0 start from other weights, so the
  set-up broadcast must replace them) with the parent's global noise; the
  noise its forward received, the reduced logs, gradients and state after
  Adam (ranks other than 0 only their digests), the collectives by site;
* ``windowed`` (the 6-camera grid): the same step with the warp windows
  forced to ``FORCED_HW`` (so they are on at micro size; JAX's default
  step warps in windows); and the windows ``configure_warp_window`` sizes
  at 128x256 over the data group's gathered first batch;
* ``loop`` (the 3-camera grid): ``Trainer.learn`` for 2 steps, the grid
  built by the trainer; ``cli`` (the 6-camera grid): the command line's
  ``main`` on a yaml with ``cam_parallel_size``, 1 step, last (it ends the
  process group).
"""
import os
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

import helpers_torch_parallel as P
from vfdepth_tpu_torch import presets, train as cli
from vfdepth_tpu_torch.config import DDAD_CAM_LIST
from vfdepth_tpu_torch.data import BatchLoader, FakeDataset
from vfdepth_tpu_torch.parallel import (COUNTS, cam_grid_for, loader_shard,
                                        maybe_initialize_distributed,
                                        reduce_logs)
from vfdepth_tpu_torch.parallel.distributed import all_reduce_sum
from vfdepth_tpu_torch.training import (Trainer, VFDepthModel,
                                        create_train_state, train_step)

STEP = P.STEP
NUM_SAMPLES = 8
COLLECTIVE_TIMEOUT_S = 240
FORCED_HW = [16, 32]       # the windowed step's boxes at 32x64
# name -> (data, cam, cameras, FakeDataset rig)
GRIDS = {"1x3": (1, 3, DDAD_CAM_LIST[:3], "nuscenes"),
         "2x2": (2, 2, DDAD_CAM_LIST, "nuscenes")}
# the pose head's ego-motion bias (helpers_torch_step.with_motion), per
# grid: on the 6-camera rig at 32x64 the 3-camera rig's (0.4, 0.2, 0.6) m
# leaves 4 of its 24,576 pixels within rounding of an auto-mask tie (the
# port's step against JAX's: 1.8e-3 on the masked logs); at (1.0, 0.5,
# 1.5) m one pixel, 5.9e-5
MOTION = {"1x3": (40.0, 20.0, 60.0), "2x2": (100.0, 50.0, 150.0)}


def world(name) -> int:
    data, cam = GRIDS[name][:2]
    return data * cam


def step_config(name, cam_parallel: bool = True):
    """The micro model (32x64, micro voxels) on the grid's rig at the
    focal-length scale 15 (overlap losses live), one sample a data shard,
    ``cam_parallel_size`` the grid's."""
    data, cam, cams, _ = GRIDS[name]
    cfg = presets.micro_config(cameras=list(cams))
    cfg.set("focal_length_scale", 15.0)
    if cam_parallel:
        cfg.set("cam_parallel_size", cam, section="tpu")
    return cfg


def dataset(name, cfg=None, num_samples=NUM_SAMPLES):
    cfg = cfg or step_config(name)
    return FakeDataset(num_samples=num_samples, num_cams=cfg.num_cams,
                       height=cfg.height, width=cfg.width,
                       fusion_level=cfg.fusion_level, rig=GRIDS[name][3])


def shard_loader(ds, shard, shards):
    return BatchLoader(ds, 1, shuffle=True, num_workers=0, seed=42,
                       shard_index=shard, num_shards=shards)


def global_indices(name):
    """Epoch 0's permutation and the data shards' first samples in
    order."""
    data = GRIDS[name][0]
    perm = np.random.RandomState(42).permutation(NUM_SAMPLES)
    return perm, [perm[d * NUM_SAMPLES // data] for d in range(data)]


def _grid_checks(grid, rank, num_cams):
    """The grid's layout, and a cam-group sum of (rank + 1) whose
    objective weighs it by (rank + 1): its gradient is the sum of the
    weights over the group."""
    x = torch.full((3,), float(rank + 1), requires_grad=True)
    y = all_reduce_sum(x, "cam_fusion", grid.cam_group)
    (y * float(rank + 1)).sum().backward()
    return dict(coords=(grid.d, grid.c), data_cam=(grid.data, grid.cam),
                local_cams=grid.local_cams(num_cams),
                loader=loader_shard(grid),
                cam_group=dist.get_process_group_ranks(grid.cam_group),
                data_group=dist.get_process_group_ranks(grid.data_group),
                sum_value=y.detach(), sum_grad=x.grad)


def _step(name, rank, grid, inputs, forced_hw=None):
    """One step from the parent's weights; ``forced_hw`` forces the warp
    windows."""
    cfg = step_config(name)
    if forced_hw is not None:
        cfg.set("warp_window_hw", forced_hw, section="tpu")
    loader = shard_loader(dataset(name, cfg), *loader_shard(grid))
    batch = next(iter(loader))
    model = VFDepthModel(cfg, device="cpu", seed=rank)
    if rank == 0:
        model.load_state_dict(inputs["state"])
    model.shard_cameras(grid)
    before = dict(COUNTS)
    opt = create_train_state(model)
    P.carry_adam_state(opt, model)
    seen, forward = {}, model.forward

    def recording(*args, **kwargs):
        seen["noise"] = kwargs["noise"].clone()
        return forward(*args, **kwargs)
    model.forward = recording
    logs = train_step(model, opt, batch, STEP, torch.Generator(),
                      noise=inputs["noise"])
    counts = {k: v - before.get(k, 0) for k, v in COUNTS.items()
              if v != before.get(k, 0)}
    grads = {n: p.grad for n, p in model.named_parameters()}
    state = model.state_dict()
    out = dict(epoch_indices=loader._epoch_indices(), batch=batch,
               noise=seen["noise"], logs=reduce_logs(logs), counts=counts,
               windows=(model.warp_window, model.warp_window_hw),
               digests=(P.digest(grads), P.digest(state)))
    if rank == 0:       # the others are held to rank 0's by their digests
        out.update(grads={n: g.clone() for n, g in grads.items()},
                   state={k: v.clone() for k, v in state.items()})
    return out


def window_config(name):
    data, cam, cams, _ = GRIDS[name]
    cfg = presets.micro_config(cameras=list(cams), **P.WINDOW_SIZE)
    cfg.set("focal_length_scale", 15.0)
    return cfg


# shard 1's focal length in the window check: at 0.6 the 6-camera rig's
# boxes would cover 90% of the image, so the global batch turns the
# windows off where shard 0's alone sizes them (at 0.8, as in
# tests/helpers_torch_parallel.py, both size the same boxes)
WINDOW_FX_SCALE = 0.6


def window_batch(name, d):
    """Data shard d's first batch of the window check: sample d of the
    "nuscenes" rig, shard 1's focal length shortened."""
    batch = dataset(name, window_config(name), 2).batch([d])
    if d == 1:
        batch["K/0"] = batch["K/0"].copy()
        batch["K/0"][..., :2, :2] *= WINDOW_FX_SCALE
    return batch


def _windows(name, grid):
    cfg = window_config(name)
    model = VFDepthModel(cfg, device="cpu")
    model.shard_cameras(grid)
    model.configure_warp_window(window_batch(name, grid.d),
                                rigs=dataset(name, cfg, 2).rig_calibrations())
    return (model.warp_window, model.warp_window_hw)


def _loop(name, rank, work: Path):
    cfg = step_config(name)
    root = work / "loop" / f"rank{rank}"
    for key, value in (("num_epochs", 1), ("log_frequency", 1),
                       ("early_phase", 1000), ("late_log_frequency", 1000),
                       ("log_path", str(root / "log")),
                       ("save_weights_root", str(root / "models"))):
        cfg.set(key, value)
    ds = dataset(name, cfg)
    model = VFDepthModel(cfg, device="cpu", seed=rank)
    trainer = Trainer(cfg, model, use_tb=False)
    before = COUNTS["cam_fusion"]
    trainer.learn(shard_loader(ds, *loader_shard(trainer.grid)),
                  BatchLoader(ds, 1, shuffle=False, num_workers=0),
                  max_steps=2)
    return dict(loop_grid=(trainer.grid.data, trainer.grid.cam),
                loop_cam_fusion=COUNTS["cam_fusion"] - before,
                loop_digest=P.digest(model.state_dict()))


def _cli(rank, work: Path):
    """The command line's ``main`` on tiny_fake.yaml with
    ``cam_parallel_size`` 2 and its ``log_dir`` under ``work``: one step.
    It ends the process group, so it runs last."""
    src = (Path(__file__).resolve().parent.parent / "configs"
           / "tiny_fake.yaml").read_text()
    src = src.replace("log_dir: ./results/", f"log_dir: {work}/cli/")
    src += "tpu: {cam_parallel_size: 2}\n"
    cfg_file = work / f"cli_config{rank}" / "cam_cli.yaml"
    cfg_file.parent.mkdir()
    cfg_file.write_text(src)
    before = COUNTS["cam_fusion"]
    cli.main(["--config_file", str(cfg_file), "--max_steps", "1", "--cpu"])
    return dict(cli_cam_fusion=COUNTS["cam_fusion"] - before)


def run_rank(rank: int, name: str, work: str) -> None:
    """One rank of grid ``name``: join the group, run every check's part,
    save the results to ``<work>/rank<rank>.pt``."""
    torch.set_num_threads(P.THREADS)
    work = Path(work)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world(name)))
    maybe_initialize_distributed(
        "cpu", init_method=f"file://{work / 'store'}",
        timeout_s=COLLECTIVE_TIMEOUT_S)
    cfg = step_config(name)
    grid = cam_grid_for(cfg)
    inputs = torch.load(work / "inputs.pt", weights_only=False)
    out = dict(grid=_grid_checks(grid, rank, cfg.num_cams))
    out.update(_step(name, rank, grid, inputs))
    if name == "2x2":
        w = _step(name, rank, grid, inputs, FORCED_HW)
        out["windowed"] = {k: w[k] for k in ("logs", "windows", "digests",
                                             *(("grads", "state")
                                               if rank == 0 else ()))}
        out["sized_windows"] = _windows(name, grid)
    else:
        out.update(_loop(name, rank, work))
    dist.barrier()
    if name == "2x2":
        out.update(_cli(rank, work))
    else:
        dist.destroy_process_group()
    torch.save(out, work / f"rank{rank}.pt")
