"""The camera-axis grid of ranks (the port's counterpart of
``vfdepth_tpu/parallel/mesh.py``'s 2-D mesh: ``make_mesh_2d``,
``batch_sharding_2d``, ``shard_batch_2d``; ``training/step.py
shard_train_step_2d``).

JAX lays ``data * cam`` devices out row-major as a [data, cam] array and
shards every [b, cams, ...] batch array ``P(DATA, CAM)``: device (d, c)
holds batch shard d and the cameras [c*k, (c+1)*k), k = num_cams / cam.
GSPMD partitions each per-camera stage over the cam axis and inserts the
cross-camera sums where VFNet fuses the volume. Here one process a card
plays one device: rank r sits at (d, c) = divmod(r, cam), and

* the **cam group** (the ranks with the same d) completes the
  back-projection's camera sums and count with two differentiable
  all-reduces (``distributed.all_reduce_sum``, site "cam_fusion"); the
  voxel stages after them run replicated on every rank of the group;
* the **data group** (the ranks with the same c, one per batch shard)
  gathers the global first batch that sizes the warp windows;
* the whole world sums BatchNorm's statistics (each rank holds a disjoint
  set of (sample, camera) pairs), assembles the loss's per-camera
  numerators, denominators and batch means (``percam_sum``,
  ``percam_mean``) and averages the gradients, as under data parallelism.

The loader shard is d (``distributed.loader_shard(grid)``): the ranks of
one cam group read the same samples, ``batch_size`` of them, so the
global batch is ``data * batch_size``.

The one deliberate difference from GSPMD's input sharding: each rank keeps
the WHOLE camera axis of its inputs (images, masks, intrinsics,
extrinsics), not only its cameras'. The cross-camera losses warp the
neighbours' source images, which are inputs with no gradient, with the
target camera's own depth, so no activation crosses ranks there.

Only the training forward splits the cameras; serving and the evaluation
forward run every camera on one rank, with no collective.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .data_parallel import batch_sum
from .distributed import all_reduce_sum, rank_world


@dataclass(frozen=True)
class Grid:
    """This rank's place in the (data, cam) grid and its two groups."""
    data: int
    cam: int
    d: int
    c: int
    cam_group: Any       # the ranks with this rank's d
    data_group: Any      # the ranks with this rank's c

    def local_cams(self, num_cams: int) -> slice:
        """This rank's cameras: the c-th contiguous block of num_cams /
        cam (axis 1 of ``P(DATA, CAM)``)."""
        k = num_cams // self.cam
        return slice(self.c * k, (self.c + 1) * k)


def grid_coords(rank: int, cam: int) -> Tuple[int, int]:
    """(d, c) of ``rank`` in a grid of ``cam`` columns, row-major as
    ``make_mesh_2d`` lays its devices out."""
    return divmod(rank, cam)


def make_grid_2d(data: int, cam: int) -> Grid:
    """The (data, cam) grid over the world of ``data * cam`` ranks. A
    collective: every rank calls it, and builds every group in the same
    order (``new_group``'s rule)."""
    rank, world = rank_world()
    if world != data * cam:
        raise ValueError(f"a ({data}, {cam}) grid needs {data * cam} ranks, "
                         f"not {world}")
    d, c = grid_coords(rank, cam)
    cam_group = data_group = None
    for i in range(data):
        g = dist.new_group([i * cam + j for j in range(cam)])
        if i == d:
            cam_group = g
    for j in range(cam):
        g = dist.new_group([i * cam + j for i in range(data)])
        if j == c:
            data_group = g
    return Grid(data, cam, d, c, cam_group, data_group)


def cam_grid_for(cfg, num_cams: Optional[int] = None) -> Optional[Grid]:
    """JAX's rule (``vfdepth_tpu/training/trainer.py:221-235``): with
    ``tpu.cam_parallel_size`` > 1 and a process group of more than one
    rank, the (world / cam, cam) grid (built here: every rank calls it);
    None otherwise (one process, or ``cam_parallel_size`` 1). The global
    batch must divide over the data shards and ``num_cams`` over the
    camera shards, else ValueError with JAX's message. A world that is
    not a multiple of ``cam_parallel_size`` raises too: JAX leaves the
    leftover devices out of its mesh (or, with fewer devices than
    ``cam``, drops the camera axis), the port does neither."""
    cam = int(cfg.get("cam_parallel_size", 1) or 1)
    world = rank_world()[1]
    if cam <= 1 or world == 1:
        return None
    if world % cam:
        raise ValueError(
            f"cam_parallel_size={cam}: a world of {world} ranks is not a "
            f"multiple of it; JAX would leave ranks out of its mesh, the "
            f"port runs every rank (ROADMAP A3b)")
    data = world // cam
    num_cams = int(num_cams if num_cams is not None else cfg.num_cams)
    batch = data * int(cfg.batch_size)
    # JAX's message; its batch half always holds, as batch_size is one
    # data shard's batch here
    if num_cams % cam:
        raise ValueError(
            f"cam_parallel_size={cam}: batch {batch} must divide over "
            f"{data} data shards and num_cams {num_cams} over {cam} camera "
            f"shards")
    return make_grid_2d(data, cam)


def local_cameras(x: torch.Tensor, grid: Optional[Grid], num_cams: int,
                  axis: int = 1) -> torch.Tensor:
    """This rank's cameras of ``x`` along its camera ``axis`` (``x`` itself
    without a grid)."""
    if grid is None:
        return x
    loc = grid.local_cams(num_cams)
    return x.narrow(axis, loc.start, loc.stop - loc.start)


# ------------------------------------------------- the loss's camera axis

_CAMERAS = contextvars.ContextVar("camera_shard", default=None)


@contextlib.contextmanager
def camera_shard(grid: Optional[Grid], num_cams: int):
    """Within the block the loss's per-camera vectors hold this rank's
    cameras of ``grid`` (nothing changes without one): ``percam_sum`` and
    ``percam_mean`` assemble them over every rank into the rig's
    ``num_cams``."""
    token = _CAMERAS.set(None if grid is None else (grid, num_cams))
    try:
        yield
    finally:
        _CAMERAS.reset(token)


def _placed(x: torch.Tensor, grid: Grid, num_cams: int) -> torch.Tensor:
    """x [..., k] of this rank's cameras at their place in zeros [...,
    num_cams] (differentiable)."""
    loc = grid.local_cams(num_cams)
    return F.pad(x, (loc.start, num_cams - loc.stop))


def percam_sum(x: torch.Tensor) -> torch.Tensor:
    """Per-camera sums over this rank's batch, [..., cams] -> the global
    batch's over every rank. Inside ``camera_shard`` x holds this rank's
    cameras and the result the rig's: one world all-reduce of x at its
    cameras' places (the other ranks fill the rest). Otherwise
    ``data_parallel.batch_sum``."""
    shard = _CAMERAS.get()
    if shard is None:
        return batch_sum(x)
    return all_reduce_sum(_placed(x, *shard), "loss")


def percam_mean(x: torch.Tensor) -> torch.Tensor:
    """Per-camera means over this rank's batch, [..., cams]. Inside
    ``camera_shard`` the global batch's means of the rig's cameras (the
    world sum of x at its cameras' places over the data count: every batch
    shard is the same size); otherwise x itself (data parallelism leaves
    them per rank, and the ranks' mean of the logs is the global one)."""
    shard = _CAMERAS.get()
    if shard is None:
        return x
    return all_reduce_sum(_placed(x, *shard), "loss") / shard[0].data
