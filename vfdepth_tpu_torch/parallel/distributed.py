"""Process-group wiring of the port's data parallelism (counterpart of
``vfdepth_tpu/parallel/distributed.py``, the reference's ``utils/ddp.py``
rendezvous).

One process per card, each holding the whole model. A launcher names the
group through the environment:

  torchrun         RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT
  the JAX package  VFDEPTH_COORDINATOR (host:port of process 0),
                   VFDEPTH_NUM_PROCESSES, VFDEPTH_PROCESS_ID

``maybe_initialize_distributed`` joins that group (NCCL for a CUDA device,
gloo for the CPU) or, with no launcher, initialises nothing: a lone
process runs with no group and no collective. The JAX package's process
index and count are the rank and world size here.

The port's collectives are ``all_reduce``, ``broadcast`` and ``barrier``,
which gloo also runs on CUDA tensors (through the host). Each
``all_reduce`` and ``broadcast`` adds one to ``COUNTS[site]``, ``site``
naming the code path that called it (``"batch_norm"``, ``"loss"``,
``"gradients"``, ``"cam_fusion"``, ...), so a run can show which global
reductions it went through. Each takes the process group it reduces over
(``group``; None is the whole world): the camera-axis grid
(``parallel/mesh.py``) reduces some sums over its cam group or its data
group.
"""
from __future__ import annotations

import collections
import os
from datetime import timedelta
from typing import Iterable, Optional, Tuple, Union

import torch
import torch.distributed as dist

COUNTS: collections.Counter = collections.Counter()


def _launch() -> Optional[Tuple[str, int, int, Optional[int]]]:
    """(init method, rank, world size, local rank or None) named by the
    environment, None without a launcher."""
    env = os.environ
    if env.get("WORLD_SIZE") and env.get("RANK") is not None:
        local = env.get("LOCAL_RANK")
        return ("env://", int(env["RANK"]), int(env["WORLD_SIZE"]),
                None if local is None else int(local))
    coord = env.get("VFDEPTH_COORDINATOR")
    nproc = env.get("VFDEPTH_NUM_PROCESSES")
    if coord and nproc:
        local = env.get("LOCAL_RANK")
        return (f"tcp://{coord}", int(env.get("VFDEPTH_PROCESS_ID") or 0),
                int(nproc), None if local is None else int(local))
    return None


def maybe_initialize_distributed(
        device: Optional[Union[str, torch.device]] = None,
        backend: Optional[str] = None, init_method: Optional[str] = None,
        timeout_s: Optional[float] = None) -> Tuple[int, int]:
    """Join the launcher's process group; returns (rank, world size).

    ``device`` is the kind of device the ranks compute on (CUDA unless
    "cpu" is given): NCCL for CUDA, gloo for the CPU, unless ``backend``
    names one (gloo on CUDA tensors lets two ranks share one card, which
    NCCL refuses). On CUDA each rank takes ``cuda:LOCAL_RANK`` (without
    LOCAL_RANK, its rank modulo the visible cards) before anything touches
    the card. ``init_method`` replaces the launcher's rendezvous (e.g.
    ``file://...``; rank and size still come from the environment).
    With no launcher nothing is initialised and (0, 1) returned; an
    initialised group is returned as it is."""
    if is_active():
        return dist.get_rank(), dist.get_world_size()
    launch = _launch()
    if launch is None:
        return 0, 1
    method, rank, world, local = launch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if local is None:
            local = rank % max(torch.cuda.device_count(), 1)
        torch.cuda.set_device(local)
    kwargs = {} if timeout_s is None else dict(
        timeout=timedelta(seconds=timeout_s))
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method or method, rank=rank, world_size=world,
        **kwargs)
    return rank, world


def is_active() -> bool:
    """Whether a process group is initialised (a world of 1 included)."""
    return dist.is_available() and dist.is_initialized()


def rank_world() -> Tuple[int, int]:
    return ((dist.get_rank(), dist.get_world_size()) if is_active()
            else (0, 1))


def is_main_process() -> bool:
    """True on the rank that logs and writes checkpoints (rank 0)."""
    return rank_world()[0] == 0


def loader_shard(grid=None) -> Tuple[int, int]:
    """(shard_index, num_shards) of this rank's data loader: its rank in
    the world, or under a camera-axis ``grid`` (``parallel/mesh.py``) its
    data index, so the ranks of one cam group read the same samples."""
    return (grid.d, grid.data) if grid is not None else rank_world()


def per_process_seed(seed: int) -> int:
    """A host-side seed distinct per rank (the reference seeds 42 + rank).
    The step's tie-break draws are not seeded so: every rank draws the
    global batch's from the same seed (``training/step.py``)."""
    return seed + rank_world()[0]


class _SumAllReduce(torch.autograd.Function):
    """Sum over the ranks of ``group``; its backward sums the cotangents
    over the same ranks, so the gradient of every rank's loss reaches the
    inputs it read."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, site: str, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (None: the world),
    differentiable (a new tensor)."""
    COUNTS[site] += 1
    return _SumAllReduce.apply(x, group)


def all_reduce_max(x: torch.Tensor, site: str, group=None) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks of ``group`` (a new
    tensor, no gradient)."""
    COUNTS[site] += 1
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def broadcast_(tensors: Iterable[torch.Tensor], site: str,
               group=None) -> None:
    """Overwrite ``tensors`` in place with rank 0's, one broadcast a
    tensor (``group`` must hold rank 0)."""
    with torch.no_grad():
        for t in tensors:
            COUNTS[site] += 1
            dist.broadcast(t, 0, group=group)
