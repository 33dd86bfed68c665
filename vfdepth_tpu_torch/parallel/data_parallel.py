"""Data-parallel training over a process group (the port's counterpart of
``vfdepth_tpu/parallel/mesh.py`` and ``training/step.py
shard_train_step``: JAX's 1-D ``data`` mesh, batch sharded, parameters
replicated).

JAX runs one program over the global batch: its gradient is the global
loss's, its BatchNorm normalises with the global batch's statistics and
every reduction over the batch in the loss is global. Here each rank runs
the step on its own slice of that batch, and the places where the step
reduces over the batch take a collective instead:

* the set-up broadcasts rank 0's parameters and BatchNorm statistics
  (``broadcast_model``), so every rank starts from the same state;
* BatchNorm in train mode sums its per-channel statistics over the ranks
  (``models/blocks.py``);
* the loss's masked means sum their numerator and denominator over the
  ranks, and the cold-start priors average their batch means
  (``batch_sum`` / ``batch_mean`` inside ``global_batch()``,
  ``losses/composite.py``);
* the tie-break draws are the global batch's, each rank taking its slice
  (``local_slice``, ``training/step.py``);
* after the backward pass every gradient is averaged over the ranks
  (``average_gradients``).

Those sums are differentiable (``distributed.all_reduce_sum``: a sum in
the forward pass, a sum of the cotangents in the backward), so each rank's
loss is the global one evaluated with the global sums plus its own batch
means, the mean of the ranks' losses is the global loss, and the mean of
their gradients is its gradient. The ranks then hold identical gradients,
take identical Adam updates and stay bit-identical.

The gradients are averaged in one flat bucket per dtype after
``loss.backward()``, not by ``DistributedDataParallel``: DDP's bucketed
all-reduces run during the backward pass, beside the backward sums of
BatchNorm and of the loss, and under ``tpu.remat`` beside the
recomputed BatchNorm's, with no order between them that every rank must
keep. After the backward pass nothing else is in flight.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterable, Mapping

import torch
import torch.distributed as dist
from torch import nn

from .distributed import (COUNTS, all_reduce_max, all_reduce_sum,
                          broadcast_, is_active, loader_shard, rank_world)

# the scalar logs reduced by a maximum and a minimum over the ranks; the
# others are means over the batch, or equal on every rank, and average
MAX_LOGS = ("depth/max", "warp_window_overflow")
MIN_LOGS = ("depth/min",)

_GLOBAL_BATCH = contextvars.ContextVar("global_batch", default=False)


@contextlib.contextmanager
def global_batch(on: bool = True):
    """Within the block, ``batch_sum`` / ``batch_mean`` reduce over the
    ranks (where a process group is active). The training forward runs its
    loss so; the evaluation forward does not, so it holds no collective
    and one rank may run it alone."""
    token = _GLOBAL_BATCH.set(on)
    try:
        yield
    finally:
        _GLOBAL_BATCH.reset(token)


def _global() -> bool:
    return _GLOBAL_BATCH.get() and is_active()


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x``, a sum over this rank's batch, summed over the ranks inside
    ``global_batch()``; ``x`` itself outside it."""
    return all_reduce_sum(x, "loss") if _global() else x


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """``x``, a mean over this rank's batch, as the global batch's mean
    inside ``global_batch()`` (every rank holds the same batch size);
    ``x`` itself outside it."""
    if not _global():
        return x
    return all_reduce_sum(x, "loss") / rank_world()[1]


def local_slice(x: torch.Tensor, axis: int, grid=None) -> torch.Tensor:
    """This rank's slice of a global-batch tensor along ``axis`` (batch
    shard r takes the r-th of the equal parts; under a ``grid`` r is the
    data index); ``x`` itself in one process."""
    shard, shards = loader_shard(grid)
    if shards == 1:
        return x
    n = x.shape[axis] // shards
    return x.narrow(axis, shard * n, n)


def global_shape(shape: Iterable[int], axis: int, grid=None) -> tuple:
    """A rank's draw shape with its batch ``axis`` over the global batch."""
    shape = list(shape)
    shape[axis] *= loader_shard(grid)[1]
    return tuple(shape)


def gather_batch(x: torch.Tensor, grid=None) -> torch.Tensor:
    """The global batch of a per-rank batch tensor [b, ...]: the batch
    shards in order, [shards * b, ...], on every rank (an all-gather by
    one sum of zero-padded slots, exact; under a ``grid`` over its data
    group, one rank a shard)."""
    if not is_active():
        return x
    shard, shards = loader_shard(grid)
    slots = x.new_zeros((shards,) + tuple(x.shape))
    slots[shard] = x
    group = None if grid is None else grid.data_group
    return all_reduce_sum(slots, "windows", group).reshape(
        (shards * x.shape[0],) + tuple(x.shape[1:]))


def broadcast_model(model: nn.Module) -> None:
    """Every rank takes rank 0's parameters and buffers (BatchNorm
    statistics)."""
    if is_active():
        broadcast_(list(model.parameters()) + list(model.buffers()),
                   "broadcast")


def average_gradients(params: Iterable[nn.Parameter]) -> None:
    """Average ``.grad`` over the ranks in one flat all-reduce per dtype,
    with no host sync. Every parameter that requires a gradient gets the
    average, zeros where no rank produced one (the gradient JAX gives an
    unused parameter), so that every rank updates the same parameters."""
    if not is_active():
        return
    world = rank_world()[1]
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        if p.requires_grad:
            by_dtype.setdefault(p.dtype, []).append(p)
    for group in by_dtype.values():
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in group])
        COUNTS["gradients"] += 1
        dist.all_reduce(flat)
        flat.div_(world)
        offset = 0
        for p in group:
            n = p.numel()
            p.grad = flat[offset:offset + n].view_as(p)
            offset += n


def reduce_logs(logs: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """Scalar logs of this rank's step as the global batch's, as floats:
    the ``MAX_LOGS`` / ``MIN_LOGS`` by their extreme over the ranks, the
    others by their mean (one sum of the stacked logs, one maximum). In one
    process, the logs as floats."""
    if not is_active():
        return {k: float(v) for k, v in logs.items()}
    world = rank_world()[1]
    keys = sorted(logs)
    vals = torch.stack([logs[k].detach().float().reshape(()) for k in keys])
    ext_keys = [k for k in keys if k in MAX_LOGS or k in MIN_LOGS]
    out = dict(zip(keys, (all_reduce_sum(vals, "logs") / world).tolist()))
    if ext_keys:
        sign = torch.tensor([-1.0 if k in MIN_LOGS else 1.0
                             for k in ext_keys], device=vals.device)
        ext = all_reduce_max(
            sign * torch.stack([vals[keys.index(k)] for k in ext_keys]),
            "logs") * sign
        out.update(zip(ext_keys, ext.tolist()))
    return out
