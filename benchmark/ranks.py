"""A training cell on several cards: one process a card, as the published
data-parallel job runs (``ddad_surround_fusion_ddp.yaml``: 4 GPUs, batch 2
each).

``launch`` starts ``world`` processes (spawned; this process touches no
card) with the launcher's environment the program reads (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and a free ``MASTER_PORT``
on this host), and each joins the program's process group through the
program's own ``maybe_initialize_distributed`` (NCCL on its card). Every
rank runs the cell on its shard of the pool; the window's number of steps
is rank 0's measured step time turned into ``--seconds``, broadcast once,
so every rank takes the same steps. Rank 0 then checks the first steps
against the plain reference at the global batch, on its card, once the
other ranks have left. The ranks' records come back through a queue,
drained before the processes are joined.
"""
from __future__ import annotations

import math
import multiprocessing as mp
import os
import queue as queue_mod
from typing import Callable, Dict, List, Mapping, Tuple

import torch

JOIN_S = 120.0


def _device(rank: int, use_cpu: bool) -> torch.device:
    return torch.device("cpu") if use_cpu else torch.device("cuda", rank)


def rank_main(rank: int, world: int, port: int, cfg: Mapping,
              traffic: Mapping, seed: int, seconds: float, trace: bool,
              t_start: float, out, use_cpu: bool = False) -> None:
    """One rank: the cell, the global losses, and on rank 0 the check."""
    import torch.distributed as dist
    from vfdepth_tpu_torch.parallel import maybe_initialize_distributed
    from . import cells

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    device = _device(rank, use_cpu)
    maybe_initialize_distributed(device=device.type)
    try:
        def fixed(step_s: float) -> int:
            n = torch.tensor([seconds / max(step_s, 1e-9)], device=device)
            dist.broadcast(n, 0)
            return max(1, math.ceil(float(n)))

        run = cells.train(cfg, traffic, seed, seconds, trace, device, t_start,
                          rank, world, fixed)
        # the global batch's loss is the mean of the ranks' losses
        losses = torch.tensor(run["losses"], device=device,
                              dtype=torch.float64)
        dist.all_reduce(losses)
        run["losses"] = (losses / world).tolist()
        # and its depth statistics: the mean of the ranks' means (equal
        # shards), the largest maximum, the smallest minimum
        for stats in run["depth"]:
            for key, op in (("mean", dist.ReduceOp.SUM),
                            ("max", dist.ReduceOp.MAX),
                            ("min", dist.ReduceOp.MIN)):
                v = torch.tensor([stats[key]], device=device,
                                 dtype=torch.float64)
                dist.all_reduce(v, op=op)
                stats[key] = float(v) / (world if key == "mean" else 1)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    numbers = None
    if rank == 0:
        run["check_batches"] = cells.global_batches(cfg, traffic, seed,
                                                    device, world)
        numbers = cells.check_train(cfg, seed, run, device)
    run.pop("check_batches", None)
    if rank != 0:
        run.pop("trace", None)
        run.pop("host_trace", None)
    out.put((rank, run, numbers))


def launch(cfg: Mapping, traffic: Mapping, seed: int, seconds: float,
           trace: bool, world: int, port: int, t_start: float,
           target: Callable = rank_main, use_cpu: bool = False
           ) -> Tuple[List[Dict], Dict[str, float]]:
    """(the ranks' records, rank 0 first; the numbers compared)."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=target,
                         args=(r, world, port, cfg, traffic, seed, seconds,
                               trace, t_start, out, use_cpu))
             for r in range(world)]
    for p in procs:
        p.start()
    got: Dict[int, Tuple] = {}
    try:
        while len(got) < world:
            try:
                rank, run, numbers = out.get(timeout=5.0)
                got[rank] = (run, numbers)
            except queue_mod.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank process(es) failed: exit codes "
                        f"{[p.exitcode for p in procs]}")
    finally:
        for p in procs:
            p.join(JOIN_S)
            if p.is_alive():
                p.kill()
                p.join()
    runs = [got[r][0] for r in range(world)]
    return runs, got[0][1]
