"""Training entry point of the port (the counterpart of the root
``train.py``):

    python -m vfdepth_tpu_torch.train --config_file <yaml> [--max_steps N]

Runs ``Trainer.learn`` on the CUDA card (on the CPU with ``--cpu``), with a
shuffled ``BatchLoader`` over the config's training set and, where the
config has one, an unshuffled one over its validation set; checkpoints go
to ``<log_dir>/<config name>/models/weights_<epoch>``.

Data-parallel, one process per card:

    python -m torch.distributed.run --nproc_per_node N \
        -m vfdepth_tpu_torch.train --config_file <yaml>

Each rank joins the launcher's process group (NCCL on the cards, gloo with
``--cpu``; ``parallel.maybe_initialize_distributed``), computes on
``cuda:LOCAL_RANK`` and reads its shard of every epoch's host-invariant
permutation (seed 42), ``batch_size`` samples a step: the global batch is N
times the config's ``batch_size``, as in the JAX package's multi-process
run and the reference's DDP. Rank 0 prints, logs and writes the
checkpoints. Without a launcher the run is one process with no group.

Camera-axis model parallelism: set ``tpu.cam_parallel_size`` (a divisor of
the rig's cameras) in the yaml and launch N ranks, a multiple of it. The
ranks form JAX's (N / cam, cam) grid (``parallel/mesh.py``): each cam group
of ``cam`` ranks splits one batch shard's cameras, so the global batch is
N / cam times ``batch_size``.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from .models.torchvision_init import find_resnet_weights


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="vfdepth_tpu_torch training")
    parser.add_argument("--config_file", default="./configs/ddad/ddad_surround_fusion.yaml",
                        type=str, help="config yaml file path")
    parser.add_argument("--max_steps", default=None, type=int,
                        help="optional early stop (debug)")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions)")
    return parser.parse_args(argv)


def check_init_strategy(cfg):
    """Warn when the config assumes ImageNet encoder init but no weight file
    is available AND the cold-start recipe is off: that combination
    collapses within ~100 steps (docs/PERF.md 'Learning validation')."""
    if not cfg.get("weights_init", False):
        return
    if find_resnet_weights(cfg.get("num_layers", 18)):
        return
    if int(cfg.get("cold_start_warmup_steps", 0)) > 0:
        return
    print(
        "WARNING: weights_init is true but no pretrained ResNet weights were "
        "found (assets/weights/resnet*_imagenet.npz / VFDEPTH_RESNET_WEIGHTS),"
        " and the cold-start schedule is off. Joint training from a random "
        "init collapses under the plain objective. Either fetch weights "
        "(`python scripts/fetch_imagenet_weights.py` on a networked machine) "
        "or train from scratch with the staged recipe: "
        "configs/ddad/ddad_surround_fusion_scratch.yaml / "
        "configs/nuscenes/nusc_surround_fusion_scratch.yaml.",
        file=sys.stderr)


def train(cfg, max_steps: Optional[int] = None, device=None):
    """``Trainer.learn`` on ``cfg``; under a process group on this rank's
    loader shard and card (``cuda:LOCAL_RANK``)."""
    import torch
    from .data.factory import construct_dataset
    from .data.loader import BatchLoader
    from .parallel import is_active, is_main_process, loader_shard
    from .training.model import VFDepthModel
    from .training.trainer import Trainer

    check_init_strategy(cfg)
    if device is None and is_active():
        # the card maybe_initialize_distributed set for this rank
        device = torch.device("cuda", torch.cuda.current_device())
    model = VFDepthModel(cfg, device=device)
    # the camera-axis grid, where the config asks for one, before the
    # loaders: it decides their shard
    trainer = Trainer(cfg, model, use_tb=is_main_process())
    shard_index, num_shards = loader_shard(trainer.grid)
    train_ds = construct_dataset(cfg, "train")
    # the shuffle seed is the same on every rank: each takes its own
    # contiguous slice of one permutation, so the shards partition the
    # epoch (the reference's DistributedSampler + set_epoch)
    train_loader = BatchLoader(train_ds, cfg.batch_size, shuffle=True,
                               num_workers=cfg.get("num_workers", 2), seed=42,
                               shard_index=shard_index, num_shards=num_shards)
    try:
        val_ds = construct_dataset(cfg, "val")
        val_loader = BatchLoader(val_ds, cfg.batch_size, shuffle=False,
                                 num_workers=0)
    except (FileNotFoundError, ValueError):
        val_loader = None
    return trainer.learn(train_loader, val_loader, max_steps=max_steps)


def main(argv=None):
    args = parse_args(argv)
    import torch.distributed as dist
    from .config import get_config
    from .parallel import COUNTS, maybe_initialize_distributed

    device = "cpu" if args.cpu else None
    rank, world = maybe_initialize_distributed(device)
    try:
        cfg = get_config(args.config_file, mode="train")
        train(cfg, max_steps=args.max_steps, device=device)
        if dist.is_initialized() and rank == 0:
            # which global reductions the run went through, by code path
            counts = json.dumps(dict(sorted(COUNTS.items())))
            print(f"data parallel: backend {dist.get_backend()}, world "
                  f"{world}; collectives {counts}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
