"""Training entry point of the port (the counterpart of the root
``train.py``):

    python -m vfdepth_tpu_torch.train --config_file <yaml> [--max_steps N]

Runs ``Trainer.learn`` on one device (the CUDA card unless ``--cpu`` is
given), with a shuffled ``BatchLoader`` over the config's training set and,
where the config has one, an unshuffled one over its validation set;
checkpoints go to ``<log_dir>/<config name>/models/weights_<epoch>``.
"""
from __future__ import annotations

import argparse
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
    from .data.factory import construct_dataset
    from .data.loader import BatchLoader
    from .training.model import VFDepthModel
    from .training.trainer import Trainer

    check_init_strategy(cfg)
    model = VFDepthModel(cfg, device=device)
    train_ds = construct_dataset(cfg, "train")
    train_loader = BatchLoader(train_ds, cfg.batch_size, shuffle=True,
                               num_workers=cfg.get("num_workers", 2), seed=42)
    try:
        val_ds = construct_dataset(cfg, "val")
        val_loader = BatchLoader(val_ds, cfg.batch_size, shuffle=False,
                                 num_workers=0)
    except (FileNotFoundError, ValueError):
        val_loader = None

    trainer = Trainer(cfg, model, use_tb=True)
    return trainer.learn(train_loader, val_loader, max_steps=max_steps)


def main(argv=None):
    args = parse_args(argv)
    from .config import get_config

    cfg = get_config(args.config_file, mode="train")
    train(cfg, max_steps=args.max_steps, device="cpu" if args.cpu else None)


if __name__ == "__main__":
    main()
