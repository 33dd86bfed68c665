"""Evaluation entry point of the port (the counterpart of the root
``eval.py``):

    python -m vfdepth_tpu_torch.eval --config_file <yaml> [--weight_path <dir>]

Loads ``weights_<epoch>`` (``training/checkpoint.py``; a JAX checkpoint goes
through ``scripts/convert_jax_checkpoint.py`` first), runs
``Trainer.evaluate`` over the config's validation set and prints the metric
and median-scaled depth metrics. Runs on the CUDA card unless ``--cpu`` is
given.
"""
from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="vfdepth_tpu_torch evaluation")
    parser.add_argument("--config_file", default="./configs/ddad/ddad_surround_fusion.yaml",
                        type=str, help="config yaml file path")
    parser.add_argument("--weight_path", default=None, type=str,
                        help="checkpoint directory (weights_<epoch>)")
    parser.add_argument("--vis_results", action="store_true",
                        help="save per-camera disparity JPEGs")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions)")
    return parser.parse_args(argv)


def test(cfg, vis_results: bool = False, device=None):
    from .data.factory import construct_dataset
    from .data.loader import BatchLoader
    from .training.model import VFDepthModel
    from .training.trainer import Trainer

    model = VFDepthModel(cfg, device=device)
    eval_ds = construct_dataset(cfg, "val")
    eval_loader = BatchLoader(eval_ds, cfg.eval_batch_size, shuffle=False,
                              drop_last=True,
                              num_workers=cfg.get("eval_num_workers", 2))

    if not os.path.isdir(cfg.load_weights_dir):
        # evaluating random weights silently produces garbage metrics
        if not os.environ.get("VFDEPTH_EVAL_RANDOM_OK"):
            raise FileNotFoundError(
                f"checkpoint directory not found: {cfg.load_weights_dir!r} — "
                "pass --weight_path or set load.weights in the config "
                "(set VFDEPTH_EVAL_RANDOM_OK=1 to evaluate random init anyway)")
        print(f"WARNING: no checkpoint at {cfg.load_weights_dir!r}; "
              "evaluating RANDOM weights")

    trainer = Trainer(cfg, model, use_tb=False)
    return trainer.evaluate(eval_loader, vis_results=vis_results,
                            load_weights=os.path.isdir(cfg.load_weights_dir))


def main(argv=None):
    args = parse_args(argv)
    from .config import get_config

    cfg = get_config(args.config_file, mode="eval",
                     weight_path=args.weight_path)
    test(cfg, vis_results=args.vis_results,
         device="cpu" if args.cpu else None)


if __name__ == "__main__":
    main()
