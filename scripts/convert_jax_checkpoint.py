"""Convert a checkpoint of the JAX package into one of the PyTorch port.

    python scripts/convert_jax_checkpoint.py --config_file <yaml> \
        --jax_dir <.../models/weights_<epoch>> --out_root <dir>

Reads the orbax directory ``weights_<epoch>`` that
``vfdepth_tpu.training.checkpoint.save_checkpoint`` writes (restored as
numpy, whatever device topology wrote it), carries the parameters,
BatchNorm statistics and Adam state into a CPU ``VFDepthModel`` of the port
built from the same config (``vfdepth_tpu_torch.weights.load_flax_params``
and ``load_optax_adam_state``), and writes them with the port's
``save_checkpoint`` as ``<out_root>/weights_<epoch>/`` (``depth_net.pth``,
``pose_net.pth``, ``adam.pth``). This is how a JAX-trained model reaches a
machine without JAX: the port loads the result on the CPU or the card.

It imports both packages, so it lives outside the port.
"""
from __future__ import annotations

import argparse
import os
import re
import sys
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _adam_state(tree):
    """The optax Adam state (``count``, ``mu``, ``nu``) inside a restored
    optimizer state: orbax restores optax's named tuples, untemplated, as
    dicts inside lists."""
    if isinstance(tree, dict):
        if {"count", "mu", "nu"} <= set(tree):
            return SimpleNamespace(count=tree["count"], mu=tree["mu"],
                                   nu=tree["nu"])
        parts = tree.values()
    elif isinstance(tree, (list, tuple)):
        parts = tree
    else:
        return None
    for part in parts:
        found = _adam_state(part)
        if found is not None:
            return found
    return None


def convert(jax_dir: str, cfg, out_root: str, epoch: int) -> str:
    """Convert ``jax_dir`` for the model ``cfg`` describes; returns the
    port's checkpoint directory."""
    import numpy as np
    from vfdepth_tpu.training.checkpoint import _restore_as_numpy
    from vfdepth_tpu_torch.training import (VFDepthModel, create_train_state,
                                            save_checkpoint)
    from vfdepth_tpu_torch.weights import (load_flax_params,
                                           load_optax_adam_state)

    restored = _restore_as_numpy(os.path.abspath(jax_dir))
    model = VFDepthModel(cfg, device="cpu")
    load_flax_params(model, restored["params"], restored["batch_stats"])
    optimizer = create_train_state(model)
    adam = _adam_state(restored["opt_state"])
    if adam is None:
        raise ValueError(f"{jax_dir}: no Adam state (count, mu, nu) in the "
                         "optimizer state")
    load_optax_adam_state(optimizer, model, adam)
    return save_checkpoint(out_root, epoch, model, optimizer,
                           int(np.asarray(restored["step"])))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="convert a vfdepth_tpu (orbax) checkpoint into a "
                    "vfdepth_tpu_torch one")
    parser.add_argument("--config_file", required=True,
                        help="the config the checkpoint was trained with")
    parser.add_argument("--jax_dir", required=True,
                        help="the JAX package's weights_<epoch> directory")
    parser.add_argument("--out_root", required=True,
                        help="directory that receives weights_<epoch>/")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    match = re.search(r"weights_(\d+)$", os.path.normpath(args.jax_dir))
    if match is None:
        raise SystemExit("--jax_dir is not named weights_<epoch>")
    epoch = int(match.group(1))
    import jax
    jax.config.update("jax_platforms", "cpu")   # numpy restore: no device
    from vfdepth_tpu_torch.config import get_config
    cfg = get_config(args.config_file, mode="train")
    print(convert(args.jax_dir, cfg, args.out_root, epoch))


if __name__ == "__main__":
    main()
