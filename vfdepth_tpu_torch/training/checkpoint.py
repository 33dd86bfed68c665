"""Checkpoint save/load (port of ``vfdepth_tpu/training/checkpoint.py``) in
PyTorch's own files, with the reference's layout
(``models/base_model.py:45-93``): one directory per epoch,
``<save_weights_root>/weights_<epoch>/``, holding one file per network
(``depth_net.pth``, ``pose_net.pth``: the net's ``state_dict``, BatchNorm
statistics included) and ``adam.pth`` (the optimizer's ``state_dict`` and
the step count).

Loading restores a ``models_to_load`` subset of the nets (the partial load
used to evaluate the depth net alone), warns where a net's keys do not
match, and falls back to a fresh optimizer when the saved one does not fit
the live one. Tensors load onto the model's device, so a checkpoint
written on the card loads on the CPU and the other way round. A checkpoint
of the JAX package (orbax) reaches the port through
``scripts/convert_jax_checkpoint.py``.
"""
from __future__ import annotations

import os
from typing import List, Optional

import torch

from .model import VFDepthModel

NETS = ("depth_net", "pose_net")
OPTIMIZER_FILE = "adam.pth"


def save_checkpoint(save_root: str, epoch: int, model: VFDepthModel,
                    optimizer: torch.optim.Optimizer, step: int) -> str:
    """Write ``<save_root>/weights_<epoch>/``; returns its absolute path.
    ``step`` is the number of optimizer updates made so far."""
    path = os.path.abspath(os.path.join(save_root, f"weights_{epoch}"))
    os.makedirs(path, exist_ok=True)
    for name in NETS:
        torch.save(getattr(model, name).state_dict(),
                   os.path.join(path, f"{name}.pth"))
    torch.save({"optimizer": optimizer.state_dict(), "step": int(step)},
               os.path.join(path, OPTIMIZER_FILE))
    return path


def _fits(optimizer: torch.optim.Optimizer, saved: dict) -> bool:
    """Whether a saved optimizer ``state_dict`` has the live optimizer's
    groups, parameters and state shapes."""
    groups = optimizer.param_groups
    saved_groups = saved.get("param_groups", [])
    if len(saved_groups) != len(groups) or any(
            len(s["params"]) != len(g["params"])
            for s, g in zip(saved_groups, groups)):
        return False
    state = saved.get("state", {})
    for s, g in zip(saved_groups, groups):
        for idx, p in zip(s["params"], g["params"]):
            for key in ("exp_avg", "exp_avg_sq"):
                value = state.get(idx, {}).get(key)
                if value is not None and tuple(value.shape) != tuple(p.shape):
                    return False
    return True


def load_checkpoint(load_dir: str, model: VFDepthModel,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    models_to_load: Optional[List[str]] = None,
                    load_optimizer: bool = True) -> Optional[int]:
    """Restore (a subset of) the nets of ``model`` from ``load_dir`` in
    place, and with ``load_optimizer`` the optimizer's state.

    Returns the saved step where the optimizer state was restored, else
    None (the caller keeps its own count). The live optimizer keeps its own
    schedule (its parameter groups' settings), as an optax schedule lives
    outside the JAX package's saved state; only Adam's moments and counts
    are restored.
    """
    path = os.path.abspath(load_dir)
    device = model.device
    for name in (NETS if models_to_load is None else models_to_load):
        net = getattr(model, name)
        saved = torch.load(os.path.join(path, f"{name}.pth"),
                           map_location=device, weights_only=True)
        cur, new = set(net.state_dict()), set(saved)
        if cur != new:
            print(f"WARNING: checkpoint key mismatch for '{name}' (model "
                  f"expects e.g. {sorted(cur - new)[:4]}, checkpoint has "
                  f"e.g. {sorted(new - cur)[:4]}); loading the keys both "
                  "have")
        net.load_state_dict(saved, strict=False)

    if optimizer is None or not load_optimizer:
        return None
    opt_path = os.path.join(path, OPTIMIZER_FILE)
    if not os.path.isfile(opt_path):
        print("\tCannot load optimizer state (no adam.pth) - the optimizer "
              "will be freshly initialized")
        return None
    saved = torch.load(opt_path, map_location=device, weights_only=True)
    if not _fits(optimizer, saved["optimizer"]):
        print("\tCannot load optimizer state (structure changed) - the "
              "optimizer will be freshly initialized")
        return None
    live = optimizer.state_dict()["param_groups"]
    optimizer.load_state_dict({
        "state": saved["optimizer"]["state"],
        "param_groups": [dict(g, params=s["params"]) for g, s in
                         zip(live, saved["optimizer"]["param_groups"])]})
    # Adam keeps its update count on the CPU (a device scalar would cost a
    # host sync per update), as a fresh optimizer does
    for state in optimizer.state.values():
        if "step" in state:
            state["step"] = state["step"].detach().to("cpu", torch.float32)
    return int(saved["step"])
