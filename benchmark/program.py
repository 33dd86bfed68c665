"""The benchmark's hold on the program under test (``vfdepth_tpu_torch``):
its configuration object and its model with the benchmark's weights.

The program is imported inside the functions (here, in ``cells.py`` and
``ranks.py``), so that the plain reference and the yardstick load
without it."""
from __future__ import annotations

import json
import os
import tempfile
from typing import Mapping

import torch

from . import weights as weights_mod


def port_config(cfg: Mapping):
    """The program's ``Config`` of a benchmark configuration, through the
    program's own loader (its derived keys and defaults), as its command
    line reads a YAML file (JSON is YAML)."""
    from vfdepth_tpu_torch.config import get_config
    body = {k: v for k, v in cfg.items() if isinstance(v, dict)}
    fd, path = tempfile.mkstemp(suffix=".yaml")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(body, f)
        return get_config(path, mode="train")
    finally:
        os.unlink(path)


def param_spec(cfg: Mapping):
    """(name, shape) of every parameter of the configuration's model, by
    the plain reference built on the meta device."""
    from .reference.model import RefModel
    with torch.device("meta"):
        ref = RefModel(cfg)
    return [(n, tuple(p.shape)) for n, p in ref.named_parameters()]


def build_model(cfg: Mapping, seed: int, device):
    """The program's ``VFDepthModel`` of ``cfg`` on ``device`` with the
    benchmark's weights of ``seed``."""
    from vfdepth_tpu_torch.training.model import VFDepthModel
    model = VFDepthModel(port_config(cfg), device=device, seed=0)
    weights_mod.load(model, weights_mod.make(param_spec(cfg), seed, device))
    return model


def set_precision(cfg: Mapping) -> None:
    """The configuration's precision: f32 with TF32 off in cuDNN and in
    matmul (the published training script sets both)."""
    if cfg.get("peak", "f32") == "f32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
