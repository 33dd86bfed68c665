"""Analytic FLOPs of a cell's work, counted on the plain reference.

``torch.utils.flop_counter.FlopCounterMode`` walks the reference's
training step (forward, loss and backward; under ``aug_depth`` the
rotated decode and its loss too) or its serving forward on the meta
device: every tensor has its shape and no data, so nothing is
computed and the count is that of the configuration's shapes. It counts
the convolutions, their backward, and the matrix products (the fusion
MLPs, the einsum resizes and projections); elementwise work, pooling and
the samplers' gathers are not counted. Nothing recomputed is counted,
and nothing of the program is read.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference.model import RefModel, draws

CONV_OPS = ("convolution", "convolution_backward")


def _meta_batch(cfg: Mapping, batch: int) -> Dict[str, torch.Tensor]:
    t = cfg["training"]
    h, w = int(t["height"]), int(t["width"])
    cams = len(cfg["data"]["cameras"])
    n_scales = int(cfg["model"].get("fusion_level", 2)) + 2
    x = {}
    for f in t["frame_ids"]:
        for key in ("color", "color_aug"):
            x[f"{key}/{f}/0"] = torch.empty(batch, cams, h, w, 3)
    for s in range(1, n_scales):
        for key in ("color", "color_aug"):
            x[f"{key}/0/{s}"] = torch.empty(batch, cams, h >> s, w >> s, 3)
    for s in range(n_scales):
        x[f"K/{s}"] = torch.empty(batch, cams, 4, 4)
        x[f"inv_K/{s}"] = torch.empty(batch, cams, 4, 4)
    x["extrinsics"] = torch.empty(batch, cams, 4, 4)
    x["extrinsics_inv"] = torch.empty(batch, cams, 4, 4)
    x["mask"] = torch.empty(batch, cams, h, w, 1)
    return x


def of(fn: Callable[[], object]) -> Dict[str, float]:
    """{"total": FLOPs, "conv": FLOPs of the convolutions} of ``fn()``."""
    with FlopCounterMode(display=False) as fc:
        fn()
    by_op = fc.get_flop_counts()["Global"]
    conv = sum(v for k, v in by_op.items()
               if str(k).split(".")[-1] in CONV_OPS)
    return {"total": float(fc.get_total_flops()), "conv": float(conv)}


def count(cfg: Mapping, batch: int, train: bool) -> Dict[str, float]:
    """The FLOPs (``of``) of one training step (``train``) or one serving
    forward at ``batch`` framesets, on the meta device."""
    with torch.device("meta"):
        model = RefModel(cfg)
        x = _meta_batch(cfg, batch)
        if train:
            drawn = {d.name: torch.empty(d.shape) for d in draws(model, x)}
            return of(lambda: model.loss(x, **drawn).backward())
        return of(lambda: model.predict(x))
