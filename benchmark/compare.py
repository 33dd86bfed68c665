"""How ``correct`` is decided: the numbers compared between what the timed
path produced and the plain reference, and their limits.

Training (the first three steps of the very optimizer and model the window
then drives):

* ``loss_gap``: the largest relative gap of a step's loss
  (``loss_gap_first``: the first step's);
* ``depth_gap_first``: the first step's depth as the step logs it (the
  mean, largest and smallest of the finest scale), the largest relative
  gap: the forward alone, which the loss's ties (the auto-mask, the
  minimum over frames) do not reach;
* ``grad_gap``: the first gradient as the optimizer got it (its first
  moment after one step over 1 - beta1), by the worst leaf: the gap between
  the program's norm of a leaf and the reference's, over the reference's
  norm of that leaf or of the median leaf, whichever is larger;
* ``change_gap``: the parameters' change over the three steps, by the
  worst leaf in the same measure, leaving out the leaves whose reference
  gradient is under a thousandth of the median leaf's (Adam moves those by
  round-off alone); ``change_gap_median``: the median leaf's gap.

Serving (a sample of the requests the window finished):

* ``depth_gap``: the largest relative gap of a depth pixel;
* ``pose_gap``: the largest gap of an entry of ``cam_T_cam``.

The numbers that ``benchmark/limits/<workload>.json`` gives a limit are
compared; a number that is not finite fails.
"""
from __future__ import annotations

import json
import math
import statistics
from pathlib import Path
from typing import Dict, List, Mapping, Sequence

LIMITS_DIR = Path(__file__).resolve().parent / "limits"
SMALL_GRAD = 1e-3


def leaf_gaps(prog: Mapping[str, float], ref: Mapping[str, float],
              leaves: Sequence[str]) -> Dict[str, float]:
    """{leaf: |prog - ref| / max(ref, median ref)} over ``leaves``."""
    med = statistics.median(ref[k] for k in leaves)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in leaves}


def train_numbers(prog_losses: Sequence[float], ref_losses: Sequence[float],
                  prog_grad: Mapping[str, float], ref_grad: Mapping[str, float],
                  prog_change: Mapping[str, float],
                  ref_change: Mapping[str, float],
                  prog_depth: Sequence[Mapping[str, float]],
                  ref_depth: Sequence[Mapping[str, float]]
                  ) -> Dict[str, float]:
    if set(prog_grad) != set(ref_grad) or set(prog_change) != set(ref_change):
        raise ValueError("the program's and the reference's leaves differ")
    loss = [abs(p - r) / abs(r) for p, r in zip(prog_losses, ref_losses)]
    med = statistics.median(ref_grad.values())
    moving = [k for k in ref_change if ref_grad[k] >= SMALL_GRAD * med]
    grad = leaf_gaps(prog_grad, ref_grad, list(ref_grad))
    change = leaf_gaps(prog_change, ref_change, moving)
    depth = max(abs(prog_depth[0][k] - v) / abs(v)
                for k, v in ref_depth[0].items())
    return {"loss_gap": max(loss), "loss_gap_first": loss[0],
            "depth_gap_first": depth,
            "grad_gap": max(grad.values()),
            "change_gap": max(change.values()),
            "change_gap_median": statistics.median(change.values()),
            "detail": {"loss_gaps": loss,
                       "grad_worst": max(grad, key=grad.get),
                       "change_worst": max(change, key=change.get),
                       "left_out": sorted(set(ref_change) - set(moving))}}


def serve_numbers(pairs: List) -> Dict[str, float]:
    """``pairs``: [(program outputs, reference outputs)], each a dict with
    ``depth/0`` and ``cam_T_cam`` on the host."""
    depth = max(float(((p["depth/0"] - r["depth/0"]).abs()
                       / r["depth/0"].abs()).max()) for p, r in pairs)
    pose = max(float((p["cam_T_cam"] - r["cam_T_cam"]).abs().max())
               for p, r in pairs)
    return {"depth_gap": depth, "pose_gap": pose}


def limits(workload: str) -> Dict[str, float]:
    with open(LIMITS_DIR / f"{workload}.json") as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


def verdict(numbers: Mapping[str, float], lim: Mapping[str, float]) -> bool:
    """Every number that has a limit present, finite and within it."""
    return all(k in numbers and math.isfinite(numbers[k])
               and numbers[k] <= v for k, v in lim.items())
