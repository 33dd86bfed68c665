"""Depth evaluation metrics (a copy of ``vfdepth_tpu/utils/metrics.py``).

Copied whole (numpy only) so the port scores depth maps as the JAX package
does without importing it: the reference's ``utils/misc.py:85-98`` and
``utils/logger.py:193-247`` semantics, the masked median scaling done on
the host in numpy, the lower-middle "torch median" and the average over
cameras with valid ground truth.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

METRIC_NAMES = ["abs_rel", "sq_rel", "rms", "log_rms", "a1", "a2", "a3"]


def cal_depth_error(pred: np.ndarray, target: np.ndarray) -> Tuple[float, ...]:
    """abs_rel, sq_rel, rmse, rmse_log, delta<1.25/1.25^2/1.25^3."""
    abs_rel = np.mean(np.abs(pred - target) / target)
    sq_rel = np.mean((pred - target) ** 2 / target)
    rmse = np.sqrt(np.mean((pred - target) ** 2))
    rmse_log = np.sqrt(np.mean((np.log(target) - np.log(pred)) ** 2))
    thresh = np.maximum(target / pred, pred / target)
    a1 = float((thresh < 1.25).mean())
    a2 = float((thresh < 1.25 ** 2).mean())
    a3 = float((thresh < 1.25 ** 3).mean())
    return float(abs_rel), float(sq_rel), float(rmse), float(rmse_log), a1, a2, a3


def _resize_bilinear_np(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """torch F.interpolate(mode='bilinear', align_corners=False) on
    [b, H, W, 1] numpy arrays (used to lift predictions to the GT shape)."""
    b, h0, w0 = img.shape[:3]
    h, w = hw
    if (h0, w0) == (h, w):
        return img
    ys = np.clip((np.arange(h) + 0.5) * h0 / h - 0.5, 0, h0 - 1)
    xs = np.clip((np.arange(w) + 0.5) * w0 / w - 0.5, 0, w0 - 1)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h0 - 1)
    x1 = np.minimum(x0 + 1, w0 - 1)
    wy = (ys - y0)[None, :, None, None]
    wx = (xs - x0)[None, None, :, None]
    v00 = img[:, y0][:, :, x0]
    v01 = img[:, y0][:, :, x1]
    v10 = img[:, y1][:, :, x0]
    v11 = img[:, y1][:, :, x1]
    return ((1 - wy) * ((1 - wx) * v00 + wx * v01)
            + wy * ((1 - wx) * v10 + wx * v11))


def _resize_nearest_np(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    b, h0, w0 = img.shape[:3]
    h, w = hw
    if (h0, w0) == (h, w):
        return img
    ys = np.clip((np.arange(h) * h0 / h).astype(int), 0, h0 - 1)
    xs = np.clip((np.arange(w) * w0 / w).astype(int), 0, w0 - 1)
    return img[:, ys][:, :, xs]


def compute_depth_metrics(
    depth_gt: np.ndarray,       # [b, cams, Hg, Wg, 1] (any resolution)
    depth_pred: np.ndarray,     # [b, cams, H, W, 1] (network-res, full scale)
    occ_mask: np.ndarray,       # [b, cams, H, W, 1]
    min_eval_depth: float,
    max_eval_depth: float,
) -> Tuple[Dict[str, float], Dict[str, float], List[float]]:
    """Per-camera metric + median-scaled metrics, averaged over cameras.

    Mirrors reference ``Logger.compute_depth_losses`` (utils/logger.py:
    193-247): predictions are bilinearly interpolated (align_corners=False)
    to the GT map's resolution and clamped to the eval range; mask =
    (gt in (min,max)) * self-occlusion (nearest-resized to GT resolution if
    needed); median scale = median(gt)/median(pred) per camera.
    Returns (metric_dict, median_dict, per-camera median scales).
    """
    num_cams = depth_gt.shape[1]
    gt_hw = depth_gt.shape[2:4]
    metric_acc = {k: 0.0 for k in METRIC_NAMES}
    median_acc = {k: 0.0 for k in METRIC_NAMES}
    med_scales: List[float] = []
    valid_cams = 0

    for cam in range(num_cams):
        gt = depth_gt[:, cam]
        pred = np.clip(_resize_bilinear_np(depth_pred[:, cam], gt_hw),
                       min_eval_depth, max_eval_depth)
        occ = _resize_nearest_np(occ_mask[:, cam], gt_hw)
        mask = (gt > min_eval_depth) & (gt < max_eval_depth) & (occ > 0)

        gt_m = gt[mask]
        pred_m = pred[mask]
        if gt_m.size == 0:
            med_scales.append(float("nan"))
            continue
        valid_cams += 1

        def torch_median(v: np.ndarray) -> float:
            # torch.median returns the LOWER of the two middle elements for
            # even counts (np.median averages them) — reference parity
            k = (v.size - 1) // 2
            return float(np.partition(v.ravel(), k)[k])

        scale = torch_median(gt_m) / torch_median(pred_m)
        med_scales.append(round(scale, 2))

        pred_metric = np.clip(pred_m, min_eval_depth, max_eval_depth)
        for k, v in zip(METRIC_NAMES, cal_depth_error(pred_metric, gt_m)):
            metric_acc[k] += v
        pred_median = np.clip(pred_m * scale, min_eval_depth, max_eval_depth)
        for k, v in zip(METRIC_NAMES, cal_depth_error(pred_median, gt_m)):
            median_acc[k] += v

    # Average only over cameras that had valid GT. Dividing by num_cams
    # would silently deflate averages when a camera contributes nothing;
    # the reference would loudly NaN there (torch.median of an empty
    # tensor). With zero valid cameras everything becomes NaN — the same
    # loud failure semantics.
    denom = valid_cams if valid_cams > 0 else float("nan")
    for k in METRIC_NAMES:
        metric_acc[k] /= denom
        median_acc[k] /= denom
    return metric_acc, median_acc, med_scales


def pretty_ts(ts: float) -> str:
    second = int(ts)
    minute = second // 60
    hour = minute // 60
    return f"{hour:02d}h{minute % 60:02d}m{second % 60:02d}s"
