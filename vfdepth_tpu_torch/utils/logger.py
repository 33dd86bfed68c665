"""Training logger: console + TensorBoard (a copy of
``vfdepth_tpu/utils/logger.py``, the reference's ``utils/logger.py``).

The reference's observable behaviour: the examples/s console line, the
two-phase log cadence (every ``log_frequency`` steps until ``early_phase``,
then every ``late_log_frequency``), TB scalars for every loss key, half-res
image panels from host-side numpy copies, eval metric printing.
tensorboardX, matplotlib and PIL are optional: without them the logger
prints to the console only. Logging is not the device path, so this is no
fallback that hides the device.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict

import numpy as np

from .metrics import METRIC_NAMES, pretty_ts
from .visualize import colormap

try:
    from tensorboardX import SummaryWriter
    _HAS_TB = True
except Exception:  # pragma: no cover
    SummaryWriter = None
    _HAS_TB = False


class Logger:
    def __init__(self, cfg, use_tb: bool = True):
        self.cfg = cfg
        self.log_path = cfg.log_path
        self.batch_size = cfg.batch_size
        self.log_frequency = cfg.log_frequency
        self.late_log_frequency = cfg.late_log_frequency
        self.early_phase = cfg.early_phase
        self.num_cams = cfg.num_cams
        os.makedirs(self.log_path, exist_ok=True)

        self.writers: Dict[str, Any] = {}
        if use_tb and _HAS_TB:
            for mode in ("train", "val"):
                self.writers[mode] = SummaryWriter(os.path.join(self.log_path, mode))

        if cfg.get("eval_visualize", False):
            self._init_vis(cfg)

    def _init_vis(self, cfg):
        vis_path = os.path.join(self.log_path, "vis_results")
        os.makedirs(vis_path, exist_ok=True)
        self.cam_paths = []
        for cam_id in range(self.num_cams):
            p = os.path.join(vis_path, f"cam{cam_id:d}")
            os.makedirs(p, exist_ok=True)
            self.cam_paths.append(p)
        if cfg.get("syn_visualize", False):
            self.syn_path = os.path.join(self.log_path, "syn_results")
            os.makedirs(self.syn_path, exist_ok=True)

    def get_metric_names(self):
        return METRIC_NAMES

    def is_checkpoint(self, step: int) -> bool:
        early = (step % self.log_frequency == 0) and (step < self.early_phase)
        late = step % self.late_log_frequency == 0
        return early or late

    def log_time(self, epoch: int, batch_idx: int, duration: float,
                 total_loss: float, start_time: float) -> None:
        samples_per_sec = self.batch_size / max(duration, 1e-9)
        elapsed = time.time() - start_time
        print(f"epoch: {epoch:2d} | batch: {batch_idx:6d} |"
              f"examples/s: {samples_per_sec:5.1f} | loss: {total_loss:.3f} |"
              f" time elapsed: {pretty_ts(elapsed)}")

    def log_scalars(self, mode: str, losses: Dict[str, float], step: int) -> None:
        writer = self.writers.get(mode)
        if writer is None:
            return
        for k, v in losses.items():
            try:
                writer.add_scalar(k, float(v), step)
            except (TypeError, ValueError):
                pass

    def log_images(self, mode: str, batch: Dict[str, np.ndarray],
                   outputs: Dict[str, np.ndarray], step: int,
                   sample: int = 0) -> None:
        """Per-camera TB image panels — the reference's full panel set
        (``utils/logger.py:138-170``): input, colormapped disparity,
        reprojection loss/mask, self-occlusion mask, spatio overlap +
        mask, per-context-frame predicted and spatio-temporal overlap
        images, and the augmented-view disparity when present.
        Half-res like the reference's ``resize_for_tb``; NHWC numpy."""
        writer = self.writers.get(mode)
        if writer is None:
            return

        def add_img(title, img_hwc):
            if img_hwc.shape[-1] == 1:
                img_hwc = np.repeat(img_hwc, 3, -1)
            img = np.clip(img_hwc[::2, ::2], 0.0, 1.0)
            writer.add_image(title, img.transpose(2, 0, 1), step)

        color = np.asarray(batch["color/0/0"])
        mask = np.asarray(batch["mask"])
        disp = np.asarray(outputs["disp/0"])
        for cam in range(self.num_cams):
            add_img(f"cam/{cam}", color[sample, cam])
            add_img(f"cam/{cam}/disp", colormap(disp[sample, cam, ..., 0]))
            add_img(f"cam/{cam}/self_occ_mask", mask[sample, cam])
            if "reproj_map" in outputs:
                add_img(f"cam/{cam}/reproj",
                        np.asarray(outputs["reproj_map"])[sample, cam])
                add_img(f"cam/{cam}/reproj_mask",
                        np.asarray(outputs["reproj_mask"])[sample, cam])
            if "overlap_img" in outputs:
                ov = np.asarray(outputs["overlap_img"])[sample, cam]
                ovm = np.asarray(outputs["overlap_mask"])[sample, cam]
                add_img(f"cam/{cam}/sp", ov[0])
                add_img(f"cam/{cam}/sp_mask", ovm[0])
                for fi in range(1, ov.shape[0]):
                    add_img(f"cam/{cam}/sp_tm_{fi}", ov[fi])
                    add_img(f"cam/{cam}/sp_tm_mask_{fi}", ovm[fi])
            if "temporal_img" in outputs:
                ti = np.asarray(outputs["temporal_img"])[sample, cam]
                for fi in range(ti.shape[0]):
                    add_img(f"cam/{cam}/pred_{fi}", ti[fi])
            if "disp/0/aug" in outputs:
                add_img(f"view_aug/{cam}",
                        colormap(np.asarray(outputs["disp/0/aug"])[sample, cam, ..., 0]))

    def log_result(self, outputs: Dict[str, np.ndarray], idx: int,
                   syn_visualize: bool = False) -> None:
        """Save per-camera colormapped disparity JPEGs (reference :172-191)."""
        try:
            import PIL.Image as pil
        except ImportError:  # pragma: no cover
            return
        # eval.py --vis_results can arrive with eval_visualize false in the
        # YAML; create the output dirs lazily instead of failing mid-eval
        if not hasattr(self, "cam_paths"):
            self._init_vis(self.cfg)
        disp = np.asarray(outputs["disp/0"])
        for cam in range(self.num_cams):
            for j in range(disp.shape[0]):
                img = colormap(disp[j, cam, ..., 0])
                img = pil.fromarray((img * 255).astype(np.uint8))
                cur = idx * self.batch_size + j
                img.save(os.path.join(self.cam_paths[cam], f"{cur:03d}_disp.jpg"))
        if syn_visualize and "disp_vis" in outputs:
            for k, sd in enumerate(outputs["disp_vis"]):
                img = colormap(np.asarray(sd)[0, ..., 0])
                img = pil.fromarray((img * 255).astype(np.uint8))
                img.save(os.path.join(self.syn_path, f"{k:03d}_syndisp.jpg"))

    def print_perf(self, loss: Dict[str, float], scale: str) -> None:
        perf = " " * 3 + scale
        for k, v in loss.items():
            perf += " | " + str(k) + f": {v:.3f}"
        print(perf)

    def close(self):
        for w in self.writers.values():
            w.close()
