"""Host-side training / evaluation loop (port of
``vfdepth_tpu/training/trainer.py``, the reference's ``VFDepthTrainer``).

The epoch / step loop with the reference's logging cadence, periodic
single-batch validation (a cycled iterator), per-epoch checkpoints, and the
full evaluation with metric and median-scaled depth metrics. Each step is
``training/step.py train_step`` (forward, loss, backward, one Adam update
with the StepLR schedule and the pose-LR boost of ``create_train_state``);
training batches reach the card through ``data/loader.py device_prefetch``.

The warp windows are sized over the first batch's rig and the dataset's
``rig_calibrations()`` (``create_train_state``). A window that overflows
truncates its warp, so the loss differs from the dense one; the loop keeps
the running maximum of ``warp_window_overflow`` on the device between log
checkpoints (no host sync a step), and ``_note_warp_overflow`` turns the
windows off after two checkpoints in a row with overflow, as the JAX
package does (there is nothing to recompile here: the next step is dense).

Data parallelism (the JAX ``_build_step``'s 1-D data mesh and its
process-0 rule): under a process group (``parallel/``), one rank a card,
each rank runs ``learn`` on its loader shard and ``train_step`` computes
the global batch's step (``training/step.py``). Only rank 0 prints, logs
(TensorBoard), validates and draws the image panels, which hold no
collective, and writes the checkpoints, which every rank then waits for at
a barrier. At each log checkpoint the ranks' scalar logs are reduced to
the global batch's (``parallel.reduce_logs``: one sum, one maximum), the
overflow's running maximum among them, before ``_note_warp_overflow``, so
every rank falls back to dense warps at the same step; between log
checkpoints there is no host sync. ``pretrain`` loads the same files on
every rank.

The camera-axis grid (JAX's 2-D mesh, ``parallel/mesh.py``): with
``tpu.cam_parallel_size`` > 1 under a process group, the trainer builds
the (world / cam, cam) grid by JAX's rule (``cam_grid_for``: a world
smaller than cam trains data-parallel, as JAX's 1-D mesh does; a larger
world not a multiple of cam, or num_cams not divisible by it, raises) and
splits the model's training forward over it
(``VFDepthModel.shard_cameras``, every training option);
``parallel.loader_shard(trainer.grid)`` is then the data index, so the
ranks of one cam group read the same batches. The rank-0 rules above hold
unchanged.

Randomness is explicit: ``learn``'s ``seed`` seeds the ``torch.Generator``
(on the model's device) that draws each step's tie-break noise and, under
``aug_depth``, the rotated views' uniform draw after it; validation and the
image panels draw from a generator of their own, so the training draws do
not depend on the log cadence. ``noise_fn(step, shape)`` and ``aug_fn(step,
shape)``, where given, supply each step's draws instead (how a test hands
in the JAX package's), of the global batch's shape. ``evaluate`` draws the
rotated views of each batch from a generator seeded with its ``seed``; with
``syn_visualize`` it renders the depth-synthesis sweep
(``training/synthesis.py``) at batch ``syn_idx`` and stops there.
"""
from __future__ import annotations

import itertools
import time
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .checkpoint import load_checkpoint, save_checkpoint
from .model import VFDepthModel
from .step import (aug_shape, create_train_state, eval_step, noise_shape,
                   train_step)
from ..data.loader import device_prefetch
from ..parallel.data_parallel import reduce_logs
from ..parallel.distributed import is_active, is_main_process
from ..parallel.mesh import cam_grid_for
from ..utils.logger import Logger
from ..utils.metrics import METRIC_NAMES, compute_depth_metrics

DrawFn = Callable[[int, Tuple[int, ...]], torch.Tensor]


def _numpy(tree: Mapping) -> Dict[str, np.ndarray]:
    """The arrays and tensors of a batch or outputs dict as f32 numpy
    arrays on the host (what the logger and the metrics read)."""
    return {k: (v.detach().float().cpu().numpy()
                if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in tree.items() if hasattr(v, "shape")}


class Trainer:
    def __init__(self, cfg, model: VFDepthModel, use_tb: bool = True):
        self.cfg = cfg
        self.model = model
        self.num_epochs = cfg.num_epochs
        # the camera-axis grid by JAX's rule (None: data parallelism only)
        self.grid = cam_grid_for(cfg, model.num_cams)
        model.shard_cameras(self.grid)
        # rank 0 logs, validates and writes checkpoints
        self.is_main = is_main_process()
        self.logger = Logger(cfg, use_tb and self.is_main)

    # ------------------------------------------------------------------
    def learn(self, train_loader, val_loader=None, seed: int = 42,
              max_steps: Optional[int] = None,
              noise_fn: Optional[DrawFn] = None,
              aug_fn: Optional[DrawFn] = None) -> torch.optim.Optimizer:
        """Full training run of ``self.model`` in place; returns the
        optimizer. ``train_loader`` (a ``BatchLoader``) / ``val_loader``
        yield numpy batch dicts (already collated, NHWC). The StepLR
        boundary counts the loader's ``steps_per_epoch`` optimizer
        updates."""
        model = self.model
        # the first batch (host arrays) and the dataset's per-scene rigs
        # size the warp windows over the calibration spread
        train_iter = iter(train_loader)
        first = next(train_iter)
        train_iter = itertools.chain([first], train_iter)
        ds = getattr(train_loader, "dataset", None)
        rigs = (ds.rig_calibrations() if hasattr(ds, "rig_calibrations")
                else None)
        optimizer = create_train_state(
            model, steps_per_epoch=train_loader.steps_per_epoch, batch=first,
            rigs=rigs)
        step = 0
        if self.cfg.get("pretrain", False):
            saved_step = load_checkpoint(self.cfg.load_weights_dir, model,
                                         optimizer, self.cfg.models_to_load,
                                         load_optimizer=True)
            if saved_step is not None:
                step = saved_step

        device = model.device
        train_gen = torch.Generator(device).manual_seed(seed)
        eval_gen = torch.Generator(device).manual_seed(seed)
        val_iter = iter(val_loader) if val_loader is not None else None
        prefetch_depth = self.cfg.get("prefetch_depth", 2)

        start_time = time.time()
        # the logged examples/s: the steps since the last log checkpoint over
        # their wall time, read after reduce_logs (which waits for the
        # device's work); the checkpoint's own validation and panels are
        # left out
        mark_time, mark_step = start_time, step
        # the running maximum of the overflow since the last log
        # checkpoint, on the device (read only at checkpoints)
        overflow_acc = None
        for epoch in range(self.num_epochs):
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            # uploads overlap the device's work on the current step
            epoch_iter = device_prefetch(
                train_iter if epoch == 0 else train_loader,
                size=prefetch_depth, device=device)
            for batch_idx, batch in enumerate(epoch_iter):
                noise = (noise_fn(step, noise_shape(model, batch))
                         if noise_fn is not None else None)
                aug_u = (aug_fn(step, aug_shape(model, batch))
                         if aug_fn is not None else None)
                logs = train_step(model, optimizer, batch, step, train_gen,
                                  noise=noise, aug_u=aug_u)
                ov = logs.get("warp_window_overflow")
                if ov is not None:
                    overflow_acc = (ov if overflow_acc is None
                                    else torch.maximum(overflow_acc, ov))

                if self.logger.is_checkpoint(step):
                    if overflow_acc is not None:
                        # every step since the last checkpoint counts
                        logs["warp_window_overflow"] = overflow_acc
                        overflow_acc = None
                    # the global batch's logs, the overflow's maximum over
                    # the ranks among them: every rank notes the same
                    logs = reduce_logs(logs)
                    step_s = (time.time() - mark_time) / (step + 1 - mark_step)
                    self._note_warp_overflow(
                        logs.get("warp_window_overflow", 0.0))
                    if self.is_main:
                        self.logger.log_time(
                            epoch, batch_idx, step_s,
                            logs.get("total_loss", float("nan")),
                            start_time)
                        self.logger.log_scalars("train", logs, step)
                    # train-batch panels (the reference logs its full panel
                    # set from the training batch): one more forward, with
                    # BatchNorm in eval mode, only where a writer takes them
                    if self.logger.writers.get("train") is not None:
                        p_out, _ = eval_step(model, batch, eval_gen,
                                             return_renders=True)
                        self.logger.log_images("train", _numpy(batch),
                                               _numpy(p_out), step)
                    if val_iter is not None and self.is_main:
                        val_iter = self._validate(val_loader, val_iter,
                                                  eval_gen, step)
                    mark_time, mark_step = time.time(), step + 1
                step += 1
                if max_steps is not None and step >= max_steps:
                    break

            # the reference saves every `save_frequency` epochs
            # (trainer/vfdepth_trainer.py:46-47), and the JAX package at the
            # last epoch too
            save_freq = max(int(self.cfg.get("save_frequency", 1) or 1), 1)
            if (epoch + 1) % save_freq == 0 or epoch == self.num_epochs - 1:
                if self.is_main:
                    save_checkpoint(self.cfg.save_weights_root, epoch, model,
                                    optimizer, step)
                if is_active():
                    dist.barrier()
            if self.is_main:
                print("-" * 110)
            if max_steps is not None and step >= max_steps:
                break
        self.logger.close()
        return optimizer

    def _note_warp_overflow(self, overflow: float) -> bool:
        """Count log checkpoints with ``warp_window_overflow`` > 0 (JAX
        ``_note_warp_overflow``): each one warns (a window truncated its
        warp, so that step's loss differs from the dense one); the second
        in a row turns the windows off (``model.warp_window`` False,
        ``warp_window_hw`` None) and returns True. A checkpoint without
        overflow clears the count."""
        if overflow and overflow > 0:
            self._overflow_strikes = getattr(self, "_overflow_strikes", 0) + 1
            if self.is_main:
                print(f"WARNING: warp window overflow {overflow:.0f} px "
                      f"(strike {self._overflow_strikes}) — a static warp "
                      "window truncated real content this step")
            if self._overflow_strikes >= 2 and self.model.warp_window:
                if self.is_main:
                    print("WARNING: persistent warp-window overflow — "
                          "falling back to dense warps")
                self.model.warp_window = False
                self.model.warp_window_hw = None
                self._overflow_strikes = 0
                return True
        else:
            self._overflow_strikes = 0
        return False

    def _validate(self, val_loader, val_iter, generator: torch.Generator,
                  step: int):
        """Single-batch validation at log checkpoints; cycles the iterator
        (the reference's ``next(self.val_iter)`` stops at exhaustion)."""
        try:
            batch = next(val_iter)
        except StopIteration:
            val_iter = iter(val_loader)
            batch = next(val_iter)
        outputs, logs = eval_step(self.model, batch, generator,
                                  return_renders=True)
        logs = {k: float(v) for k, v in logs.items()}
        if "depth" in batch:
            metric, median, med_scale = compute_depth_metrics(
                np.asarray(batch["depth"]),
                outputs["depth/0"].float().cpu().numpy(),
                np.asarray(batch["mask"]),
                self.cfg.eval_min_depth, self.cfg.eval_max_depth)
            print(f"          | median scale = {med_scale}")
            self.logger.print_perf(metric, "metric")
            self.logger.print_perf(median, "median")
        self.logger.log_scalars("val", logs, step)
        if self.logger.writers.get("val") is not None:
            self.logger.log_images("val", _numpy(batch), _numpy(outputs),
                                   step)
        return val_iter

    # ------------------------------------------------------------------
    def evaluate(self, eval_loader, vis_results: bool = False,
                 load_weights: bool = True, seed: int = 42):
        """Full-dataset evaluation (the reference's ``evaluate``:112-152):
        (average metric dict, average median-scaled dict) over batches.

        Each batch goes through ``VFDepthModel.predict``. The JAX package
        runs its eval step here and discards the loss; only ``depth/0``
        reaches the metrics, and predict computes the same tensor, so the
        warps and the loss are skipped. Under ``aug_depth`` each batch's
        rotated views are drawn from a generator seeded with ``seed``.

        With ``syn_visualize`` the batches before ``syn_idx`` are skipped;
        that batch is predicted, swept (``synthesize_sweep``) and written by
        ``log_result``, and the evaluation stops there (no metrics: both
        dicts stay 0).
        """
        syn_visualize = bool(self.cfg.get("syn_visualize", False))
        syn_idx = self.cfg.get("syn_idx") or 0
        if load_weights:
            load_checkpoint(self.cfg.load_weights_dir, self.model,
                            models_to_load=self.cfg.models_to_load,
                            load_optimizer=False)

        avg_metric = {k: 0.0 for k in METRIC_NAMES}
        avg_median = {k: 0.0 for k in METRIC_NAMES}
        n_batches = 0
        model = self.model
        gen = torch.Generator(model.device).manual_seed(seed)
        for batch_idx, batch in enumerate(eval_loader):
            if syn_visualize and batch_idx < syn_idx:
                continue
            aug_u = (torch.rand(model.aug_shape(batch), generator=gen,
                                device=gen.device)
                     if model.aug_depth else None)
            outputs = model.predict(batch, aug_u=aug_u)
            if syn_visualize:
                from .synthesis import synthesize_sweep
                out_np = _numpy(outputs)
                out_np["disp_vis"] = synthesize_sweep(model, batch)
                self.logger.log_result(out_np, batch_idx, syn_visualize=True)
                break
            metric, median, _ = compute_depth_metrics(
                np.asarray(batch["depth"]),
                outputs["depth/0"].float().cpu().numpy(),
                np.asarray(batch["mask"]),
                self.cfg.eval_min_depth, self.cfg.eval_max_depth)
            for k in METRIC_NAMES:
                avg_metric[k] += metric[k]
                avg_median[k] += median[k]
            n_batches += 1
            if vis_results:
                self.logger.log_result(_numpy(outputs), batch_idx)

        for k in METRIC_NAMES:
            avg_metric[k] /= max(n_batches, 1)
            avg_median[k] /= max(n_batches, 1)
        print("Evaluation result...\n")
        self.logger.print_perf(avg_metric, "metric")
        self.logger.print_perf(avg_median, "median")
        return avg_metric, avg_median
