"""The training and evaluation steps (port of
``vfdepth_tpu/training/step.py``'s optimizer, ``build_train_step`` body and
``build_eval_step``).

Optimizer parity with the JAX package (optax): one Adam over both nets
(b1 0.9, b2 0.999, eps 1e-8, eps_root 0 -- ``torch.optim.Adam``'s update
lr * m_hat / (sqrt(v_hat) + eps) is optax's), StepLR(``scheduler_step_size``
epochs, gamma 0.1) as a per-step schedule that scales the rate once
``count >= boundary`` (optax ``piecewise_constant_schedule``), and the
cold-start pose-net LR boost as the pose net's own parameter group, fading
linearly to exactly 1.0. ``count`` is the number of updates already made,
as optax counts. The schedule's numbers ride in each parameter group, so
the optimizer alone carries them.

Under a process group (data parallelism, ``parallel/``) each rank runs
``train_step`` on its slice of the global batch: ``create_train_state``
broadcasts rank 0's parameters and BatchNorm statistics, the tie-break
draws are the global batch's (every rank draws them from the same seed and
takes its slice), the BatchNorm statistics and the loss's masked means are
the global batch's, and the gradients are averaged over the ranks before
Adam. The step then computes what JAX's sharded step computes over the
global batch; ``parallel.reduce_logs`` turns a rank's logs into the global
batch's.

Under the camera-axis grid (``model.cam_grid``, ``parallel/mesh.py``) the
ranks of one cam group hold the same batch shard, ``batch`` is that
shard, and each rank takes the global tie-break noise's slice of both its
batch shard (axis 1) and its cameras (axis 2). The gradients are still
averaged over every rank: each rank's loss is the global one, so the mean
of the ranks' gradients is the global loss's, per-camera and replicated
parameters alike.

The epoch loop around these steps is ``training/trainer.py``.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from .model import VFDepthModel
from ..parallel.data_parallel import (average_gradients, broadcast_model,
                                      global_shape, local_slice)
from ..parallel.mesh import local_cameras
from ..utils.tracing import span


def make_lr_schedule(learning_rate: float, scheduler_step_size: int,
                     steps_per_epoch: int, gamma: float = 0.1
                     ) -> Callable[[int], float]:
    """StepLR(step_size epochs, gamma) over global steps: the rate at update
    ``count``. ``steps_per_epoch <= 0`` gives a constant rate."""
    boundary = (scheduler_step_size * steps_per_epoch
                if steps_per_epoch > 0 else None)
    return lambda count: _scheduled(learning_rate, boundary, gamma, count)


def _scheduled(lr: float, boundary: Optional[int], gamma: float,
               count: int) -> float:
    return lr * gamma if boundary is not None and count >= boundary else lr


def boost_factor(count: int, pose_boost: float, fade_start: int,
                 fade_steps: int) -> float:
    """The pose net's LR multiplier at update ``count``: ``pose_boost``
    until ``fade_start``, then linear to exactly 1.0 over ``fade_steps``."""
    f = min(max((count - fade_start) / max(fade_steps, 1), 0.0), 1.0)
    return 1.0 if f >= 1.0 else pose_boost + (1.0 - pose_boost) * f


def lr_at(group: Mapping, count: int) -> float:
    """The learning rate of one parameter group at update ``count``."""
    lr = _scheduled(group["base_lr"], group["boundary"], group["gamma"], count)
    if group["pose_boost"] > 1.0:
        lr *= boost_factor(count, group["pose_boost"], group["fade_start"],
                           group["fade_steps"])
    return lr


def make_optimizer(model: VFDepthModel, learning_rate: float,
                   scheduler_step_size: int, steps_per_epoch: int,
                   pose_boost: float = 1.0, boost_fade_start: int = 0,
                   boost_fade_steps: int = 1) -> torch.optim.Adam:
    """Adam over the depth net and the pose net (one parameter group each),
    the StepLR schedule and, with ``pose_boost > 1``, the pose net's LR
    boost (``boost_factor``)."""
    boundary = (scheduler_step_size * steps_per_epoch
                if steps_per_epoch > 0 else None)
    sched = dict(base_lr=float(learning_rate), boundary=boundary, gamma=0.1,
                 fade_start=int(boost_fade_start),
                 fade_steps=int(boost_fade_steps))
    groups = [dict(params=list(model.depth_net.parameters()),
                   name="depth_net", pose_boost=1.0, **sched),
              dict(params=list(model.pose_net.parameters()),
                   name="pose_net", pose_boost=float(pose_boost), **sched)]
    opt = torch.optim.Adam(groups, lr=float(learning_rate),
                           betas=(0.9, 0.999), eps=1e-8)
    for group in opt.param_groups:
        group["lr"] = lr_at(group, 0)
    return opt


def create_train_state(model: VFDepthModel, steps_per_epoch: int = 0,
                       batch: Optional[Mapping] = None,
                       rigs=None) -> torch.optim.Adam:
    """The optimizer for ``model`` as its config sets it up: the pose boost
    is active only under the cold-start schedule, and fades with its last
    ramp (the joint ramp [warm, warm+ramp] by default, the staggered
    spatio-temporal ramp [warm+ramp, warm+2*ramp] under
    ``cold_start_stagger_ramps``). The model holds the parameters and the
    BatchNorm statistics; the caller counts steps from 0.

    Given an example ``batch`` (and the dataset's ``rigs``, (K, extrinsics)
    pairs), the warp windows are sized first, on the host, as the JAX
    ``create_train_state`` does (``VFDepthModel.configure_warp_window``);
    without one the warps stay dense unless ``tpu.warp_window_hw`` sizes
    them. Under a process group every rank takes rank 0's parameters and
    BatchNorm statistics first."""
    broadcast_model(model)
    if batch is not None:
        model.configure_warp_window(batch, rigs=rigs)
    cfg = model.cfg
    warm = int(cfg.get("cold_start_warmup_steps", 0))
    ramp = int(cfg.get("cold_start_ramp_steps", 0))
    boost = (float(cfg.get("cold_start_pose_lr_boost", 1.0))
             if (warm or ramp) else 1.0)
    stagger = bool(cfg.get("cold_start_stagger_ramps", False))
    return make_optimizer(model, cfg.learning_rate, cfg.scheduler_step_size,
                          steps_per_epoch, pose_boost=boost,
                          boost_fade_start=(warm + ramp) if stagger else warm,
                          boost_fade_steps=max(ramp, 1))


def noise_shape(model: VFDepthModel, batch: Mapping) -> Tuple[int, ...]:
    """The tie-break noise of the global batch (``model.noise_shape`` with
    its batch axis, 1, over every batch shard)."""
    return global_shape(model.noise_shape(batch), 1, model.cam_grid)


def aug_shape(model: VFDepthModel, batch: Mapping) -> Tuple[int, ...]:
    """The rotated views' draw of the global batch (batch axis 0)."""
    return global_shape(model.aug_shape(batch), 0, model.cam_grid)


def _draw_noise(shape, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device)


def _draw_aug(model: VFDepthModel, shape,
              generator: torch.Generator) -> Optional[torch.Tensor]:
    """The depth-synthesis rotation's uniform draw (after the noise), None
    without ``aug_depth``."""
    if not model.aug_depth:
        return None
    return torch.rand(shape, generator=generator, device=generator.device)


def _scalars(logs: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in logs.items() if v.dim() == 0}


def train_step(model: VFDepthModel, optimizer: torch.optim.Optimizer,
               batch: Mapping, step: int, generator: torch.Generator,
               noise: Optional[torch.Tensor] = None,
               aug_u: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
    """Forward, loss, backward and one Adam update at global step ``step``
    (the number of updates made before it). The identity tie-break noise
    is ``noise`` where given (``noise_shape(model, batch)``), else drawn
    from ``generator`` (on its device); under ``aug_depth`` the rotated
    views' draw likewise ``aug_u`` (``aug_shape(model, batch)``) or, after
    the noise, ``generator``. Both are the global batch's: under a process
    group ``batch`` is this rank's slice of it, the generator is seeded
    alike on every rank, and each rank takes its slice of the draws (the
    noise's batch axis is 1, the rotations' 0; under the camera-axis grid
    the noise's cameras, axis 2, too); then the gradients are averaged
    over the ranks. Returns this rank's scalar logs, detached, on the
    model's device."""
    with span("vf.train_step"):
        for group in optimizer.param_groups:
            group["lr"] = lr_at(group, step)
        optimizer.zero_grad(set_to_none=True)
        if noise is None:
            noise = _draw_noise(noise_shape(model, batch), generator)
        if aug_u is None:
            aug_u = _draw_aug(model, aug_shape(model, batch), generator)
        grid = model.cam_grid
        noise = local_cameras(local_slice(noise, 1, grid), grid,
                              model.num_cams, axis=2)
        with span("vf.step.forward"):
            _, loss, logs = model(batch, step=step, noise=noise,
                                  aug_u=None if aug_u is None
                                  else local_slice(aug_u, 0, grid))
        with span("vf.step.backward"):
            loss.backward()
        with span("vf.parallel.grad_average"):
            average_gradients(model.parameters())
        with span("vf.step.optimizer"):
            optimizer.step()
        return _scalars(logs)


@torch.no_grad()
def eval_step(model: VFDepthModel, batch: Mapping,
              generator: torch.Generator, return_renders: bool = False
              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The forward and the loss with BatchNorm in eval mode, no gradient
    (JAX ``build_eval_step``): (outputs, scalar logs). The tie-break noise
    and, under ``aug_depth``, the rotated views' draw are drawn from
    ``generator``; ``return_renders`` adds the warped views for the image
    panels (``VFDepthModel.forward``)."""
    noise = _draw_noise(model.noise_shape(batch), generator)
    outputs, _, logs = model(batch, noise=noise,
                             aug_u=_draw_aug(model, model.aug_shape(batch),
                                             generator),
                             train=False, return_renders=return_renders)
    return outputs, _scalars(logs)
