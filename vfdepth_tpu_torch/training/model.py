"""The depth + pose model (port of ``vfdepth_tpu/training/model.py``).

``model.depth_model`` and ``model.pose_model`` each pick the surround-fusion
net ('fusion') or the Monodepth2 baseline ('fsm', the paper's Full Surround
Monodepth: every camera alone, a pose per camera, and the pose-consistency
loss); every pair of the two builds, as in the JAX package.

With both nets 'fusion', both entry points compute the prediction as the
JAX ``predict_pose_depth`` does: both nets' aggregated feature maps go
through ONE merged back-projection, the pose branch takes its channels plus
the shared rel-depth channel, the depth branch the rest, then the frustum
sample (kernel K3), the decoder and ``to_depth``'s fx/300 metric scale. The
back-projection is group-reduced (kernel K1) where the rig's two overlap
groups are equal (the 6-camera rig) and per camera (kernel K1b) otherwise
(the 3-camera rig). ``tpu.merge_backprojection: false`` runs the JAX
``predict_pose`` / ``predict_depth`` instead: each net back-projects its
own features (``FusedPoseNet.forward``, ``FusedDepthNet.forward``). So does
``tpu.batch_pose_frames: false`` with more than one context frame: the pose
net then runs once per context frame, as the reference VFDepth predicts
pose; and so does every pair with an fsm net, whose ``MonoPoseNet`` /
``MonoDepthNet`` run on the camera-packed batch and back-project nothing
(an fsm net runs no TPU kernel; its training step runs K5 in
``render_views``).

* ``predict(batch)`` serves: BatchNorm in eval mode, under
  ``torch.inference_mode``; returns ``cam_T_cam`` and ``disp/{s}``,
  ``depth/{s}`` per scale.
* ``forward(batch, step, noise)`` trains, the counterpart of JAX
  ``forward(train=True)``: BatchNorm in train mode (flax's running
  statistics), then ``relative_cam_poses``, ``render_views`` (kernel K5)
  and ``total_loss``; returns (outputs, loss, logs). Its backward runs the
  kernels K2 (of K1) or K2b (of K1b), K4 (of K3) and K5's coordinate
  gradient. ``forward(..., train=False)`` is the eval step's pipeline
  (BatchNorm in eval mode), optionally with the warped views for the
  image panels (``return_renders``).

``tpu.mixed_precision: true`` computes every network in bf16 as the JAX
package does (``compute_dtype``; parameters, BatchNorm statistics and Adam
state stay f32, ``models/blocks.py`` says where each layer casts): the
back-projected features, the voxel volume and the frustum sample are bf16
(the bf16 forms of kernels K1 / K1b, K2 / K2b, K3), the colours are cast to
bf16 before rendering (K5's bf16 form; the loss targets stay f32), and the
disparity sigmoid, the pose head and every sampling coordinate stay f32.

``tpu.sampler_3d`` picks the frustum sampler's backward (K4) as the JAX
package does: 'packed' sums bf16 updates (K4's bf16-update form, in an f32
config too), 'packed_f32grad' f32 ones (of a bf16 cotangent too, under
mixed precision), 'gather' f32 ones in an f32 config (the same function up
to summation order), and None means 'packed' under mixed precision and
'packed_f32grad' otherwise. Under mixed precision 'gather' is JAX's plain
XLA trilinear gather on the bf16 volume, every product and tap sum rounded
to bf16, and its backward an XLA scatter of bf16 updates into a bf16
volume: the port's ``ops/sample3d.py Sample3dGather`` computes both with
the same roundings (the gather-bf16 forms of K3 and K4).

``tpu.remat`` checkpoints the nets' train-mode calls as the JAX package's
``jax.checkpoint`` does (False, True or 'all', 'depth_net', 'pose_net'):
each call JAX's ``_apply`` wraps (the merged path's ``encode_aggregate``,
``pose_from_backprojection`` and ``decode_from_backprojection``, and each
net's whole forward elsewhere) runs under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, so its
activations are recomputed in the backward pass instead of kept; the
merged back-projection between them is not recomputed, as in JAX. The
recompute runs in ``models/blocks.py recomputing()`` (checkpoint's
``context_fn``): BatchNorm normalises with the same batch statistics and
does not move its running statistics a second time. Serving and the eval
step never checkpoint (JAX remats only under ``train=True``).

``training.aug_depth: true`` adds the depth-synthesis branch (with the
fusion depth net): each camera's extrinsics are rotated at random
(``models/vfnet.py augment_extrinsics``, the draw an explicit tensor
``aug_u`` of ``aug_shape``, uniform in [0, 1), as the tie-break noise is
one of normals), the depth net decodes its voxel volume a second time
along the rotated frusta (kernel K3 again, backward K4 again), and
``predict`` and ``forward`` return ``disp/{s}/aug`` and ``depth/{s}/aug``
(the latter at ``K/0``'s unrotated focal length); ``forward`` warps the
neighbours' and the camera's own depths into the rotated views
(``warp_depth``) for the depth-synthesis loss.

``model.weights_init: true`` loads ImageNet ResNet weights into every
encoder (the depth net's of one image, the pose net's of two) from a local
file (``models/torchvision_init.py``); with none, the encoders stay random
and a warning says so, as in the JAX package.

``tpu.warp_window: true`` (the default) warps the spatial and
spatio-temporal views inside windows, as the JAX package does:
``configure_warp_window(batch, rigs)`` sizes static boxes on the host over
the rigs' calibrations (``geometry/warp_window.py``; off by the 90%-area
rule, or with neither overlap loss), or ``tpu.warp_window_hw`` gives them;
each ``forward`` then places the boxes from the batch's rig, the predicted
ego-motion and, in ``tpu.st_window_mode: 'actual'``, the predicted depth
(one set a step, or one per scale in 'actual' mode with several scales),
and logs ``warp_window_overflow``. While it is 0 the windowed loss equals
the dense one; above 0 a window truncated its warp and the loss differs
(``training/trainer.py`` then falls back to dense warps after two log
checkpoints in a row). Until windows are sized the warps are dense.

Under a process group (data parallelism, ``parallel/``) the training
forward's BatchNorm and loss reduce over the global batch (``forward``
runs its loss inside ``parallel.global_batch()``), and
``configure_warp_window`` sizes the boxes over the global first batch, so
every rank warps the same windows; ``predict`` and ``forward(...,
train=False)`` hold no collective.

Under the camera-axis grid (``shard_cameras``, ``parallel/mesh.py``: JAX's
``tpu.cam_parallel_size``), the training forward runs on this rank's block
of cameras, for every option above: the encoders, each back-projection
(per camera, K1b), the frustum sample (K3, twice under ``aug_depth``)
and the decoders see only them, and each back-projection's overlap-group
sums and count are completed over the cam group by a differentiable
all-reduce each before the fusion and the pose branch's BEV, which run
replicated: one pair for the merged back-projection, one per net and
pose pass where the nets back-project their own features. Those
all-reduces stay outside ``tpu.remat``'s checkpointed calls, so a
recompute repeats none. A fusion net's pose is distributed to every
camera; an fsm pose net's per-camera poses, and under ``aug_depth`` each
scale's depth, are gathered over the cam group with their gradient. The
renders (K5) warp the whole rig's source images into this rank's cameras,
the depth synthesis the rig's depths into its rotated views, and the loss
assembles its per-camera vectors over every rank (``losses/composite.py``).

Config keys that name TPU alternates of one function map onto the port's
one implementation (the CUDA kernel for CUDA tensors, its plain version
for CPU tensors): ``tpu.sampler_2d`` and ``tpu.warp_op`` (K5 is the one
warp).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import Config
from ..device import resolve_device
from ..geometry import (distribute_pose, invert_pose, relative_cam_poses,
                        vec_to_matrix)
from ..geometry.view_rendering import render_views
from ..geometry.warp_window import (WarpWindows, compute_windows,
                                    estimate_window_hw_multi, st_actual_hw)
from ..losses import LossConfig, total_loss
from ..models import (FusedDepthNet, FusedPoseNet, MonoDepthNet, MonoPoseNet,
                      backproject_features, backproject_features_grouped,
                      grouped_backprojection_ok, pack_cam_feat,
                      unpack_cam_feat)
from ..models.blocks import recomputing
from ..models.torchvision_init import load_resnet_encoder_params
from ..models.vfnet import augment_extrinsics, local_group_sums
from ..ops.resize import resize_bilinear
from ..parallel.data_parallel import gather_batch, global_batch
from ..parallel.distributed import all_reduce_sum
from ..parallel.mesh import camera_shard, gather_cameras, local_cameras
from ..utils.tracing import span
from ..weights import init_random

_SAMPLERS_2D = (None, "auto", "pallas", "matmul", "gather")
_SAMPLERS_3D = (None, "packed", "packed_f32grad", "gather")
_WARP_OPS = (None, "auto", "mxu", "quad")
_NETS = ("fusion", "fsm")
_REMATS = (None, False, True, "all", "depth_net", "pose_net")
_ST_WINDOW_MODES = ("actual", "interval", "dense")


def _host(a) -> np.ndarray:
    """A batch array or tensor (on any device) as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _recompute_contexts():
    """``checkpoint``'s context_fn: nothing around the forward, BatchNorm's
    recompute mode around the recompute."""
    return contextlib.nullcontext(), recomputing()


def loss_config_from(cfg: Config) -> LossConfig:
    return LossConfig(
        frame_ids=tuple(cfg.frame_ids),
        scales=tuple(cfg.scales),
        disparity_smoothness=cfg.disparity_smoothness,
        spatio_coeff=cfg.spatio_coeff,
        spatio_tempo_coeff=cfg.spatio_tempo_coeff,
        pose_loss_coeff=cfg.pose_loss_coeff,
        depth_con_coeff=cfg.get("depth_con_coeff", 0.03),
        depth_sm_coeff=cfg.get("depth_sm_coeff", 0.05),
        spatio=cfg.spatio,
        spatio_temporal=cfg.spatio_temporal,
        aug_depth=cfg.aug_depth,
        pose_model=cfg.pose_model,
        warmup_steps=int(cfg.get("cold_start_warmup_steps", 0)),
        ramp_steps=int(cfg.get("cold_start_ramp_steps", 0)),
        stagger_ramps=bool(cfg.get("cold_start_stagger_ramps", False)),
        pose_prior_coeff=float(cfg.get("cold_start_pose_coeff", 1.0)),
        pose_prior_floor=float(cfg.get("cold_start_pose_floor", 0.1)),
        pose_prior_ceil=float(cfg.get("cold_start_pose_ceil", 1.0)),
        disp_anchor_coeff=float(cfg.get("cold_start_disp_coeff", 0.1)),
    )


class VFDepthModel(nn.Module):
    """Depth net + pose net built from a ``Config``, on one device.

    ``device`` defaults to CUDA and raises without it; pass "cpu" for the
    plain PyTorch versions of the kernels (tests). Parameters start from a
    seeded random init (``weights.init_random``); ``weights.load_flax_params``
    carries the JAX package's parameters over. Setting ``plain_samplers``
    runs the kernels' plain versions on any device (a reference run on the
    card).
    """

    def __init__(self, cfg: Config,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0):
        super().__init__()
        self.device = resolve_device(device)
        self.cfg = cfg
        for key in ("depth_model", "pose_model"):
            if cfg.get(key) not in _NETS:
                raise ValueError(f"unknown {key} {cfg.get(key)!r}")
        self.compute_dtype = (torch.bfloat16
                              if cfg.get("mixed_precision", False) else None)
        self.frame_ids = tuple(cfg.frame_ids)
        # one pose-net pass for all context frames, or one per frame
        self.batch_pose_frames = bool(cfg.get("batch_pose_frames", True))
        # one back-projection for both nets where both are fusion nets
        # (_can_merge_backproject)
        self.merge_backproject = bool(cfg.get("merge_backprojection", True))
        # activation checkpointing of the nets' train-mode calls
        self.remat = cfg.get("remat", False)
        if self.remat not in _REMATS:
            raise ValueError(f"unknown remat {self.remat!r}")
        if cfg.get("sampler_2d") not in _SAMPLERS_2D:
            raise ValueError(f"unknown sampler_2d {cfg.get('sampler_2d')!r}")
        if cfg.get("sampler_3d") not in _SAMPLERS_3D:
            raise ValueError(f"unknown sampler_3d {cfg.get('sampler_3d')!r}")
        if cfg.get("warp_op") not in _WARP_OPS:
            raise ValueError(f"unknown warp_op {cfg.get('warp_op')!r}")
        # the JAX rule (training/model.py:177-182): bf16 backward updates
        # for an explicit 'packed', and by default under mixed precision
        self.sampler_3d = cfg.get("sampler_3d") or (
            "packed" if self.compute_dtype is not None else "packed_f32grad")
        self.groups = tuple(map(tuple, cfg.overlap_groups))
        # K1 where the two overlap groups split the rig equally, else K1b
        self.grouped = grouped_backprojection_ok(self.groups, cfg.num_cams)

        self.scales = tuple(cfg.scales)
        self.height, self.width = cfg.height, cfg.width
        self.fusion_level = cfg.fusion_level
        self.min_depth, self.max_depth = cfg.min_depth, cfg.max_depth
        self.focal_length_scale = cfg.focal_length_scale
        self.loss_cfg = loss_config_from(cfg)
        self.aug_depth = bool(cfg.aug_depth)
        self.aug_angle = tuple(cfg.get("aug_angle", (15.0, 15.0, 40.0)))
        if self.aug_depth and cfg.depth_model != "fusion":
            # the rotated views are decoded from the voxel volume, which
            # only the fusion depth net has (JAX fails there too)
            raise ValueError("aug_depth needs the fusion depth net")
        self.intensity_align = bool(cfg.intensity_align)
        # warp windows (JAX training/model.py:144-164): on by default, sized
        # by configure_warp_window or given by tpu.warp_window_hw
        self.warp_window = bool(cfg.get("warp_window", True))
        self.st_window_mode = str(cfg.get("st_window_mode", "actual"))
        if self.st_window_mode not in _ST_WINDOW_MODES:
            raise ValueError(f"unknown st_window_mode "
                             f"{self.st_window_mode!r}")
        self.st_window_pad = int(cfg.get("st_window_pad", 64))
        self.st_window_pad_v = int(cfg.get("st_window_pad_v", 16))
        hw = cfg.get("warp_window_hw", None)   # [h, w] or [[h0, w0], [h1, w1]]
        if hw and not isinstance(hw[0], (list, tuple)):
            hw = (tuple(hw), tuple(hw))
        hw = tuple(map(tuple, hw)) if hw else None
        # (spatio_hw, st_hw), each ((H0, W0), (H1, W1)) or None (dense); an
        # explicit size applies to both kinds
        self.warp_window_hw = (hw, hw) if hw else None
        self.plain_samplers = False
        self.num_cams = int(cfg.num_cams)
        # the camera-axis grid of the training forward (shard_cameras)
        self.cam_grid = None
        # the voxel keys only where a fusion net is built: the published fsm
        # configs (configs/*/*_baseline.yaml) have none, and the JAX
        # package, which reads them for every pair, cannot build those
        if "fusion" in (cfg.depth_model, cfg.pose_model):
            self.voxel = dict(voxel_str_p=tuple(cfg.voxel_str_p),
                              voxel_unit_size=tuple(cfg.voxel_unit_size),
                              voxel_size=tuple(cfg.voxel_size))
            vfnet_kwargs = dict(
                **self.voxel, proj_d_bins=cfg.proj_d_bins,
                proj_d_str=cfg.proj_d_str, proj_d_end=cfg.proj_d_end,
                num_cams=cfg.num_cams, height=cfg.height, width=cfg.width,
                dtype=self.compute_dtype)
        if cfg.depth_model == "fusion":
            self.depth_net = FusedDepthNet(
                cfg.num_layers, cfg.fusion_level, cfg.fusion_feat_in_dim,
                use_skips=cfg.use_skips, scales=self.scales,
                voxel_pre_dim=tuple(cfg.voxel_pre_dim),
                overlap_groups=self.groups, sampler_3d=self.sampler_3d,
                **vfnet_kwargs)
        else:
            self.depth_net = MonoDepthNet(cfg.num_layers, scales=self.scales,
                                          dtype=self.compute_dtype)
        if cfg.pose_model == "fusion":
            self.pose_net = FusedPoseNet(cfg.num_layers, cfg.fusion_level,
                                         cfg.fusion_feat_in_dim,
                                         **vfnet_kwargs)
        else:
            self.pose_net = MonoPoseNet(cfg.num_layers,
                                        dtype=self.compute_dtype)
        init_random(self, torch.Generator().manual_seed(seed))
        if cfg.get("weights_init", False):
            # ImageNet encoders from a local weight file (JAX init :370-380)
            for net, n_imgs in ((self.depth_net, 1), (self.pose_net, 2)):
                load_resnet_encoder_params(net.encoder, cfg.num_layers,
                                           n_imgs)
        self.to(self.device)
        # [cams, 2] neighbour indices, -1 = none (not a buffer: no state)
        self.rel_cam = torch.as_tensor(cfg.rel_cam_array,
                                       device=self.device).long()
        self.eval()

    def shard_cameras(self, grid) -> None:
        """Split the training forward's cameras over ``grid``
        (``parallel/mesh.py``; None: every camera on this rank). Every
        training option runs on the grid; the rig's cameras must divide
        over it."""
        if grid is not None and self.num_cams % grid.cam:
            raise ValueError(f"num_cams {self.num_cams} does not divide "
                             f"over {grid.cam} camera shards")
        self.cam_grid = grid

    def configure_warp_window(self, batch: Mapping, rigs=None) -> None:
        """Size the static warp windows on the host (JAX
        ``configure_warp_window``): over every rig of ``batch`` (``K/0`` and
        ``extrinsics``, numpy or tensors on any device, read once here) and
        of ``rigs``, a list of (K [cams, 4, 4] at the train resolution,
        extrinsics [cams, 4, 4]) pairs (``dataset.rig_calibrations()``),
        identical rigs once. Does nothing when ``warp_window`` is off or
        ``tpu.warp_window_hw`` set the sizes; turns the windows off with
        neither overlap loss, and where the boxes would cover 90% of the
        image or more (dense is cheaper there). Under a process group
        ``batch`` is this rank's, and the boxes are sized over the global
        batch (every rank's, gathered in one collective; under the
        camera-axis grid over its data group, one rank a batch shard), so
        every rank sizes the same boxes and turns them off alike."""
        if not self.warp_window or self.warp_window_hw is not None:
            return
        if not (self.loss_cfg.spatio or self.loss_cfg.spatio_temporal):
            self.warp_window = False
            return
        rel = np.asarray(self.cfg.rel_cam_array)
        k_b, ext_b = (_host(gather_batch(torch.as_tensor(batch[key]).to(
            self.device), self.cam_grid)) for key in ("K/0", "extrinsics"))
        rig_list = [(k_b[i], ext_b[i]) for i in range(k_b.shape[0])]
        for k, ext in (rigs or []):
            rig_list.append((_host(k), _host(ext)))
        seen, uniq = set(), []
        for k, ext in rig_list:
            key = (k[:, :2].round(4).tobytes(), ext[:, :3].round(5).tobytes())
            if key not in seen:
                seen.add(key)
                uniq.append((k, ext))
        full = self.height * self.width

        def sized(with_motion):
            hw = estimate_window_hw_multi(
                uniq, np.maximum(rel, 0), rel >= 0, self.height, self.width,
                self.min_depth, self.max_depth, self.focal_length_scale,
                with_motion=with_motion)
            return None if sum(h * w for h, w in hw) >= 0.9 * full else hw

        spatio_hw = sized(False) if self.loss_cfg.spatio else None
        st_hw = None
        if self.loss_cfg.spatio_temporal:
            if self.st_window_mode == "actual":
                base = spatio_hw if spatio_hw is not None else sized(False)
                if base is not None:
                    st_hw = st_actual_hw(base, self.height, self.width,
                                         self.st_window_pad,
                                         self.st_window_pad_v)
                    if sum(h * w for h, w in st_hw) >= 0.9 * full:
                        st_hw = None
            elif self.st_window_mode == "interval":
                st_hw = sized(True)
        if spatio_hw is None and st_hw is None:
            self.warp_window = False
            return
        self.warp_window_hw = (spatio_hw, st_hw)

    def _windows(self, x: Mapping[str, torch.Tensor],
                 spatio_pose: Optional[torch.Tensor],
                 st_pose: Optional[torch.Tensor],
                 depth: Optional[torch.Tensor], rel_cam: torch.Tensor,
                 src_k: Optional[torch.Tensor]) -> Optional[WarpWindows]:
        """This step's windows (JAX ``_windows``), None where the warps
        are dense. The poses and the depth enter without gradient.
        ``rel_cam`` (the target cameras' rows of the neighbour indices) and
        ``src_k`` as ``compute_windows`` takes them."""
        with span("vf.geometry.windows"):
            if not self.warp_window or self.warp_window_hw is None:
                return None
            if spatio_pose is None or st_pose is None:
                return None
            spatio_hw, st_hw = self.warp_window_hw
            st_depth = (depth.detach() if self.st_window_mode == "actual"
                        and depth is not None else None)
            sources = {} if src_k is None else dict(src_k=src_k)
            return compute_windows(
                x["inv_K/0"], x["K/0"], spatio_pose.detach(),
                st_pose.detach(), torch.clamp(rel_cam, min=0), rel_cam >= 0,
                self.height, self.width, spatio_hw, st_hw, self.min_depth,
                self.max_depth, self.focal_length_scale, st_depth=st_depth,
                **sources)

    def _remat_for(self, net: nn.Module) -> bool:
        """Whether ``net``'s train-mode calls are checkpointed (JAX
        ``_remat_for``): every net for True or 'all', the named one for
        'depth_net' / 'pose_net'."""
        if not self.remat:
            return False
        if self.remat is True or self.remat == "all":
            return True
        return self.remat == ("depth_net" if net is self.depth_net
                              else "pose_net")

    def _call(self, net: nn.Module, fn, *args, **kwargs):
        """``fn(*args, **kwargs)``, a call of ``net``; in train mode, where
        ``_remat_for(net)``, under activation checkpointing, its BatchNorm
        recompute in ``recomputing()`` (``models/blocks.py``)."""
        if self.training and torch.is_grad_enabled() \
                and self._remat_for(net):
            return checkpoint(fn, *args, use_reentrant=False,
                              context_fn=_recompute_contexts, **kwargs)
        return fn(*args, **kwargs)

    @contextlib.contextmanager
    def _bn_mode(self, train: bool):
        """BatchNorm (the only mode-dependent layer) in train or eval mode
        for the block, restored after it."""
        was = self.training
        self.train(train)
        try:
            yield
        finally:
            self.train(was)

    def to_depth(self, disp: torch.Tensor, k0: torch.Tensor) -> torch.Tensor:
        """Disparity [b, cams, h, w, 1] -> metric depth at full resolution:
        1 / (1/max_d + (1/min_d - 1/max_d) * disp), bilinearly upsampled
        (align_corners=False), scaled by fx / focal_length_scale."""
        min_disp = 1.0 / self.max_depth
        max_disp = 1.0 / self.min_depth
        disp_full = resize_bilinear(disp, (self.height, self.width),
                                    align_corners=False)
        depth = 1.0 / (min_disp + (max_disp - min_disp) * disp_full)
        fx = k0[..., 0:1, 0:1]                 # [b, cams, 1, 1]
        return depth * fx[..., None] / self.focal_length_scale

    def _to_device(self, batch: Mapping, keys=None) -> Dict[str, torch.Tensor]:
        """The batch's arrays (those named by ``keys``, else all) as f32
        tensors on this model's device."""
        keys = batch.keys() if keys is None else keys & batch.keys()
        with span("vf.model.upload"):
            x = {k: torch.as_tensor(batch[k]).to(self.device, torch.float32)
                 for k in keys}
            if "extrinsics_inv" not in x:
                x["extrinsics_inv"] = invert_pose(x["extrinsics"])
        return x

    def _predict_pose_depth(self, x: Mapping[str, torch.Tensor],
                            extrinsics_aug: Optional[torch.Tensor] = None,
                            rig: Optional[Mapping[str, torch.Tensor]] = None):
        """(cam_T_cam [b, cams, n_ctx, 4, 4], the depth net's outputs
        {'disp/{s}' [b, cams, h, w, 1], and 'disp/{s}/aug' where
        ``extrinsics_aug`` is given}) from a batch already on the device.

        Given the whole ``rig`` (the camera-axis grid's training forward),
        ``x`` holds this rank's cameras: the back-projection runs per
        camera (K1b), its overlap-group sums and count are completed over
        the cam group, and cam_T_cam covers the rig's every camera."""
        fk = f"K/{self.fusion_level + 1}"
        fik = f"inv_K/{self.fusion_level + 1}"
        ctx = self.frame_ids[1:]
        n_ctx = len(ctx)
        bsz = x["color_aug/0/0"].shape[0]

        # time-ordered context pairs, group-major along batch (one BatchNorm
        # batch for all pairs, as in the JAX package)
        with span("vf.nets.encode"):
            curs = torch.cat([x[f"color_aug/{f if f < 0 else 0}/0"]
                              for f in ctx])
            nxts = torch.cat([x[f"color_aug/{0 if f < 0 else f}/0"]
                              for f in ctx])
            pose_feats = self._call(self.pose_net,
                                    self.pose_net.encode_aggregate, curs,
                                    nxts, n_ctx=n_ctx)
            dfeats, depth_feats = self._call(self.depth_net,
                                             self.depth_net.encode_aggregate,
                                             x["color_aug/0/0"])

        # ONE back-projection for both nets: their projected coordinates are
        # identical, so the feature maps concatenate on channels
        cp = pose_feats.shape[-1]
        grouped = self.grouped or rig is not None
        with span("vf.nets.backproject"):
            merged = torch.cat([pose_feats, depth_feats], dim=-1)
            if rig is not None:
                feat, count = self._cam_group_backprojection(merged, x)
            elif self.grouped:
                feat, count = backproject_features_grouped(
                    merged, x["mask"], x[fk], x["extrinsics_inv"],
                    groups=self.groups, plain=self.plain_samplers,
                    **self.voxel)
            else:
                feat, _, count = backproject_features(
                    merged, x["mask"], x[fk], x["extrinsics_inv"],
                    plain=self.plain_samplers, **self.voxel)
            # the trailing rel-depth channel is shared by both branches.
            # Autograd of these slices and this cat already gives the merged
            # cotangent as the JAX package's custom VJP writes it
            # (_split_merged_channels: one concat plus the rel-column add),
            # so no Function is needed here.
            feat_pose = torch.cat([feat[..., :cp], feat[..., -1:]], dim=-1)
            feat_depth = feat[..., cp:]

        with span("vf.nets.pose"):
            axisangle, translation = self._call(
                self.pose_net, self.pose_net.pose_from_backprojection,
                feat_pose, count, n_ctx=n_ctx, grouped=grouped)
            cam_t_cam = self._cam_t_cam(axisangle, translation, x, bsz, rig)
        with span("vf.nets.depth"):
            skips = [dfeats[i] for i in range(self.fusion_level)]
            disps = self._call(
                self.depth_net, self.depth_net.decode_from_backprojection,
                feat_depth, count, skips, x[fik], x["extrinsics"],
                extrinsics_aug=extrinsics_aug, grouped=grouped,
                plain=self.plain_samplers)
        return cam_t_cam, disps

    def _cam_group_backprojection(self, feats_agg: torch.Tensor,
                                  x: Mapping[str, torch.Tensor]
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A back-projection under the camera-axis grid: this rank's cameras
        of ``x`` one row each (K1b), their part of the two overlap-group
        sums (``local_group_sums``, the rank's camera range passed down),
        then the sums and the count completed over the cam group by one
        differentiable all-reduce each (site "cam_fusion") -> (feat [b, 2,
        n, C+1], count [b, n]), the same on every rank of the group."""
        lev = self.fusion_level + 1
        feat, _, count = backproject_features(
            feats_agg, x["mask"], x[f"K/{lev}"], x["extrinsics_inv"],
            plain=self.plain_samplers, **self.voxel)
        loc = self.cam_grid.local_cams(self.num_cams)
        group = self.cam_grid.cam_group
        feat = all_reduce_sum(local_group_sums(
            feat, self.groups, range(loc.start, loc.stop)), "cam_fusion",
            group)
        return feat, all_reduce_sum(count, "cam_fusion", group)

    def _cam_t_cam(self, axisangle: torch.Tensor, translation: torch.Tensor,
                   x: Mapping[str, torch.Tensor], bsz: int,
                   rig: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> torch.Tensor:
        """The pose net's motions (context frames group-major) -> cam_T_cam
        [b, cams, n_ctx, 4, 4]; a past frame's motion is inverted. A fusion
        pose net gives one canonical motion per frameset ([n_ctx*b, 1, 1,
        3]), distributed to the cameras through the extrinsics; an fsm pose
        net one motion per camera of ``x`` ([n_ctx*b*cams, 1, 1, 3]). Given
        the whole ``rig`` (the camera-axis grid), cam_T_cam covers the
        rig's every camera: distributed through its extrinsics, or the fsm
        net's poses gathered over the cam group (site "cam_poses")."""
        ctx = self.frame_ids[1:]
        aa = axisangle[:, 0, 0].reshape(len(ctx), -1, 3)
        tr = translation[:, 0, 0].reshape(len(ctx), -1, 3)
        calib = x if rig is None else rig
        mono = isinstance(self.pose_net, MonoPoseNet)
        mats = []
        for i, f in enumerate(ctx):
            mat = vec_to_matrix(aa[i], tr[i], invert=(f < 0))
            if mono:
                mats.append(unpack_cam_feat(mat, bsz,
                                            x["extrinsics"].shape[1]))
            else:
                mats.append(distribute_pose(mat, calib["extrinsics"],
                                            calib["extrinsics_inv"]))
        cam_t_cam = torch.stack(mats, dim=2)
        if mono and rig is not None:
            cam_t_cam = gather_cameras(cam_t_cam, self.cam_grid,
                                       self.num_cams, "cam_poses")
        return cam_t_cam

    def predict_pose(self, x: Mapping[str, torch.Tensor],
                     rig: Optional[Mapping[str, torch.Tensor]] = None
                     ) -> torch.Tensor:
        """The pose net alone (JAX ``predict_pose``; a fusion net on its own
        back-projection, an fsm net on each camera alone): cam_T_cam [b,
        cams, n_ctx, 4, 4] from a batch already on the device. With
        batched pose frames the context pairs
        go through one pass; otherwise through one pass each, in the order
        of ``frame_ids[1:]`` (pairs in time order, a past frame's motion
        inverted), and in train mode each pass normalises with its own
        batch statistics and updates the running ones in turn.

        Given the whole ``rig`` (the camera-axis grid's training forward),
        ``x`` holds this rank's cameras: a fusion net's passes each
        back-project them and complete the group sums over the cam group
        (``_cam_group_backprojection``), and cam_T_cam covers the rig's
        every camera (``_cam_t_cam``)."""
        lev = self.fusion_level + 1
        ctx = self.frame_ids[1:]
        calib = (x["mask"], x[f"K/{lev}"], x[f"inv_K/{lev}"], x["extrinsics"],
                 x["extrinsics_inv"])
        pairs = [(x[f"color_aug/{f if f < 0 else 0}/0"],
                  x[f"color_aug/{0 if f < 0 else f}/0"]) for f in ctx]
        # (cur, next, the number of context frames stacked in them)
        passes = [(c, n, 1) for c, n in pairs]
        if self.batch_pose_frames or len(ctx) < 2:
            passes = [(torch.cat([c for c, _ in pairs]),
                       torch.cat([n for _, n in pairs]), len(ctx))]
        if isinstance(self.pose_net, MonoPoseNet):
            # every camera alone: the cameras packed into the batch
            outs = [self._call(self.pose_net, self.pose_net,
                               pack_cam_feat(c), pack_cam_feat(n))
                    for c, n, _ in passes]
        elif rig is not None:
            # the net's halves, the cam-group sums between them outside
            # any checkpointed call
            outs = []
            for c, n, k in passes:
                feats_agg = self._call(self.pose_net,
                                       self.pose_net.encode_aggregate, c, n,
                                       n_ctx=k)
                feat, count = self._cam_group_backprojection(feats_agg, x)
                outs.append(self._call(
                    self.pose_net, self.pose_net.pose_from_backprojection,
                    feat, count, n_ctx=k, grouped=True))
        else:
            outs = [self._call(self.pose_net, self.pose_net, c, n, *calib,
                               n_ctx=k, plain=self.plain_samplers)
                    for c, n, k in passes]
        # per-frame passes stack group-major, as one batched pass returns
        return self._cam_t_cam(torch.cat([o[0] for o in outs]),
                               torch.cat([o[1] for o in outs]), x,
                               x["color_aug/0/0"].shape[0], rig)

    def predict_depth(self, x: Mapping[str, torch.Tensor],
                      extrinsics_aug: Optional[torch.Tensor] = None,
                      rig: Optional[Mapping[str, torch.Tensor]] = None
                      ) -> Dict[str, torch.Tensor]:
        """The depth net alone (JAX ``predict_depth``; a fusion net on its
        own back-projection, an fsm net on each camera alone): {'disp/{s}'
        [b, cams, h, w, 1]}, and a fusion net's 'disp/{s}/aug' where
        ``extrinsics_aug`` is given. Given the whole ``rig`` (the
        camera-axis grid's training forward), ``x`` holds this rank's
        cameras, and a fusion net completes its group sums over the cam
        group (``_cam_group_backprojection``)."""
        images = x["color_aug/0/0"]
        if isinstance(self.depth_net, MonoDepthNet):
            b, cams = images.shape[:2]
            out = self._call(self.depth_net, self.depth_net,
                             pack_cam_feat(images))
            return {k: unpack_cam_feat(v, b, cams) for k, v in out.items()}
        lev = self.fusion_level + 1
        if rig is not None:
            # the net's halves, the cam-group sums between them outside
            # any checkpointed call
            feats, feats_agg = self._call(
                self.depth_net, self.depth_net.encode_aggregate, images)
            feat, count = self._cam_group_backprojection(feats_agg, x)
            return self._call(
                self.depth_net, self.depth_net.decode_from_backprojection,
                feat, count, feats[:self.fusion_level], x[f"inv_K/{lev}"],
                x["extrinsics"], extrinsics_aug=extrinsics_aug, grouped=True,
                plain=self.plain_samplers)
        return self._call(self.depth_net, self.depth_net, images, x["mask"],
                          x[f"K/{lev}"], x[f"inv_K/{lev}"], x["extrinsics"],
                          x["extrinsics_inv"], extrinsics_aug=extrinsics_aug,
                          plain=self.plain_samplers)

    def _can_merge_backproject(self) -> bool:
        # an instance-level predict_pose override must keep routing through
        # predict_pose: the merged path would silently bypass it
        return (self.merge_backproject and "predict_pose" not in self.__dict__
                and isinstance(self.pose_net, FusedPoseNet)
                and isinstance(self.depth_net, FusedDepthNet)
                and (self.batch_pose_frames or len(self.frame_ids) <= 2))

    def _predict(self, x: Mapping[str, torch.Tensor],
                 aug_u: Optional[torch.Tensor] = None,
                 rig: Optional[Mapping[str, torch.Tensor]] = None):
        """(cam_T_cam, {scale: disp}, {scale: aug disp} or None, the rotated
        extrinsics or None) through the merged back-projection, or through
        each net's own where the two are not merged. ``aug_u`` (under
        ``aug_depth``) is the rotation's draw; a missing or misshapen one
        raises, as a missing noise does. Given the whole ``rig`` (the
        camera-axis grid's training forward), ``x`` holds this rank's
        cameras, ``aug_u`` the rig's draw (this rank's rows of it rotate its
        cameras), and cam_T_cam covers the rig."""
        ext_aug = None
        if self.aug_depth:
            shape = self.aug_shape(x if rig is None else rig)
            if aug_u is None or tuple(aug_u.shape) != shape:
                raise ValueError(f"aug_depth: aug_u must have shape {shape}")
            aug_u = local_cameras(torch.as_tensor(aug_u).to(self.device),
                                  None if rig is None else self.cam_grid,
                                  self.num_cams)
            ext_aug = augment_extrinsics(aug_u, x["extrinsics"],
                                         self.aug_angle)
        if self._can_merge_backproject():
            cam_t_cam, out = self._predict_pose_depth(x, ext_aug, rig)
        else:
            with span("vf.nets.pose"):
                cam_t_cam = self.predict_pose(x, rig)
            with span("vf.nets.depth"):
                out = self.predict_depth(x, ext_aug, rig)
        disps = {s: out[f"disp/{s}"] for s in self.scales}
        disps_aug = ({s: out[f"disp/{s}/aug"] for s in self.scales}
                     if self.aug_depth else None)
        return cam_t_cam, disps, disps_aug, ext_aug

    @torch.inference_mode()
    def predict(self, batch: Mapping, aug_u: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """Batch dict (NHWC numpy arrays or tensors, the JAX package's
        contract) -> {'cam_T_cam' [b, cams, n_ctx, 4, 4], 'disp/{s}',
        'depth/{s}' [b, cams, H, W, 1]} on this model's device. BatchNorm
        runs in eval mode. Under ``aug_depth`` ``aug_u`` (``aug_shape``,
        uniform in [0, 1)) draws the rotated views, and the outputs add
        ``disp/{s}/aug`` and ``depth/{s}/aug``, as JAX's
        ``forward(train=False)`` returns them."""
        lev = self.fusion_level + 1
        keys = {f"K/{lev}", f"inv_K/{lev}", "K/0", "mask", "extrinsics",
                "extrinsics_inv",
                *(f"color_aug/{f}/0" for f in self.frame_ids)}
        with span("vf.predict"):
            x = self._to_device(batch, keys)
            with self._bn_mode(False):
                cam_t_cam, disps, disps_aug, _ = self._predict(x, aug_u)
            outputs = {"cam_T_cam": cam_t_cam}
            for s in self.scales:
                outputs[f"disp/{s}"] = disps[s]
                outputs[f"depth/{s}"] = self.to_depth(disps[s], x["K/0"])
                if disps_aug is not None:
                    outputs[f"disp/{s}/aug"] = disps_aug[s]
                    outputs[f"depth/{s}/aug"] = self.to_depth(disps_aug[s],
                                                              x["K/0"])
        return outputs

    def noise_shape(self, batch: Mapping) -> Tuple[int, ...]:
        """Shape of ``forward``'s tie-break noise: [n_scales, b, cams,
        n_ctx, H, W, 1]."""
        b, cams, h, w = batch["color/0/0"].shape[:4]
        return (len(self.scales), b, cams, len(self.frame_ids) - 1, h, w, 1)

    def aug_shape(self, batch: Mapping) -> Tuple[int, ...]:
        """Shape of the depth-synthesis rotation's draw ``aug_u``: [b, cams,
        3]."""
        return tuple(batch["extrinsics"].shape[:2]) + (3,)

    def forward(self, batch: Mapping, step=None,
                noise: Optional[torch.Tensor] = None,
                aug_u: Optional[torch.Tensor] = None, train: bool = True,
                return_renders: bool = False):
        """The whole pipeline with the loss -> (outputs, loss, logs).

        With ``train`` BatchNorm runs in train mode (batch statistics,
        running statistics updated in place); without it in eval mode, on
        the running statistics, which stay as they are (JAX
        ``forward(train=False)``, the eval step's). ``step`` drives the
        cold-start schedule when the config sets one. ``noise`` [n_scales,
        b, cams, n_ctx, H, W, 1] (``noise_shape``) holds the standard
        normals of the identity-loss tie-break (the JAX package draws them
        from its key; see ``training/step.py train_step``); ``aug_u``
        [b, cams, 3] (``aug_shape``) the uniform draw of the rotated views
        under ``aug_depth`` (JAX draws it from the key's second split).
        ``return_renders`` adds the smallest scale's warped views and the
        reprojection map and mask to the outputs (``temporal_img`` /
        ``temporal_mask``, ``overlap_img`` / ``overlap_mask`` where the
        overlap losses are on, ``reproj_map`` / ``reproj_mask``), for the
        logger's image panels.

        Under the camera-axis grid (``shard_cameras``) the training forward
        takes this rank's cameras of ``batch`` as its targets: ``noise``
        then holds them only, and the outputs are theirs (``cam_T_cam``
        the rig's); the loss is the global one (``parallel/mesh.py``).
        """
        rig = self._to_device(batch)
        grid = self.cam_grid if train else None
        # the targets: this rank's cameras of every [b, cams, ...] array
        # (JAX's batch_sharding_2d rule), the whole rig without a grid
        x = {k: (local_cameras(v, grid, self.num_cams)
                 if v.dim() >= 2 and v.shape[1] == self.num_cams else v)
             for k, v in rig.items()}
        if noise is None or tuple(noise.shape) != self.noise_shape(x):
            raise ValueError(f"noise must have shape {self.noise_shape(x)}")
        with self._bn_mode(train):
            cam_t_all, disps, disps_aug, ext_aug = self._predict(
                x, aug_u, None if grid is None else rig)
        k0 = x["K/0"]
        depths = {s: self.to_depth(disps[s], k0) for s in self.scales}
        depths_aug = ({s: self.to_depth(disps_aug[s], k0)
                       for s in self.scales}
                      if disps_aug is not None else None)
        # the target cameras' poses and neighbour rows; the neighbours are
        # the rig's cameras
        with span("vf.geometry.poses"):
            spatio_pose, st_pose = relative_cam_poses(
                rig["extrinsics"], rig["extrinsics_inv"], cam_t_all,
                self.rel_cam)
        cam_t_cam, spatio_pose, st_pose = (
            local_cameras(t, grid, self.num_cams)
            for t in (cam_t_all, spatio_pose, st_pose))
        rel_cam = local_cameras(self.rel_cam, grid, self.num_cams, axis=0)
        # the warp sources in the compute dtype; the loss targets stay f32
        src_colors = {f: rig[f"color/{f}/0"].to(self.compute_dtype
                                                 or torch.float32)
                      for f in self.frame_ids}
        colors = {f: local_cameras(v, grid, self.num_cams)
                  for f, v in src_colors.items()}
        # under the grid the neighbours' side is the rig's
        src_k = None if grid is None else rig["K/0"]
        sources = ({} if grid is None else dict(
            src_colors=src_colors, src_mask=rig["mask"], src_k=src_k,
            src_inv_k=rig["inv_K/0"],
            first_cam=grid.local_cams(self.num_cams).start))
        # the 'actual' spatio-temporal windows follow each scale's depth:
        # one set from the finest scale's, or one per scale with several
        per_scale = self.st_window_mode == "actual" and len(self.scales) > 1
        windows = (None if per_scale else self._windows(
            x, spatio_pose, st_pose, depths[min(self.scales)], rel_cam,
            src_k))
        rendered, overflow = {}, None
        for s in self.scales:
            win = (self._windows(x, spatio_pose, st_pose, depths[s], rel_cam,
                                 src_k)
                   if per_scale else windows)
            if win is not None:
                overflow = (win.overflow if overflow is None
                            else torch.maximum(overflow, win.overflow))
            if grid is not None and self.aug_depth:
                # each camera's depth synthesis warps its neighbours'
                # depths: the rig's, gathered with their gradient
                sources["src_depth"] = gather_cameras(
                    depths[s], grid, self.num_cams, "cam_depths")
            with span("vf.geometry.render"):
                rendered[s] = render_views(
                    colors, x["mask"], k0, x["inv_K/0"], depths[s],
                    cam_t_cam, spatio_pose, st_pose, rel_cam, self.frame_ids,
                    do_intensity_align=self.intensity_align,
                    spatio=self.loss_cfg.spatio,
                    spatio_temporal=self.loss_cfg.spatio_temporal,
                    aug_depth=self.aug_depth, extrinsics=rig["extrinsics"],
                    extrinsics_aug=ext_aug,
                    depth_aug=depths_aug[s] if depths_aug else None,
                    min_depth=self.min_depth, max_depth=self.max_depth,
                    windows=win, plain=self.plain_samplers, **sources)
        with span("vf.losses"), global_batch(train), \
                camera_shard(grid, self.num_cams):
            loss, logs = total_loss(noise.to(self.device), self.loss_cfg, x,
                                    disps, depths, cam_t_all, rendered,
                                    disps_aug=disps_aug,
                                    depths_aug=depths_aug, step=step,
                                    rig=rig)
        if overflow is not None:
            # > 0: a window truncated its warp this step (JAX :697-701)
            logs["warp_window_overflow"] = overflow
        outputs = {"cam_T_cam": cam_t_all}
        for s in self.scales:
            outputs[f"disp/{s}"] = disps[s]
            outputs[f"depth/{s}"] = depths[s]
            if disps_aug is not None:
                outputs[f"disp/{s}/aug"] = disps_aug[s]
                outputs[f"depth/{s}/aug"] = depths_aug[s]
        if return_renders:
            r0 = rendered[min(self.scales)]
            outputs["temporal_img"] = r0.temporal_img
            outputs["temporal_mask"] = r0.temporal_mask
            if r0.overlap_img is not None:
                outputs["overlap_img"] = r0.overlap_img
                outputs["overlap_mask"] = r0.overlap_mask
            outputs["reproj_map"] = logs["reproj_map"]
            outputs["reproj_mask"] = logs["reproj_mask"]
        return outputs, loss, logs
