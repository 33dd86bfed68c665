#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``vfdepth_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (the kernels build from ``csrc/`` here, at
first use); exits non-zero, printing no result, without them or outside a
checkout of the repository. Imports nothing of JAX or ``vfdepth_tpu``.

Phases (any failure exits non-zero):
 1. device: the card's name and power limit;
 2. build: the five CUDA sources (one nvcc each, in parallel), with nvcc's
    register report;
 3. each kernel against its plain PyTorch version at the main paths'
    shapes, plus special inputs: K1 (grouped raw back-projection, 6-camera
    serving shapes) and K2 (its backward, training shapes): points behind
    the camera, out of the image, non-finite, at near-zero depth, a crowd
    of 3000 points on one pixel of every camera, N not a multiple of the
    tile, cotangent rows that no camera may read set to NaN; K1 again with
    normalised coordinates; K3 (trilinear frustum
    sampler) and K4 (its backward): the real frustum coordinates plus
    out-of-range and non-finite ones; K5 (image + mask warp):
    temporal-warp coordinates plus non-finite, huge finite and border
    ones, and its autograd coordinate gradient; K1b (the per-camera
    sampler, 3-camera serving shapes) in its raw back-projection mode and
    its three normalised modes, with the same special inputs and exact
    nearest-pick ties (fraction 0.5); K2b (its backward, 3-camera training
    shapes) gated, with the rows of invalid points NaN, and ungated. Each
    of the seven backward forms (K2, K2b, K4 and their bf16 forms: K2-,
    K2b-bf16, K4 with f32 updates of a bf16 cotangent, K4 with bf16
    updates) builds its destination-tile plan on the card, which must equal
    the plain plan element for element, with a hot tile cut in chunks, and
    two launches must give the same bits;
 4. timing with CUDA events (warm-up, then the median of 20 runs) of each
    kernel, its plain version and a PyTorch yardstick the port never calls
    (K1, K1b: 2-D ``F.grid_sample`` on the same points, which computes
    less; K2, K2b: its autograd input gradient; K3: 5-D ``F.grid_sample``;
    K4: the autograd backward of 5-D ``F.grid_sample`` with respect to its
    input; K5: 2-D ``F.grid_sample`` on the RGB), beside the bound: bytes
    over 3.35 TB/s or f32 operations over 67 TFLOP/s, whichever is larger,
    counted from this run's inputs; the backward forms' two stages (plan,
    reduce) are timed apart beside the whole call; K1, K1b, K3 and their
    bf16 forms also a call at a time over 20 calls issued back to back
    (``stream_ms``: without the wrapper's host time; K5's too, on the
    step's coordinates below);
 5. the bf16 forms (mixed precision) against their plain versions with the
    same special inputs, then timed beside their bounds and bf16
    yardsticks: K1-, K2-, K3-, K5-bf16 and K4's bf16-update form at the
    6-camera shapes, K1b-bf16 (four modes, and raw mode at the unmerged
    nets' 512 and 256 channels: odd bf16 rows of 769, 513 and 257 values)
    and K2b-bf16 (gated and ungated) at the 3-camera shapes, K4's
    f32-update form on a bf16 cotangent at the 6-camera training shapes;
 6. each path below at full width with seeded random weights, the launch
    counts set to 0 just before each path and read just after, for
    ``configs/ddad/ddad_surround_fusion.yaml`` (6 cameras, ``FakeDataset``'s
    even rig) and for the 3-camera front rig (``presets.build_config(
    cameras=DDAD_CAM_LIST[:3])``, its "nuscenes" rig), each in f32 and in
    bf16 (``mixed_precision=True``):
    serving: 3 requests (one frameset with its -1/+1 context frames each)
    through ``VFDepthModel.predict``; checks shapes, finiteness, the metric
    depth range, launches per request (6 cameras: K1 1, K3 1; 3 cameras:
    K1b 1, K3 1; their bf16 forms in bf16), and request 1 against the same
    model run with the plain versions; one more request under
    ``torch.profiler``;
    unmerged request: request 1 with ``merge_backprojection`` off (each
    net back-projects its own features: K1 or K1b twice), held against the
    merged output;
    training: batch 2 (the config's): one warm-up step, then 3 timed steps
    through ``train_step`` (forward, loss, backward, Adam); checks a finite
    loss, finite gradients non-zero in both nets, moved parameters and
    BatchNorm statistics, and launches per step (K1 or K1b 1, K2 or K2b 1,
    K3 1, K4 1, K5 4, in their bf16 forms in bf16); step 1 again from the
    same state with the plain versions (loss and every gradient within
    stated tolerances); one more step under ``torch.profiler``; on the
    6-camera rig (f32 and bf16) K5's 4 calls of the warm-up step are
    captured, checked against the plain version and timed: K5's row then
    holds those times (the coordinates of a real step), its random-depth
    input as ``stress_ms``;
    then the 6-camera bf16 model with ``sampler_3d: packed_f32grad``
    (training: K4's f32-update form on the bf16 cotangent once a step, its
    bf16-update form never) and the 6-camera f32 model with
    ``batch_pose_frames: false`` (one pose-net pass per context frame:
    serving at K1 3, K3 1 a request, training at K1 3, K2 3, K3 1, K4 1,
    K5 4 a step);
 7. the data feed: ``device_prefetch`` (pinned, non-blocking copies on a
    side stream) against the pageable route over 50 full-width batch-2
    training batches, bit for bit, in two passes: one batch ahead, read as
    soon as yielded (a missing ``wait_event`` shows), and two ahead,
    behind device work longer than the next batch's upload (a missing
    ``record_stream`` shows);
 8. evaluation of the 6-camera model, f32 and bf16: the seeded model saved
    with ``save_checkpoint``, then ``Trainer.evaluate`` loads it
    (``models_to_load`` from the config) into a model of other weights and
    scores 2 batches of ``eval_batch_size`` 4 (``FakeDataset(with_depth=
    True)``, even rig); checks the loaded nets, finite metrics, launches a
    batch (K1 1, K3 1, K5 0; their bf16 forms in bf16), batch 1's
    ``depth/0`` against the plain versions (``FWD_RTOL`` /
    ``BF16_FWD_RTOL``) and the metrics against a plain evaluation; one
    more batch under ``torch.profiler``;
 9. the trainer: ``Trainer.learn`` on the 6-camera f32 model, 2 epochs of 3
    batch-2 steps from a shuffled ``BatchLoader`` through
    ``device_prefetch``, validation at steps 0, 2, 4, ``weights_0`` and
    ``weights_1`` saved; checks finite losses, launches a step (K1 1, K2 1,
    K3 1, K4 1, K5 4) and a validation (K1 1, K3 1, K5 4), and that
    ``weights_1`` reloaded into a fresh model and optimizer on the card and
    on the CPU holds the live parameters, BatchNorm statistics and Adam
    state bit for bit; the loop's ms a step is its wall time less the
    validations and checkpoint writes (its steps are not synchronised, so
    the next batch's pinning overlaps the device's work as it would); then
    one step under ``torch.profiler`` with the pinned prefetch and one with
    the pageable route (their ``Memcpy HtoD`` device time), and one batch's
    upload alone through the pageable route and through
    ``device_prefetch`` (host clock);
10. the command lines: ``python3 -m vfdepth_tpu_torch.train`` (2 steps of
    ``configs/tiny_fake.yaml``, its ``log_dir`` moved to a temporary
    directory) and ``python3 -m vfdepth_tpu_torch.eval`` on the
    ``weights_0`` it wrote, both on the card, both exiting 0, eval printing
    its metric and median lines;
11. the fsm (Monodepth2) baseline at full width (``fsm_config``:
    ``presets.build_config`` with the DDAD rig, 6 cameras at 384x640,
    ``depth_model`` / ``pose_model`` fsm, ``ddad_baseline.yaml``'s loss),
    f32 and bf16: 3 requests (no kernel: no voxel volume), 3 training
    steps at batch 2 (K5 or K5-bf16 4 a step; step 1 against the plain
    versions; K5's 4 calls of the warm-up step against the plain warp and
    timed), ``Trainer.learn`` (2 epochs of 2 steps, validation at steps 0
    and 2, a checkpoint an epoch; K5 4 a step and a validation) and
    ``Trainer.evaluate`` of ``weights_1`` with ``models_to_load:
    [depth_net]`` into a model of other weights (the depth net loaded, the
    pose net not; no kernel; metrics against a plain evaluation);
12. the host pipeline at DDAD's native 1216x1936, no decode: the native
    resize of 18 frames (uint8 and f32) to 384x640 against a numpy float64
    bilinear of the same rule, the LiDAR projection of a 120,000-point
    sweep into 6 cameras, ``assemble_sample`` with the train-mode jitter,
    each timed, and one batch of two assembled samples through a fsm
    training step; then, where PIL is installed (else one line says it is
    not), the readers: a DGP fixture (a train scene of 4 and a val scene
    of 3 samples x 6 cameras at 1216x1936, PNG, LiDAR sweeps) and a
    nuScenes one (3 samples x 3 sweeps x 6 cameras at 900x1600, JPEG)
    written to a temporary directory; per dataset one sample's host work
    timed in train mode and in val mode (LiDAR depth uncached) and one
    image's decode; each read through ``construct_dataset`` ->
    ``BatchLoader`` -> ``device_prefetch`` by the published fusion and fsm
    configs (``configs/{ddad,nuscenes}/*_surround_fusion.yaml``,
    ``*_baseline.yaml``, the fixture's path and the repository's masks) for
    2 training steps each (launches checked, the rig read back);
13. depth synthesis (``configs/ddad/ddad_surround_fusion_augdepth.yaml``:
    the production fusion model with ``aug_depth``, ``aug_angle`` (15, 15,
    40) acting as radians, so each camera's rotated view looks in a
    near-random direction), run after the unbatched pose frames of 6: 3
    f32 requests (each with its seeded rotated-view draw; K1 1, K3 2 a
    request: the volume decoded along the main and the rotated frusta;
    ``disp/0/aug`` and ``depth/0/aug`` checked and held against the plain
    versions with the rest) and one unmerged request (K1 2, K3 2); 3 f32
    steps at batch 2 (K1 1, K2 1, K3 2, K4 2, K5 4; step 1 against the
    plain versions, the depth-synthesis logs too); K3 and K4 on the
    coordinates that the warm-up step handed them, the main and the
    rotated frusta apart (``check_rotated_frusta``: the share of points
    inside the volume, K4's plan against the plain plan with its live
    points and hottest tile, each kernel against its plain version and
    timed alone and 20 back to back; the ``rotated`` and ``step_main``
    entries of the K3 and K4 rows); the same request and step in bf16
    (K1-, K3-bf16 2, K2-bf16, K4's bf16-update form 2, K5-bf16 4) and a
    bf16 step with ``packed_f32grad`` (K4's f32-update form 2); after
    the trainer of 9, ``Trainer.evaluate`` with ``syn_visualize`` at the
    eval batch 4 (batch ``SYN_IDX`` swept: ``fuse_voxel`` then all 767
    views, one K3 launch a view, every view written as a syn image; the
    first view and one of each later segment of the sweep against the
    plain versions); and, after the command lines of 10,
    both command lines again on tiny_fake.yaml with ``aug_depth`` and the
    sweep on (767 syn images written);
14. the last model options: ``sampler_3d: gather`` under mixed precision
    on the 6-camera rig (3 requests: K1-bf16 1 and the gather-bf16
    forward 1 a request, an unmerged request; 3 steps: K1-, K2-bf16 1,
    the gather-bf16 forward and backward 1, K5-bf16 4 a step), then both
    gather-bf16 forms on the warm-up step's own volume, coordinates and
    cotangent (``check_gather_forms``: bit for bit against their plain
    versions, two launches bit-identical, the backward's plan against the
    plain plan; timed beside their bounds and 5-D ``F.grid_sample`` in
    bf16 and its autograd backward; rows "K3-gather-bf16" and
    "K4-gather-bf16", counterparts of JAX's XLA gather and scatter, not of
    TPU kernels); ``tpu.remat`` (``run_remat``: the 6-camera batch-2 step
    in f32 with remat False, 'all', 'depth_net', 'pose_net' and in bf16
    with False and 'all', each held against the remat-False step and
    timed 3 times with its peak device memory, K3 twice a step where the
    depth net is rematerialised; the f32 peaks at batch 4 for False and
    'all'; a ``{"remat": [...]}`` line); and, before the evaluation of 8,
    ``weights_init`` (``run_weights_init``: ``ddad_surround_fusion.yaml``
    and ``ddad_baseline.yaml`` with ``VFDEPTH_RESNET_WEIGHTS`` naming a
    seeded synthetic torchvision ResNet-18 ``.pth``: every encoder tensor
    against the file, one request and one step from each);
15. the warp windows (``tpu.warp_window``, the JAX package's default),
    after the gather paths of 14: the 6-camera step on ``FakeDataset``'s
    "nuscenes" rig (thin overlap strips, so the windows engage) in f32 and
    bf16 at batch 2 (``focal_length_scale`` 100, so that the random init's
    depths put pixels in the overlaps) and in bf16 at batch 1 (the bench's
    cell, the production scale 300), the windows
    sized by ``create_train_state`` from the first batch and the dataset's
    rigs (their sizes, the origins' range and the overflow printed); K5 on
    the warm-up step's three windowed calls (both slots' pixels in one
    launch) against its plain version, timed beside its bound (the K5 /
    K5-bf16 row's ``window`` entry); 3 windowed steps (K5 4 a step) and,
    from the same state and batches, 3 dense ones, step 1 held windowed
    against dense where the overflow is 0 (loss and every gradient); a
    profiled windowed step; a forced overflow (boxes of
    ``WINDOW_FORCED_HW``) through ``Trainer.learn``: two checkpoints with
    ``warp_window_overflow`` > 0, then the fall-back to dense warps; and
    ``python -m vfdepth_tpu_torch.bench`` with ``BENCH_STEPS=3``, its JSON
    line checked for the root bench's keys and finite values. The reader
    paths of 12 size the windows as ``Trainer.learn`` does and say whether
    they engage on the fixtures' rig.
16. data parallelism (``vfdepth_tpu_torch/parallel/``), after the windows
    of 15: ``python -m vfdepth_tpu_torch.train`` as ``torch.distributed.run``
    starts a world of one (RANK 0, WORLD_SIZE 1, LOCAL_RANK 0, MASTER_ADDR /
    MASTER_PORT on localhost) on ``configs/ddad/ddad_surround_fusion_ddp.yaml``
    at full width on ``FakeDataset`` (its encoders from a seeded synthetic
    ResNet-18 file), 2 steps: it must join an NCCL group, go through the
    global BatchNorm, the global loss and the gradient average (its
    collectives line), write ``weights_0`` and build no kernel; then two
    ranks sharing the card over gloo (NCCL refuses two ranks on one
    device), spawned with a ``FileStore``, each cell of ``DP_CELLS`` (the
    6-camera f32 step; the bench's cell: bf16, "nuscenes" rig, windows
    sized over the global first batch) at batch 1 a rank from a carried
    Adam state, held against one process's step at batch 2 from the same
    weights, global batch and global noise: loss and logs within the step
    tolerance, each gradient, parameter update and BatchNorm statistic
    within the gradient tolerance (relative L2), the ranks' states bit
    for bit, each rank's launches a step equal to one process's, the
    windows equal; each rank's step time is printed as two ranks
    time-sharing one card (no data-parallel speed). Then the camera-axis
    grids (``CAM_WORLDS``), each cell held so against the same
    single-process step: (1, 2) on those cells and on every training
    option (``CAM_OPTION_CELLS``, f32: the production yaml unmerged and
    with unbatched pose frames, the fsm baseline, the augdepth yaml), and
    (2, 2) on the bench's cell, each rank launching per camera (K1b / K2b)
    what one process launches grouped, with the cell's cam-group
    collectives by site.
TF32 is off for every phase (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32``): the f32 comparisons must see
only the kernels' differences.

Output: progress lines, then a ``{"kernels": [...]}`` JSON line, the
``nvidia-smi`` name/power line, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "ddad" / "ddad_surround_fusion.yaml"
AUG_CONFIG = ROOT / "configs" / "ddad" / "ddad_surround_fusion_augdepth.yaml"
AUG_LOGS = ("depth_con_loss", "depth_sm_loss", "depth_loss")
SYN_IDX = 1            # the swept eval batch (the yaml's 102 is a DDAD index)
SWEEP_VIEWS = 767      # aug_depth_params' scripted views
# the views held against the plain versions: the first, then one of each
# segment (roll 10 deg, pitch 5 deg, the focal morph's end, yaw 90 and
# 180 deg, where camera 0's decode turns furthest from its own frustum)
SWEEP_CHECK_VIEWS = (0, 38, 177, 355, 497, 587)
N_REQUESTS = 3
N_STEPS = 3
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
K1_TOL = 1e-4                  # x max|feat|: fma contraction, sums in order
K3_TOL = 1e-5                  # x max|vol|: 8-term dot, fma contraction
# the backward kernels sum each output in their plan's fixed order, the
# plain versions in another (tap planes, or one index_add_ per tap): an f32
# sum of n terms in another order differs by up to ~n * 2^-24 of its
# largest partial sum (n is ~34 for K2 and ~46 for K4 on average, a few
# hundred at most), so 2e-5 bounded the atomic kernels, whose order changed
# from run to run. The order is fixed now, and so is the difference on
# these seeded inputs: at most 2.5e-6 (K2, K2b) and 1.1e-6 (K4) of the
# largest output in every run of the tiled kernels; the bounds keep a
# margin of 2 (K2) and 4 (K4) above that
K2_TOL = 5e-6                  # x max|dfeat|
K4_TOL = 4e-6                  # x max|dvol|
K5_TOL = 1e-6                  # absolute: 4-tap sums of [0, 1] inputs, fma
K5_GRAD_TOL = 1e-5             # x max|dcoords|: the same dot of ddx / ddy
FWD_RTOL = 1e-4                # whole forward, kernels vs plain, x max|out|
POSE_ATOL = 1e-5
# training step 1, kernels vs plain versions, from the same state and batch:
# the forward differs by fma contraction (~1e-7 relative), the backward by
# its summation order. The auto-mask is a discrete comparison of two
# photometric losses, which SSIM makes sensitive to ~1e-6 input changes; at
# a random init the pose is ~0, every temporal warp is near the identity
# and the two losses tie to within the 1e-5 tie-break noise, so tens of the
# 2.9M pixels flip between two f32 evaluations. Each flip moves the masked
# mean by ~1e-5 of the loss and a gradient (a sum over pixels that largely
# cancels for the pose net) by up to ~1% in relative L2 norm
# (tests/test_torch_train_step.py measures the same effect against JAX)
STEP_LOSS_RTOL = 1e-3
STEP_GRAD_RTOL = 3e-2          # relative L2 norm, per parameter
# bf16 forms against their plain versions: both compute in f32 and round
# each output once to bf16, so an f32 difference of a few ulp can move an
# output by one bf16 step (2^-7 of the largest magnitude); K2's f32 sums
# add their own order (K2_TOL) before the rounding
BF16_STEP = 2.0 ** -7
# K4's bf16-update form rounds every addition of a tap plane to bf16 (in
# plan order; the plain version's index_add_ accumulates in f32): a
# running bf16 sum of k random-sign terms drifts by ~2^-9 sqrt(k / 3) of
# its size; the production frustum gives its plane entries 6.6 additions on
# average and 625 at most (JAX's sequential bf16 scatter on these points,
# on the CPU: cosine 0.99997, relative L2 7.7e-3 against f32 updates). The
# tiled kernel's fixed order measured cosine >= 0.99997 and relative L2 <=
# 7.5e-3 on the card in every run (against the plain version and against
# the f32 K4); the bounds keep a margin of 3 in 1 - cosine and 2 in the
# relative L2 (they were 0.9995 and 3e-2 for the atomic kernel)
K4_BF16_MIN_COS = 0.9999
K4_BF16_MAX_REL = 1.5e-2
# the bf16 model, kernels against plain versions: the kernels' one-step
# differences flip a few bf16 roundings, and every later bf16 layer spreads
# them (two bf16 runs of the same model part the way a bf16 run parts from
# an f32 one; tests/test_torch_mixed_model.py measures it against JAX on
# the CPU: disparity 7e-4 relative L2, gradients ~20% in all, up to 36%
# for one parameter)
BF16_FWD_RTOL = 2e-2           # x max|out|
BF16_POSE_ATOL = 1e-3
BF16_STEP_LOSS_RTOL = 1e-2
BF16_STEP_GRAD_RTOL = 0.5      # relative L2 norm, per parameter


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median over ``reps`` runs of ``fn`` timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def stream_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """``fn``'s time a call over ``reps`` calls issued back to back between
    two CUDA events: the host's per-call work (argument checks, the output
    allocation, the launch) overlaps the previous call's kernel, where
    ``time_ms``, which times each call alone, counts it."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profiler_ms(fn, name: str, reps: int = 10) -> float:
    """Device time a call of the kernels whose name holds ``name``, read by
    ``torch.profiler`` over ``reps`` calls of ``fn`` after one warm-up
    call: the kernels alone, without the gaps a CUDA event pair around a
    call also counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and name in e.key)
    check(us > 0, f"the profiler saw no device time of {name}")
    return us / reps / 1e3


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def k1_inputs(cfg, device, gen, special: bool, batch: int = 1):
    """Main-path K1 inputs: merged pose+depth features [6*batch, 48, 80,
    768], a random 0/1 low-res mask with holes, and the fake rig's voxel
    points through the port's ``_project_cam_points`` (cameras group-major,
    the same rig for every frameset). ``special`` appends points that are
    behind the camera, out of the image, non-finite or at near-zero depth,
    and a crowd on one pixel (``hot_points``; N is then odd and not a
    multiple of the kernel's 32-point tile)."""
    from vfdepth_tpu_torch.data import FakeDataset
    from vfdepth_tpu_torch.models.vfnet import _project_cam_points

    lev = cfg.fusion_level
    h, w = cfg.height // 2 ** (lev + 1), cfg.width // 2 ** (lev + 1)
    c = 3 * cfg.fusion_feat_in_dim          # pose (2 context pairs) + depth
    ds = FakeDataset(num_samples=1, height=cfg.height, width=cfg.width,
                     fusion_level=lev)
    sample = ds.batch([0])
    g1, g2 = cfg.overlap_groups
    order = list(g1) + list(g2)
    k = torch.from_numpy(sample[f"K/{lev + 1}"][:, order]).to(device)
    ext_inv = torch.from_numpy(sample["extrinsics_inv"][:, order]).to(device)
    ones = torch.ones(1, len(order), cfg.height, cfg.width, 1, device=device)
    cam3, _ = _project_cam_points(
        ones, k, ext_inv, h, w, voxel_str_p=tuple(cfg.voxel_str_p),
        voxel_unit_size=tuple(cfg.voxel_unit_size),
        voxel_size=tuple(cfg.voxel_size))
    cam3 = cam3[0]
    cams = cam3.shape[0]
    if special:
        extra = torch.rand(cams, 37, 3, generator=gen).to(device) * 50.0
        extra[:, 0:5, 2] *= -1.0                 # behind the camera
        extra[:, 5:10, 0] += 1e4                 # right of the image
        extra[:, 10:13, 0] = float("nan")
        extra[:, 13:16, 1] = float("inf")
        extra[:, 16:18, 2] = float("nan")
        extra[:, 18:20, 2] = 1e30                # far away: projects to (0, 0)
        extra[:, 20:23, 2] = 1e-9                # near-zero depth
        cam3 = torch.cat([cam3, extra, hot_points(cams, h, w, gen, device)],
                         dim=1)
    cam3 = cam3.repeat(batch, 1, 1)
    cams = cam3.shape[0]
    feats = torch.randn(cams, h, w, c, generator=gen).to(device)
    mask = (torch.rand(cams, h, w, generator=gen) > 0.15).float().to(device)
    mask[:, h // 3:h // 2, w // 4:w // 3] = 0.0   # a hole, as a car body
    open_hot_pixel(mask)
    return feats, mask, cam3.contiguous(), 1.0 / cfg.voxel_size[0], len(g1)


HOT_COUNT = 3000               # points of the special inputs' crowd


def hot_pixel(h: int, w: int):
    """(x, y) of the special inputs' crowd: (41, 20) on the 48 x 80 maps,
    inside one 4 x 4 tile of K2's plan."""
    return w // 2 + 1, max(h // 2 - 4, 0)


def hot_points(cams: int, h: int, w: int, gen, device):
    """HOT_COUNT camera-plane points per camera whose pixels lie within 0.2
    of ``hot_pixel`` + 0.3 (a list longer than the backward plan's chunk:
    the hot tile is cut), at depths 5-6."""
    x, y = hot_pixel(h, w)
    z = 5.0 + torch.rand(cams, HOT_COUNT, 1, generator=gen)
    pix = torch.tensor([x + 0.3, y + 0.3]) + 0.2 * torch.rand(
        cams, HOT_COUNT, 2, generator=gen)
    return torch.cat([pix * z, z], dim=-1).to(device)


def open_hot_pixel(mask):
    """The mask [cams, h, w] set to 1 around the crowd's pixels."""
    x, y = hot_pixel(*mask.shape[1:])
    mask[:, y:y + 2, x:x + 2] = 1.0


def k3_inputs(cfg, device, gen, special: bool, batch: int = 1):
    """Main-path K3 inputs: a [batch, 100, 100, 20, 64] yxz volume and the
    fake rig's frustum coordinates (6 cams x 48x80 px x 50 bins per
    frameset) from the port's ``VFNet.frustum_coords``; ``special`` appends
    out-of-range and non-finite coordinates."""
    from vfdepth_tpu_torch.data import FakeDataset
    from vfdepth_tpu_torch.models.vfnet import VFNet

    lev = cfg.fusion_level
    net = VFNet(cfg.fusion_feat_in_dim, 128, "depth",
                voxel_str_p=tuple(cfg.voxel_str_p),
                voxel_unit_size=tuple(cfg.voxel_unit_size),
                voxel_size=tuple(cfg.voxel_size),
                voxel_pre_dim=tuple(cfg.voxel_pre_dim),
                proj_d_bins=cfg.proj_d_bins, proj_d_str=cfg.proj_d_str,
                proj_d_end=cfg.proj_d_end, num_cams=cfg.num_cams,
                fusion_level=lev, height=cfg.height, width=cfg.width)
    sample = FakeDataset(num_samples=1, height=cfg.height, width=cfg.width,
                         fusion_level=lev).batch([0])
    coords = net.frustum_coords(
        torch.from_numpy(sample[f"inv_K/{lev + 1}"]).to(device),
        torch.from_numpy(sample["extrinsics"]).to(device))
    if special:
        extra = (torch.rand(1, 41, 3, generator=gen).to(device) - 0.5) * 8.0
        extra[0, 0:3, 0] = float("nan")
        extra[0, 3:6, 1] = float("inf")
        extra[0, 6:9, 2] = float("-inf")
        extra[0, 9:12] = torch.tensor([-1.0, 1.0, -1.0], device=device)
        extra[0, 12:15] = torch.tensor([1.0, 1.0, 1.0], device=device)
        extra[0, 15] = torch.tensor([3e9, -3e9, 0.0], device=device)
        coords = torch.cat([coords, extra], dim=1)
    vx, vy, vz = cfg.voxel_size
    vol = torch.randn(batch, vy, vx, vz, cfg.voxel_pre_dim[-1],
                      generator=gen).to(device)
    return vol, coords.repeat(batch, 1, 1).contiguous()


def k5_inputs(cfg, device, gen, special: bool):
    """Main-path K5 inputs, one call's worth (the temporal warps of a batch
    of 2): the fake rig's -1/+1 frames [24, 384, 640, 3], its mask with a
    hole, and the coordinates ``project_coords`` gives for a random depth in
    [2, 50] m and a random ego-motion (~0.5 m, ~0.01 rad). ``special``
    appends non-finite, huge finite and border coordinates."""
    from vfdepth_tpu_torch.data import FakeDataset
    from vfdepth_tpu_torch.geometry import project_coords, vec_to_matrix

    b, h, w = cfg.batch_size, cfg.height, cfg.width
    sample = FakeDataset(num_samples=b, height=h, width=w,
                         fusion_level=cfg.fusion_level).batch(range(b))
    ctx = [f for f in cfg.frame_ids if f != 0]
    img = torch.stack([torch.from_numpy(sample[f"color/{f}/0"]).to(device)
                       for f in ctx], dim=2)             # [b, cams, 2, ...]
    cams = img.shape[1]
    mask = torch.ones(b, cams, len(ctx), h, w, 1, device=device)
    mask[..., h // 2:, w // 3:w // 2, :] = 0.0          # a car body
    depth = (torch.rand(b, cams, len(ctx), h, w, 1, generator=gen) * 48.0
             + 2.0).to(device)
    rot = (torch.randn(b, cams, len(ctx), 3, generator=gen) * 0.01).to(device)
    tr = (torch.randn(b, cams, len(ctx), 3, generator=gen) * 0.5).to(device)
    k = torch.from_numpy(sample["K/0"]).to(device)[:, :, None].expand(
        b, cams, len(ctx), 4, 4)
    ik = torch.from_numpy(sample["inv_K/0"]).to(device)[:, :, None].expand(
        b, cams, len(ctx), 4, 4)
    coords = project_coords(depth, vec_to_matrix(rot, tr), ik, k)
    n_warps = b * cams * len(ctx)
    coords = coords.reshape(n_warps, h * w, 2)
    if special:
        extra = (torch.rand(n_warps, 37, 2, generator=gen).to(device) - 0.5) * 3
        extra[:, 0:3, 0] = float("nan")
        extra[:, 3:6, 1] = float("inf")
        extra[:, 6:9, 0] = 3e30                  # huge but finite
        extra[:, 9:12, 1] = -3e30
        extra[:, 12:14] = 1.0
        extra[:, 14:16] = -1.0
        coords = torch.cat([coords, extra], dim=1)
    return (img.reshape(n_warps, h, w, 3).contiguous(),
            mask.reshape(n_warps, h, w, 1).contiguous(), coords.contiguous())


def check_k1(cfg, device, gen):
    from vfdepth_tpu_torch.ops.backproject_sample import (
        backproject_grouped, backproject_grouped_plain)
    feats, mask, cam3, rel_scale, gs = k1_inputs(cfg, device, gen, True)
    out, valid = backproject_grouped(feats, mask, cam3, rel_scale, 1, gs)
    ref, ref_valid = backproject_grouped_plain(feats, mask, cam3,
                                                   rel_scale, 1, gs)
    torch.cuda.synchronize()
    check(torch.equal(valid, ref_valid), "K1 per-camera validity differs")
    check(torch.equal(out[..., -1], ref[..., -1]), "K1 counts differ")
    check(bool(torch.isfinite(out).all()), "K1 output not finite")
    err = (out - ref).abs().max().item()
    tol = K1_TOL * feats.abs().max().item()
    n_valid = int(valid.sum().item())
    print(f"K1 check: N={cam3.shape[1]} max_abs_err={err:.3e} (tol {tol:.3e})"
          f" valid camera-points={n_valid}", flush=True)
    check(err <= tol, f"K1 differs from its plain version: {err} > {tol}")
    check(0 < n_valid < valid.numel(), "K1 validity is degenerate")
    return err


def check_k3(cfg, device, gen):
    from vfdepth_tpu_torch.ops.sample3d import (sample3d_trilinear,
                                                sample3d_trilinear_plain)
    vol, coords = k3_inputs(cfg, device, gen, True)
    out = sample3d_trilinear(vol, coords)
    ref = sample3d_trilinear_plain(vol, coords)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "K3 output not finite")
    err = (out - ref).abs().max().item()
    tol = K3_TOL * vol.abs().max().item()
    print(f"K3 check: N={coords.shape[1]} max_abs_err={err:.3e} "
          f"(tol {tol:.3e})", flush=True)
    check(err <= tol, f"K3 differs from its plain version: {err} > {tol}")
    return err


def k2_inputs(cfg, device, gen, special: bool):
    """K2 at the training path's shapes (batch 2): K1's inputs, its
    per-camera validity from the kernel, and a random cotangent [2, 2, N,
    770] whose rows no camera of their group sees are NaN (the kernel must
    not read them)."""
    from vfdepth_tpu_torch.ops.backproject_sample import backproject_grouped
    b = cfg.batch_size
    feats, mask, cam3, rel_scale, gs = k1_inputs(cfg, device, gen, special,
                                                 batch=b)
    _, valid = backproject_grouped(feats, mask, cam3, rel_scale, b, gs)
    n, c = cam3.shape[1], feats.shape[-1]
    g = torch.randn(b, 2, n, c + 2, generator=gen).to(device)
    seen = valid.reshape(b, 2, gs, n).amax(dim=2) > 0
    g = torch.where(seen[..., None], g, float("nan"))
    return g, cam3, valid, feats.shape[1], feats.shape[2], c, gs, seen


def check_backward_plan(form: str, plan, plain_plan, run):
    """A redesigned backward form at production shapes: its plan built on
    the card equals the plain plan element for element, some tile is cut in
    chunks (the special inputs' crowd, or the frustum's hot columns), and
    two launches of the whole call give the same bits. Returns the first
    launch's output."""
    for name, got in plan.fields().items():
        want = plain_plan.fields()[name]
        check(got.shape == want.shape and torch.equal(got, want.to(
            got.device)), f"{form}: the card's plan differs from the plain "
                          f"plan in {name}")
    chunks = plan.chunk_off[1:] - plan.chunk_off[:-1]
    cut = int((chunks > 1).sum())
    check(cut > 0, f"{form}: no tile was cut in chunks")
    out = run()
    again = run()
    torch.cuda.synchronize()
    check(torch.equal(out, again), f"{form}: two launches differ")
    print(f"{form} plan: {int(plan.start[-1])} live of {plan.order.numel()}"
          f" contributions, {len(chunks)} tiles, chunk "
          f"{int(plan.params[0])}, {cut} tiles cut (up to "
          f"{int(chunks.max())} chunks, {int(plan.params[1])} of "
          f"{len(chunks) // 2 + 16} scratch slots); equal to the plain plan; "
          f"two launches bit-identical",
          flush=True)
    return out


def check_k2(cfg, device, gen):
    from vfdepth_tpu_torch.ops.backproject_sample import (
        backproject_bwd_plan, backproject_bwd_plan_plain,
        backproject_grouped_bwd, backproject_grouped_bwd_plain)
    g, cam3, valid, h, w, c, gs, _ = k2_inputs(cfg, device, gen, True)
    out = check_backward_plan(
        "K2", backproject_bwd_plan(cam3, valid, h, w),
        backproject_bwd_plan_plain(cam3, valid, h, w),
        lambda: backproject_grouped_bwd(g, cam3, valid, h, w, c, gs))
    ref = backproject_grouped_bwd_plain(g, cam3, valid, h, w, c, gs)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "K2 output not finite")
    err = (out - ref).abs().max().item()
    tol = K2_TOL * ref.abs().max().item()
    print(f"K2 check: g {list(g.shape)} max_abs_err={err:.3e} (tol "
          f"{tol:.3e})", flush=True)
    check(err <= tol, f"K2 differs from its plain version: {err} > {tol}")
    return err


def check_k4(cfg, device, gen):
    from vfdepth_tpu_torch.ops.sample3d import (sample3d_bwd_plan,
                                                sample3d_bwd_plan_plain,
                                                sample3d_trilinear_bwd,
                                                sample3d_trilinear_bwd_plain)
    vol, coords = k3_inputs(cfg, device, gen, True, batch=cfg.batch_size)
    g = torch.randn(vol.shape[0], coords.shape[1], vol.shape[-1],
                    generator=gen).to(device)
    out = check_backward_plan(
        "K4", sample3d_bwd_plan(coords, vol.shape),
        sample3d_bwd_plan_plain(coords, vol.shape),
        lambda: sample3d_trilinear_bwd(g, coords, vol.shape))
    ref = sample3d_trilinear_bwd_plain(g, coords, vol.shape)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "K4 output not finite")
    err = (out - ref).abs().max().item()
    tol = K4_TOL * ref.abs().max().item()
    print(f"K4 check: g {list(g.shape)} max_abs_err={err:.3e} (tol "
          f"{tol:.3e})", flush=True)
    check(err <= tol, f"K4 differs from its plain version: {err} > {tol}")
    return err


def check_k5(cfg, device, gen):
    from vfdepth_tpu_torch.ops.warp import (warp_image_mask,
                                            warp_image_mask_maps,
                                            warp_image_mask_maps_plain)
    img, mask, coords = k5_inputs(cfg, device, gen, True)
    got = warp_image_mask_maps(img, mask, coords)
    ref = warp_image_mask_maps_plain(img, mask, coords)
    torch.cuda.synchronize()
    errs = []
    for name, a, r in zip(("img", "mask", "ddx", "ddy"), got, ref):
        check(bool(torch.isfinite(a).all()), f"K5 {name} not finite")
        errs.append((a - r).abs().max().item())
    check(errs[1] == 0.0, "K5 masks differ from the plain version")
    cot = torch.randn(img.shape[0], coords.shape[1], 3,
                      generator=gen).to(device)
    grads = []
    for plain in (False, True):
        c = coords.clone().requires_grad_()
        (warp_image_mask(img, mask, c, plain=plain)[0] * cot).sum().backward()
        grads.append(c.grad)
    gerr = (grads[0] - grads[1]).abs().max().item()
    gtol = K5_GRAD_TOL * grads[1].abs().max().item()
    err = max(errs)
    print(f"K5 check: coords {list(coords.shape)} max_abs_err img/mask/ddx/"
          f"ddy {[f'{e:.3e}' for e in errs]} (tol {K5_TOL:.0e}, masks exact);"
          f" coordinate gradient {gerr:.3e} (tol {gtol:.3e})", flush=True)
    check(err <= K5_TOL, f"K5 differs from its plain version: {err}")
    check(gerr <= gtol, f"K5 coordinate gradient differs: {gerr} > {gtol}")
    return err


def mixed_precision_config():
    """The 6-camera model at full width with ``tpu.mixed_precision: true``:
    ``presets.build_config(mixed_precision=True)`` (DDAD's six cameras,
    ResNet-18, fusion dim 256, 100x100x20 voxels, 50 depth bins, 384x640,
    batch 2)."""
    from vfdepth_tpu_torch import presets
    return presets.build_config(mixed_precision=True)


def three_cam_config():
    """The 3-camera front rig at full width: ``presets.build_config`` with
    DDAD's front three cameras (ResNet-18, fusion dim 256, 100x100x20
    voxels, 50 depth bins, 384x640, batch 2)."""
    from vfdepth_tpu_torch import presets
    from vfdepth_tpu_torch.config import DDAD_CAM_LIST
    return presets.build_config(cameras=DDAD_CAM_LIST[:3])


def k1b_inputs(cfg3, device, gen, special: bool, batch: int = 1):
    """Main-path K1b inputs (the 3-camera serving path, raw mode): merged
    pose+depth features [3*batch, 48, 80, 768], a random 0/1 low-res mask
    with holes, and the voxel points of ``FakeDataset``'s "nuscenes" rig
    (front and +-55 degrees) through ``_project_cam_points``. ``special``
    appends points behind the camera, off the image, non-finite, at
    near-zero depth, at exact nearest-pick ties (z = 1, pixel k + 0.5) and
    a crowd on one pixel (``hot_points``; N is then odd and not a multiple
    of the kernel's 32-point tile)."""
    from vfdepth_tpu_torch.data import FakeDataset
    from vfdepth_tpu_torch.models.vfnet import _project_cam_points

    lev = cfg3.fusion_level
    h, w = cfg3.height // 2 ** (lev + 1), cfg3.width // 2 ** (lev + 1)
    c = 3 * cfg3.fusion_feat_in_dim          # pose (2 context pairs) + depth
    sample = FakeDataset(num_samples=1, num_cams=cfg3.num_cams,
                         height=cfg3.height, width=cfg3.width,
                         fusion_level=lev, rig="nuscenes").batch([0])
    k = torch.from_numpy(sample[f"K/{lev + 1}"]).to(device)
    ext_inv = torch.from_numpy(sample["extrinsics_inv"]).to(device)
    ones = torch.ones(1, cfg3.num_cams, cfg3.height, cfg3.width, 1,
                      device=device)
    cam3, _ = _project_cam_points(
        ones, k, ext_inv, h, w, voxel_str_p=tuple(cfg3.voxel_str_p),
        voxel_unit_size=tuple(cfg3.voxel_unit_size),
        voxel_size=tuple(cfg3.voxel_size))
    cam3 = cam3[0]
    cams = cam3.shape[0]
    if special:
        extra = torch.rand(cams, 45, 3, generator=gen).to(device) * 50.0
        extra[:, 0:5, 2] *= -1.0                 # behind the camera
        extra[:, 5:10, 0] += 1e4                 # right of the image
        extra[:, 10:13, 0] = float("nan")
        extra[:, 13:16, 1] = float("inf")
        extra[:, 16:18, 2] = float("nan")
        extra[:, 18:20, 2] = 1e30                # far away: projects to (0, 0)
        extra[:, 20:23, 2] = 1e-9                # near-zero depth
        ties = torch.tensor([[10.5, 7.5], [0.5, 0.5], [w - 1.5, h - 1.5],
                             [3.5, 20.0], [41.0, 11.5], [w - 1.0, 0.5]],
                            device=device)
        extra[:, 23:29, :2] = ties               # z + 1e-8 rounds to 1.0
        extra[:, 23:29, 2] = 1.0
        cam3 = torch.cat([cam3, extra, hot_points(cams, h, w, gen, device)],
                         dim=1)
    cam3 = cam3.repeat(batch, 1, 1)
    cams = cam3.shape[0]
    feats = torch.randn(cams, h, w, c, generator=gen).to(device)
    mask = (torch.rand(cams, h, w, generator=gen) > 0.15).float().to(device)
    mask[:, h // 3:h // 2, w // 4:w // 3] = 0.0   # a hole, as a car body
    open_hot_pixel(mask)
    return feats, mask, cam3.contiguous(), 1.0 / cfg3.voxel_size[0]


def _norm_ties(size: int, count: int):
    """``count`` normalised coordinates whose f32 pixel, (c + 1) * (0.5 *
    (size - 1)), has a fraction of exactly 0.5 (a nearest-pick tie),
    repeated where the size has fewer."""
    s = torch.tensor(0.5 * (size - 1), dtype=torch.float32)
    one = torch.tensor(1.0)
    found = []
    for k in range(size - 1):
        lo = hi = torch.tensor((k + 0.5) / (0.5 * (size - 1)),
                               dtype=torch.float32)
        cands = [lo]
        for _ in range(4):           # a few ulps either side
            lo, hi = torch.nextafter(lo, one * 0), torch.nextafter(hi, one * 3)
            cands += [lo, hi]
        for cand in cands:
            if ((cand - one + one) * s).item() == k + 0.5:
                found.append((cand - one).item())
                break
    check(len(found) > 0, f"no normalised ties for size {size}")
    return [found[i % len(found)] for i in range(count)]


def normalise(cam3, h: int, w: int, special: bool, gen=None,
              sanitize: bool = True):
    """Camera-plane points [B, N, 3] -> normalised (x, y) [B, N, 2] as the
    JAX package's ``_project_voxel_coords`` forms them (divide by z + 1e-8,
    NaN -> 2w, clip +-2w, align corners), points behind the camera or off
    the image sent to -3 (``sanitize``); ``special`` appends exact
    nearest-pick ties on one and both axes, non-finite and huge
    coordinates."""
    z = cam3[..., 2:3]
    big = 2.0 * w
    xy = torch.clamp(torch.nan_to_num(cam3[..., :2] / (z + 1e-8), nan=big,
                                      posinf=big, neginf=-big), -big, big)
    scale = torch.tensor([2.0 / (w - 1), 2.0 / (h - 1)], device=cam3.device)
    pix = xy * scale - 1.0
    if sanitize:
        ok = (z[..., 0] > 0) & (pix.abs() <= 1.0).all(-1)
        pix = torch.where(ok[..., None], pix, -3.0)
    if special:
        tx, ty = _norm_ties(w, 6), _norm_ties(h, 6)
        extra = (torch.rand(pix.shape[0], 20, 2, generator=gen) * 2.6
                 - 1.3).to(cam3.device)
        extra[:, 0:6, 0] = torch.tensor(tx)
        extra[:, 0:6, 1] = torch.tensor(ty)
        extra[:, 6:12, 0] = torch.tensor(tx)
        extra[:, 12, 0] = float("nan")
        extra[:, 13, 1] = float("inf")
        extra[:, 14] = torch.tensor([1e30, -3e9])
        extra[:, 15] = torch.tensor([-1.0, 1.0])
        pix = torch.cat([pix, extra], dim=1)
    return pix.contiguous()


def check_k1b(cfg3, device, gen):
    """K1b in the model's raw mode at the 3-camera serving shapes, then in
    the three normalised modes on the same points normalised."""
    from vfdepth_tpu_torch.ops.backproject_sample import sample2d, sample2d_plain
    feats, mask, cam3, rel_scale = k1b_inputs(cfg3, device, gen, True)
    h, w, c = feats.shape[1:]
    errs = {}
    out, valid = sample2d(feats, mask, cam3, "backproject", rel_scale, True)
    ref, ref_valid = sample2d_plain(feats, mask, cam3, "backproject",
                                    rel_scale, True)
    torch.cuda.synchronize()
    check(torch.equal(valid, ref_valid), "K1b per-camera validity differs")
    check(torch.equal(out[..., -1], ref[..., -1]), "K1b rel column differs")
    check(bool(torch.isfinite(out).all()), "K1b output not finite")
    n_valid = int(valid.sum().item())
    check(0 < n_valid < valid.numel(), "K1b validity is degenerate")
    errs["raw backproject"] = (out - ref).abs().max().item()
    del out, ref
    tol = K1_TOL * feats.abs().max().item()
    pix = normalise(cam3, h, w, True, gen)
    rel = torch.cat([cam3[..., 2] * rel_scale,
                     torch.ones(cam3.shape[0], pix.shape[1] - cam3.shape[1],
                                device=device)], dim=1)
    for mode, coords in (("bilinear", pix), ("mask", pix),
                         ("backproject", torch.cat([pix, rel[..., None]],
                                                   dim=-1).contiguous())):
        m = None if mode == "bilinear" else mask
        out, v = sample2d(feats, m, coords, mode)
        ref, rv = sample2d_plain(feats, m, coords, mode)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"K1b {mode} output not finite")
        if mode != "bilinear":
            check(torch.equal(out[..., -1], ref[..., -1]),
                  f"K1b {mode}: the last column differs")
        if v is not None:
            check(torch.equal(v, rv), f"K1b {mode}: validity differs")
        errs[mode] = (out - ref).abs().max().item()
        del out, ref
    print(f"K1b check: N={cam3.shape[1]} (normalised {pix.shape[1]}) "
          f"max_abs_err {({k: f'{e:.3e}' for k, e in errs.items()})} (tol "
          f"{tol:.3e}); valid camera-points={n_valid}", flush=True)
    check(max(errs.values()) <= tol, f"K1b differs from its plain version: "
                                     f"{errs} > {tol}")
    return max(errs.values())


def check_k1_normalised(cfg, device, gen):
    """K1 (grouped) with normalised coordinates on the 6-camera inputs."""
    from vfdepth_tpu_torch.ops.backproject_sample import (
        backproject_grouped, backproject_grouped_plain)
    feats, mask, cam3, rel_scale, gs = k1_inputs(cfg, device, gen, True)
    pix = normalise(cam3, feats.shape[1], feats.shape[2], False)
    coords = torch.cat([pix, cam3[..., 2:] * rel_scale], dim=-1).contiguous()
    out, valid = backproject_grouped(feats, mask, coords, 1.0, 1, gs, False)
    ref, ref_valid = backproject_grouped_plain(feats, mask, coords, 1.0, 1,
                                               gs, False)
    torch.cuda.synchronize()
    check(torch.equal(valid, ref_valid), "normalised K1 validity differs")
    check(bool(torch.isfinite(out).all()), "normalised K1 output not finite")
    err = (out - ref).abs().max().item()
    tol = K1_TOL * feats.abs().max().item()
    print(f"K1 (normalised coordinates) check: max_abs_err={err:.3e} (tol "
          f"{tol:.3e})", flush=True)
    check(err <= tol, f"normalised K1 differs from its plain version: {err}")
    return err


def k2b_inputs(cfg3, device, gen, special: bool):
    """K2b at the 3-camera training path's shapes (batch 2): K1b's inputs,
    its validity from the kernel, and a random cotangent [6, N, 769] whose
    rows of invalid points are NaN (the kernel must not read them)."""
    from vfdepth_tpu_torch.ops.backproject_sample import sample2d
    b = cfg3.batch_size
    feats, mask, cam3, rel_scale = k1b_inputs(cfg3, device, gen, special,
                                              batch=b)
    _, valid = sample2d(feats, mask, cam3, "backproject", rel_scale, True)
    n, c = cam3.shape[1], feats.shape[-1]
    g = torch.randn(cam3.shape[0], n, c + 1, generator=gen).to(device)
    g = torch.where(valid[..., None] > 0, g, float("nan"))
    return g, cam3, valid, feats.shape[1], feats.shape[2], c


def check_k2b(cfg3, device, gen):
    """K2b gated (the model's raw mode, NaN rows unread) and ungated (the
    bilinear mode's backward on the normalised points)."""
    from vfdepth_tpu_torch.ops.backproject_sample import (
        backproject_bwd_plan, backproject_bwd_plan_plain, sample2d_bwd,
        sample2d_bwd_plain)
    g, cam3, valid, h, w, c = k2b_inputs(cfg3, device, gen, True)
    errs, tols = [], []
    for gate in (True, False):
        if gate:
            coords, v, raw = cam3, valid, True
        else:
            coords, v, raw = normalise(cam3, h, w, False), None, False
            g = torch.randn(cam3.shape[0], cam3.shape[1], c,
                            generator=gen).to(device)
        out = check_backward_plan(
            f"K2b ({'gated' if gate else 'ungated'})",
            backproject_bwd_plan(coords, v, h, w, raw),
            backproject_bwd_plan_plain(coords, v, h, w, raw),
            lambda: sample2d_bwd(g, coords, v, h, w, c, raw))
        ref = sample2d_bwd_plain(g, coords, v, h, w, c, raw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), "K2b output not finite")
        errs.append((out - ref).abs().max().item())
        tols.append(K2_TOL * ref.abs().max().item())
        del out, ref
    print(f"K2b check: g {list(g.shape[:2])} x {c}(+1) max_abs_err gated "
          f"{errs[0]:.3e} (tol {tols[0]:.3e}), ungated {errs[1]:.3e} (tol "
          f"{tols[1]:.3e})", flush=True)
    check(all(e <= t for e, t in zip(errs, tols)),
          f"K2b differs from its plain version: {errs} > {tols}")
    return max(errs)


def _row(name, source, replaces, err, ms, plain_ms, bytes_, flops,
         library_ms, shapes):
    b_ms, b_by = bound(bytes_, flops)
    return dict(name=name, route="cuda",
                source=f"vfdepth_tpu_torch/csrc/{source}",
                replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                shapes={k: list(v) for k, v in shapes.items()}, bytes=bytes_,
                flops=flops)


def stage_split(plan_fn, reduce_fn):
    """A backward form's two stages timed apart: its plan alone and its
    reduce (the module's private ``_bwd_launch``: the tiled kernel alone,
    without K2's bf16 rounding) on that plan; the whole call is the row's
    ``ms``."""
    plan = plan_fn()
    return dict(plan_ms=time_ms(plan_fn),
                reduce_ms=time_ms(lambda: reduce_fn(plan)))


def _print_rows(rows):
    for key, r in rows.items():
        stages = (f" (plan {r['plan_ms']:.4f} + reduce {r['reduce_ms']:.4f})"
                  if "plan_ms" in r else "")
        if "stream_ms" in r:
            stages += f" ({r['stream_ms']:.4f} a call back to back)"
        print(f"{key} {r['name']}: kernel {r['ms']:.4f} ms{stages}, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)


def _grid_sample_2d(feats, pix):
    """The yardstick of the 2-D samplers: ``F.grid_sample`` (bilinear, zeros
    padding, align corners) of NCHW features [B, C, h, w] at normalised
    points [B, N, 2] -> [B, C, 1, N]."""
    return F.grid_sample(feats, pix[:, None], mode="bilinear",
                         padding_mode="zeros", align_corners=True)


def _library_bwd(feats, pix, g):
    """The backward yardstick: the autograd input gradient of
    ``_grid_sample_2d`` for the cotangent g [B, N, C] (its forward runs
    once, outside the timing)."""
    x = feats.permute(0, 3, 1, 2).contiguous().requires_grad_()
    out = _grid_sample_2d(x, pix)
    gt = g.transpose(1, 2)[:, :, None].contiguous()
    return lambda: torch.autograd.grad(out, x, gt, retain_graph=True)


def time_kernels(cfg, cfg3, device, gen, errs):
    """Each kernel, its plain version and its yardstick at the main paths'
    shapes: K1 and K3 at the 6-camera serving path's (batch 1), K1b at the
    3-camera serving path's, K2, K4 and K5 at the 6-camera training path's
    (batch 2; K5 one call, the 24 temporal warps), K2b at the 3-camera
    training path's. The 2-D yardstick, ``F.grid_sample``, computes less
    than K1, K1b (mask pick, validity, rel column, K1's group sum) and
    their backward kernels (validity gate)."""
    from vfdepth_tpu_torch.ops import backproject_sample as bp_ops
    from vfdepth_tpu_torch.ops import sample3d as s3_ops
    from vfdepth_tpu_torch.ops.backproject_sample import (
        backproject_bwd_plan, backproject_grouped, backproject_grouped_bwd,
        backproject_grouped_bwd_plain, backproject_grouped_plain, sample2d,
        sample2d_bwd, sample2d_bwd_plain, sample2d_plain)
    from vfdepth_tpu_torch.ops.sample3d import (
        sample3d_bwd_plan, sample3d_trilinear, sample3d_trilinear_bwd,
        sample3d_trilinear_bwd_plain, sample3d_trilinear_plain)
    from vfdepth_tpu_torch.ops.warp import (warp_image_mask_maps,
                                            warp_image_mask_maps_plain)
    rows = {}
    feats, mask, cam3, rel_scale, gs = k1_inputs(cfg, device, gen, False)
    out, valid = backproject_grouped(feats, mask, cam3, rel_scale, 1, gs)
    live_pairs = valid.sum().item()
    feats_nchw = feats.permute(0, 3, 1, 2).contiguous()
    pix = normalise(cam3, feats.shape[1], feats.shape[2], False)
    rows["K1"] = _row(
        "backproject_grouped", "backproject_sample.cu",
        "vfdepth_tpu/ops/pallas_sample.py:176", errs["K1"],
        time_ms(lambda: backproject_grouped(feats, mask, cam3, rel_scale,
                                            1, gs)),
        time_ms(lambda: backproject_grouped_plain(
            feats, mask, cam3, rel_scale, 1, gs), reps=10),
        nbytes(feats, mask, cam3, out, valid),
        live_pairs * feats.shape[-1] * 4 * 2,
        time_ms(lambda: _grid_sample_2d(feats_nchw, pix)),
        dict(feats=feats.shape, cam3=cam3.shape, out=out.shape))
    rows["K1"]["stream_ms"] = stream_ms(
        lambda: backproject_grouped(feats, mask, cam3, rel_scale, 1, gs))
    del feats, mask, cam3, out, valid, feats_nchw, pix

    feats, mask, cam3, rel_scale = k1b_inputs(cfg3, device, gen, False)
    out, valid = sample2d(feats, mask, cam3, "backproject", rel_scale, True)
    h, w = feats.shape[1:3]
    feats_nchw = feats.permute(0, 3, 1, 2).contiguous()
    pix = normalise(cam3, h, w, False)
    bil, _ = sample2d(feats, None, pix, "bilinear")
    lib = _grid_sample_2d(feats_nchw, pix)
    lib_err = (lib[:, :, 0].transpose(1, 2) - bil).abs().max().item()
    bil_ms = time_ms(lambda: sample2d(feats, None, pix, "bilinear"))
    print(f"K1b bilinear mode vs F.grid_sample on the same points: "
          f"max_abs_diff={lib_err:.3e}; bilinear mode {bil_ms:.4f} ms",
          flush=True)
    del lib, bil
    rows["K1b"] = _row(
        "sample2d", "backproject_sample.cu",
        "vfdepth_tpu/ops/pallas_sample.py:176", errs["K1b"],
        time_ms(lambda: sample2d(feats, mask, cam3, "backproject", rel_scale,
                                 True)),
        time_ms(lambda: sample2d_plain(feats, mask, cam3, "backproject",
                                       rel_scale, True), reps=10),
        nbytes(feats, mask, cam3, out, valid),
        valid.sum().item() * feats.shape[-1] * 4 * 2,
        time_ms(lambda: _grid_sample_2d(feats_nchw, pix)),
        dict(feats=feats.shape, cam3=cam3.shape, out=out.shape))
    rows["K1b"]["bilinear_mode_ms"] = bil_ms
    rows["K1b"]["stream_ms"] = stream_ms(
        lambda: sample2d(feats, mask, cam3, "backproject", rel_scale, True))
    del feats, mask, cam3, out, valid, feats_nchw, pix
    torch.cuda.empty_cache()

    # K2: the bytes a run must move are the cotangent rows of the points
    # some camera of their group sees (the others are never read), cam3,
    # valid and the feature gradient
    g, cam3, valid, h, w, c, gs, seen = k2_inputs(cfg, device, gen, False)
    dfeat = backproject_grouped_bwd(g, cam3, valid, h, w, c, gs)
    k2_bytes = (int(seen.sum().item()) * c * 4
                + nbytes(cam3, valid, dfeat))
    # yardstick: the input gradient of F.grid_sample per camera, each
    # camera reading its group's cotangent
    g_cam = g[..., :c].repeat_interleave(gs, dim=1).reshape(
        -1, g.shape[2], c).nan_to_num()
    lib2 = _library_bwd(torch.zeros(cam3.shape[0], h, w, c, device=device),
                        normalise(cam3, h, w, False), g_cam)
    rows["K2"] = _row(
        "backproject_grouped_bwd", "backproject_sample_bwd.cu",
        "vfdepth_tpu/ops/pallas_sample.py:301", errs["K2"],
        time_ms(lambda: backproject_grouped_bwd(g, cam3, valid, h, w, c,
                                                gs)),
        time_ms(lambda: backproject_grouped_bwd_plain(
            g, cam3, valid, h, w, c, gs), reps=5),
        k2_bytes, valid.sum().item() * c * 4 * 2, time_ms(lib2, reps=5),
        dict(g=g.shape, cam3=cam3.shape, valid=valid.shape,
             dfeat=dfeat.shape))
    rows["K2"].update(stage_split(
        lambda: backproject_bwd_plan(cam3, valid, h, w),
        lambda p: bp_ops._bwd_launch(g, cam3, valid, True, h, w, c,
                                     (g.shape[0], gs), p)))
    del g, cam3, valid, dfeat, seen, g_cam, lib2
    torch.cuda.empty_cache()

    # K2b: the cotangent rows of valid points, cam3, valid, the gradient
    g, cam3, valid, h, w, c = k2b_inputs(cfg3, device, gen, False)
    dfeat = sample2d_bwd(g, cam3, valid, h, w, c, True)
    lib2b = _library_bwd(torch.zeros(cam3.shape[0], h, w, c, device=device),
                         normalise(cam3, h, w, False),
                         g[..., :c].nan_to_num())
    rows["K2b"] = _row(
        "sample2d_bwd", "backproject_sample_bwd.cu",
        "vfdepth_tpu/ops/pallas_sample.py:301", errs["K2b"],
        time_ms(lambda: sample2d_bwd(g, cam3, valid, h, w, c, True)),
        time_ms(lambda: sample2d_bwd_plain(g, cam3, valid, h, w, c, True),
                reps=5),
        int(valid.sum().item()) * c * 4 + nbytes(cam3, valid, dfeat),
        valid.sum().item() * c * 4 * 2, time_ms(lib2b, reps=5),
        dict(g=g.shape, cam3=cam3.shape, valid=valid.shape,
             dfeat=dfeat.shape))
    rows["K2b"].update(stage_split(
        lambda: backproject_bwd_plan(cam3, valid, h, w),
        lambda p: bp_ops._bwd_launch(g, cam3, valid, True, h, w, c,
                                     (cam3.shape[0],), p)))
    del g, cam3, valid, dfeat, lib2b
    torch.cuda.empty_cache()

    vol, coords = k3_inputs(cfg, device, gen, False)
    out = sample3d_trilinear(vol, coords)
    # yardstick: F.grid_sample 5-D, align_corners=True, zeros padding, on
    # the volume permuted to [B, C, Z, Y, X] (the permute is not timed)
    vol_czyx = vol.permute(0, 4, 3, 1, 2).contiguous()
    grid = coords.reshape(1, 1, 1, -1, 3)

    def library3():
        return F.grid_sample(vol_czyx, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)
    lib_err = (library3()[0, :, 0, 0].t() - out).abs().max().item()
    print(f"K3 vs F.grid_sample on the frustum coords: max_abs_diff="
          f"{lib_err:.3e}", flush=True)
    rows["K3"] = _row(
        "sample3d_trilinear", "sample3d.cu",
        "vfdepth_tpu/ops/sample3d_packed.py:101", errs["K3"],
        time_ms(lambda: sample3d_trilinear(vol, coords)),
        time_ms(lambda: sample3d_trilinear_plain(vol, coords), reps=10),
        nbytes(vol, coords, out), coords.shape[1] * vol.shape[-1] * 8 * 2,
        time_ms(library3), dict(vol=vol.shape, coords=coords.shape,
                                out=out.shape))
    rows["K3"]["stream_ms"] = stream_ms(lambda: sample3d_trilinear(vol,
                                                                   coords))
    del vol, coords, out, vol_czyx, grid

    vol, coords = k3_inputs(cfg, device, gen, False, batch=cfg.batch_size)
    g = torch.randn(vol.shape[0], coords.shape[1], vol.shape[-1],
                    generator=gen).to(device)
    dvol = sample3d_trilinear_bwd(g, coords, vol.shape)
    # yardstick: the autograd backward of 5-D F.grid_sample with respect
    # to its input (its forward runs once, outside the timing)
    vol_czyx = vol.permute(0, 4, 3, 1, 2).contiguous().requires_grad_()
    lib_out = F.grid_sample(vol_czyx, coords.reshape(vol.shape[0], 1, 1, -1,
                                                     3),
                            mode="bilinear", padding_mode="zeros",
                            align_corners=True)
    lib_g = g.transpose(1, 2).reshape(lib_out.shape).contiguous()

    def library4():
        return torch.autograd.grad(lib_out, vol_czyx, lib_g,
                                   retain_graph=True)
    lib_err = (library4()[0].permute(0, 3, 4, 2, 1) - dvol).abs().max().item()
    print(f"K4 vs F.grid_sample's input gradient: max_abs_diff={lib_err:.3e}",
          flush=True)
    rows["K4"] = _row(
        "sample3d_trilinear_bwd", "sample3d_bwd.cu",
        "vfdepth_tpu/ops/sample3d_packed.py:146", errs["K4"],
        time_ms(lambda: sample3d_trilinear_bwd(g, coords, vol.shape)),
        time_ms(lambda: sample3d_trilinear_bwd_plain(g, coords, vol.shape),
                reps=5),
        nbytes(g, coords, dvol), coords.shape[1] * vol.shape[0]
        * vol.shape[-1] * 8 * 2, time_ms(library4),
        dict(g=g.shape, coords=coords.shape, dvol=dvol.shape))
    rows["K4"].update(stage_split(
        lambda: sample3d_bwd_plan(coords, vol.shape),
        lambda p: s3_ops._bwd_launch(g, coords, vol.shape, False, p)))
    del vol, coords, g, dvol, vol_czyx, lib_out, lib_g
    torch.cuda.empty_cache()

    img, mask, coords = k5_inputs(cfg, device, gen, False)
    maps = warp_image_mask_maps(img, mask, coords)
    n_warps, h, w, _ = img.shape
    img_nchw = img.permute(0, 3, 1, 2).contiguous()
    grid = coords.reshape(n_warps, h, w, 2)

    def library5():
        return F.grid_sample(img_nchw, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)
    lib_err = (library5().permute(0, 2, 3, 1).reshape(maps[0].shape)
               - maps[0]).abs().max().item()
    print(f"K5 vs F.grid_sample on the RGB: max_abs_diff={lib_err:.3e}",
          flush=True)
    # per target pixel and channel: the bilinear value (~6 operations), ddx
    # (~4) and ddy (~1)
    rows["K5"] = _row(
        "warp_image_mask", "warp_image_mask.cu",
        "vfdepth_tpu/ops/warp_mxu.py:75", errs["K5"],
        time_ms(lambda: warp_image_mask_maps(img, mask, coords)),
        time_ms(lambda: warp_image_mask_maps_plain(img, mask, coords),
                reps=5),
        nbytes(img, mask, coords, *maps), coords.shape[0] * coords.shape[1]
        * 3 * 11, time_ms(library5),
        dict(img=img.shape, mask=mask.shape, coords=coords.shape))
    del img, mask, coords, maps, img_nchw, grid
    torch.cuda.empty_cache()
    _print_rows(rows)
    return rows


def _bf16(*tensors):
    return [t.to(torch.bfloat16) for t in tensors]


def _cos_rel(a, b):
    """(cosine, relative L2 difference) of a against b, in f64."""
    a, b = a.double().ravel(), b.double().ravel()
    return ((a @ b) / (a.norm() * b.norm())).item(), \
        ((a - b).norm() / b.norm()).item()


def check_bf16_forms(cfg, device, gen):
    """The bf16 forms against their plain versions at the mixed-precision
    paths' shapes, with the special inputs of the f32 checks: K1-bf16 (6
    cameras, serving), K2-bf16 (training, unread rows NaN), K3-bf16
    (serving), K4's bf16-update form (training; exact at distinct base
    voxels, bounded elsewhere, and its error against the f32 K4 printed),
    K5-bf16 (one call, 24 warps). Returns the max_abs_err of each."""
    from vfdepth_tpu_torch.ops.backproject_sample import (
        backproject_bwd_plan, backproject_bwd_plan_plain, backproject_grouped,
        backproject_grouped_bwd, backproject_grouped_bwd_plain,
        backproject_grouped_plain)
    from vfdepth_tpu_torch.ops.sample3d import (
        sample3d_bwd_plan, sample3d_bwd_plan_plain, sample3d_trilinear,
        sample3d_trilinear_bwd, sample3d_trilinear_bwd_bf16,
        sample3d_trilinear_bwd_bf16_plain, sample3d_trilinear_plain)
    from vfdepth_tpu_torch.ops.warp import (warp_image_mask,
                                            warp_image_mask_maps,
                                            warp_image_mask_maps_plain)
    errs = {}
    feats, mask, cam3, rel_scale, gs = k1_inputs(cfg, device, gen, True)
    (fb,) = _bf16(feats)
    out, valid = backproject_grouped(fb, mask, cam3, rel_scale, 1, gs)
    ref, ref_valid = backproject_grouped_plain(fb, mask, cam3, rel_scale, 1,
                                               gs)
    torch.cuda.synchronize()
    check(out.dtype == torch.bfloat16, "K1-bf16 output not bf16")
    check(torch.equal(valid, ref_valid), "K1-bf16 per-camera validity differs")
    check(torch.equal(out[..., -1], ref[..., -1]), "K1-bf16 counts differ")
    check(bool(torch.isfinite(out.float()).all()), "K1-bf16 not finite")
    # the feature sums against their magnitude; the rel-depth sums (up to
    # 1e28 for the far-away special points) each against its own
    got_f, ref_f = out[..., :-2].float(), ref[..., :-2].float()
    errs["K1-bf16"] = (got_f - ref_f).abs().max().item()
    tol = BF16_STEP * ref_f.abs().max().item()
    rel_ok = bool(((out[..., -2].float() - ref[..., -2].float()).abs()
                   <= BF16_STEP * ref[..., -2].float().abs()).all())
    print(f"K1-bf16 check: max_abs_err={errs['K1-bf16']:.3e} (tol {tol:.3e})"
          f"; rel-depth column within one bf16 step of each value: {rel_ok}",
          flush=True)
    check(errs["K1-bf16"] <= tol, "K1-bf16 differs from its plain version")
    check(rel_ok, "K1-bf16 rel-depth sums differ from the plain version")
    del feats, fb, out, ref, valid, ref_valid

    g, cam3, valid, h, w, c, gs, _ = k2_inputs(cfg, device, gen, True)
    (gb,) = _bf16(g)
    out = check_backward_plan(
        "K2-bf16", backproject_bwd_plan(cam3, valid, h, w),
        backproject_bwd_plan_plain(cam3, valid, h, w),
        lambda: backproject_grouped_bwd(gb, cam3, valid, h, w, c, gs))
    ref = backproject_grouped_bwd_plain(gb, cam3, valid, h, w, c, gs)
    torch.cuda.synchronize()
    check(out.dtype == torch.bfloat16, "K2-bf16 output not bf16")
    check(bool(torch.isfinite(out.float()).all()), "K2-bf16 not finite")
    errs["K2-bf16"] = (out.float() - ref.float()).abs().max().item()
    tol = (BF16_STEP + K2_TOL) * ref.float().abs().max().item()
    print(f"K2-bf16 check: g {list(g.shape)} max_abs_err="
          f"{errs['K2-bf16']:.3e} (tol {tol:.3e})", flush=True)
    check(errs["K2-bf16"] <= tol, "K2-bf16 differs from its plain version")
    del g, gb, out, ref, cam3, valid
    torch.cuda.empty_cache()

    vol, coords = k3_inputs(cfg, device, gen, True)
    (vb,) = _bf16(vol)
    out = sample3d_trilinear(vb, coords)
    ref = sample3d_trilinear_plain(vb, coords)
    torch.cuda.synchronize()
    check(out.dtype == torch.bfloat16, "K3-bf16 output not bf16")
    check(bool(torch.isfinite(out.float()).all()), "K3-bf16 not finite")
    errs["K3-bf16"] = (out.float() - ref.float()).abs().max().item()
    tol = BF16_STEP * vb.float().abs().max().item()
    print(f"K3-bf16 check: max_abs_err={errs['K3-bf16']:.3e} (tol {tol:.3e})",
          flush=True)
    check(errs["K3-bf16"] <= tol, "K3-bf16 differs from its plain version")
    del vol, vb, out, ref, coords

    vol, coords = k3_inputs(cfg, device, gen, True, batch=cfg.batch_size)
    shape = tuple(vol.shape)
    nb, h, w, d, c = shape
    # one point per base voxel (fractions away from the edges): one bf16
    # addition per plane entry, so kernel and plain version agree exactly
    n_base = (h - 1) * (w - 1) * (d - 1)
    base = torch.stack([torch.randperm(n_base, generator=gen)
                        for _ in range(nb)])
    pix = torch.stack([(base // (d - 1)) % (w - 1), base // ((w - 1) * (
        d - 1)), base % (d - 1)], -1).float() + 0.1 + 0.8 * torch.rand(
        nb, n_base, 3, generator=gen)
    uniq = (pix / (0.5 * (torch.tensor([w, h, d]).float() - 1))
            - 1.0).to(device)
    g1 = torch.randn(nb, n_base, c, generator=gen).to(device)
    for gd in (torch.float32, torch.bfloat16):
        gg = g1.to(gd)
        exact = torch.equal(sample3d_trilinear_bwd_bf16(gg, uniq, shape),
                            sample3d_trilinear_bwd_bf16_plain(gg, uniq, shape))
        check(exact, f"K4-bf16 ({gd} g) differs from its plain version at "
                     f"distinct base voxels")
    g = torch.randn(nb, coords.shape[1], c, generator=gen).to(device)
    (gb,) = _bf16(g)
    out = check_backward_plan(
        "K4-bf16", sample3d_bwd_plan(coords, shape, True),
        sample3d_bwd_plan_plain(coords, shape, True),
        lambda: sample3d_trilinear_bwd_bf16(gb, coords, shape))
    ref = sample3d_trilinear_bwd_bf16_plain(gb, coords, shape)
    f32 = sample3d_trilinear_bwd(gb.float(), coords, shape)
    out_f = sample3d_trilinear_bwd_bf16(gb.float(), coords, shape)
    torch.cuda.synchronize()
    check(out.dtype == torch.bfloat16 and out_f.dtype == torch.float32,
          "K4-bf16 output dtype is not g's")
    check(bool(torch.isfinite(out.float()).all()), "K4-bf16 not finite")
    errs["K4-bf16"] = (out.float() - ref.float()).abs().max().item()
    report = {}
    for what, a, b in (("bf16 g vs plain", out, ref),
                       ("bf16 g vs f32 K4", out, f32),
                       ("f32 g vs f32 K4", out_f, f32)):
        cos, rel = _cos_rel(a, b)
        report[what] = (cos, rel)
        check(cos >= K4_BF16_MIN_COS and rel <= K4_BF16_MAX_REL,
              f"K4-bf16 {what}: cosine {cos}, relative L2 {rel}")
    max_rel = ((out.float() - f32).abs().max() / f32.abs().max()).item()
    print(f"K4-bf16 check: exact at {n_base} distinct base voxels (f32 and "
          f"bf16 g); crowded production frustum "
          f"{({k: f'cos {c_:.6f} rel {r:.3e}' for k, (c_, r) in report.items()})}"
          f" (bounds cos >= {K4_BF16_MIN_COS}, rel <= {K4_BF16_MAX_REL}); "
          f"max|bf16 - f32 K4| / max|f32 K4| = {max_rel:.3e}", flush=True)
    del vol, coords, g, gb, out, ref, f32, out_f, uniq, g1
    torch.cuda.empty_cache()

    img, mask, coords = k5_inputs(cfg, device, gen, True)
    img, mask = _bf16(img, mask)
    got = warp_image_mask_maps(img, mask, coords)
    ref = warp_image_mask_maps_plain(img, mask, coords)
    torch.cuda.synchronize()
    e = []
    for name, a, r in zip(("img", "mask", "ddx", "ddy"), got, ref):
        check(a.dtype == torch.bfloat16, f"K5-bf16 {name} not bf16")
        check(bool(torch.isfinite(a.float()).all()),
              f"K5-bf16 {name} not finite")
        e.append((a.float() - r.float()).abs().max().item())
    check(e[1] == 0.0, "K5-bf16 masks differ from the plain version")
    cot = torch.randn(img.shape[0], coords.shape[1], 3,
                      generator=gen).to(device).to(torch.bfloat16)
    grads = []
    for plain in (False, True):
        cc = coords.clone().requires_grad_()
        warp_image_mask(img, mask, cc, plain=plain)[0].backward(cot)
        grads.append(cc.grad)
    gerr = (grads[0] - grads[1]).abs().max().item()
    gtol = BF16_STEP * grads[1].abs().max().item()
    errs["K5-bf16"] = max(e)
    print(f"K5-bf16 check: max_abs_err img/mask/ddx/ddy "
          f"{[f'{x:.3e}' for x in e]} (tol {BF16_STEP:.3e}, masks exact); "
          f"coordinate gradient {gerr:.3e} (tol {gtol:.3e})", flush=True)
    check(max(e) <= BF16_STEP, "K5-bf16 differs from its plain version")
    check(gerr <= gtol, "K5-bf16 coordinate gradient differs")
    return errs


def three_cam_bf16_config():
    """The 3-camera front rig at full width with ``tpu.mixed_precision:
    true``: ``presets.build_config(cameras=DDAD_CAM_LIST[:3],
    mixed_precision=True)``."""
    from vfdepth_tpu_torch import presets
    from vfdepth_tpu_torch.config import DDAD_CAM_LIST
    return presets.build_config(cameras=DDAD_CAM_LIST[:3],
                                mixed_precision=True)


def check_k1b_k2b_bf16(cfg3, device, gen):
    """K1b-bf16 at the 3-camera bf16 serving shapes (merged: [3, 48, 80,
    768] -> rows of 769) in the model's raw mode and the three normalised
    modes, with K1b's special inputs (exact nearest-pick ties included),
    and in raw mode at the unmerged nets' widths (512 and 256 channels:
    rows of 513 and 257); K2b-bf16 at the 3-camera bf16 training shapes,
    gated (rows of invalid points NaN) and ungated. Features within one
    bf16 step of the largest magnitude; validity, mask values and rel
    columns exact. Returns (K1b-bf16 err, K2b-bf16 err)."""
    from vfdepth_tpu_torch.ops.backproject_sample import (
        backproject_bwd_plan, backproject_bwd_plan_plain, sample2d,
        sample2d_bwd, sample2d_bwd_plain, sample2d_plain)
    feats, mask, cam3, rel_scale = k1b_inputs(cfg3, device, gen, True)
    (fb,) = _bf16(feats)
    h, w, c = fb.shape[1:]
    pix = normalise(cam3, h, w, True, gen)
    rel = torch.cat([cam3[..., 2] * rel_scale,
                     torch.ones(cam3.shape[0], pix.shape[1] - cam3.shape[1],
                                device=device)], dim=1)
    cases = [("raw backproject", fb, "backproject", cam3, rel_scale, True),
             ("bilinear", fb, "bilinear", pix, 1.0, False),
             ("mask", fb, "mask", pix, 1.0, False),
             ("backproject", fb, "backproject",
              torch.cat([pix, rel[..., None]], dim=-1).contiguous(), 1.0,
              False)]
    for width in (512, 256):           # the unmerged nets' own features
        cases.append((f"raw backproject C={width}",
                      fb[..., :width].contiguous(), "backproject", cam3,
                      rel_scale, True))
    # the feature columns against their magnitude; the last column (mask
    # value or rel, up to 1e28 for the far-away special points) exactly
    errs, tols = {}, {}
    for what, f, mode, coords, rs, raw in cases:
        m = None if mode == "bilinear" else mask
        out, v = sample2d(f, m, coords, mode, rs, raw)
        ref, rv = sample2d_plain(f, m, coords, mode, rs, raw)
        torch.cuda.synchronize()
        check(out.dtype == torch.bfloat16, f"K1b-bf16 {what}: not bf16")
        check(bool(torch.isfinite(out.float()).all()),
              f"K1b-bf16 {what}: not finite")
        if mode != "bilinear":
            check(torch.equal(out[..., -1], ref[..., -1]),
                  f"K1b-bf16 {what}: the last column differs")
        if v is not None:
            check(torch.equal(v, rv), f"K1b-bf16 {what}: validity differs")
            check(0 < v.sum().item() < v.numel(),
                  f"K1b-bf16 {what}: validity is degenerate")
        c_f = f.shape[-1]
        got_f, ref_f = out[..., :c_f].float(), ref[..., :c_f].float()
        errs[what] = (got_f - ref_f).abs().max().item()
        tols[what] = BF16_STEP * ref_f.abs().max().item()
        del out, ref, got_f, ref_f
    print(f"K1b-bf16 check: N={cam3.shape[1]} (normalised {pix.shape[1]}) "
          f"max_abs_err (tol) "
          f"{({k: f'{e:.3e} ({tols[k]:.3e})' for k, e in errs.items()})}",
          flush=True)
    check(all(errs[k] <= tols[k] for k in errs),
          f"K1b-bf16 differs from its plain version: {errs} > {tols}")
    k1b_err = max(errs.values())
    del feats, fb, mask, cam3, pix, rel, cases
    torch.cuda.empty_cache()

    g, cam3, valid, h, w, c = k2b_inputs(cfg3, device, gen, True)
    errs, tols = [], []
    for gate in (True, False):
        if gate:
            coords, v, raw = cam3, valid, True
            (gb,) = _bf16(g)
        else:
            coords, v, raw = normalise(cam3, h, w, False), None, False
            (gb,) = _bf16(torch.randn(cam3.shape[0], cam3.shape[1], c,
                                      generator=gen).to(device))
        out = check_backward_plan(
            f"K2b-bf16 ({'gated' if gate else 'ungated'})",
            backproject_bwd_plan(coords, v, h, w, raw),
            backproject_bwd_plan_plain(coords, v, h, w, raw),
            lambda: sample2d_bwd(gb, coords, v, h, w, c, raw))
        ref = sample2d_bwd_plain(gb, coords, v, h, w, c, raw)
        torch.cuda.synchronize()
        check(out.dtype == torch.bfloat16, "K2b-bf16 output not bf16")
        check(bool(torch.isfinite(out.float()).all()), "K2b-bf16 not finite")
        errs.append((out.float() - ref.float()).abs().max().item())
        tols.append((BF16_STEP + K2_TOL) * ref.float().abs().max().item())
        del out, ref
    print(f"K2b-bf16 check: g {list(g.shape[:2])} x {c}(+1) bf16 max_abs_err "
          f"gated {errs[0]:.3e} (tol {tols[0]:.3e}), ungated {errs[1]:.3e} "
          f"(tol {tols[1]:.3e})", flush=True)
    check(all(e <= t for e, t in zip(errs, tols)),
          f"K2b-bf16 differs from its plain version: {errs} > {tols}")
    return k1b_err, max(errs)


def check_k4_f32_updates_bf16(cfg, device, gen):
    """K4's f32-update form with a bf16 cotangent (6-camera bf16 training
    shapes, ``sampler_3d: packed_f32grad``) against its plain version
    (f32 tap planes and fold in JAX's order, rounded once) and against the
    f32 K4 on the same values rounded once: both differ from it only by the
    order of f32 sums, so within one bf16 step plus K4's own bound."""
    from vfdepth_tpu_torch.ops.sample3d import (sample3d_bwd_plan,
                                                sample3d_bwd_plan_plain,
                                                sample3d_trilinear_bwd,
                                                sample3d_trilinear_bwd_plain)
    vol, coords = k3_inputs(cfg, device, gen, True, batch=cfg.batch_size)
    shape = tuple(vol.shape)
    (gb,) = _bf16(torch.randn(vol.shape[0], coords.shape[1], vol.shape[-1],
                              generator=gen).to(device))
    out = check_backward_plan(
        "K4-f32upd-bf16", sample3d_bwd_plan(coords, shape),
        sample3d_bwd_plan_plain(coords, shape),
        lambda: sample3d_trilinear_bwd(gb, coords, shape))
    ref = sample3d_trilinear_bwd_plain(gb, coords, shape)
    f32 = sample3d_trilinear_bwd(gb.float(), coords, shape)
    torch.cuda.synchronize()
    check(out.dtype == torch.bfloat16, "K4 f32-update bf16 output not bf16")
    check(bool(torch.isfinite(out.float()).all()),
          "K4 f32-update bf16 output not finite")
    tol = (BF16_STEP + K4_TOL) * ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs().max().item()
    err_f32 = (out.float() - f32.to(torch.bfloat16).float()).abs().max().item()
    moved = (out != f32.to(torch.bfloat16)).float().mean().item()
    print(f"K4 f32-update (bf16 g) check: g {list(gb.shape)} max_abs_err "
          f"{err:.3e} vs plain, {err_f32:.3e} vs the f32 K4 rounded once "
          f"(tol {tol:.3e}; {moved:.2e} of the values differ from it)",
          flush=True)
    check(err <= tol and err_f32 <= tol,
          "K4 f32-update (bf16 g) differs from its plain version")
    return err


def time_bf16_forms(cfg, cfg3, device, gen, errs):
    """Each bf16 form, its plain version and its yardstick on the same bf16
    tensors (``F.grid_sample`` 2-D and 5-D, and their autograd input
    gradients), at the mixed-precision paths' shapes: K1-bf16 and K3-bf16
    at serving's (batch 1), K2-bf16, both K4 forms and K5-bf16 at
    training's (batch 2; K5 one call of 24 warps); K1b-bf16 at the 3-camera
    bf16 serving path's, K2b-bf16 at its training path's. Bytes are the
    bf16 tensors' (f32 masks, coordinates and validity); operations are
    counted as the f32 forms count them (the arithmetic is f32)."""
    from vfdepth_tpu_torch.ops import backproject_sample as bp_ops
    from vfdepth_tpu_torch.ops import sample3d as s3_ops
    from vfdepth_tpu_torch.ops.backproject_sample import (
        backproject_bwd_plan, backproject_grouped, backproject_grouped_bwd,
        backproject_grouped_bwd_plain, backproject_grouped_plain, sample2d,
        sample2d_bwd, sample2d_bwd_plain, sample2d_plain)
    from vfdepth_tpu_torch.ops.sample3d import (
        sample3d_bwd_plan, sample3d_trilinear, sample3d_trilinear_bwd,
        sample3d_trilinear_bwd_bf16, sample3d_trilinear_bwd_bf16_plain,
        sample3d_trilinear_bwd_plain, sample3d_trilinear_plain)
    from vfdepth_tpu_torch.ops.warp import (warp_image_mask_maps,
                                            warp_image_mask_maps_plain)
    rows = {}
    feats, mask, cam3, rel_scale, gs = k1_inputs(cfg, device, gen, False)
    (fb,) = _bf16(feats)
    out, valid = backproject_grouped(fb, mask, cam3, rel_scale, 1, gs)
    feats_nchw = fb.permute(0, 3, 1, 2).contiguous()
    pix = normalise(cam3, fb.shape[1], fb.shape[2], False).to(torch.bfloat16)
    rows["K1-bf16"] = _row(
        "backproject_grouped (bf16)", "backproject_sample.cu",
        "vfdepth_tpu/ops/pallas_sample.py:176", errs["K1-bf16"],
        time_ms(lambda: backproject_grouped(fb, mask, cam3, rel_scale, 1,
                                            gs)),
        time_ms(lambda: backproject_grouped_plain(fb, mask, cam3, rel_scale,
                                                  1, gs), reps=5),
        nbytes(fb, mask, cam3, out, valid),
        valid.sum().item() * fb.shape[-1] * 4 * 2,
        time_ms(lambda: _grid_sample_2d(feats_nchw, pix)),
        dict(feats=fb.shape, cam3=cam3.shape, out=out.shape))
    rows["K1-bf16"]["stream_ms"] = stream_ms(
        lambda: backproject_grouped(fb, mask, cam3, rel_scale, 1, gs))
    del feats, fb, mask, cam3, out, valid, feats_nchw, pix
    torch.cuda.empty_cache()

    g, cam3, valid, h, w, c, gs, seen = k2_inputs(cfg, device, gen, False)
    (gb,) = _bf16(g)
    dfeat = backproject_grouped_bwd(gb, cam3, valid, h, w, c, gs)
    g_cam = gb[..., :c].repeat_interleave(gs, dim=1).reshape(
        -1, g.shape[2], c).nan_to_num()
    lib2 = _library_bwd(torch.zeros(cam3.shape[0], h, w, c, device=device,
                                    dtype=torch.bfloat16),
                        normalise(cam3, h, w, False).to(torch.bfloat16),
                        g_cam)
    rows["K2-bf16"] = _row(
        "backproject_grouped_bwd (bf16)", "backproject_sample_bwd.cu",
        "vfdepth_tpu/ops/pallas_sample.py:301", errs["K2-bf16"],
        time_ms(lambda: backproject_grouped_bwd(gb, cam3, valid, h, w, c,
                                                gs)),
        time_ms(lambda: backproject_grouped_bwd_plain(
            gb, cam3, valid, h, w, c, gs), reps=5),
        int(seen.sum().item()) * c * 2 + nbytes(cam3, valid, dfeat),
        valid.sum().item() * c * 4 * 2, time_ms(lib2, reps=5),
        dict(g=gb.shape, cam3=cam3.shape, valid=valid.shape,
             dfeat=dfeat.shape))
    rows["K2-bf16"].update(stage_split(
        lambda: backproject_bwd_plan(cam3, valid, h, w),
        lambda p: bp_ops._bwd_launch(gb, cam3, valid, True, h, w, c,
                                     (g.shape[0], gs), p)))
    del g, gb, cam3, valid, dfeat, seen, g_cam, lib2
    torch.cuda.empty_cache()

    vol, coords = k3_inputs(cfg, device, gen, False)
    (vb,) = _bf16(vol)
    out = sample3d_trilinear(vb, coords)
    vol_czyx = vb.permute(0, 4, 3, 1, 2).contiguous()
    grid = coords.reshape(1, 1, 1, -1, 3).to(torch.bfloat16)
    rows["K3-bf16"] = _row(
        "sample3d_trilinear (bf16)", "sample3d.cu",
        "vfdepth_tpu/ops/sample3d_packed.py:101", errs["K3-bf16"],
        time_ms(lambda: sample3d_trilinear(vb, coords)),
        time_ms(lambda: sample3d_trilinear_plain(vb, coords), reps=10),
        nbytes(vb, coords, out), coords.shape[1] * vb.shape[-1] * 8 * 2,
        time_ms(lambda: F.grid_sample(vol_czyx, grid, mode="bilinear",
                                      padding_mode="zeros",
                                      align_corners=True)),
        dict(vol=vb.shape, coords=coords.shape, out=out.shape))
    rows["K3-bf16"]["stream_ms"] = stream_ms(lambda: sample3d_trilinear(
        vb, coords))
    del vol, vb, coords, out, vol_czyx, grid

    vol, coords = k3_inputs(cfg, device, gen, False, batch=cfg.batch_size)
    shape = tuple(vol.shape)
    gb = torch.randn(vol.shape[0], coords.shape[1], vol.shape[-1],
                     generator=gen).to(device).to(torch.bfloat16)
    dvol = sample3d_trilinear_bwd_bf16(gb, coords, shape)
    vol_czyx = vol.to(torch.bfloat16).permute(0, 4, 3, 1, 2).contiguous(
        ).requires_grad_()
    lib_out = F.grid_sample(vol_czyx, coords.reshape(
        vol.shape[0], 1, 1, -1, 3).to(torch.bfloat16), mode="bilinear",
        padding_mode="zeros", align_corners=True)
    lib_g = gb.transpose(1, 2).reshape(lib_out.shape).contiguous()
    lib4_ms = time_ms(lambda: torch.autograd.grad(lib_out, vol_czyx, lib_g,
                                                  retain_graph=True))
    rows["K4-bf16"] = _row(
        "sample3d_trilinear_bwd_bf16", "sample3d_bwd.cu",
        "vfdepth_tpu/ops/sample3d_packed.py:146", errs["K4-bf16"],
        time_ms(lambda: sample3d_trilinear_bwd_bf16(gb, coords, shape)),
        time_ms(lambda: sample3d_trilinear_bwd_bf16_plain(gb, coords, shape),
                reps=5),
        nbytes(gb, coords, dvol), coords.shape[1] * vol.shape[0]
        * vol.shape[-1] * 8 * 2, lib4_ms,
        dict(g=gb.shape, coords=coords.shape, dvol=dvol.shape))
    rows["K4-bf16"].update(stage_split(
        lambda: sample3d_bwd_plan(coords, shape, True),
        lambda p: s3_ops._bwd_launch(gb, coords, shape, True, p)))
    # the f32-update form on the same bf16 cotangent (packed_f32grad)
    dvol = sample3d_trilinear_bwd(gb, coords, shape)
    rows["K4-f32upd-bf16"] = _row(
        "sample3d_trilinear_bwd (bf16 g)", "sample3d_bwd.cu",
        "vfdepth_tpu/ops/sample3d_packed.py:146", errs["K4-f32upd-bf16"],
        time_ms(lambda: sample3d_trilinear_bwd(gb, coords, shape)),
        time_ms(lambda: sample3d_trilinear_bwd_plain(gb, coords, shape),
                reps=5),
        nbytes(gb, coords, dvol), coords.shape[1] * vol.shape[0]
        * vol.shape[-1] * 8 * 2, lib4_ms,
        dict(g=gb.shape, coords=coords.shape, dvol=dvol.shape))
    rows["K4-f32upd-bf16"].update(stage_split(
        lambda: sample3d_bwd_plan(coords, shape),
        lambda p: s3_ops._bwd_launch(gb, coords, shape, False, p)))
    del vol, coords, gb, dvol, vol_czyx, lib_out, lib_g
    torch.cuda.empty_cache()

    feats, mask, cam3, rel_scale = k1b_inputs(cfg3, device, gen, False)
    (fb,) = _bf16(feats)
    out, valid = sample2d(fb, mask, cam3, "backproject", rel_scale, True)
    h, w = fb.shape[1:3]
    feats_nchw = fb.permute(0, 3, 1, 2).contiguous()
    pix = normalise(cam3, h, w, False)
    bil_ms = time_ms(lambda: sample2d(fb, None, pix, "bilinear"))
    pix_b = pix.to(torch.bfloat16)
    rows["K1b-bf16"] = _row(
        "sample2d (bf16)", "backproject_sample.cu",
        "vfdepth_tpu/ops/pallas_sample.py:176", errs["K1b-bf16"],
        time_ms(lambda: sample2d(fb, mask, cam3, "backproject", rel_scale,
                                 True)),
        time_ms(lambda: sample2d_plain(fb, mask, cam3, "backproject",
                                       rel_scale, True), reps=5),
        nbytes(fb, mask, cam3, out, valid),
        valid.sum().item() * fb.shape[-1] * 4 * 2,
        time_ms(lambda: _grid_sample_2d(feats_nchw, pix_b)),
        dict(feats=fb.shape, cam3=cam3.shape, out=out.shape))
    rows["K1b-bf16"]["bilinear_mode_ms"] = bil_ms
    rows["K1b-bf16"]["stream_ms"] = stream_ms(
        lambda: sample2d(fb, mask, cam3, "backproject", rel_scale, True))
    del feats, fb, mask, cam3, out, valid, feats_nchw, pix, pix_b
    torch.cuda.empty_cache()

    g, cam3, valid, h, w, c = k2b_inputs(cfg3, device, gen, False)
    (gb,) = _bf16(g)
    dfeat = sample2d_bwd(gb, cam3, valid, h, w, c, True)
    lib2b = _library_bwd(torch.zeros(cam3.shape[0], h, w, c, device=device,
                                     dtype=torch.bfloat16),
                         normalise(cam3, h, w, False).to(torch.bfloat16),
                         gb[..., :c].nan_to_num())
    rows["K2b-bf16"] = _row(
        "sample2d_bwd (bf16)", "backproject_sample_bwd.cu",
        "vfdepth_tpu/ops/pallas_sample.py:301", errs["K2b-bf16"],
        time_ms(lambda: sample2d_bwd(gb, cam3, valid, h, w, c, True)),
        time_ms(lambda: sample2d_bwd_plain(gb, cam3, valid, h, w, c, True),
                reps=5),
        int(valid.sum().item()) * c * 2 + nbytes(cam3, valid, dfeat),
        valid.sum().item() * c * 4 * 2, time_ms(lib2b, reps=5),
        dict(g=gb.shape, cam3=cam3.shape, valid=valid.shape,
             dfeat=dfeat.shape))
    rows["K2b-bf16"].update(stage_split(
        lambda: backproject_bwd_plan(cam3, valid, h, w),
        lambda p: bp_ops._bwd_launch(gb, cam3, valid, True, h, w, c,
                                     (cam3.shape[0],), p)))
    del g, gb, cam3, valid, dfeat, lib2b
    torch.cuda.empty_cache()

    img, mask, coords = k5_inputs(cfg, device, gen, False)
    img, mask = _bf16(img, mask)
    maps = warp_image_mask_maps(img, mask, coords)
    n_warps, h, w, _ = img.shape
    img_nchw = img.permute(0, 3, 1, 2).contiguous()
    grid = coords.reshape(n_warps, h, w, 2).to(torch.bfloat16)
    rows["K5-bf16"] = _row(
        "warp_image_mask (bf16)", "warp_image_mask.cu",
        "vfdepth_tpu/ops/warp_mxu.py:75", errs["K5-bf16"],
        time_ms(lambda: warp_image_mask_maps(img, mask, coords)),
        time_ms(lambda: warp_image_mask_maps_plain(img, mask, coords),
                reps=5),
        nbytes(img, mask, coords, *maps), coords.shape[0] * coords.shape[1]
        * 3 * 11,
        time_ms(lambda: F.grid_sample(img_nchw, grid, mode="bilinear",
                                      padding_mode="zeros",
                                      align_corners=True)),
        dict(img=img.shape, mask=mask.shape, coords=coords.shape))
    del img, mask, coords, maps, img_nchw, grid
    torch.cuda.empty_cache()
    _print_rows(rows)
    return rows


def kernel_counters():
    """The launch counter of each kernel form, by row key: (the wrapper,
    the name of its counter). A bf16 form counts apart from the f32 one."""
    from vfdepth_tpu_torch.ops.backproject_sample import (
        backproject_grouped, backproject_grouped_bwd, sample2d, sample2d_bwd)
    from vfdepth_tpu_torch.ops.sample3d import (sample3d_gather,
                                                sample3d_gather_bwd,
                                                sample3d_trilinear,
                                                sample3d_trilinear_bwd,
                                                sample3d_trilinear_bwd_bf16)
    from vfdepth_tpu_torch.ops.warp import warp_image_mask_maps
    f32, bf16 = "launches", "launches_bf16"
    return {"K1": (backproject_grouped, f32), "K1b": (sample2d, f32),
            "K2": (backproject_grouped_bwd, f32), "K2b": (sample2d_bwd, f32),
            "K3": (sample3d_trilinear, f32), "K4": (sample3d_trilinear_bwd, f32),
            "K5": (warp_image_mask_maps, f32),
            "K1-bf16": (backproject_grouped, bf16),
            "K1b-bf16": (sample2d, bf16),
            "K2-bf16": (backproject_grouped_bwd, bf16),
            "K2b-bf16": (sample2d_bwd, bf16),
            "K3-bf16": (sample3d_trilinear, bf16),
            "K4-bf16": (sample3d_trilinear_bwd_bf16, f32),
            "K4-f32upd-bf16": (sample3d_trilinear_bwd, bf16),
            "K5-bf16": (warp_image_mask_maps, bf16),
            "K3-gather-bf16": (sample3d_gather, bf16),
            "K4-gather-bf16": (sample3d_gather_bwd, bf16)}


def reset_counts():
    for fn, attr in kernel_counters().values():
        setattr(fn, attr, 0)


def read_counts():
    return {k: getattr(fn, attr) for k, (fn, attr) in kernel_counters().items()}


def launches(**counts):
    """Expected launches by kernel: the given ones, 0 for every other."""
    return {k: counts.get(k, 0) for k in kernel_counters()}


def _dataset(cfg, n: int, rig: str):
    from vfdepth_tpu_torch.data import FakeDataset
    return FakeDataset(num_samples=n, num_cams=cfg.num_cams,
                       height=cfg.height, width=cfg.width,
                       frame_ids=tuple(cfg.frame_ids),
                       fusion_level=cfg.fusion_level, rig=rig)


def run_serving_path(cfg, device, label: str, per_request, rig: str,
                     tols=(FWD_RTOL, POSE_ATOL)):
    """3 full-width requests through ``VFDepthModel.predict``; returns
    (launches per kernel over the 3 requests, per-request ms, the model,
    the requests, their outputs, the requests' rotated-view draws). Under
    ``aug_depth`` each request draws its rotated views (``aug_draws``).
    ``tols``: request 1 against the plain versions (``compare_outputs``)."""
    from vfdepth_tpu_torch.training.model import VFDepthModel

    t0 = time.perf_counter()
    model = VFDepthModel(cfg, device=device, seed=0)
    ds = _dataset(cfg, N_REQUESTS, rig)
    requests = [ds.batch([i]) for i in range(N_REQUESTS)]
    draws = aug_draws(model, requests)
    model.predict(requests[0], aug_u=draws[0])  # warm-up (not counted)
    torch.cuda.synchronize()
    print(f"{label} serving path set-up (model, data, warm-up): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    reset_counts()
    outputs, ms = [], []
    for i, req in enumerate(requests):
        before = read_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = model.predict(req, aug_u=draws[i])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        delta = {k: n - before[k] for k, n in read_counts().items()}
        check(delta == per_request, f"{label} request {i}: kernel launches "
                                    f"{delta}, expected {per_request}")
        outputs.append(out)
        print(f"{label} request {i}: {ms[-1]:.2f} ms", flush=True)
    counts = read_counts()

    b, cams, h, w = 1, cfg.num_cams, cfg.height, cfg.width
    n_ctx = len(cfg.frame_ids) - 1
    for i, (req, out) in enumerate(zip(requests, outputs)):
        cam = out["cam_T_cam"]
        check(tuple(cam.shape) == (b, cams, n_ctx, 4, 4), f"cam_T_cam shape "
              f"{tuple(cam.shape)}")
        check(bool(torch.isfinite(cam).all()), "cam_T_cam not finite")
        rot = cam[..., :3, :3]
        eye = torch.eye(3, device=device)
        check((rot @ rot.transpose(-1, -2) - eye).abs().max().item() < 1e-4,
              "cam_T_cam rotations not orthonormal")
        fx = torch.from_numpy(req["K/0"][..., 0, 0]).to(device)[..., None,
                                                                 None, None]
        lo = cfg.min_depth * fx / cfg.focal_length_scale
        hi = cfg.max_depth * fx / cfg.focal_length_scale
        tags = ("", "/aug") if model.aug_depth else ("",)
        check(set(out) == {"cam_T_cam"} | {f"{k}/{s}{t}" for k in (
            "disp", "depth") for s in cfg.scales for t in tags},
            f"{label}: outputs {sorted(out)}")
        for s in cfg.scales:
            for tag in tags:
                disp, depth = out[f"disp/{s}{tag}"], out[f"depth/{s}{tag}"]
                check(tuple(depth.shape) == (b, cams, h, w, 1),
                      f"depth shape {tuple(depth.shape)}")
                check(bool(torch.isfinite(depth).all()), "depth not finite")
                check(bool(((disp >= 0) & (disp <= 1)).all()),
                      "disp not in [0,1]")
                check(bool(((depth >= lo * (1 - 1e-5))
                            & (depth <= hi * (1 + 1e-5))).all()),
                      "depth outside the metric range")
        aug = (f"; depth/0/aug in [{out['depth/0/aug'].min().item():.3f}, "
               f"{out['depth/0/aug'].max().item():.3f}] m"
               if model.aug_depth else "")
        print(f"{label} request {i}: depth/0 in "
              f"[{outputs[i]['depth/0'].min().item():.3f}, "
              f"{outputs[i]['depth/0'].max().item():.3f}] m{aug}; |t| max "
              f"{cam[..., :3, 3].abs().max().item():.4f}", flush=True)

    # request 1 again with the plain versions of the kernels (same weights)
    model.plain_samplers = True
    ref = model.predict(requests[1], aug_u=draws[1])
    torch.cuda.synchronize()
    model.plain_samplers = False
    check(read_counts() == counts,
          "the plain reference run launched a kernel")
    compare_outputs(f"{label} request 1 kernels vs plain", outputs[1], ref,
                    *tols)
    profile(f"{label} request", lambda: model.predict(requests[2],
                                                      aug_u=draws[2]))
    return counts, ms, model, requests, outputs, draws


def aug_draws(model, requests):
    """Each request's seeded draw of the rotated views (uniform [b, cams,
    3]) where the model runs the depth-synthesis branch, else None."""
    if not model.aug_depth:
        return [None] * len(requests)
    return [torch.rand(model.aug_shape(req),
                       generator=torch.Generator().manual_seed(100 + i))
            for i, req in enumerate(requests)]


def compare_outputs(what, got, ref, fwd_rtol=FWD_RTOL, pose_atol=POSE_ATOL):
    """Poses within ``pose_atol``, every other output within ``fwd_rtol`` of
    its magnitude."""
    for key, val in got.items():
        diff = (val - ref[key]).abs().max().item()
        if key == "cam_T_cam":
            tol = pose_atol
        else:
            tol = fwd_rtol * ref[key].abs().max().item()
        print(f"{what}: {key} max_abs_diff={diff:.3e} (tol {tol:.3e})",
              flush=True)
        check(diff <= tol, f"{what}: {key} disagrees")


def run_unmerged(model, request, merged_out, label: str, per_request,
                 tols=(FWD_RTOL, POSE_ATOL), aug_u=None):
    """One request with ``merge_backprojection: false`` (each net
    back-projects its own features) from the serving model's weights, held
    against that model's merged output for the same request, after one
    uncounted warm-up request (the separate nets' shapes are new to cuDNN);
    returns (the launches, ms)."""
    model.merge_backproject = False
    model.predict(request, aug_u=aug_u)
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = model.predict(request, aug_u=aug_u)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    counts = read_counts()
    model.merge_backproject = True
    check(counts == per_request, f"{label} unmerged request: kernel launches "
                                 f"{counts}, expected {per_request}")
    print(f"{label} unmerged request: {ms:.2f} ms", flush=True)
    compare_outputs(f"{label} unmerged vs merged", out, merged_out, *tols)
    return counts, ms


def _grads(model):
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def capture_k5(fn):
    """Runs ``fn()`` with ``render_views``' warp entry recording a copy of
    what it hands K5: returns [(img, mask, coords)], one per call, in call
    order."""
    from vfdepth_tpu_torch.geometry import view_rendering
    original = view_rendering.warp_image_mask
    calls = []

    def recording(img, mask, coords, plain=False):
        calls.append((img.clone(), mask.clone(), coords.clone()))
        return original(img, mask, coords, plain)
    view_rendering.warp_image_mask = recording
    try:
        fn()
    finally:
        view_rendering.warp_image_mask = original
    return calls


def capture_k3k4(fn, sampler: str = "Sample3dTrilinear"):
    """Runs ``fn()`` with the depth net's frustum sampler
    (``Sample3dTrilinear`` as ``models/vfnet.py`` calls it, or the
    ``sampler`` named: ``Sample3dGather``, the gather-bf16 forms) recording
    copies of what it hands K3 and K4: {"fwd": [(vol, coords)] in call
    order, "bwd": [(g, coords, vol_shape)] (each sample's cotangent, as K4
    receives it) in the order the backward reaches them}."""
    import types
    from vfdepth_tpu_torch.models import vfnet
    original = getattr(vfnet, sampler)
    calls = {"fwd": [], "bwd": []}

    def apply(vol, coords, *args):
        calls["fwd"].append((vol.detach().clone(), coords.clone()))
        out = original.apply(vol, coords, *args)
        if out.requires_grad:
            shape = tuple(vol.shape)
            out.register_hook(lambda g: calls["bwd"].append(
                (g.detach().contiguous().clone(), coords, shape)))
        return out
    setattr(vfnet, sampler, types.SimpleNamespace(apply=apply))
    try:
        fn()
    finally:
        setattr(vfnet, sampler, original)
    return calls


def touched_voxels(coords, vol_shape):
    """(voxel rows that some live tap of coords [B, N, 3] reads, points
    with a live tap) in a [B, H, W, D, C] volume."""
    from vfdepth_tpu_torch.ops import sample3d as s3
    nb, h, w, d, _ = vol_shape
    rows, live = 0, 0
    for b in range(nb):
        base, wts = s3._point_taps(coords[b], h, w, d)
        taps = torch.stack([base + off for off in s3._tap_offsets(w, d)])
        on = torch.stack(wts).ne(0)
        rows += int(torch.unique(taps[on]).numel())
        live += int(on.any(0).sum())
    return rows, live


def check_rotated_frusta(rows, calls):
    """K3 and K4 (f32 updates) on the coordinates the 6-camera
    depth-synthesis step handed them (``capture_k3k4``): the main frusta and
    the rotated ones (``augment_extrinsics``: the config's angles act as
    radians, so most rotated points fall outside the volume). For each: the
    share of points inside the volume, K3 against its plain version and
    timed (a call alone and 20 back to back), K4's plan on the card against
    the plain plan (live points, tiles, the hottest tile's contributions,
    tiles cut in chunks), K4 against its plain version, two launches
    bit-identical, and timed (whole call, plan, reduce; 20 back to back).
    The rotated results join the K3 and K4 rows as ``rotated``, the step's
    main frusta as ``step_main``."""
    from vfdepth_tpu_torch.ops import sample3d as s3
    check(len(calls["fwd"]) == 2 and len(calls["bwd"]) == 2,
          f"the depth-synthesis step called K3 {len(calls['fwd'])} and K4 "
          f"{len(calls['bwd'])} times, expected 2 and 2")
    (vol, main), (vol_aug, rotated) = calls["fwd"]
    check(torch.equal(vol, vol_aug), "the two decodes sampled two volumes")
    out = {}
    for name, coords in (("step_main", main), ("rotated", rotated)):
        bwd = [c for c in calls["bwd"] if torch.equal(c[1], coords)]
        check(len(bwd) == 1, f"K4 {name}: {len(bwd)} matching calls")
        g, _, vol_shape = bwd[0]
        inside = ((coords.abs() <= 1.0).all(-1)).float().mean().item()
        got = s3.sample3d_trilinear(vol, coords)
        ref = s3.sample3d_trilinear_plain(vol, coords)
        torch.cuda.synchronize()
        err3 = (got - ref).abs().max().item()
        tol3 = K3_TOL * vol.abs().max().item()
        check(err3 <= tol3, f"K3 on the {name} frusta differs from its plain "
                            f"version: {err3} > {tol3}")
        # the work this data needs: the voxel rows some live tap reads, the
        # points, the output; 8 multiply-adds a live point and channel
        rows_read, live_pts = touched_voxels(coords, vol.shape)
        k3 = dict(ms=time_ms(lambda: s3.sample3d_trilinear(vol, coords)),
                  stream_ms=stream_ms(lambda: s3.sample3d_trilinear(
                      vol, coords)),
                  bound_ms=bound(rows_read * vol.shape[-1]
                                 * vol.element_size() + nbytes(coords, got),
                                 live_pts * vol.shape[-1] * 16)[0],
                  inside_share=inside, live_share=live_pts / (
                      coords.shape[0] * coords.shape[1]),
                  voxel_rows_read=rows_read, max_abs_err=err3)
        del got, ref
        plan = s3.sample3d_bwd_plan(coords, vol_shape)
        plain = s3.sample3d_bwd_plan_plain(coords, vol_shape)
        for field, val in plan.fields().items():
            check(torch.equal(val, plain.fields()[field].to(val.device)),
                  f"K4 {name}: the card's plan differs from the plain plan "
                  f"in {field}")
        grid = s3._grid(vol_shape, False)
        _, lens = grid.runs(plain.start)
        totals = lens.sum(1)
        chunks = (plan.chunk_off[1:] - plan.chunk_off[:-1]).cpu()
        live, n = int(plan.start[-1]), plan.order.numel()
        dvol = s3.sample3d_trilinear_bwd(g, coords, vol_shape)
        again = s3.sample3d_trilinear_bwd(g, coords, vol_shape)
        ref = s3.sample3d_trilinear_bwd_plain(g, coords, vol_shape)
        torch.cuda.synchronize()
        check(torch.equal(dvol, again), f"K4 {name}: two launches differ")
        err4 = (dvol - ref).abs().max().item()
        tol4 = K4_TOL * ref.abs().max().item()
        check(err4 <= tol4, f"K4 on the {name} frusta differs from its plain "
                            f"version: {err4} > {tol4}")
        k4 = dict(ms=time_ms(lambda: s3.sample3d_trilinear_bwd(g, coords,
                                                               vol_shape)),
                  stream_ms=stream_ms(lambda: s3.sample3d_trilinear_bwd(
                      g, coords, vol_shape)),
                  bound_ms=bound(live * vol_shape[-1] * g.element_size()
                                 + nbytes(coords, dvol),
                                 live * vol_shape[-1] * 16)[0],
                  live_share=live / n, tiles=len(chunks),
                  hottest_tile=int(totals.max()),
                  mean_tile=float(totals.float().mean()),
                  cut_tiles=int((chunks > 1).sum()),
                  max_chunks=int(chunks.max()), chunk=int(plan.params[0]),
                  max_abs_err=err4,
                  **stage_split(lambda: s3.sample3d_bwd_plan(coords,
                                                             vol_shape),
                                lambda p: s3._bwd_launch(g, coords,
                                                         vol_shape, False,
                                                         p)))
        del dvol, again, ref, plan, plain
        out[name] = (k3, k4)
        print(f"K3 on the {name} frusta of the depth-synthesis step "
              f"({coords.shape[1]} points a frameset, batch "
              f"{coords.shape[0]}): {100 * inside:.1f}% inside the volume, "
              f"{100 * k3['live_share']:.1f}% with a tap in it, "
              f"{rows_read} voxel rows read; "
              f"max_abs_err {err3:.3e} (tol {tol3:.3e}); {k3['ms']:.4f} ms "
              f"a call, {k3['stream_ms']:.4f} back to back, bound "
              f"{k3['bound_ms']:.4f}", flush=True)
        print(f"K4 on the {name} frusta: plan {live} live of {n} points "
              f"({100 * live / n:.1f}%), {len(chunks)} tiles, hottest tile "
              f"{int(totals.max())} contributions (mean "
              f"{float(totals.float().mean()):.1f}), chunk "
              f"{k4['chunk']}, {k4['cut_tiles']} tiles cut (up to "
              f"{k4['max_chunks']} chunks); equal to the plain plan; two "
              f"launches bit-identical; max_abs_err {err4:.3e} (tol "
              f"{tol4:.3e}); {k4['ms']:.4f} ms a call (plan "
              f"{k4['plan_ms']:.4f} + reduce {k4['reduce_ms']:.4f}), "
              f"{k4['stream_ms']:.4f} back to back, bound "
              f"{k4['bound_ms']:.4f}", flush=True)
    for key, i in (("K3", 0), ("K4", 1)):
        for name, res in out.items():
            rows[key][name] = res[i]
        rows[key]["max_abs_err"] = max(rows[key]["max_abs_err"],
                                       *(r[i]["max_abs_err"]
                                         for r in out.values()))
    del calls["fwd"][:], calls["bwd"][:]
    torch.cuda.empty_cache()


def time_k5_on_step(key, row, calls):
    """K5's row (``key`` "K5" or "K5-bf16") timed on the coordinates that
    ``render_views`` handed it in one training step (``calls``, from
    ``capture_k5``): each call against its plain version, then timed beside
    its bound; the row's ``ms`` and ``bound_ms`` become the calls' means,
    and the random-depth input's become ``stress_ms`` and
    ``stress_bound_ms``."""
    from vfdepth_tpu_torch.ops.warp import (warp_image_mask_maps,
                                            warp_image_mask_maps_plain)
    check(len(calls) == 4, f"{key}: {len(calls)} calls in a step, expected 4")
    bf16 = key.endswith("bf16")
    tol = BF16_STEP if bf16 else K5_TOL
    img, mask, coords = calls[0]
    got = warp_image_mask_maps(img, mask, coords)
    ref = warp_image_mask_maps_plain(img, mask, coords)
    torch.cuda.synchronize()
    err = max((a.float() - r.float()).abs().max().item()
              for a, r in zip(got, ref))
    check(err <= tol, f"{key} on the step's coordinates differs from its "
                      f"plain version: {err} > {tol}")
    del got, ref
    times, streams, bounds, devices = [], [], [], []
    for img, mask, coords in calls:
        maps = warp_image_mask_maps(img, mask, coords)
        times.append(time_ms(lambda: warp_image_mask_maps(img, mask,
                                                          coords)))
        streams.append(stream_ms(lambda: warp_image_mask_maps(img, mask,
                                                              coords)))
        devices.append(profiler_ms(lambda: warp_image_mask_maps(
            img, mask, coords), "warp_image_mask"))
        bounds.append(bound(nbytes(img, mask, coords, *maps),
                            coords.shape[0] * coords.shape[1] * 3 * 11)[0])
        del maps
    row.update(stress_ms=row["ms"], stress_bound_ms=row["bound_ms"],
               ms=statistics.mean(times), bound_ms=statistics.mean(bounds),
               stream_ms=statistics.mean(streams), step_call_ms=times,
               step_call_stream_ms=streams, step_call_bound_ms=bounds,
               profiler_ms=statistics.mean(devices),
               step_call_profiler_ms=devices,
               max_abs_err=max(row["max_abs_err"], err))
    print(f"{key} on the step's own coordinates (4 calls of one training "
          f"step; call 1 against plain: max_abs_err {err:.3e}, tol "
          f"{tol:.1e}): per call {[round(t, 4) for t in times]} ms, back "
          f"to back {[round(t, 4) for t in streams]} ms, bound "
          f"{[round(b, 4) for b in bounds]} ms, mean {row['ms']:.4f} ms "
          f"({100 * row['bound_ms'] / row['ms']:.1f}% of the bound; back to "
          f"back {row['stream_ms']:.4f}, "
          f"{100 * row['bound_ms'] / row['stream_ms']:.1f}%; profiler "
          f"device time {[round(t, 4) for t in devices]} ms, mean "
          f"{row['profiler_ms']:.4f}, "
          f"{100 * row['bound_ms'] / row['profiler_ms']:.1f}% of the bound); "
          f"stress input "
          f"(random depth per pixel) {row['stress_ms']:.4f} ms "
          f"({100 * row['stress_bound_ms'] / row['stress_ms']:.1f}%)",
          flush=True)


def run_training_path(cfg, device, label: str, per_step, rig: str,
                      tols=(STEP_LOSS_RTOL, STEP_GRAD_RTOL), k5_calls=None,
                      k3k4_calls=None, sampler: str = "Sample3dTrilinear"):
    """Full-width training steps at the config's batch through
    ``train_step``; returns (launches per kernel over the timed steps,
    per-step ms). ``tols``: step 1 against the plain versions, the loss's
    (and the depth-synthesis logs') relative difference and each
    gradient's relative L2 difference. ``k5_calls``: a list that receives
    K5's inputs of the (uncounted) warm-up step; ``k3k4_calls`` a dict that
    receives K3's and K4's (``capture_k3k4``; ``sampler`` names the
    frustum sampler's Function to record)."""
    loss_rtol, grad_rtol = tols
    from vfdepth_tpu_torch.training import (VFDepthModel, create_train_state,
                                            train_step)

    b = cfg.batch_size
    t0 = time.perf_counter()
    model = VFDepthModel(cfg, device=device, seed=0)
    opt = create_train_state(model)
    ds = _dataset(cfg, b * (N_STEPS + 1), rig)
    batches = [ds.batch(list(range(i * b, (i + 1) * b)))
               for i in range(N_STEPS + 1)]

    def noise_gen(step):      # the same tie-break noise for a repeated step
        return torch.Generator(device).manual_seed(1000 + step)

    warm = {}

    def warm_up():
        warm["logs"] = train_step(model, opt, batches[0], 0, noise_gen(0))

    def run_k5():
        if k5_calls is None:
            warm_up()
        else:
            k5_calls.extend(capture_k5(warm_up))
    if k3k4_calls is None:
        run_k5()
    else:
        k3k4_calls.update(capture_k3k4(run_k5, sampler))
    logs0 = warm["logs"]
    torch.cuda.synchronize()
    print(f"{label} training path set-up (model, data, warm-up step): "
          f"{time.perf_counter() - t0:.1f} s; step 0 loss "
          f"{logs0['total_loss'].item():.6f}", flush=True)
    params0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt0 = copy.deepcopy(opt.state_dict())

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for step in range(1, N_STEPS + 1):
        before = read_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        logs = train_step(model, opt, batches[step], step, noise_gen(step))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        delta = {k: n - before[k] for k, n in read_counts().items()}
        check(delta == per_step, f"{label} step {step}: kernel launches "
                                 f"{delta}, expected {per_step}")
        losses.append(logs["total_loss"].item())
        if step == 1:
            grads1, logs1 = _grads(model), logs
        aug = "".join(f", {k} {logs[k].item():.6f}" for k in AUG_LOGS
                      if k in logs)
        print(f"{label} step {step}: {ms[-1]:.2f} ms, loss {losses[-1]:.6f}, "
              f"reproj {logs['reproj_loss'].item():.6f}, spatio "
              f"{logs['spatio_loss'].item():.6f}, spatio-temporal "
              f"{logs['spatio_tempo_loss'].item():.6f}, auto-mask cover "
              f"{logs['amask_cover'].item():.4f}{aug}", flush=True)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{label} training path: peak device memory {peak:.2f} GiB",
          flush=True)

    check(all(math.isfinite(v) for v in losses), "training loss not finite")
    for name, g in grads1.items():
        check(bool(torch.isfinite(g).all()), f"gradient of {name} not finite")
    for net in ("depth_net", "pose_net"):
        check(any(g.abs().max().item() > 0 for k, g in grads1.items()
                  if k.startswith(net + ".")), f"{net}: every gradient is 0")
    state = model.state_dict()
    tracked = [k for k in params0 if not k.endswith("num_batches_tracked")]
    moved = [k for k in tracked if not torch.equal(params0[k], state[k])]
    for kind in ("weight", "running_mean", "running_var"):
        check(any(k.endswith(kind) for k in moved), f"no {kind} moved")
    print(f"{label} training path: {len(moved)} of {len(tracked)} "
          f"parameters and "
          f"BatchNorm statistics moved", flush=True)

    # step 1 again from the same state and batch, plain versions
    model.load_state_dict(params0)
    opt.load_state_dict(opt0)
    model.plain_samplers = True
    logs_p = train_step(model, opt, batches[1], 1, noise_gen(1))
    torch.cuda.synchronize()
    model.plain_samplers = False
    check(read_counts() == counts, "the plain reference step launched a "
                                   "kernel")
    lk, lp = logs1["total_loss"].item(), logs_p["total_loss"].item()
    n_pix = b * cfg.num_cams * cfg.height * cfg.width
    flips = abs(logs1["amask_cover"].item()
                - logs_p["amask_cover"].item()) * n_pix
    print(f"{label} step 1 kernels vs plain: auto-mask cover differs by "
          f"{flips:.0f} of {n_pix} pixels (net flips)", flush=True)
    check(abs(lk - lp) <= loss_rtol * abs(lp),
          f"step 1 loss: kernels {lk} vs plain {lp}")
    for key in AUG_LOGS:
        if key in logs1:
            vk, vp = logs1[key].item(), logs_p[key].item()
            print(f"{label} step 1 kernels vs plain: {key} {vk:.7f} vs "
                  f"{vp:.7f}", flush=True)
            check(math.isfinite(vk) and abs(vk - vp) <= loss_rtol * abs(vp),
                  f"step 1 {key}: kernels {vk} vs plain {vp}")
    worst, worst_name = 0.0, ""
    for name, p in model.named_parameters():
        ref = p.grad
        rel = ((grads1[name] - ref).norm() / ref.norm().clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, name
    print(f"{label} step 1 kernels vs plain: loss {lk:.7f} vs {lp:.7f} (rel "
          f"{abs(lk - lp) / abs(lp):.2e}, tol {loss_rtol:.0e}); worst "
          f"gradient relative L2 difference {worst:.2e} ({worst_name}; tol "
          f"{grad_rtol:.0e})", flush=True)
    check(worst <= grad_rtol, f"step 1 gradients: {worst_name} differs "
                              f"by {worst} (relative L2)")
    del grads1, params0, opt0, logs_p
    opt.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    profile(f"{label} training step", lambda: train_step(
        model, opt, batches[0], N_STEPS + 1, noise_gen(N_STEPS + 1)))
    return counts, ms


PREFETCH_BATCHES = 50
# device work queued before each read in the prefetch check: a few times
# one full-width batch's pinning and copies (about 12 + 5 ms)
PREFETCH_SLEEP_MS = 60
EVAL_BATCHES = 2
TRAINER_EPOCHS, TRAINER_STEPS = 2, 3        # steps an epoch
# evaluation metrics, kernels against plain versions: relative, and
# absolute for the a1-a3 fractions (a pixel at a threshold may fall on
# either side; one pixel weighs ~3e-7 here). About 5 times the worst
# differences read on an H100: f32 3.8e-8 and 8.5e-8, bf16 2.0e-5 and
# 3.0e-6
EVAL_METRIC_RTOL = 2e-7
EVAL_FRACTION_ATOL = 1e-6
BF16_EVAL_METRIC_RTOL = 1e-4
BF16_EVAL_FRACTION_ATOL = 1.5e-5


def _delta(before):
    return {k: n - before[k] for k, n in read_counts().items()}


def _sleep_cycles_per_ms(device) -> float:
    """Clock cycles of ``torch.cuda._sleep`` per ms on this card."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10 ** 6)                 # warm-up
    start.record()
    torch.cuda._sleep(2 * 10 ** 7)
    end.record()
    end.synchronize()
    return 2 * 10 ** 7 / start.elapsed_time(end)


def check_prefetch(cfg, device):
    """``device_prefetch`` against the pageable route (``_to_device``'s
    ``.to(device, float32)``) over ``PREFETCH_BATCHES`` full-width training
    batches (5 distinct ones in turn, one of them float64), every tensor bit
    for bit, in two passes, each built so that one fault shows on every
    batch:

    * one batch ahead, the consumer reads each batch as soon as it is
      yielded, its own stream empty: the batch's copies were queued just
      before, so a consumer that did not wait for them would read memory
      still being written;
    * two batches ahead (the trainer's depth), the consumer queues
      ``PREFETCH_SLEEP_MS`` of device work before it reads each batch and
      drops the batch at once: the next batch is pinned and copied well
      within that time, so memory handed back to the side stream without
      ``record_stream`` would hold the next batch by the time it is read.
    """
    from vfdepth_tpu_torch.data import device_prefetch
    b = cfg.batch_size
    ds = _dataset(cfg, 5 * b, "even")
    distinct = [ds.batch(list(range(i * b, (i + 1) * b))) for i in range(5)]
    distinct[1] = {k: v.astype("float64") for k, v in distinct[1].items()}
    refs = [{k: torch.as_tensor(v).to(device, torch.float32)
             for k, v in batch.items()} for batch in distinct]
    sleep = int(PREFETCH_SLEEP_MS * _sleep_cycles_per_ms(device))
    consumer = torch.cuda.current_stream(device)
    mb = sum(v.nbytes for v in distinct[0].values()) / 2 ** 20
    for size, busy in ((1, False), (2, True)):
        mismatches, n = [], 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        for got in device_prefetch((distinct[i % 5]
                                    for i in range(PREFETCH_BATCHES)),
                                   size=size, device=device):
            if busy:
                torch.cuda._sleep(sleep)
            ref = refs[n % 5]
            check(got.keys() == ref.keys(), "prefetch: keys differ")
            mismatches.append(sum((got[k].view(torch.int32)
                                   != ref[k].view(torch.int32)).sum()
                                  for k in ref))
            del got
            if not busy:
                consumer.synchronize()
            n += 1
        bad = int(torch.stack(mismatches).sum())
        ms = (time.perf_counter() - t) * 1e3
        what = (f"{PREFETCH_SLEEP_MS} ms of device work queued before each "
                "read" if busy else "each batch read as soon as yielded")
        print(f"prefetch check, {size} ahead, {what}: {n} batches of "
              f"{mb:.1f} MB (f32) through device_prefetch against the "
              f"pageable route, {bad} elements differ; {ms:.1f} ms",
              flush=True)
        check(n == PREFETCH_BATCHES and bad == 0,
              f"prefetch ({size} ahead): {bad} elements differ from the "
              "pageable route")
    del refs, distinct


def run_evaluation_path(cfg, device, label, per_batch, tmp,
                        tols=(FWD_RTOL, POSE_ATOL, EVAL_METRIC_RTOL,
                              EVAL_FRACTION_ATOL)):
    """``Trainer.evaluate`` over ``EVAL_BATCHES`` full-width batches at the
    config's ``eval_batch_size`` (``FakeDataset(with_depth=True)``, the even
    rig), loading the seeded model's checkpoint (``save_checkpoint``) into a
    model of other weights (``models_to_load`` from the config); then batch
    1 and the metrics against the plain versions. Returns (launches over the
    evaluation, per-batch ms, metric and median dicts)."""
    from vfdepth_tpu_torch.data import BatchLoader, FakeDataset
    from vfdepth_tpu_torch.training import (Trainer, VFDepthModel,
                                            create_train_state,
                                            save_checkpoint)
    fwd_rtol, pose_atol, metric_rtol, fraction_atol = tols
    b = cfg.eval_batch_size
    check(cfg.batch_size == b, f"{label}: eval mode sets batch {b}")
    t0 = time.perf_counter()
    seeded = VFDepthModel(cfg, device=device, seed=0)
    cfg.set("load_weights_dir", save_checkpoint(
        str(tmp / "models"), 0, seeded, create_train_state(seeded), 0))
    cfg.set("log_path", str(tmp / "log"))
    model = VFDepthModel(cfg, device=device, seed=1)
    ds = FakeDataset(num_samples=b * EVAL_BATCHES, num_cams=cfg.num_cams,
                     height=cfg.height, width=cfg.width,
                     frame_ids=tuple(cfg.frame_ids),
                     fusion_level=cfg.fusion_level, rig="even",
                     with_depth=True)
    loader = BatchLoader(ds, b, shuffle=False, num_workers=2)
    model.predict(ds.batch(list(range(b))))     # warm-up at batch b
    torch.cuda.synchronize()
    print(f"{label} evaluation set-up (models, checkpoint, data, warm-up): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    record = []
    real_predict = model.predict

    def counted(batch, aug_u=None):
        before = read_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_predict(batch, aug_u=aug_u)
        torch.cuda.synchronize()
        record.append(((time.perf_counter() - t) * 1e3, _delta(before)))
        return out
    model.predict = counted
    reset_counts()
    metric, median = Trainer(cfg, model, use_tb=False).evaluate(loader)
    counts = read_counts()
    del model.predict
    check(len(record) == EVAL_BATCHES,
          f"{label}: {len(record)} batches evaluated")
    for i, (ms, delta) in enumerate(record):
        check(delta == per_batch, f"{label} evaluation batch {i}: kernel "
                                  f"launches {delta}, expected {per_batch}")
        print(f"{label} evaluation batch {i}: {ms:.2f} ms (batch {b})",
              flush=True)
    for name in cfg.models_to_load:
        live, saved = (getattr(m, name).state_dict() for m in (model, seeded))
        check(all(torch.equal(v, saved[k]) for k, v in live.items()),
              f"{label}: evaluate did not load {name} from the checkpoint")
    check(all(math.isfinite(v) for v in (*metric.values(), *median.values())),
          f"{label}: metrics not finite")
    del seeded

    batch = ds.batch(list(range(b)))
    got = model.predict(batch)
    after = read_counts()
    model.plain_samplers = True
    ref = model.predict(batch)
    plain_metric, plain_median = Trainer(cfg, model, use_tb=False).evaluate(
        loader, load_weights=False)
    model.plain_samplers = False
    torch.cuda.synchronize()
    check(read_counts() == after, "the plain evaluation launched a kernel")
    compare_outputs(f"{label} evaluation batch 0 (batch {b}) kernels vs "
                    f"plain", got, ref, fwd_rtol, pose_atol)
    worst = {"relative": 0.0, "fraction": 0.0}
    for name, got_d, ref_d in (("metric", metric, plain_metric),
                               ("median", median, plain_median)):
        for k, r in ref_d.items():
            kind = "fraction" if k in ("a1", "a2", "a3") else "relative"
            diff = abs(got_d[k] - r) / (1.0 if kind == "fraction" else abs(r))
            worst[kind] = max(worst[kind], diff)
            check(diff <= (fraction_atol if kind == "fraction"
                           else metric_rtol),
                  f"{label} evaluation {name} {k}: kernels {got_d[k]} vs "
                  f"plain {r}")
    print(f"{label} evaluation metrics, kernels vs plain: worst relative "
          f"difference {worst['relative']:.3e} (limit {metric_rtol:g}), "
          f"worst a1-a3 difference {worst['fraction']:.3e} (limit "
          f"{fraction_atol:g})", flush=True)
    del got, ref
    profile(f"{label} evaluation batch (batch {b})",
            lambda: model.predict(batch))
    return counts, [ms for ms, _ in record], metric, median


def _same_training_state(model, opt, other, other_opt, what):
    """``other`` holds ``model``'s parameters, BatchNorm statistics and Adam
    state, bit for bit, on its own device (the update count on the CPU)."""
    theirs = other.state_dict()
    for k, v in model.state_dict().items():
        check(torch.equal(v.cpu(), theirs[k].cpu()), f"{what}: {k} differs")
    mine = [p for g in opt.param_groups for p in g["params"]]
    loaded = [p for g in other_opt.param_groups for p in g["params"]]
    check(len(mine) == len(loaded), f"{what}: optimizer parameters differ")
    for p, q in zip(mine, loaded):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            check(torch.equal(opt.state[p][key].cpu(),
                              other_opt.state[q][key].cpu()),
                  f"{what}: Adam {key} differs")
        check(other_opt.state[q]["exp_avg"].device == q.device
              and other_opt.state[q]["step"].device.type == "cpu",
              f"{what}: Adam state on the wrong device")


def run_trainer_path(cfg, device, label, per_step, per_validation, tmp):
    """``Trainer.learn``: ``TRAINER_EPOCHS`` epochs of ``TRAINER_STEPS``
    full-width steps at the config's batch, from a shuffled ``BatchLoader``
    through ``device_prefetch``, validation at the log checkpoints (steps 0,
    2, 4) on a cycled one-batch loader with depth, ``weights_<epoch>``
    saved each epoch; ``weights_1`` reloaded on the card and on the CPU;
    then one profiled step with the pinned prefetch and one with the
    pageable route. Returns (launches over the run, the loop's ms a step:
    its wall time less the validations and checkpoint writes, over the
    steps)."""
    from vfdepth_tpu_torch.data import BatchLoader, FakeDataset, device_prefetch
    from vfdepth_tpu_torch.training import (Trainer, VFDepthModel,
                                            create_train_state,
                                            load_checkpoint, train_step)
    from vfdepth_tpu_torch.training import trainer as trainer_module
    b = cfg.batch_size
    for key, value in (("num_fake_samples", b * TRAINER_STEPS),
                       ("num_epochs", TRAINER_EPOCHS), ("log_frequency", 2),
                       ("early_phase", 1000), ("late_log_frequency", 1000),
                       ("save_frequency", 1), ("log_path", str(tmp / "log")),
                       ("save_weights_root", str(tmp / "models"))):
        cfg.set(key, value)
    model = VFDepthModel(cfg, device=device, seed=0)
    train_loader = BatchLoader(_dataset(cfg, b * TRAINER_STEPS, "even"), b,
                               shuffle=True, num_workers=2)
    val_loader = BatchLoader(
        FakeDataset(num_samples=b, num_cams=cfg.num_cams, height=cfg.height,
                    width=cfg.width, frame_ids=tuple(cfg.frame_ids),
                    fusion_level=cfg.fusion_level, rig="even",
                    with_depth=True), b, shuffle=False, num_workers=0)
    trainer = Trainer(cfg, model, use_tb=False)
    steps, validations, saves = [], [], []
    real_step, real_validate = trainer_module.train_step, trainer._validate
    real_save = trainer_module.save_checkpoint

    # a step is not synchronised: the loop runs as it would, the next
    # batch's pinning overlapping the device's work; CUDA events give each
    # step's device span, from the end of the work queued before it
    def counted_step(*args, **kwargs):
        before = read_counts()
        entered = time.perf_counter()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        logs = real_step(*args, **kwargs)
        end.record()
        steps.append((start, end, _delta(before),
                      logs["total_loss"].detach(), entered))
        return logs

    # validations and checkpoint writes are timed to be taken out of the
    # loop's wall time
    def synchronised(fn, record):
        def run(*args, **kwargs):
            before = read_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            record.append(((time.perf_counter() - t) * 1e3, _delta(before)))
            return out
        return run
    trainer._validate = synchronised(real_validate, validations)
    trainer_module.train_step = counted_step
    trainer_module.save_checkpoint = synchronised(real_save, saves)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        opt = trainer.learn(train_loader, val_loader, seed=0)
        torch.cuda.synchronize()
    finally:
        trainer_module.train_step = real_step
        trainer_module.save_checkpoint = real_save
    wall = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    n = TRAINER_EPOCHS * TRAINER_STEPS
    check(len(steps) == n, f"{label}: {len(steps)} steps, expected {n}")
    for i, (start, end, delta, loss, _) in enumerate(steps):
        check(delta == per_step, f"{label} step {i}: kernel launches "
                                 f"{delta}, expected {per_step}")
        check(math.isfinite(loss.item()), f"{label} step {i}: loss not "
                                          "finite")
        print(f"{label} step {i}: train_step's device span "
              f"{start.elapsed_time(end):.2f} ms (CUDA events; the feed "
              f"not in it), loss {loss.item():.6f}", flush=True)
    check(len(validations) == 3, f"{label}: {len(validations)} validations, "
                                 "expected 3 (steps 0, 2, 4)")
    for i, (_, delta) in enumerate(validations):
        check(delta == per_validation, f"{label} validation {i}: kernel "
                                       f"launches {delta}, expected "
                                       f"{per_validation}")
    check(len(saves) == TRAINER_EPOCHS, f"{label}: {len(saves)} checkpoints")
    val_ms = sum(ms for ms, _ in validations)
    save_ms = sum(ms for ms, _ in saves)
    loop_ms = (wall - val_ms - save_ms) / n
    print(f"{label}: learn() {wall:.2f} ms wall for {n} steps, "
          f"{len(validations)} validations ({val_ms:.2f} ms) and "
          f"{len(saves)} checkpoint writes ({save_ms:.2f} ms); the loop "
          f"{loop_ms:.2f} ms a step with the pinned prefetch (wall less the "
          f"validations and writes, over {n} steps: the feed included)",
          flush=True)
    gaps = [round(a[1].elapsed_time(b[0]), 2) for a, b in zip(steps, steps[1:])]
    print(f"{label}: host {(steps[0][4] - t0) * 1e3:.2f} ms from learn()'s "
          f"start to step 0; the device idle between steps {gaps} ms (CUDA "
          f"events; a validation after steps 0, 2, 4, a checkpoint and a new "
          f"epoch after step {TRAINER_STEPS - 1})", flush=True)

    path = Path(cfg.save_weights_root)
    check(sorted(p.name for p in path.iterdir()) == ["weights_0",
                                                     "weights_1"],
          f"{label}: checkpoints {sorted(path.iterdir())}")
    spe = train_loader.steps_per_epoch
    for where in (device, torch.device("cpu")):
        fresh = VFDepthModel(cfg, device=where, seed=1)
        fresh_opt = create_train_state(fresh, steps_per_epoch=spe)
        step = load_checkpoint(str(path / "weights_1"), fresh, fresh_opt)
        check(step == n, f"{label}: weights_1 holds step {step}")
        _same_training_state(model, opt, fresh, fresh_opt,
                             f"{label} weights_1 loaded on {where.type}")
        del fresh, fresh_opt
    print(f"{label}: weights_1 reloaded on the card and on the CPU: "
          f"parameters, BatchNorm statistics and Adam state bit for bit",
          flush=True)

    gen = torch.Generator(device).manual_seed(5)
    it = device_prefetch(train_loader, size=2, device=device)
    train_step(model, opt, next(it), n, gen)
    pageable = train_loader.dataset.batch(list(range(b)))
    uploads = {}
    for route, fn in (
            ("pinned prefetch", lambda: train_step(model, opt, next(it),
                                                   n + 1, gen)),
            ("pageable", lambda: train_step(model, opt, pageable, n + 2,
                                            gen))):
        rows = profile(f"{label} step, {route}", fn)
        uploads[route] = [(us, c) for key, us, c in rows
                          if "Memcpy HtoD" in key]
        for key, us, c in rows:
            if "Memcpy" in key:
                print(f"  {key}: {us / 1e3:.3f} ms x{c}", flush=True)
    for route, ups in uploads.items():
        print(f"{label} step upload ({route}): Memcpy HtoD "
              f"{sum(us for us, _ in ups) / 1e3:.2f} ms device time over "
              f"{sum(c for _, c in ups)} copies", flush=True)
    del it
    upload_times(pageable, device, label)
    opt.zero_grad(set_to_none=True)
    return counts, loop_ms


def upload_times(batch, device, label, reps: int = 5):
    """One batch's upload by each route, alone, median of ``reps``, host
    clock: the pageable route (``_to_device``'s copies, to a sync), and
    ``device_prefetch`` one batch ahead: the time its ``next()`` holds the
    loop's thread (pinning, the copies queued) and the time to the end of
    the copies (the consumer's stream synchronised)."""
    from vfdepth_tpu_torch.data import device_prefetch
    consumer = torch.cuda.current_stream(device)
    mb = sum(v.nbytes for v in batch.values()) / 2 ** 20
    times = {"pageable": [], "next": [], "copied": []}
    it = device_prefetch((batch for _ in range(reps)), size=1, device=device)
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        dev = {k: torch.as_tensor(v).to(device, torch.float32)
               for k, v in batch.items()}
        torch.cuda.synchronize()
        times["pageable"].append((time.perf_counter() - t) * 1e3)
        del dev
        t = time.perf_counter()
        dev = next(it)
        times["next"].append((time.perf_counter() - t) * 1e3)
        consumer.synchronize()
        times["copied"].append((time.perf_counter() - t) * 1e3)
        del dev
    check(next(it, None) is None, "device_prefetch yielded too many batches")
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"{label} upload of one batch ({mb:.1f} MB, median of {reps}, host "
          f"clock): pageable {med['pageable']:.2f} ms "
          f"({mb / 1024 / med['pageable'] * 1e3:.1f} GiB/s); device_prefetch "
          f"one ahead: next() {med['next']:.2f} ms on the loop's thread "
          f"(pinning, copies queued), copies done at {med['copied']:.2f} ms",
          flush=True)
    return med


def run_clis(tmp, aug: bool = False):
    """The port's command lines on the card, as a user runs them: train 2
    steps of ``configs/tiny_fake.yaml`` (its ``log_dir`` moved into
    ``tmp``), then evaluate the checkpoint it wrote. ``aug``: the same with
    ``aug_depth`` on and the eval's depth-synthesis sweep (``syn_visualize``
    at batch ``SYN_IDX``, all its views written)."""
    src = (ROOT / "configs" / "tiny_fake.yaml").read_text()
    check("log_dir: ./results/" in src, "tiny_fake.yaml has no log_dir")
    src = src.replace("log_dir: ./results/", f"log_dir: {tmp}/")
    cfg_name = "tiny_fake_aug" if aug else "tiny_fake"
    if aug:
        for old, new in (("aug_depth: false", "aug_depth: true"),
                         ("syn_visualize: false, syn_idx: 245",
                          f"syn_visualize: true, syn_idx: {SYN_IDX}")):
            check(old in src, f"tiny_fake.yaml has no {old!r}")
            src = src.replace(old, new)
    cfg_file = tmp / f"{cfg_name}.yaml"
    cfg_file.write_text(src)
    weights = tmp / cfg_name / "models" / "weights_0"
    outputs = {}
    for name, args in (
            ("train", ["--config_file", str(cfg_file), "--max_steps", "2"]),
            ("eval", ["--config_file", str(cfg_file), "--weight_path",
                      str(weights)])):
        t = time.perf_counter()
        res = subprocess.run([sys.executable, "-m",
                              f"vfdepth_tpu_torch.{name}", *args],
                             cwd=str(ROOT), capture_output=True, text=True,
                             timeout=600)
        print(f"CLI {name}{' (aug_depth)' if aug else ''}: exit "
              f"{res.returncode} in {time.perf_counter() - t:.1f} s",
              flush=True)
        if res.returncode != 0:
            print(res.stdout[-3000:], res.stderr[-3000:], flush=True)
        check(res.returncode == 0, f"python -m vfdepth_tpu_torch.{name} "
                                   f"exited {res.returncode}")
        outputs[name] = res.stdout
    check(weights.is_dir(), "the train CLI wrote no weights_0")
    lines = [line for line in outputs["eval"].splitlines()
             if line.strip().startswith(("metric", "median"))]
    check(len(lines) == 2, "the eval CLI printed no metric and median lines")
    for line in lines:
        print(f"CLI eval: {line.strip()}", flush=True)
    if aug:
        syn = tmp / cfg_name / "syn_results"
        n = len(list(syn.iterdir())) if syn.is_dir() else 0
        check(n == SWEEP_VIEWS, f"the aug eval CLI wrote {n} syn images, "
                                f"expected {SWEEP_VIEWS}")
        print(f"CLI eval (aug_depth): {n} syn images written", flush=True)


def aug_config(mixed_precision: bool = False, mode: str = "train"):
    """``configs/ddad/ddad_surround_fusion_augdepth.yaml`` (the published
    depth-synthesis config: the production fusion model, ``aug_angle``
    (15, 15, 40), ``depth_con_coeff`` 0.03, ``depth_sm_coeff`` 0.05)."""
    from vfdepth_tpu_torch.config import get_config
    cfg = get_config(str(AUG_CONFIG), mode=mode)
    cfg.set("mixed_precision", mixed_precision)
    check(cfg.aug_depth, "the augdepth yaml has aug_depth off")
    return cfg


def run_synthesis_sweep(cfg, device, label, per_evaluation, tmp):
    """``Trainer.evaluate`` with ``syn_visualize`` on the seeded model at
    the config's eval batch (``FakeDataset(with_depth=True)``, the even
    rig): batch 0 skipped, batch ``SYN_IDX`` predicted, swept
    (``synthesize_sweep``: ``fuse_voxel`` once, one ``decode_view`` a view)
    and written (``log_result``: the per-camera disparities and one syn
    image a view), then the evaluation stops. Checks the launches (K1 twice,
    K3 twice for the request and once a view), each view's disparity
    (shape, finite, in [0, 1]) and the views ``SWEEP_CHECK_VIEWS`` against
    the plain versions. Returns (launches, ms a view)."""
    import numpy as np
    from vfdepth_tpu_torch.data import BatchLoader, FakeDataset
    from vfdepth_tpu_torch.training import Trainer, VFDepthModel, synthesis
    b = cfg.eval_batch_size
    check(cfg.syn_visualize and cfg.batch_size == b,
          f"{label}: the eval config must sweep at batch {b}")
    cfg.set("syn_idx", SYN_IDX)
    cfg.set("log_path", str(tmp / "log"))
    t0 = time.perf_counter()
    model = VFDepthModel(cfg, device=device, seed=0)
    ds = FakeDataset(num_samples=b * (SYN_IDX + 1), num_cams=cfg.num_cams,
                     height=cfg.height, width=cfg.width,
                     frame_ids=tuple(cfg.frame_ids),
                     fusion_level=cfg.fusion_level, rig="even",
                     with_depth=True)
    loader = BatchLoader(ds, b, shuffle=False, num_workers=0)
    warm = ds.batch(list(range(b)))
    model.predict(warm, aug_u=torch.rand(model.aug_shape(warm)))
    synthesis.synthesize_sweep(model, warm, max_views=2)     # warm-up
    torch.cuda.synchronize()
    print(f"{label} set-up (model, data, warm-up): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    trainer = Trainer(cfg, model, use_tb=False)
    real_sweep, real_log = synthesis.synthesize_sweep, trainer.logger.log_result
    rec = {}

    def timed_sweep(model_, batch, **kw):
        before = read_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        disps = real_sweep(model_, batch, **kw)
        torch.cuda.synchronize()
        rec["sweep"] = ((time.perf_counter() - t) * 1e3, _delta(before),
                        disps, batch)
        return disps

    def timed_log(*args, **kw):
        t = time.perf_counter()
        real_log(*args, **kw)
        rec["log_ms"] = (time.perf_counter() - t) * 1e3
    synthesis.synthesize_sweep, trainer.logger.log_result = (timed_sweep,
                                                             timed_log)
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        trainer.evaluate(loader, load_weights=False)
        torch.cuda.synchronize()
    finally:
        synthesis.synthesize_sweep = real_sweep
    wall = (time.perf_counter() - t) * 1e3
    counts = read_counts()
    ms, sweep_counts, disps, batch = rec["sweep"]
    views = len(disps)
    check(views == SWEEP_VIEWS, f"{label}: {views} views swept")
    per_view = dict(per_evaluation)
    k1 = next(k for k, v in per_evaluation.items() if v and k.startswith("K1"))
    k3 = next(k for k, v in per_evaluation.items() if v and k.startswith("K3"))
    check(sweep_counts == launches(**{k1: 1, k3: views}),
          f"{label}: sweep launches {sweep_counts}, expected {k1} 1 and "
          f"{k3} {views}")
    per_view[k3] += views
    per_view[k1] += 1
    check(counts == per_view, f"{label}: evaluation launches {counts}, "
                              f"expected {per_view}")
    for i, d in enumerate(disps):
        check(d.shape == (b, cfg.height, cfg.width, 1)
              and bool(np.isfinite(d).all()) and 0.0 <= d.min()
              and d.max() <= 1.0,
              f"{label}: view {i} disparity shape {d.shape} or range")
    syn = sorted((tmp / "log" / "syn_results").iterdir())
    check(len(syn) == views, f"{label}: {len(syn)} syn images written")
    real_params = synthesis.aug_depth_params

    def checked_views(k, n_steps=75):
        every = real_params(k, n_steps)
        return [every[i] for i in SWEEP_CHECK_VIEWS]
    model.plain_samplers = True
    synthesis.aug_depth_params = checked_views
    try:
        ref = real_sweep(model, batch)
    finally:
        synthesis.aug_depth_params = real_params
        model.plain_samplers = False
    torch.cuda.synchronize()
    check(read_counts() == counts, "the plain sweep launched a kernel")
    errs = {i: float(abs(disps[i] - r).max())
            for i, r in zip(SWEEP_CHECK_VIEWS, ref)}
    err = max(errs.values())
    tol = FWD_RTOL * max(float(abs(r).max()) for r in ref)
    check(err <= tol, f"{label}: views {SWEEP_CHECK_VIEWS} kernels vs plain "
                      f"{errs} > {tol}")
    moved = float(abs(disps[views // 2] - disps[0]).max())
    by_view = ", ".join(f"{i} {e:.2e}" for i, e in errs.items())
    print(f"{label}: Trainer.evaluate with syn_visualize at batch {b} "
          f"(batch {SYN_IDX} swept): {views} views in {ms / 1e3:.2f} s, "
          f"{ms / views:.3f} ms a view (fuse_voxel once, then one "
          f"decode_view and a copy to the host a view); {k3} "
          f"{sweep_counts[k3]} launches in the sweep (= views), {k1} "
          f"{sweep_counts[k1]}; {len(syn)} syn images and "
          f"{b * cfg.num_cams} disparity images written in "
          f"{rec['log_ms'] / 1e3:.2f} s; evaluate {wall / 1e3:.2f} s in "
          f"all; kernels vs plain max_abs_diff {err:.3e} (tol {tol:.3e}; "
          f"by view: {by_view}); view {views // 2} differs from view 0 by "
          f"{moved:.3f}",
          flush=True)
    del model, disps, ref
    torch.cuda.empty_cache()
    return counts, ms / views


# ---------------------------------------------------------------------------
# the fsm (Monodepth2) baseline and the DDAD / nuScenes readers
FSM_LEARN_EPOCHS, FSM_LEARN_STEPS = 2, 2     # steps an epoch
READER_STEPS = 2                             # training steps per reader path
DDAD_RAW_HW = (1216, 1936)                   # DDAD's native camera images
NUSC_RAW_HW = (900, 1600)
RESIZE_FRAMES = 18                           # 6 cameras x 3 frames
# the native resize against a numpy float64 bilinear of the same rule: the
# library sums 4 f32 products (fma contraction) and, for uint8, scales by
# an f32 1/255 after the sum; values lie in [0, 1]
RESIZE_ATOL = 1e-6
LIDAR_POINTS = 120_000                       # about one DDAD sweep


def fsm_config(mixed_precision: bool = False):
    """The fsm baseline at full width: ``presets.build_config`` with the
    DDAD rig (6 cameras, 384x640, frame_ids [0, -1, 1], scales [0]) and
    ``depth_model`` / ``pose_model`` fsm, with
    ``configs/ddad/ddad_baseline.yaml``'s loss and depth range."""
    from vfdepth_tpu_torch import presets
    from vfdepth_tpu_torch.config import get_config
    cfg = presets.build_config(depth_model="fsm", pose_model="fsm",
                               mixed_precision=mixed_precision)
    baseline = get_config(str(ROOT / "configs" / "ddad" /
                              "ddad_baseline.yaml"))
    for key in ("disparity_smoothness", "spatio_coeff", "spatio_tempo_coeff",
                "pose_loss_coeff", "min_depth", "max_depth"):
        cfg.set(key, baseline.get(key))
    check(cfg.pose_loss_coeff > 0, "the baseline's pose-consistency loss")
    return cfg


def check_k5_calls(key, row, calls, label):
    """K5's calls of one step of another path (``capture_k5``) against
    the plain warp; their errors join the row's ``max_abs_err`` and their
    times go into the row under ``label``."""
    from vfdepth_tpu_torch.ops.warp import (warp_image_mask_maps,
                                            warp_image_mask_maps_plain)
    check(len(calls) == 4, f"{key} ({label}): {len(calls)} calls in a step, "
                           "expected 4")
    tol = BF16_STEP if key.endswith("bf16") else K5_TOL
    errs, times = [], []
    for img, mask, coords in calls:
        got = warp_image_mask_maps(img, mask, coords)
        ref = warp_image_mask_maps_plain(img, mask, coords)
        errs.append(max((a.float() - r.float()).abs().max().item()
                        for a, r in zip(got, ref)))
        del got, ref
        times.append(time_ms(lambda: warp_image_mask_maps(img, mask,
                                                          coords)))
    check(max(errs) <= tol, f"{key} on the {label} step's coordinates "
                            f"differs from its plain version: {max(errs)}")
    row["max_abs_err"] = max(row["max_abs_err"], max(errs))
    row[f"{label}_step_call_ms"] = times
    print(f"{key} on the {label} step's coordinates: 4 calls against plain, "
          f"max_abs_err {max(errs):.3e} (tol {tol:.1e}); per call "
          f"{[round(t, 4) for t in times]} ms", flush=True)


def run_fsm_learn_evaluate(cfg, device, label, per_step, per_validation,
                           tmp):
    """``Trainer.learn`` on the fsm baseline: ``FSM_LEARN_EPOCHS`` epochs
    of ``FSM_LEARN_STEPS`` full-width steps from a shuffled ``BatchLoader``
    through ``device_prefetch``, validation at steps 0 and 2, a checkpoint
    each epoch; then ``Trainer.evaluate`` of ``weights_1`` with
    ``models_to_load: [depth_net]`` (the baseline config's) into a model of
    other weights, over 2 batches, against a plain evaluation. Returns
    (launches over learn, launches over evaluate, the loop's ms a step,
    the evaluation's per-batch ms)."""
    from vfdepth_tpu_torch.data import BatchLoader, FakeDataset
    from vfdepth_tpu_torch.training import Trainer, VFDepthModel
    from vfdepth_tpu_torch.training import trainer as trainer_module
    b = cfg.batch_size
    n = FSM_LEARN_EPOCHS * FSM_LEARN_STEPS
    for key, value in (("num_fake_samples", b * FSM_LEARN_STEPS),
                       ("num_epochs", FSM_LEARN_EPOCHS), ("log_frequency", 2),
                       ("early_phase", 1000), ("late_log_frequency", 1000),
                       ("save_frequency", 1), ("log_path", str(tmp / "log")),
                       ("save_weights_root", str(tmp / "models"))):
        cfg.set(key, value)

    def fake(count, with_depth):
        return FakeDataset(num_samples=count, num_cams=cfg.num_cams,
                           height=cfg.height, width=cfg.width,
                           frame_ids=tuple(cfg.frame_ids),
                           fusion_level=cfg.fusion_level, rig="even",
                           with_depth=with_depth)
    model = VFDepthModel(cfg, device=device, seed=0)
    trainer = Trainer(cfg, model, use_tb=False)
    steps, validations = [], []
    real_step, real_validate = trainer_module.train_step, trainer._validate

    def counted(fn, record):
        def run(*args, **kwargs):
            before = read_counts()
            out = fn(*args, **kwargs)
            record.append(_delta(before))
            return out
        return run
    trainer_module.train_step = counted(real_step, steps)
    trainer._validate = counted(real_validate, validations)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        trainer.learn(BatchLoader(fake(b * FSM_LEARN_STEPS, False), b,
                                  shuffle=True, num_workers=2),
                      BatchLoader(fake(b, True), b, shuffle=False,
                                  num_workers=0), seed=0)
        torch.cuda.synchronize()
    finally:
        trainer_module.train_step = real_step
    wall = (time.perf_counter() - t0) * 1e3
    learn_counts = read_counts()
    check(len(steps) == n, f"{label}: {len(steps)} steps, expected {n}")
    check(all(d == per_step for d in steps),
          f"{label} learn: launches a step {steps}, expected {per_step}")
    check(len(validations) == 2 and all(d == per_validation
                                        for d in validations),
          f"{label} learn: validations {validations}, expected 2 of "
          f"{per_validation}")
    path = Path(cfg.save_weights_root)
    check(sorted(p.name for p in path.iterdir()) == ["weights_0",
                                                     "weights_1"],
          f"{label}: checkpoints {sorted(path.iterdir())}")
    print(f"{label}: learn() {wall:.2f} ms wall for {n} steps, 2 "
          f"validations and 2 checkpoint writes ({wall / n:.2f} ms a step "
          f"with them)", flush=True)

    cfg.set("models_to_load", ["depth_net"])
    cfg.set("load_weights_dir", str(path / "weights_1"))
    fresh = VFDepthModel(cfg, device=device, seed=1)
    loader = BatchLoader(fake(2 * b, True), b, shuffle=False, num_workers=0)
    fresh.predict(loader.dataset.batch(list(range(b))))      # warm-up
    record = []
    real_predict = fresh.predict

    def timed(batch, aug_u=None):
        before = read_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_predict(batch, aug_u=aug_u)
        torch.cuda.synchronize()
        record.append(((time.perf_counter() - t) * 1e3, _delta(before)))
        return out
    fresh.predict = timed
    reset_counts()
    metric, median = Trainer(cfg, fresh, use_tb=False).evaluate(loader)
    eval_counts = read_counts()
    del fresh.predict
    check(len(record) == 2 and all(d == launches() for _, d in record),
          f"{label} evaluate: launches a batch {[d for _, d in record]}, "
          "expected none")
    for name, loaded in (("depth_net", True), ("pose_net", False)):
        live = getattr(fresh, name).state_dict()
        trained = getattr(model, name).state_dict()
        same = all(torch.equal(v, trained[k]) for k, v in live.items())
        check(same == loaded, f"{label} evaluate: {name} "
                              f"{'not ' if loaded else ''}loaded from "
                              "weights_1 (models_to_load: [depth_net])")
    check(all(math.isfinite(v) for v in (*metric.values(), *median.values())),
          f"{label} evaluate: metrics not finite")
    fresh.plain_samplers = True
    plain = Trainer(cfg, fresh, use_tb=False).evaluate(loader,
                                                       load_weights=False)
    fresh.plain_samplers = False
    for got_d, ref_d in zip((metric, median), plain):
        for k, r in ref_d.items():
            check(abs(got_d[k] - r) <= EVAL_METRIC_RTOL * abs(r) + 1e-12,
                  f"{label} evaluate {k}: {got_d[k]} vs plain {r}")
    ms = [m for m, _ in record]
    print(f"{label} evaluate (weights_1, models_to_load [depth_net]): "
          f"per-batch ms {[round(m, 3) for m in ms]} at batch {b}, "
          f"{1e3 * b * len(ms) / sum(ms):.3f} framesets/s; metric "
          f"{json.dumps({k: round(v, 4) for k, v in metric.items()})}",
          flush=True)
    del model, fresh
    return learn_counts, eval_counts, wall / n, ms


def _bilinear_plain(frames, out_hw):
    """The native resize's rule in numpy float64: half-pixel centres
    clamped to the image, bilinear taps; uint8 frames scaled by 1/255."""
    import numpy as np

    def axis(n_in, n_out):
        src = np.clip((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0.0,
                      n_in - 1)
        lo = np.floor(src).astype(np.int64)
        return lo, np.minimum(lo + 1, n_in - 1), src - lo
    y0, y1, wy = axis(frames.shape[1], out_hw[0])
    x0, x1, wx = axis(frames.shape[2], out_hw[1])
    f = frames.astype(np.float64)
    if frames.dtype == np.uint8:
        f /= 255.0
    rows = (f[:, y0] * (1 - wy)[:, None, None] + f[:, y1] * wy[:, None, None])
    return (rows[:, :, x0] * (1 - wx)[:, None] + rows[:, :, x1] * wx[:, None])


def _median_ms(fn, reps: int = 5):
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def _smooth_frame(rng, hw):
    """A uint8 camera frame of smooth gradients and mild noise (quick to
    encode, unlike white noise)."""
    import numpy as np
    h, w = hw
    yy, xx = np.meshgrid(np.linspace(0, 1, h, dtype=np.float32),
                         np.linspace(0, 1, w, dtype=np.float32),
                         indexing="ij")
    phase = rng.uniform(0, 6.28, 3).astype(np.float32)
    img = np.stack([0.5 + 0.4 * np.sin(6 * xx + 3 * yy + p) for p in phase],
                   axis=-1)
    img += rng.uniform(-0.03, 0.03, img.shape).astype(np.float32)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


class _Frames:
    """Distinct fixture frames made cheaply: 4 smooth base frames, each
    drawn one rolled by a seeded offset."""

    def __init__(self, rng, hw):
        self.rng = rng
        self.base = [_smooth_frame(rng, hw) for _ in range(4)]

    def __call__(self):
        import numpy as np
        frame = self.base[self.rng.randint(len(self.base))]
        return np.roll(frame, tuple(self.rng.randint(0, 64, 2)), axis=(0, 1))


def _lidar_points(rng, n):
    """A synthetic sweep in the LiDAR frame (x forward): points on a ring
    of walls 5-40 m away and on the ground."""
    import numpy as np
    az = rng.uniform(-np.pi, np.pi, n)
    r = rng.uniform(5.0, 40.0, n)
    z = rng.uniform(-1.8, 2.0, n)
    return np.stack([r * np.cos(az), r * np.sin(az), z], axis=1)


def run_host_pipeline(device, fsm_model, fsm_opt, paths):
    """What needs no image decode, at DDAD's native size: the native
    resize of ``RESIZE_FRAMES`` frames 1216x1936 -> the model's 384x640
    (uint8, and
    f32 as the readers hand it) against the numpy rule, the LiDAR
    projection of a synthetic sweep into 6 cameras, ``assemble_sample``
    with the train-mode colour jitter; each timed (host clock, median of
    5; ``assemble_sample`` of 3). Then one batch of two assembled samples through a training step of
    the fsm model on the card."""
    import numpy as np
    from vfdepth_tpu_torch.data.contract import required_keys
    from vfdepth_tpu_torch.data.depth_projection import lidar_to_camera_depth
    from vfdepth_tpu_torch.data.transforms import assemble_sample
    from vfdepth_tpu_torch.native import resize_batch
    from vfdepth_tpu_torch.training import train_step

    rng = np.random.RandomState(7)
    hw, raw = (fsm_model.height, fsm_model.width), DDAD_RAW_HW
    gen = _Frames(rng, raw)
    frames = np.stack([gen() for _ in range(RESIZE_FRAMES)])
    frames_f32 = frames.astype(np.float32) / 255.0
    for name, src in (("uint8", frames), ("f32", frames_f32)):
        got = resize_batch(src, hw)
        err = float(np.abs(got[:2] - _bilinear_plain(src[:2], hw)).max())
        check(err <= RESIZE_ATOL, f"native resize ({name}) differs from the "
                                  f"numpy rule by {err}")
        ms = _median_ms(lambda: resize_batch(src, hw))
        print(f"host: native resize of {RESIZE_FRAMES} {name} frames "
              f"{raw[0]}x{raw[1]} -> {hw[0]}x{hw[1]} (4 threads): {ms:.2f} "
              f"ms ({ms / RESIZE_FRAMES:.2f} ms a frame); frames 0-1 against "
              f"the numpy rule max_abs_err {err:.2e} (tol {RESIZE_ATOL:g})",
              flush=True)

    cams = 6
    k_full = np.tile(np.eye(4), (cams, 1, 1))
    k_full[:, 0, 0] = k_full[:, 1, 1] = 2000.0
    k_full[:, 0, 2], k_full[:, 1, 2] = raw[1] / 2, raw[0] / 2
    ext = fixture_rig(cams)[1]
    lidar_to_ref = np.eye(4)
    lidar_to_ref[2, 3] = 1.8
    points = _lidar_points(rng, LIDAR_POINTS)

    def project():
        return np.stack([lidar_to_camera_depth(points, lidar_to_ref, ext[c],
                                               k_full[c], *raw)
                         for c in range(cams)])
    depth = project()
    hits = int((depth > 0).sum())
    check(hits > 1000 and float(depth.max()) < 60.0,
          f"LiDAR projection: {hits} returns, max {depth.max()}")
    ms = _median_ms(project)
    print(f"host: LiDAR projection of {LIDAR_POINTS} points into {cams} "
          f"cameras at {raw[0]}x{raw[1]}: {ms:.2f} ms, {hits} returns",
          flush=True)

    images = {f: frames_f32[i * cams:(i + 1) * cams]
              for i, f in enumerate((0, -1, 1))}
    mask = np.ones((cams, hw[0], hw[1], 1), np.float32)
    jitter = (0.2, 0.2, 0.2, 0.05)

    def assemble(seed):
        return assemble_sample(np.random.RandomState(seed), images, k_full,
                               ext, mask, hw, 2, jitter=jitter, depth=depth)
    samples = [assemble(0), assemble(1)]
    for s in samples:
        check(set(required_keys((0, -1, 1), 2)) <= set(s) and "depth" in s,
              "assemble_sample: keys")
        check(all(np.isfinite(v).all() for v in s.values()),
              "assemble_sample: not finite")
    check(not np.array_equal(samples[0]["color_aug/0/0"],
                             samples[0]["color/0/0"]), "no jitter applied")
    ms = _median_ms(lambda: assemble(2), reps=3)
    print(f"host: assemble_sample (3 frames x {cams} cameras from "
          f"{raw[0]}x{raw[1]}, jitter {jitter}, the resizes and the depth "
          f"map): {ms:.2f} ms a sample", flush=True)

    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    reset_counts()
    logs = train_step(fsm_model, fsm_opt, batch, 0,
                      torch.Generator(device).manual_seed(3))
    torch.cuda.synchronize()
    counts = read_counts()
    check(math.isfinite(logs["total_loss"].item()), "assembled batch: loss")
    check(counts == launches(K5=4), f"assembled batch step: {counts}")
    paths["assembled batch fsm step"] = dict(launches=counts, ms=[])
    print(f"assembled batch (2 samples) through a fsm training step: loss "
          f"{logs['total_loss'].item():.6f}, pose "
          f"{logs['pose'].item():.6f}", flush=True)


def _quaternion(rot):
    """A rotation matrix's unit quaternion (w, x, y, z)."""
    r = rot
    w = math.sqrt(max(0.0, 1 + r[0, 0] + r[1, 1] + r[2, 2])) / 2
    x = math.copysign(math.sqrt(max(0.0, 1 + r[0, 0] - r[1, 1] - r[2, 2]))
                      / 2, r[2, 1] - r[1, 2])
    y = math.copysign(math.sqrt(max(0.0, 1 - r[0, 0] + r[1, 1] - r[2, 2]))
                      / 2, r[0, 2] - r[2, 0])
    z = math.copysign(math.sqrt(max(0.0, 1 - r[0, 0] - r[1, 1] + r[2, 2]))
                      / 2, r[1, 0] - r[0, 1])
    return [float(w), float(x), float(y), float(z)]


def fixture_rig(cams: int):
    """The fixtures' rig: ``FakeDataset``'s even one (the cameras at equal
    yaw steps around the vehicle, 1.5 m out), as (quaternion, translation)
    per camera and the matrices."""
    from vfdepth_tpu_torch.data.fake import make_rig_extrinsics
    ext = make_rig_extrinsics(cams).astype("float64")
    return [(_quaternion(e[:3, :3]), [float(v) for v in e[:3, 3]])
            for e in ext], ext


def write_ddad_fixture(root: Path, cameras, samples: int = 4):
    """A DGP scene dataset at DDAD's native size: scene 0 (the train split)
    of ``samples`` synchronised samples, scene 1 (val) of 3, each camera a
    PNG, a LiDAR sweep per sample, one calibration."""
    import numpy as np
    import PIL.Image as pil
    rng = np.random.RandomState(11)
    h, w = DDAD_RAW_HW
    frames = _Frames(rng, (h, w))
    rig, _ = fixture_rig(len(cameras))
    scene_files = []
    for si, count in enumerate((samples, 3)):     # val: 1 interior sample
        sdir = root / f"scene_{si:06d}"
        (sdir / "calibration").mkdir(parents=True)
        extr = [{"translation": dict(zip("xyz", t)),
                 "rotation": dict(zip(("qw", "qx", "qy", "qz"), q))}
                for q, t in rig]
        calib = {"names": list(cameras) + ["LIDAR"],
                 "intrinsics": [{"fx": 2000.0, "fy": 2000.0, "cx": w / 2,
                                 "cy": h / 2, "skew": 0.0}] * len(cameras)
                 + [{}],
                 "extrinsics": extr + [{"translation": {"z": 1.8},
                                        "rotation": {"qw": 1.0}}]}
        (sdir / "calibration" / "cal0.json").write_text(json.dumps(calib))
        data, sample_list = [], []
        for t in range(count):
            keys = []
            for cam in cameras:
                fn = f"rgb/{cam}/{t:03d}.png"
                (sdir / fn).parent.mkdir(parents=True, exist_ok=True)
                pil.fromarray(frames()).save(sdir / fn, compress_level=1)
                keys.append(f"{cam}_{t}")
                data.append({"key": keys[-1], "id": {"name": cam},
                             "datum": {"image": {"filename": fn}}})
            pcf = f"point_cloud/LIDAR/{t:03d}.npz"
            (sdir / pcf).parent.mkdir(parents=True, exist_ok=True)
            np.savez(sdir / pcf, data=_lidar_points(rng, LIDAR_POINTS))
            keys.append(f"lidar_{t}")
            data.append({"key": keys[-1], "id": {"name": "LIDAR"},
                         "datum": {"point_cloud": {"filename": pcf}}})
            sample_list.append({"datum_keys": keys,
                                "calibration_key": "cal0"})
        (sdir / "scene.json").write_text(json.dumps(
            {"samples": sample_list, "data": data}))
        scene_files.append(f"scene_{si:06d}/scene.json")
    ds_json = root / "ddad.json"
    ds_json.write_text(json.dumps({"scene_splits": {
        "0": {"filenames": [scene_files[0]]},
        "1": {"filenames": [scene_files[1]]}}}))
    return ds_json


def write_nuscenes_fixture(root: Path, cameras, samples: int = 3):
    """nuScenes tables at its native 900x1600: ``samples`` keyframes with a
    sweep before and after each, per camera a JPEG, a LiDAR keyframe."""
    import numpy as np
    import PIL.Image as pil
    rng = np.random.RandomState(12)
    h, w = NUSC_RAW_HW
    frames = _Frames(rng, (h, w))
    vdir = root / "v1.0-trainval"
    vdir.mkdir(parents=True)
    rig, _ = fixture_rig(len(cameras))
    sensors = [{"token": f"s_{c}", "channel": c} for c in cameras] + [
        {"token": "s_LIDAR_TOP", "channel": "LIDAR_TOP"}]
    calibrated = [{"token": f"cs_{c}", "sensor_token": f"s_{c}",
                   "translation": t, "rotation": q,
                   "camera_intrinsic": [[1260.0, 0, w / 2],
                                        [0, 1260.0, h / 2], [0, 0, 1]]}
                  for c, (q, t) in zip(cameras, rig)]
    calibrated.append({"token": "cs_LIDAR_TOP", "sensor_token": "s_LIDAR_TOP",
                       "translation": [0.0, 0.0, 1.8],
                       "rotation": [1.0, 0.0, 0.0, 0.0]})
    ego = [{"token": f"ep_{i}", "translation": [0.4 * i, 0.0, 0.0],
            "rotation": [1.0, 0.0, 0.0, 0.0]} for i in range(3 * samples)]
    sample_rows, sample_data = [], []
    for t in range(samples):
        tok = f"sample_{t}"
        sample_rows.append({"token": tok})
        for c in cameras:
            for j in range(3):
                fn = f"samples/{c}/{t}_{j}.jpg"
                (root / fn).parent.mkdir(parents=True, exist_ok=True)
                pil.fromarray(frames()).save(root / fn, quality=90)
                sample_data.append({
                    "token": f"sd_{c}_{t}_{j}", "sample_token": tok,
                    "calibrated_sensor_token": f"cs_{c}",
                    "ego_pose_token": f"ep_{3 * t + j}", "filename": fn,
                    "is_key_frame": j == 1, "height": h, "width": w,
                    "prev": f"sd_{c}_{t}_{j - 1}" if j > 0 else "",
                    "next": f"sd_{c}_{t}_{j + 1}" if j < 2 else ""})
        pts = np.zeros((LIDAR_POINTS, 5), np.float32)
        pts[:, :3] = _lidar_points(rng, LIDAR_POINTS)
        fn = f"samples/LIDAR_TOP/{t}.pcd.bin"
        (root / fn).parent.mkdir(parents=True, exist_ok=True)
        pts.tofile(root / fn)
        sample_data.append({"token": f"sd_lidar_{t}", "sample_token": tok,
                            "calibrated_sensor_token": "cs_LIDAR_TOP",
                            "ego_pose_token": f"ep_{3 * t + 1}",
                            "filename": fn, "is_key_frame": True,
                            "prev": "", "next": ""})
    for name, table in (("sensor", sensors), ("calibrated_sensor",
                                              calibrated),
                        ("ego_pose", ego), ("sample", sample_rows),
                        ("sample_data", sample_data)):
        (vdir / f"{name}.json").write_text(json.dumps(table))
    return root


def per_step_launches(cfg):
    """A training step's launches for ``cfg``'s nets: K5 4 for the fsm
    baseline; K1 (or K1b on unequal overlap groups), K2 (K2b), K3, K4 once
    and K5 4 for the fusion model."""
    from vfdepth_tpu_torch.models import grouped_backprojection_ok
    if cfg.depth_model == "fsm" and cfg.pose_model == "fsm":
        return launches(K5=4)
    if grouped_backprojection_ok(tuple(map(tuple, cfg.overlap_groups)),
                                 cfg.num_cams):
        return launches(K1=1, K2=1, K3=1, K4=1, K5=4)
    return launches(K1b=1, K2b=1, K3=1, K4=1, K5=4)


def run_reader_paths(cfgs, device, dataset, paths):
    """``READER_STEPS`` batches of ``cfgs[0]``'s dataset through
    ``construct_dataset`` -> ``BatchLoader`` -> ``device_prefetch`` (one
    batch an epoch where the split holds one), each batch a training step
    of every config's model (the published fusion config and the fsm
    baseline, which read the dataset alike); launches and losses checked,
    the rig read back."""
    from vfdepth_tpu_torch.data import BatchLoader, device_prefetch
    from vfdepth_tpu_torch.data.factory import construct_dataset
    from vfdepth_tpu_torch.training import (VFDepthModel, create_train_state,
                                            train_step)
    ds = construct_dataset(cfgs[0], "train")
    b = cfgs[0].batch_size
    check(len(ds) >= b, f"{dataset}: {len(ds)} samples")
    ext = ds[0]["extrinsics"]
    rig_err = float(abs(ext - fixture_rig(cfgs[0].num_cams)[1]).max())
    check(rig_err < 1e-5, f"{dataset}: the read rig differs by {rig_err}")
    loader = BatchLoader(ds, b, shuffle=True, num_workers=2)
    rigs = ds.rig_calibrations()
    runs = []
    for cfg in cfgs:
        check(cfg.batch_size == b and cfg.height == cfgs[0].height,
              f"{dataset}: the configs read the dataset alike")
        model = VFDepthModel(cfg, device=device, seed=0)
        runs.append(dict(
            label=f"{dataset} reader {cfg.depth_model} training",
            model=model, per_step=per_step_launches(cfg), opt=None,
            gen=torch.Generator(device).manual_seed(0), losses=[],
            overflows=[], counts=[], total=launches()))
    step, t0 = 0, time.perf_counter()
    while step < READER_STEPS:
        loader.set_epoch(step)
        for batch in device_prefetch(loader, size=2, device=device):
            for run in runs:
                if run["opt"] is None:
                    # the warp windows sized as Trainer.learn sizes them:
                    # over the first batch's rig and the dataset's scenes
                    model = run["model"]
                    run["opt"] = create_train_state(
                        model, steps_per_epoch=loader.steps_per_epoch,
                        batch=batch, rigs=rigs)
                    hw = (model.warp_window_hw if model.warp_window
                          else "off (the 90% rule)")
                    print(f"{run['label']}: warp windows {hw}", flush=True)
                reset_counts()
                logs = train_step(run["model"], run["opt"], batch, step,
                                  run["gen"])
                run["losses"].append(logs["total_loss"].item())
                ov = logs.get("warp_window_overflow")
                run["overflows"].append(None if ov is None else ov.item())
                counts = read_counts()
                run["counts"].append(counts)
                run["total"] = {k: run["total"][k] + n
                                for k, n in counts.items()}
            step += 1
            if step == READER_STEPS:
                break
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    for run in runs:
        label = run["label"]
        check(all(math.isfinite(v) for v in run["losses"]),
              f"{label}: loss {run['losses']}")
        check(all(c == run["per_step"] for c in run["counts"]),
              f"{label}: launches a step {run['counts']}, expected "
              f"{run['per_step']}")
        paths[label] = dict(launches=run["total"], ms=[])
        print(f"{label}: {READER_STEPS} steps at batch {b} from {len(ds)} "
              f"samples, losses {[round(v, 6) for v in run['losses']]}, "
              f"warp window overflow {run['overflows']}", flush=True)
    print(f"{dataset} readers: {READER_STEPS} batches read and trained on "
          f"by {len(runs)} models in {wall:.1f} ms wall (the reads "
          f"included)", flush=True)
    del runs
    torch.cuda.empty_cache()


def time_reader(cfg, label, load_image, image):
    """One sample's host work through ``cfg``'s reader, once in train mode
    (decode, resize, jitter, masks) and once in val mode (decode, resize,
    the LiDAR depth uncached), after one warm read; and the decode of
    ``image`` alone (``load_image``, the reader's own), median of 3."""
    from vfdepth_tpu_torch.data.factory import construct_dataset
    train = construct_dataset(cfg, "train")
    val = construct_dataset(cfg, "val")
    val.cache_depth = False
    check("depth" in val[0] and "depth" not in train[0],
          f"{label}: depth in val mode only")
    train_ms = _median_ms(lambda: train[0], reps=1)
    val_ms = _median_ms(lambda: val[0], reps=1)
    decode_ms = _median_ms(lambda: load_image(str(image)), reps=3)
    print(f"{label}: one sample's host work (3 frames x {cfg.num_cams} "
          f"cameras): train mode {train_ms:.1f} ms, val mode (LiDAR depth "
          f"uncached) {val_ms:.1f} ms; one {image.suffix[1:].upper()} "
          f"decoded to f32 alone {decode_ms:.1f} ms", flush=True)


def run_readers(device, tmp, paths):
    """The DDAD and nuScenes readers at their native sizes on written
    fixtures, each feeding the surround-fusion model and the fsm baseline
    (the published configs with the fixture's path); needs PIL."""
    from vfdepth_tpu_torch.config import get_config
    from vfdepth_tpu_torch.data import ddad, nuscenes
    t = time.perf_counter()
    ddad_root, nusc_root = tmp / "ddad", tmp / "nuscenes"
    ddad_root.mkdir()
    base = get_config(str(CONFIG))
    ds_json = write_ddad_fixture(ddad_root, list(base.cameras))
    nusc_cfg = get_config(str(ROOT / "configs" / "nuscenes" /
                              "nusc_surround_fusion.yaml"))
    write_nuscenes_fixture(nusc_root, list(nusc_cfg.cameras))
    print(f"reader fixtures written (DDAD 4 + 3 samples x 6 cameras at "
          f"{DDAD_RAW_HW[0]}x{DDAD_RAW_HW[1]} PNG; nuScenes 3 samples x 3 "
          f"sweeps x 6 cameras at {NUSC_RAW_HW[0]}x{NUSC_RAW_HW[1]} JPEG): "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    for dataset, names, data_path, mask_dir, reader, image in (
            ("DDAD", ("ddad/ddad_surround_fusion", "ddad/ddad_baseline"),
             str(ds_json), ROOT / "assets" / "ddad_mask", ddad,
             next(ddad_root.rglob("*.png"))),
            ("nuScenes", ("nuscenes/nusc_surround_fusion",
                          "nuscenes/nusc_baseline"),
             str(nusc_root), ROOT / "assets" / "nuscenes_mask", nuscenes,
             next(nusc_root.rglob("*.jpg")))):
        cfgs = []
        for name in names:
            cfg = get_config(str(ROOT / "configs" / f"{name}.yaml"))
            cfg.set("data_path", data_path)
            cfg.set("mask_dir", str(mask_dir))
            cfg.set("split_dir", "")      # the fixture's tokens, not the list
            cfgs.append(cfg)
        time_reader(cfgs[0], f"{dataset} reader", reader._load_image, image)
        run_reader_paths(cfgs, device, dataset, paths)


# ------------------------------------------------ the last model options

RESNET_ENV = "VFDEPTH_RESNET_WEIGHTS"
REMAT_VALUES = (False, "all", "depth_net", "pose_net")
REMAT_BF16_VALUES = (False, "all")
REMAT_SAMPLES = 3
REMAT_PEAK_BATCH = 4


def synthetic_resnet18(path: Path, seed: int = 0):
    """A ResNet-18 state dict in torchvision's layout (its names, OIHW
    convolutions, BatchNorm weight / bias / running statistics /
    ``num_batches_tracked``, the fc head), seeded, saved to ``path`` as a
    ``.pth``: the stand-in for an ImageNet file, which the repository does
    not hold and nothing fetches. Returns the state dict."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(name, cout, cin, k):
        sd[f"{name}.weight"] = torch.randn(cout, cin, k, k,
                                           generator=gen) / math.sqrt(
            cin * k * k)

    def bn(name, ch):
        sd[f"{name}.weight"] = torch.rand(ch, generator=gen) + 0.5
        sd[f"{name}.bias"] = torch.randn(ch, generator=gen) * 0.1
        sd[f"{name}.running_mean"] = torch.randn(ch, generator=gen) * 0.1
        sd[f"{name}.running_var"] = torch.rand(ch, generator=gen) * 1.5 + 0.5
        sd[f"{name}.num_batches_tracked"] = torch.tensor(100)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for stage, width in enumerate((64, 128, 256, 512)):
        for blk in range(2):
            t = f"layer{stage + 1}.{blk}"
            conv(f"{t}.conv1", width, cin, 3)
            bn(f"{t}.bn1", width)
            conv(f"{t}.conv2", width, width, 3)
            bn(f"{t}.bn2", width)
            if stage > 0 and blk == 0:
                conv(f"{t}.downsample.0", width, cin, 1)
                bn(f"{t}.downsample.1", width)
            cin = width
    sd["fc.weight"] = torch.randn(1000, cin, generator=gen) * 0.01
    sd["fc.bias"] = torch.zeros(1000)
    torch.save(sd, path)
    return sd


def _torchvision_name(local: str) -> str:
    """A port encoder tensor's name -> torchvision's (``bn1.bn.weight`` ->
    ``bn1.weight``, ``layer2_0.downsample_bn.bn.running_var`` ->
    ``layer2.0.downsample.1.running_var``)."""
    local = (local.replace(".bn.", ".")
             .replace("downsample_conv", "downsample.0")
             .replace("downsample_bn", "downsample.1"))
    return local.replace("_", ".", 1) if local.startswith("layer") else local


def check_loaded_encoders(model, sd, label: str) -> int:
    """Every encoder tensor of both nets equals the file's: the depth net's
    as they are, the pose net's conv1 tiled over its two frames and
    halved. Returns the number of tensors compared."""
    state = model.state_dict()
    n = 0
    for net, n_imgs in (("depth_net", 1), ("pose_net", 2)):
        prefix = f"{net}.encoder."
        for name, value in state.items():
            if not name.startswith(prefix) or name.endswith(
                    "num_batches_tracked"):
                continue
            key = _torchvision_name(name[len(prefix):])
            check(key in sd, f"{label}: {name} has no tensor {key} in the "
                             f"file")
            want = sd[key]
            if key == "conv1.weight":
                want = torch.cat([want] * n_imgs, dim=1) / n_imgs
            check(torch.equal(value.cpu(), want),
                  f"{label}: {name} differs from the file's {key}")
            n += 1
    check(n == 2 * 100, f"{label}: {n} encoder tensors, expected 200")
    return n


def run_weights_init(device, tmp: Path, paths):
    """The published ``ddad_surround_fusion.yaml`` and ``ddad_baseline.yaml``
    (``weights_init: true``) built with ``VFDEPTH_RESNET_WEIGHTS`` naming a
    synthetic torchvision ResNet-18 file: every encoder tensor against the
    file, then one full-width request and one training step from each,
    launches counted (the fusion model: K1 1, K3 1 a request, K1-K4 1, K5
    4 a step; the fsm baseline: none, K5 4)."""
    from vfdepth_tpu_torch.config import get_config
    from vfdepth_tpu_torch.training import (VFDepthModel, create_train_state,
                                            train_step)
    path = tmp / "resnet18_synthetic.pth"
    sd = synthetic_resnet18(path)
    old = os.environ.get(RESNET_ENV)
    os.environ[RESNET_ENV] = str(path)
    try:
        for yaml, label, per_request, per_step in (
                ("ddad_surround_fusion.yaml", "6-camera ImageNet-init",
                 launches(K1=1, K3=1),
                 launches(K1=1, K2=1, K3=1, K4=1, K5=4)),
                ("ddad_baseline.yaml", "6-camera fsm ImageNet-init",
                 launches(), launches(K5=4))):
            cfg = get_config(str(ROOT / "configs" / "ddad" / yaml))
            check(bool(cfg.get("weights_init")), f"{yaml}: weights_init")
            t0 = time.perf_counter()
            model = VFDepthModel(cfg, device=device, seed=0)
            n = check_loaded_encoders(model, sd, label)
            print(f"{label} ({yaml}): {n} encoder tensors equal the "
                  f"file's (the pose conv1 tiled and halved); built in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            b = cfg.batch_size
            ds = _dataset(cfg, 1 + b, "even")
            request, batch = ds.batch([0]), ds.batch(list(range(1, 1 + b)))
            opt = create_train_state(model)
            reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = model.predict(request)
            torch.cuda.synchronize()
            req_ms = (time.perf_counter() - t) * 1e3
            counts = read_counts()
            check(counts == per_request, f"{label} request: kernel launches "
                                         f"{counts}, expected {per_request}")
            check(all(bool(torch.isfinite(v).all()) for v in out.values()),
                  f"{label} request: outputs not finite")
            paths[f"{label} request"] = dict(launches=counts, ms=[req_ms])
            stats0 = model.depth_net.encoder.bn1.bn.running_mean.clone()
            reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            logs = train_step(model, opt, batch, 0,
                              torch.Generator(device).manual_seed(7))
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t) * 1e3
            counts = read_counts()
            check(counts == per_step, f"{label} step: kernel launches "
                                      f"{counts}, expected {per_step}")
            loss = logs["total_loss"].item()
            check(math.isfinite(loss), f"{label} step: loss not finite")
            check(not torch.equal(stats0,
                                  model.depth_net.encoder.bn1.bn.running_mean),
                  f"{label} step: the encoder's statistics did not move")
            paths[f"{label} step"] = dict(launches=counts, ms=[step_ms])
            print(f"{label}: request {req_ms:.2f} ms (depth/0 in "
                  f"[{out['depth/0'].min().item():.3f}, "
                  f"{out['depth/0'].max().item():.3f}] m), one step at batch "
                  f"{b} {step_ms:.2f} ms, loss {loss:.6f} (first calls: "
                  f"cuDNN's set-up included)", flush=True)
            del model, opt, out
            torch.cuda.empty_cache()
    finally:
        if old is None:
            os.environ.pop(RESNET_ENV, None)
        else:
            os.environ[RESNET_ENV] = old


def _remat_step_launches(mp: bool, depth_remat: bool):
    """Launches a 6-camera step (merged back-projection) makes: under remat
    of the depth net its ``decode_from_backprojection`` runs again in the
    backward pass, so K3 twice; the back-projection between the
    checkpointed calls is not recomputed (JAX's remat leaves it out too)."""
    tag = "-bf16" if mp else ""
    return launches(**{f"K1{tag}": 1, f"K2{tag}": 1,
                       f"K3{tag}": 2 if depth_remat else 1, f"K4{tag}": 1,
                       f"K5{tag}": 4})


def run_remat(device, paths):
    """``tpu.remat`` on the 6-camera full-width training step at batch 2:
    f32 with remat False, 'all', 'depth_net', 'pose_net', bf16 with False
    and 'all', each from the same state and batch (the model's ``remat``
    set between runs; step 1, the same tie-break noise). The first of
    ``REMAT_SAMPLES`` steps of each value against the remat-False step:
    loss and each gradient within the step tolerances (bf16: the bf16
    ones), every BatchNorm running statistic within the loss tolerance of
    its magnitude; each sample's ms and the peak device memory of the
    samples (``max_memory_allocated``: the model, its Adam state, the
    batch and the step's activations). Then the f32 peak at batch 4 with
    remat False and 'all'. Returns the table."""
    from vfdepth_tpu_torch.config import get_config
    from vfdepth_tpu_torch.training import (VFDepthModel, create_train_state,
                                            train_step)
    table = []
    for mp, values, (loss_rtol, grad_rtol) in (
            (False, REMAT_VALUES, (STEP_LOSS_RTOL, STEP_GRAD_RTOL)),
            (True, REMAT_BF16_VALUES, (BF16_STEP_LOSS_RTOL,
                                       BF16_STEP_GRAD_RTOL))):
        cfg = get_config(str(CONFIG))
        cfg.set("mixed_precision", mp)
        model = VFDepthModel(cfg, device=device, seed=0)
        opt = create_train_state(model)
        batch = _dataset(cfg, cfg.batch_size, "even").batch(
            list(range(cfg.batch_size)))
        state0 = {k: v.detach().cpu().clone()
                  for k, v in model.state_dict().items()}
        opt0 = copy.deepcopy(opt.state_dict())

        def step(b=batch):
            model.load_state_dict(state0)
            opt.load_state_dict(opt0)
            return train_step(model, opt, b, 1,
                              torch.Generator(device).manual_seed(1001))
        step()                                    # warm-up (not counted)
        logs = step()
        ref = dict(loss=logs["total_loss"].item(),
                   grads={k: p.grad.clone()
                          for k, p in model.named_parameters()},
                   stats={k: v.clone() for k, v in model.named_buffers()
                          if k.endswith(("running_mean", "running_var"))})
        tag = " bf16" if mp else ""
        for value in values:
            model.remat = value
            depth_remat = model._remat_for(model.depth_net)
            per_step = _remat_step_launches(mp, depth_remat)
            ms = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            for i in range(REMAT_SAMPLES):
                before = read_counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                logs = step()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
                delta = {k: n - before[k] for k, n in read_counts().items()}
                check(delta == per_step, f"remat {value!r}{tag}: kernel "
                      f"launches {delta}, expected {per_step}")
                if i == 0:
                    loss = logs["total_loss"].item()
                    check(abs(loss - ref["loss"]) <= loss_rtol
                          * abs(ref["loss"]), f"remat {value!r}{tag}: loss "
                          f"{loss} vs {ref['loss']}")
                    worst = max(
                        ((p.grad - ref["grads"][k]).norm()
                         / ref["grads"][k].norm().clamp_min(1e-30)).item()
                        for k, p in model.named_parameters())
                    check(worst <= grad_rtol, f"remat {value!r}{tag}: a "
                          f"gradient differs by {worst} (relative L2)")
                    bufs = dict(model.named_buffers())
                    stat_err = max(
                        ((bufs[k] - v).abs().max()
                         / v.abs().max().clamp_min(1e-30)).item()
                        for k, v in ref["stats"].items())
                    check(stat_err <= loss_rtol, f"remat {value!r}{tag}: "
                          f"BatchNorm statistics differ by {stat_err}")
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            counts = read_counts()
            label = f"6-camera{tag} remat {value}"
            paths[label] = dict(launches=counts, ms=ms)
            table.append(dict(dtype="bf16" if mp else "f32",
                              remat=str(value), batch=cfg.batch_size,
                              ms=ms, peak_gib=peak, loss_rel=abs(
                                  loss - ref["loss"]) / abs(ref["loss"]),
                              worst_grad_rel=worst, stats_rel=stat_err))
            print(f"{label}: step ms {[round(m, 3) for m in ms]}, peak "
                  f"device memory {peak:.3f} GiB at batch {cfg.batch_size}; "
                  f"step 1 against remat False: loss rel "
                  f"{table[-1]['loss_rel']:.2e}, worst gradient rel "
                  f"{worst:.2e}, BatchNorm statistics rel {stat_err:.2e}; "
                  f"launches a step {({k: v for k, v in per_step.items() if v})}",
                  flush=True)
        if not mp:
            big = _dataset(cfg, REMAT_PEAK_BATCH, "even").batch(
                list(range(REMAT_PEAK_BATCH)))
            for value in (False, "all"):
                model.remat = value
                step(big)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                logs = step(big)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t) * 1e3
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                check(math.isfinite(logs["total_loss"].item()),
                      f"remat {value!r} at batch {REMAT_PEAK_BATCH}: loss")
                table.append(dict(dtype="f32", remat=str(value),
                                  batch=REMAT_PEAK_BATCH, ms=[ms],
                                  peak_gib=peak))
                print(f"6-camera remat {value} at batch {REMAT_PEAK_BATCH}: "
                      f"step {ms:.3f} ms, peak device memory {peak:.3f} GiB",
                      flush=True)
            del big
        model.remat = False
        del model, opt, state0, opt0, ref
        torch.cuda.empty_cache()
    print(json.dumps({"remat": table}), flush=True)
    return table


GATHER_HOT_POINTS = 5000       # past the gather backward's column kernel


def gather_hot_coords(coords, shape):
    """The step's coordinates with their first GATHER_HOT_POINTS points of
    each frameset moved into one voxel cell, (w/2, h/2, d/2) to that plus 1
    (fractions in [0.1, 0.9]): each of the cell's 8 voxels takes that many
    more taps, in one serial chain by contract, and more than the reduce's
    column kernel holds (4,096), so its serial merge runs."""
    _, h, w, d, _ = shape
    gen = torch.Generator().manual_seed(7)
    size = torch.tensor([w, h, d], dtype=torch.float32)
    pix = size.div(2).floor() + 0.1 + 0.8 * torch.rand(
        coords.shape[0], GATHER_HOT_POINTS, 3, generator=gen)
    hot = coords.clone()
    hot[:, :GATHER_HOT_POINTS] = (pix / (0.5 * (size - 1)) - 1.0).to(
        coords.device)
    return hot


def gather_tap_stats(coords, shape):
    """(live taps, live points, voxels touched, the hottest voxel's taps) of
    the gather-bf16 backward at coords: its taps of weight != 0
    (``_gather_bwd_items``) counted per voxel."""
    from vfdepth_tpu_torch.ops import sample3d as s3
    n_vox = math.prod(shape[:4])
    wts, keys = s3._gather_bwd_items(coords, shape)
    live_keys = keys[keys < n_vox]
    per_voxel = torch.bincount(live_keys, minlength=n_vox)
    live_pts = int(wts.reshape(-1, 8).ne(0).any(1).sum())
    return (int(live_keys.numel()), live_pts, int((per_voxel > 0).sum()),
            int(per_voxel.max()))


def check_gather_forms(calls):
    """The gather-bf16 forms (``sampler_3d: gather`` under mixed precision;
    counterparts of JAX's XLA gather ``grid_sample_3d`` and the scatter of
    its VJP ``_gs3d_bwd``, not of TPU kernels) on the volume, coordinates
    and cotangent that the 6-camera bf16 gather step's warm-up handed them
    (``capture_k3k4``): each against its plain version bit for bit, two
    launches bit-identical, the backward's plan on the card against the
    plain plan; timed (median of 20 with CUDA events, and 20 back to
    back; the backward's plan and reduce apart, and each of its kernels
    under the profiler) beside the plain version, the bound (bytes over
    3.35 TB/s: the volume, coordinates and output; for the backward the
    rows of g that some live tap reads, the coordinates and dvol) and the
    library call (5-D ``F.grid_sample`` in bf16, and its autograd backward,
    alone and back to back). Then the backward again on a hot-voxel input
    (``gather_hot_coords``): bits, relaunch, plan and times. Returns the
    two rows."""
    from vfdepth_tpu_torch.ops import sample3d as s3
    check(len(calls["fwd"]) == 1 and len(calls["bwd"]) == 1,
          f"the gather step called its sampler {len(calls['fwd'])} and its "
          f"backward {len(calls['bwd'])} times, expected 1 and 1")
    (vol, coords), (g, _, shape) = calls["fwd"][0], calls["bwd"][0]
    check(vol.dtype == g.dtype == torch.bfloat16, "gather: not bf16")

    def bits(t):
        return t.view(torch.int16)
    out = s3.sample3d_gather(vol, coords)
    again = s3.sample3d_gather(vol, coords)
    ref = s3.sample3d_gather_plain(vol, coords)
    torch.cuda.synchronize()
    check(torch.equal(bits(out), bits(ref)), "K3-gather-bf16 differs from "
                                             "its plain version")
    check(torch.equal(bits(out), bits(again)), "K3-gather-bf16: two "
                                               "launches differ")
    err3 = (out.float() - ref.float()).abs().max().item()
    nb = vol.shape[0]
    vol_czyx = vol.permute(0, 4, 3, 1, 2).contiguous()
    grid = coords.reshape(nb, 1, 1, -1, 3).to(torch.bfloat16)

    def library3():
        return F.grid_sample(vol_czyx, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)
    row3 = _row(
        "sample3d_gather (bf16)", "sample3d.cu",
        "vfdepth_tpu/ops/grid_sample.py:188", err3,
        time_ms(lambda: s3.sample3d_gather(vol, coords)),
        time_ms(lambda: s3.sample3d_gather_plain(vol, coords), reps=5),
        nbytes(vol, coords, out), coords.shape[0] * coords.shape[1]
        * vol.shape[-1] * 8 * 2, time_ms(library3),
        dict(vol=vol.shape, coords=coords.shape, out=out.shape))
    row3["stream_ms"] = stream_ms(lambda: s3.sample3d_gather(vol, coords))
    row3["library_stream_ms"] = stream_ms(library3)
    row3["counterpart_of"] = "XLA gather grid_sample_3d, not a TPU kernel"
    del out, again, ref

    order, start = s3.sample3d_gather_bwd_plan(coords, shape)
    p_order, p_start = s3.sample3d_gather_bwd_plan_plain(coords, shape)
    check(torch.equal(order, p_order) and torch.equal(start, p_start),
          "K4-gather-bf16: the card's plan differs from the plain plan")
    check(int(start[-1]) == int(p_start[-1]), "K4-gather-bf16: live count")
    del p_order, p_start
    dvol = s3.sample3d_gather_bwd(g, coords, shape)
    again = s3.sample3d_gather_bwd(g, coords, shape)
    ref = s3.sample3d_gather_bwd_plain(g, coords, shape)
    torch.cuda.synchronize()
    check(torch.equal(bits(dvol), bits(ref)), "K4-gather-bf16 differs from "
                                              "its plain version")
    check(torch.equal(bits(dvol), bits(again)), "K4-gather-bf16: two "
                                                "launches differ")
    err4 = (dvol.float() - ref.float()).abs().max().item()
    live, live_pts, touched, hottest = gather_tap_stats(coords, shape)
    check(live_pts == int(start[-1]), "K4-gather-bf16: the plan's live "
                                      "points")
    c = shape[-1]
    vol_g = vol.permute(0, 4, 3, 1, 2).contiguous().requires_grad_()
    lib_out = F.grid_sample(vol_g, grid, mode="bilinear",
                            padding_mode="zeros", align_corners=True)
    lib_g = g.transpose(1, 2).reshape(lib_out.shape).contiguous()

    def library4():
        return torch.autograd.grad(lib_out, vol_g, lib_g, retain_graph=True)
    row4 = _row(
        "sample3d_gather_bwd (bf16)", "sample3d_bwd.cu",
        "vfdepth_tpu/ops/grid_sample.py:165", err4,
        time_ms(lambda: s3.sample3d_gather_bwd(g, coords, shape)),
        time_ms(lambda: s3.sample3d_gather_bwd_plain(g, coords, shape),
                reps=2, warmup=1),
        live_pts * c * g.element_size() + nbytes(coords, dvol),
        live * c * 2, time_ms(library4),
        dict(g=g.shape, coords=coords.shape, dvol=dvol.shape))
    row4.update(stage_split(
        lambda: s3.sample3d_gather_bwd_plan(coords, shape),
        lambda p: s3._gather_bwd_launch(g, coords, shape, *p)))
    row4["stream_ms"] = stream_ms(lambda: s3.sample3d_gather_bwd(g, coords,
                                                                 shape))
    row4["library_stream_ms"] = stream_ms(library4)
    row4["counterpart_of"] = ("XLA scatter of grid_sample_3d's VJP "
                              "_gs3d_bwd, not a TPU kernel")
    row4.update(live_taps=live, taps=8 * coords.shape[0] * coords.shape[1],
                live_points=live_pts, hottest_voxel=hottest,
                voxels_touched=touched)
    profile("K4-gather-bf16, one call on the gather step's inputs",
            lambda: s3.sample3d_gather_bwd(g, coords, shape))
    print(f"K3-gather-bf16 on the 6-camera bf16 gather step "
          f"({coords.shape[1]} points a frameset, batch {nb}): equal to its "
          f"plain version bit for bit, two launches bit-identical; "
          f"{row3['ms']:.4f} ms a call ({row3['stream_ms']:.4f} back to "
          f"back) against F.grid_sample 5-D bf16 {row3['library_ms']:.4f} "
          f"({row3['library_stream_ms']:.4f}): "
          f"{'faster' if row3['ms'] < row3['library_ms'] else 'SLOWER'}; "
          f"{100 * row3['bound_ms'] / row3['ms']:.1f}% of its bound",
          flush=True)
    print(f"K4-gather-bf16 on that step: plan of {int(start[-1])} live of "
          f"{order.numel()} points ({live} live taps of {row4['taps']}), "
          f"{touched} voxels touched, the hottest {hottest} taps; equal to "
          f"the plain plan; equal to its plain version bit for bit, two "
          f"launches bit-identical; {row4['ms']:.4f} ms = plan "
          f"{row4['plan_ms']:.4f} + reduce {row4['reduce_ms']:.4f} "
          f"({row4['stream_ms']:.4f} back to back; the tap-sort form took "
          f"2.790 on an H100 80GB HBM3 at 700 W), "
          f"{100 * row4['bound_ms'] / row4['ms']:.1f}% of its bound; "
          f"autograd backward of F.grid_sample {row4['library_ms']:.4f} "
          f"({row4['library_stream_ms']:.4f})", flush=True)
    del dvol, again, ref, lib_out, vol_g, order, start

    hot = gather_hot_coords(coords, shape)
    order, start = s3.sample3d_gather_bwd_plan(hot, shape)
    p_order, p_start = s3.sample3d_gather_bwd_plan_plain(hot, shape)
    check(torch.equal(order, p_order) and torch.equal(start, p_start),
          "K4-gather-bf16 on the hot input: the card's plan differs from "
          "the plain plan")
    del p_order, p_start
    dvol = s3.sample3d_gather_bwd(g, hot, shape)
    again = s3.sample3d_gather_bwd(g, hot, shape)
    ref = s3.sample3d_gather_bwd_plain(g, hot, shape)
    torch.cuda.synchronize()
    check(torch.equal(bits(dvol), bits(ref)), "K4-gather-bf16 on the hot "
                                              "input differs from its plain "
                                              "version")
    check(torch.equal(bits(dvol), bits(again)), "K4-gather-bf16 on the hot "
                                                "input: two launches differ")
    h_live, _, _, h_hot = gather_tap_stats(hot, shape)
    check(h_hot >= GATHER_HOT_POINTS, f"the hot input's hottest voxel takes "
                                      f"{h_hot} taps, expected >= "
                                      f"{GATHER_HOT_POINTS}")
    hot_row = stage_split(lambda: s3.sample3d_gather_bwd_plan(hot, shape),
                          lambda p: s3._gather_bwd_launch(g, hot, shape, *p))
    hot_row.update(ms=time_ms(lambda: s3.sample3d_gather_bwd(g, hot, shape)),
                   live_taps=h_live, hottest_voxel=h_hot)
    row4["hot_input"] = hot_row
    print(f"K4-gather-bf16 on the hot-voxel input ({GATHER_HOT_POINTS} points "
          f"of each frameset in one cell; the hottest voxel {h_hot} taps, "
          f"{h_live} live taps): equal to its plain version bit for bit, "
          f"two launches bit-identical, the plans equal; {hot_row['ms']:.4f} "
          f"ms = plan {hot_row['plan_ms']:.4f} + reduce "
          f"{hot_row['reduce_ms']:.4f}", flush=True)
    rows = {"K3-gather-bf16": row3, "K4-gather-bf16": row4}
    del dvol, again, ref, hot, order, start
    torch.cuda.empty_cache()
    _print_rows(rows)
    return rows


# ------------------------------------------------------ the warp windows

# (mixed precision, batch, focal_length_scale): the 6-camera step on
# FakeDataset's "nuscenes" rig, whose thin overlap strips make the windows
# engage. At the production scale (300) the random init's depths (~5 m)
# put no pixel in any overlap, so the overlap losses are 0 and windowed
# against dense would hold nothing; at 100 (depths ~14 m) they are not, and
# the comparison reads the windowed warps' gradients. The last cell is the
# bench's.
WINDOW_CELLS = ((False, 2, 100.0), (True, 2, 100.0), (True, 1, 300.0))
# windowed against dense, step 1 from the same state and batch with the
# overflow 0: the windows warp every pixel that can see a neighbour, so
# only the coordinates' rounding (the window's grid offset by its origin)
# and cuDNN's run-to-run spread (1.9e-5 in relative L2 between two f32
# runs, root PERF.md "PR 11") part them; bf16 parts like two bf16 runs
WINDOW_LOSS_RTOL = 1e-5
WINDOW_GRAD_RTOL = 1e-3        # relative L2 norm, per parameter
# boxes too small for the "nuscenes" rig's overlaps: every step overflows
WINDOW_FORCED_HW = (64, 128)


def _window_summary(win, model) -> str:
    """Sizes, the origins' range per kind and slot, and the overflow."""
    parts = [f"sizes spatial {model.warp_window_hw[0]}, spatio-temporal "
             f"{model.warp_window_hw[1]}"]
    for kind, org in (("spatial", win.spatio_origin),
                      ("spatio-temporal", win.st_origin)):
        if org is None:
            parts.append(f"{kind} dense")
            continue
        for slot in range(org.shape[-2]):
            o = org[..., slot, :].reshape(-1, 2)
            parts.append(f"{kind} slot {slot} y0 in [{o[:, 0].min().item()}"
                         f", {o[:, 0].max().item()}], x0 in "
                         f"[{o[:, 1].min().item()}, {o[:, 1].max().item()}]")
    parts.append(f"overflow {win.overflow.item():.0f} px")
    return "; ".join(parts)


def time_k5_windowed(key, row, calls, label):
    """K5 on the windowed calls of one step (``capture_k5``: the overlap
    warps' coordinates are the windows' pixels, both slots in one launch):
    each against its plain version, then timed alone and back to back
    beside its bound; kept in ``key``'s row under ``window``."""
    from vfdepth_tpu_torch.ops.warp import (warp_image_mask_maps,
                                            warp_image_mask_maps_plain)
    check(len(calls) == 4, f"{label}: {len(calls)} K5 calls in a step, "
                           f"expected 4")
    full = calls[0][2].shape[1]
    windowed = [c for c in calls if c[2].shape[1] < full]
    check(len(windowed) == 3, f"{label}: {len(windowed)} windowed K5 calls, "
                              f"expected 3 (spatial, 2 spatio-temporal)")
    tol = BF16_STEP if key.endswith("bf16") else K5_TOL
    times, streams, bounds, errs = [], [], [], []
    for img, mask, coords in windowed:
        got = warp_image_mask_maps(img, mask, coords)
        ref = warp_image_mask_maps_plain(img, mask, coords)
        torch.cuda.synchronize()
        errs.append(max((a.float() - r.float()).abs().max().item()
                        for a, r in zip(got, ref)))
        times.append(time_ms(lambda: warp_image_mask_maps(img, mask, coords)))
        streams.append(stream_ms(lambda: warp_image_mask_maps(img, mask,
                                                              coords)))
        bounds.append(bound(nbytes(img, mask, coords, *got),
                            coords.shape[0] * coords.shape[1] * 3 * 11)[0])
        del got, ref
    check(max(errs) <= tol, f"{label}: K5 on the windows differs from its "
                            f"plain version: {max(errs)} > {tol}")
    entry = dict(points=[c[2].shape[1] for c in windowed],
                 dense_points=full, call_ms=times, stream_ms=streams,
                 bound_ms=bounds, max_abs_err=max(errs))
    row.setdefault("window", {})[label] = entry
    row["max_abs_err"] = max(row["max_abs_err"], max(errs))
    print(f"{key} on {label}'s windows ({entry['points']} target pixels "
          f"a call against {full} dense; against plain: max_abs_err "
          f"{max(errs):.3e}, tol {tol:.1e}): per call "
          f"{[round(t, 4) for t in times]} ms, back to back "
          f"{[round(t, 4) for t in streams]} ms, bound "
          f"{[round(b, 4) for b in bounds]} ms", flush=True)


def run_windowed_path(cfg, device, label, per_step, row, key, paths):
    """The 6-camera step with the warp windows on the "nuscenes" rig:
    windows sized by ``create_train_state`` from the first batch, a
    warm-up step (K5's windowed calls captured, held and timed), then 3
    windowed steps, the state restored, and the same 3 steps dense (step
    1's loss and gradients held against the windowed step 1; where the
    focal-length scale is below the production 300, the overlap losses
    must be above 0 for it). Returns (windowed ms, dense ms)."""
    from vfdepth_tpu_torch.training import (VFDepthModel, create_train_state,
                                            train_step)
    b = cfg.batch_size
    bf16 = cfg.get("mixed_precision", False)
    loss_rtol, grad_rtol = ((BF16_STEP_LOSS_RTOL, BF16_STEP_GRAD_RTOL)
                            if bf16 else (WINDOW_LOSS_RTOL, WINDOW_GRAD_RTOL))
    t0 = time.perf_counter()
    model = VFDepthModel(cfg, device=device, seed=0)
    ds = _dataset(cfg, b * (N_STEPS + 1), "nuscenes")
    batches = [ds.batch(list(range(i * b, (i + 1) * b)))
               for i in range(N_STEPS + 1)]
    opt = create_train_state(model, batch=batches[0],
                             rigs=ds.rig_calibrations())
    check(model.warp_window and model.warp_window_hw is not None,
          f"{label}: the windows did not engage on the nuscenes rig")
    hw = model.warp_window_hw
    seen = []
    real_windows = model._windows

    def recording(*args, **kwargs):
        win = real_windows(*args, **kwargs)
        seen.append(win)
        return win
    model._windows = recording

    def noise_gen(step):
        return torch.Generator(device).manual_seed(1000 + step)
    calls = capture_k5(lambda: train_step(model, opt, batches[0], 0,
                                          noise_gen(0)))
    torch.cuda.synchronize()
    print(f"{label} set-up (model, data, windows, warm-up step): "
          f"{time.perf_counter() - t0:.1f} s; {_window_summary(seen[-1], model)}",
          flush=True)
    time_k5_windowed(key, row, calls, label)
    del calls
    params0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt0 = copy.deepcopy(opt.state_dict())

    def run(tag):
        reset_counts()
        ms, overflows = [], []
        for step in range(1, N_STEPS + 1):
            before = read_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            logs = train_step(model, opt, batches[step], step,
                              noise_gen(step))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            delta = {k: n - before[k] for k, n in read_counts().items()}
            check(delta == per_step, f"{label} {tag} step {step}: kernel "
                                     f"launches {delta}, expected {per_step}")
            if step == 1:
                out = (logs["total_loss"].item(), _grads(model),
                       logs["spatio_loss"].item(),
                       logs["spatio_tempo_loss"].item())
            ov = logs.get("warp_window_overflow")
            overflows.append(None if ov is None else ov.item())
            print(f"{label} {tag} step {step}: {ms[-1]:.2f} ms, loss "
                  f"{logs['total_loss'].item():.6f}, spatio "
                  f"{logs['spatio_loss'].item():.6f}, spatio-temporal "
                  f"{logs['spatio_tempo_loss'].item():.6f}, overflow "
                  f"{overflows[-1]}", flush=True)
        return ms, out, overflows, read_counts()

    ms_w, (loss_w, grads_w, sp_w, st_w), ov_w, counts = run("windowed")
    if cfg.focal_length_scale < 300:
        check(sp_w > 0 and st_w > 0, f"{label}: overlap losses {sp_w}, "
                                     f"{st_w}: nothing to compare")
    paths[f"{label} windowed training"] = dict(launches=counts, ms=ms_w)
    check(all(v is not None and math.isfinite(v) for v in ov_w),
          f"{label}: overflow {ov_w}")
    distinct = dict.fromkeys(_window_summary(w, model)
                             for w in seen[-N_STEPS:])
    print(f"{label}: windows of the timed steps: {' | '.join(distinct)}",
          flush=True)
    model.load_state_dict(params0)
    opt.load_state_dict(opt0)
    model.warp_window_hw = None                       # dense from here
    ms_d, (loss_d, grads_d, _, _), ov_d, _ = run("dense")
    check(ov_d == [None] * N_STEPS, f"{label}: the dense steps logged an "
                                     f"overflow {ov_d}")
    model.warp_window_hw = hw
    if ov_w[0] == 0.0:
        worst, worst_name = 0.0, ""
        for name, g in grads_d.items():
            rel = ((grads_w[name] - g).norm()
                   / g.norm().clamp_min(1e-30)).item()
            if rel > worst:
                worst, worst_name = rel, name
        print(f"{label} step 1 windowed vs dense: loss {loss_w:.8f} vs "
              f"{loss_d:.8f} (rel {abs(loss_w - loss_d) / abs(loss_d):.2e}, "
              f"tol {loss_rtol:.0e}); worst gradient relative L2 difference "
              f"{worst:.2e} ({worst_name}; tol {grad_rtol:.0e})", flush=True)
        check(abs(loss_w - loss_d) <= loss_rtol * abs(loss_d),
              f"{label} step 1: windowed loss {loss_w} vs dense {loss_d}")
        check(worst <= grad_rtol, f"{label} step 1: {worst_name} differs "
                                  f"by {worst} (relative L2) from dense")
    else:
        print(f"{label} step 1 overflowed ({ov_w[0]} px): windowed and "
              f"dense differ by design; not compared", flush=True)
    print(f"{label}: windowed ms {[round(m, 3) for m in ms_w]} (median "
          f"{statistics.median(ms_w):.3f}), dense ms "
          f"{[round(m, 3) for m in ms_d]} (median "
          f"{statistics.median(ms_d):.3f})", flush=True)
    del grads_w, grads_d, params0, opt0
    opt.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    profile(f"{label} windowed step", lambda: train_step(
        model, opt, batches[0], N_STEPS + 1, noise_gen(N_STEPS + 1)))
    del model, opt
    torch.cuda.empty_cache()
    return ms_w, ms_d


def run_window_fallback(device, tmp, paths):
    """A forced overflow: the bench's bf16 batch-1 model with boxes of
    ``WINDOW_FORCED_HW`` through ``Trainer.learn`` for 3 steps, each a log
    checkpoint: the first two log ``warp_window_overflow`` > 0, the second
    turns the windows off, the third is dense."""
    from vfdepth_tpu_torch import presets
    from vfdepth_tpu_torch.data import BatchLoader
    from vfdepth_tpu_torch.training import Trainer, VFDepthModel
    cfg = presets.build_config(batch_size=1, mixed_precision=True)
    for key, value in (("warp_window_hw", list(WINDOW_FORCED_HW)),
                       ("num_fake_samples", 3), ("num_epochs", 1),
                       ("log_frequency", 1), ("early_phase", 1000),
                       ("late_log_frequency", 1000),
                       ("log_path", str(tmp / "log")),
                       ("save_weights_root", str(tmp / "models"))):
        cfg.set(key, value)
    model = VFDepthModel(cfg, device=device, seed=0)
    trainer = Trainer(cfg, model, use_tb=False)
    notes, real_note = [], trainer._note_warp_overflow

    def note(overflow):
        was = model.warp_window
        fell = real_note(overflow)
        notes.append((overflow, was, fell, model.warp_window))
        return fell
    trainer._note_warp_overflow = note
    loader = BatchLoader(_dataset(cfg, 3, "nuscenes"), 1, shuffle=False,
                         num_workers=0)
    reset_counts()
    t = time.perf_counter()
    trainer.learn(loader)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    counts = read_counts()
    paths["6-camera bf16 window fallback trainer"] = dict(launches=counts,
                                                          ms=[wall / 3])
    print(f"window fallback: Trainer.learn, 3 steps with boxes "
          f"{WINDOW_FORCED_HW} on the nuscenes rig: checkpoints "
          f"(overflow, windows on before, fell back, on after) {notes}; "
          f"{wall:.1f} ms", flush=True)
    check(len(notes) == 3, f"window fallback: {len(notes)} checkpoints")
    check(notes[0][0] > 0 and notes[0][1] and not notes[0][2],
          f"window fallback: first checkpoint {notes[0]}")
    check(notes[1][0] > 0 and notes[1][2] and not notes[1][3],
          f"window fallback: second checkpoint {notes[1]}")
    check(notes[2][0] == 0.0 and not notes[2][3],
          f"window fallback: third checkpoint {notes[2]}")
    check(model.warp_window_hw is None, "window fallback: sizes kept")
    check(counts["K5-bf16"] == 12, f"window fallback: K5-bf16 launched "
                                   f"{counts['K5-bf16']} times, expected 12")
    del model, trainer
    torch.cuda.empty_cache()


BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "extra")
BENCH_EXTRA_KEYS = ("step_ms", "mfu_pct_bf16_peak", "even_rig_samples_per_sec",
                    "batch2_samples_per_sec")


def run_bench_cli():
    """``python -m vfdepth_tpu_torch.bench`` with ``BENCH_STEPS=3``: its
    JSON line must carry the root bench's keys, with finite values."""
    env = dict(os.environ, BENCH_STEPS="3")
    for k in [k for k in env if k.startswith("BENCH_") and k != "BENCH_STEPS"]:
        del env[k]
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "vfdepth_tpu_torch.bench"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t
    for line in proc.stderr.splitlines()[-12:]:
        print(f"  bench: {line}", flush=True)
    check(proc.returncode == 0, f"bench exited {proc.returncode}: "
                                f"{proc.stderr[-2000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    result = json.loads(line)
    check(all(k in result for k in BENCH_KEYS), f"bench keys {sorted(result)}")
    extra = result["extra"]
    check(all(k in extra for k in BENCH_EXTRA_KEYS),
          f"bench extra keys {sorted(extra)}")
    numbers = [result["value"], result["vs_baseline"]] + [
        extra[k] for k in BENCH_EXTRA_KEYS]
    check(all(isinstance(v, (int, float)) and math.isfinite(v) and v > 0
              for v in numbers), f"bench numbers {numbers}")
    print(f"bench (python -m vfdepth_tpu_torch.bench, BENCH_STEPS=3, "
          f"{wall:.1f} s): {line}", flush=True)
    return result


def run_windows(device, rows, paths, tmp):
    """The warp-window phase: each of ``WINDOW_CELLS``, the forced
    overflow through the trainer, then the bench."""
    from vfdepth_tpu_torch import presets
    for mp, b, fls in WINDOW_CELLS:
        cfg = presets.build_config(batch_size=b, mixed_precision=mp)
        cfg.set("focal_length_scale", fls)
        key = "K5-bf16" if mp else "K5"
        per_step = (launches(**{"K1-bf16": 1, "K2-bf16": 1, "K3-bf16": 1,
                                "K4-bf16": 1, "K5-bf16": 4}) if mp else
                    launches(K1=1, K2=1, K3=1, K4=1, K5=4))
        label = (f"6-camera{' bf16' if mp else ''} nuscenes batch {b}"
                 f"{'' if fls == 300 else f' scale {fls:g}'}")
        run_windowed_path(cfg, device, label, per_step, rows[key], key,
                          paths)
    run_window_fallback(device, tmp / "window_fallback", paths)
    run_bench_cli()


# ------------------------------------------------ data parallelism

DDP_CONFIG = ROOT / "configs" / "ddad" / "ddad_surround_fusion_ddp.yaml"
DP_WORLD = 2
DP_STEP = 3                 # the global step of the compared update
DP_TIMED_STEPS = 2          # each rank's steps after the compared one
DP_DEADLINE_S = 600         # a world's ranks, all its cells, start-up included
DP_DEVICE = "cuda"          # the ranks' device ("cpu" rehearses the phase)
# (label, mixed precision, FakeDataset rig, windows sized from the batch,
# the training option or None): the 6-camera f32 step and the bench's cell
# (bf16, the "nuscenes" rig, the production focal-length scale, windows
# on), each at batch 1 a rank
DP_CELLS = (("6-camera f32", False, "even", False, None),
            ("6-camera bf16 nuscenes (the bench's cell)", True, "nuscenes",
             True, None))
# the training options of the camera axis, f32 at batch 1 a rank: the
# published production yaml with each net's own back-projection, and with
# unbatched pose frames; the fsm baseline; the published augdepth yaml
CAM_OPTION_CELLS = (
    ("6-camera f32 unmerged", False, "even", False, "unmerged"),
    ("6-camera f32 unbatched pose frames", False, "even", False,
     "unbatched"),
    ("6-camera fsm f32", False, "even", False, "fsm"),
    ("6-camera aug f32", False, "even", False, "aug"))
# each option cell's collectives of a step on every rank of the (1, 2)
# grid: the cam-group sums of each back-projection (2 a net and pose pass
# where the nets back-project their own features), the fsm poses' and the
# aug depths' gathers
CAM_OPTION_SITES = {
    "unmerged": dict(cam_fusion=4),
    "unbatched": dict(cam_fusion=6),
    "fsm": dict(cam_poses=1),
    "aug": dict(cam_fusion=2, cam_depths=1)}
# the camera-axis worlds, (data, cam, cells): each rank runs its cameras
# of its data shard's batch, which is the global batch of DP_WORLD samples
# split over the data shards, so every cell is held against the same
# single-process step as the two data-parallel ranks
CAM_WORLDS = ((1, 2, DP_CELLS + CAM_OPTION_CELLS), (2, 2, DP_CELLS[1:]))


def dp_config(cell):
    """A cell's config at batch 1 (a rank's batch): the published yaml in
    f32, the bench's cell (``presets.build_config``) in bf16, or the
    cell's training option (``CAM_OPTION_CELLS``)."""
    from vfdepth_tpu_torch import presets
    from vfdepth_tpu_torch.config import get_config
    mp, option = cell[1], cell[4]
    if mp:
        return presets.build_config(batch_size=1, mixed_precision=True)
    if option == "fsm":
        cfg = fsm_config()
    elif option == "aug":
        cfg = aug_config()
    else:
        cfg = get_config(str(CONFIG))
        if option == "unmerged":
            cfg.set("merge_backprojection", False)
        elif option == "unbatched":
            cfg.set("batch_pose_frames", False)
    cfg.set("batch_size", 1)
    return cfg


def carry_adam_state(opt, model, seed: int = 0):
    """A mid-run Adam state on every parameter (7 updates made, seeded
    moments; tests/test_torch_parallel.py's), so that an update follows its
    gradient smoothly: Adam's first step from zero moments is about
    lr * sign(g), which a gradient entry near 0 flips."""
    gen = torch.Generator().manual_seed(seed)
    for _, p in model.named_parameters():
        opt.state[p] = dict(
            step=torch.tensor(7.0),
            exp_avg=(1e-3 * torch.randn(p.shape, generator=gen)).to(p.device),
            exp_avg_sq=(1e-8 * (0.5 + torch.rand(p.shape, generator=gen))
                        ).to(p.device))


def dp_cell_step(cell, device, rank: int = 0, world: int = 1, grid=None):
    """One cell's step from the seeded model (seed ``rank``: under a group
    the set-up broadcast replaces the other ranks' weights with rank 0's)
    and a carried Adam state: the global batch's first ``world``-th for
    this rank (all of it in one process; under a camera-axis ``grid`` its
    data shard's part, its cameras), the global tie-break noise (and
    rotated-view draw) drawn from one seed. Then ``DP_TIMED_STEPS`` more
    steps, timed (one for an option cell: its ranks' steps take seconds
    over gloo). Returns the results on the host, with the compared step's
    launches, collectives by site and peak memory."""
    from vfdepth_tpu_torch.parallel import COUNTS, reduce_logs
    from vfdepth_tpu_torch.training import (VFDepthModel, create_train_state,
                                            train_step)
    label, mp, rig, windows, _ = cell
    cfg = dp_config(cell)
    ds = _dataset(cfg, DP_WORLD, rig)
    shard, shards = (grid.d, grid.data) if grid is not None else (rank, world)
    per = DP_WORLD // shards
    batch = ds.batch(list(range(shard * per, (shard + 1) * per)))
    model = VFDepthModel(cfg, device=device, seed=rank)
    model.shard_cameras(grid)
    opt = create_train_state(model, batch=batch if windows else None,
                             rigs=ds.rig_calibrations() if windows else None)
    carry_adam_state(opt, model)
    before = {k: v.detach().cpu().clone()
              for k, v in model.state_dict().items()}
    reset_counts()
    collectives = dict(COUNTS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logs = train_step(model, opt, batch, DP_STEP,
                      torch.Generator(device).manual_seed(1000))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out = dict(counts=read_counts(), logs=reduce_logs(logs),
               collectives={k: v - collectives.get(k, 0)
                            for k, v in COUNTS.items()
                            if v != collectives.get(k, 0)},
               peak_gib=peak, windows=(model.warp_window,
                                       model.warp_window_hw),
               before=before,
               grads={k: p.grad.detach().cpu().clone()
                      for k, p in model.named_parameters()},
               state={k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()}, ms=[])
    for i in range(1 if cell[4] else DP_TIMED_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        train_step(model, opt, batch, DP_STEP + 1 + i,
                   torch.Generator(device).manual_seed(1001 + i))
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t) * 1e3)
    del model, opt
    torch.cuda.empty_cache()
    return out


def dp_rank(rank: int, work: str, world: int = DP_WORLD, cam: int = 1,
            cells=DP_CELLS):
    """A rank of the ``world`` that share the card over gloo (NCCL refuses
    two ranks on one device): every cell's step, saved to ``rank<r>.pt``.
    With ``cam`` > 1 the ranks form the (world / cam, cam) camera-axis
    grid. The kernels are already built: ``_build`` finds their
    libraries."""
    import hashlib
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    from vfdepth_tpu_torch.parallel import (COUNTS, make_grid_2d,
                                            maybe_initialize_distributed)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK="0")
    maybe_initialize_distributed(
        DP_DEVICE, backend="gloo",
        init_method=f"file://{Path(work) / 'store'}", timeout_s=DP_DEADLINE_S)
    device = (torch.device("cuda", torch.cuda.current_device())
              if DP_DEVICE == "cuda" else torch.device(DP_DEVICE))
    grid = make_grid_2d(world // cam, cam) if cam > 1 else None
    results = []
    for cell in cells:
        out = dp_cell_step(cell, device, rank, world, grid)
        digest = hashlib.sha256()
        for k in sorted(out["state"]):
            digest.update(out["state"][k].numpy().tobytes())
        out["digest"] = digest.hexdigest()
        if rank:
            del out["state"], out["grads"], out["before"]
        results.append(out)
    results.append(dict(COUNTS))
    dist.barrier()
    torch.save(results, Path(work) / f"rank{rank}.pt")
    dist.destroy_process_group()


def _rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm()
            / b.float().norm().clamp_min(1e-30)).item()


def dp_refs(device):
    """Each cell's single-process step at the global batch (DP_WORLD), by
    label."""
    refs = {}
    for cell in DP_CELLS + CAM_OPTION_CELLS:
        ref = refs[cell[0]] = dp_cell_step(cell, device)
        print(f"{cell[0]} single-process step at batch {DP_WORLD}: loss "
              f"{ref['logs']['total_loss']:.6f}, windows {ref['windows']}, "
              f"step ms {[round(m, 3) for m in ref['ms']]}, peak "
              f"{ref['peak_gib']:.3f} GiB", flush=True)
    return refs


def spawn_ranks(tmp: Path, what: str, world: int, cam: int = 1,
                cells=DP_CELLS):
    """``world`` ranks of ``dp_rank`` over gloo on the card; their results
    and the wall time. A rank must build no kernel."""
    import torch.multiprocessing as mp
    from vfdepth_tpu_torch.ops import _build
    built = set(_build.BUILD_DIR.iterdir())
    t = time.perf_counter()
    ctx = mp.spawn(dp_rank, args=(str(tmp), world, cam, cells),
                   nprocs=world, join=False)
    deadline = time.monotonic() + DP_DEADLINE_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            check(False, f"{what}: not done in {DP_DEADLINE_S} s")
    wall = time.perf_counter() - t
    check(set(_build.BUILD_DIR.iterdir()) == built,
          f"{what}: a rank built a kernel")
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)], wall


def hold_cell(cell, ref, got, what, want_counts, paths):
    """The ranks' step of ``cell`` against the single-process step ``ref``
    at the same global batch, weights and noise: loss and logs within the
    step tolerance, each gradient, each parameter's update (after Adam from
    a carried state) and each BatchNorm statistic within the gradient
    tolerance (relative L2); the ranks' states bit-identical and their
    logs equal; each rank's launches ``want_counts``; the windows equal.
    Each rank joins ``paths``."""
    label, mp_ = cell[0], cell[1]
    loss_rtol, grad_rtol = ((BF16_STEP_LOSS_RTOL, BF16_STEP_GRAD_RTOL)
                            if mp_ else (STEP_LOSS_RTOL, STEP_GRAD_RTOL))
    for r, out in enumerate(got):
        check(out["digest"] == got[0]["digest"],
              f"{label}, {what}: rank {r}'s state differs from rank 0's")
        check(out["counts"] == want_counts,
              f"{label}, {what} rank {r}: launches {out['counts']}, "
              f"expected {want_counts}")
        check(out["windows"] == ref["windows"],
              f"{label}, {what} rank {r}: windows {out['windows']} vs "
              f"{ref['windows']}")
        check(out["logs"] == got[0]["logs"],
              f"{label}, {what}: the ranks' reduced logs differ")
    g = got[0]
    log_err = {k: abs(g["logs"][k] - w) / max(abs(w), 1e-3)
               for k, w in ref["logs"].items()}
    check(set(g["logs"]) == set(ref["logs"]), f"{label}: log keys")
    check(all(math.isfinite(v) for v in g["logs"].values()),
          f"{label}: logs {g['logs']}")
    worst_log = max(log_err, key=log_err.get)
    check(log_err[worst_log] <= loss_rtol,
          f"{label}, {what}: log {worst_log} {g['logs'][worst_log]} vs "
          f"{ref['logs'][worst_log]}")
    params = set(g["grads"])
    grad_err = {k: _rel_l2(g["grads"][k], w)
                for k, w in ref["grads"].items()}
    upd_err = {k: _rel_l2(g["state"][k] - g["before"][k],
                          ref["state"][k] - ref["before"][k])
               for k in params}
    stat_err = {k: _rel_l2(g["state"][k], w)
                for k, w in ref["state"].items()
                if k.endswith(("running_mean", "running_var"))}
    for kind, errs in (("gradient", grad_err), ("update", upd_err),
                       ("BatchNorm statistic", stat_err)):
        worst = max(errs, key=errs.get)
        check(errs[worst] <= grad_rtol, f"{label}, {what}: {kind} of "
              f"{worst} differs by {errs[worst]} (relative L2)")
    check(all(torch.equal(g["before"][k], ref["before"][k])
              for k in ref["before"]),
          f"{label}, {what}: rank 0 did not start from the seeded weights")
    for r, out in enumerate(got):
        paths[f"{label} {what}, rank {r}"] = dict(launches=out["counts"],
                                                  ms=out["ms"])
    print(f"{label}, {what} against one process at batch {DP_WORLD}: loss "
          f"{g['logs']['total_loss']:.7f} vs {ref['logs']['total_loss']:.7f};"
          f" worst log {worst_log} {log_err[worst_log]:.2e} (tol "
          f"{loss_rtol:.0e}); worst relative L2: gradient "
          f"{max(grad_err.values()):.2e}, update {max(upd_err.values()):.2e},"
          f" BatchNorm statistic {max(stat_err.values()):.2e} (tol "
          f"{grad_rtol:.0e}); ranks bit-identical; windows {g['windows']}",
          flush=True)
    for r, out in enumerate(got):
        print(f"{label}, {what} rank {r}: launches "
              f"{({k: v for k, v in out['counts'].items() if v})}, "
              f"collectives {dict(sorted(out['collectives'].items()))}, "
              f"step ms {[round(m, 3) for m in out['ms']]}, peak "
              f"{out['peak_gib']:.3f} GiB", flush=True)
    print(f"{label}, {what}: one process at batch {DP_WORLD}: step ms "
          f"{[round(m, 3) for m in ref['ms']]}, peak {ref['peak_gib']:.3f} "
          f"GiB (ranks time-share one card over gloo: not a multi-GPU "
          f"speed)", flush=True)


def run_two_ranks(device, paths, tmp: Path, refs):
    """Two ranks time-sharing the card over gloo, each cell's step at batch
    1 a rank held against the single-process step at batch 2
    (``hold_cell``); each rank launches what the single-process step
    launches."""
    ranks, wall = spawn_ranks(tmp, "two ranks", DP_WORLD)
    counts = ranks[0][-1]
    print(f"two ranks over gloo on one card: spawned, both cells run in "
          f"{wall:.1f} s; rank 0's collectives by site {counts}", flush=True)
    for site in ("broadcast", "batch_norm", "loss", "gradients", "logs"):
        check(counts.get(site, 0) > 0, f"two ranks: no {site} collective")
    for i, cell in enumerate(DP_CELLS):
        ref = refs[cell[0]]
        hold_cell(cell, ref, [r[i] for r in ranks], "two ranks over gloo",
                  ref["counts"], paths)
    del ranks
    torch.cuda.empty_cache()


def per_camera_launches(counts):
    """A step's launches with its back-projection per camera: K1 / K2 (and
    their bf16 forms) counted as K1b / K2b, as a rank of the camera-axis
    grid back-projects its cameras."""
    out = dict(counts)
    for grouped, per_cam in (("K1", "K1b"), ("K2", "K2b")):
        for tag in ("", "-bf16"):
            out[per_cam + tag] += out[grouped + tag]
            out[grouped + tag] = 0
    return out


def run_cam_world(device, paths, tmp: Path, refs, data: int, cam: int,
                  cells):
    """The (data, cam) camera-axis grid of data * cam ranks sharing the
    card over gloo: each cell's step held against the single-process step
    at the same global batch (``hold_cell``); every rank launches the
    per-camera back-projection (K1b / K2b), K3, K4 and K5 as often as one
    process launches K1 / K2, K3, K4 and K5, and takes the cell's
    cam-group collectives: two all-reduces a back-projection (its group
    sums and count; ``CAM_OPTION_SITES`` for the option cells), the fsm
    poses' and the aug depths' gathers."""
    world = data * cam
    what = f"(data {data}, cam {cam}) grid of {world} ranks over gloo"
    ranks, wall = spawn_ranks(tmp, what, world, cam, cells)
    print(f"{what} on one card: spawned, {len(cells)} cell(s) run in "
          f"{wall:.1f} s; rank 0's collectives by site {ranks[0][-1]}",
          flush=True)
    for i, cell in enumerate(cells):
        ref = refs[cell[0]]
        got = [r[i] for r in ranks]
        want = CAM_OPTION_SITES.get(cell[4], dict(cam_fusion=2))
        for r, out in enumerate(got):
            sites = {k: v for k, v in out["collectives"].items()
                     if k.startswith("cam_")}
            check(sites == want, f"{cell[0]}, {what} rank {r}: collectives "
                                 f"{out['collectives']}, expected {want}")
        hold_cell(cell, ref, got, what, per_camera_launches(ref["counts"]),
                  paths)
    del ranks
    torch.cuda.empty_cache()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_nccl_cli(tmp: Path):
    """``python -m vfdepth_tpu_torch.train`` as ``torch.distributed.run``
    starts a world of one (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT): 2 steps of the published ``_ddp.yaml`` model at full width
    on ``FakeDataset`` (its ``log_dir`` in ``tmp``), its encoders from a
    seeded synthetic ResNet-18 file. The run must join an NCCL group, go
    through the global BatchNorm and the global loss (its collectives
    line), write ``weights_0`` and build no kernel."""
    from vfdepth_tpu_torch.ops import _build
    src = DDP_CONFIG.read_text()
    for old, new in (("dataset: ddad", "dataset: fake"),
                     ("log_dir: ./results/", f"log_dir: {tmp}/"),
                     ("num_workers: 6", "num_workers: 2")):
        check(old in src, f"{DDP_CONFIG.name} has no {old!r}")
        src = src.replace(old, new)
    cfg_file = tmp / "ddad_surround_fusion_ddp.yaml"
    cfg_file.write_text(src)
    resnet = tmp / "resnet18.pth"
    synthetic_resnet18(resnet)
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               VFDEPTH_RESNET_WEIGHTS=str(resnet))
    built = set(_build.BUILD_DIR.iterdir())
    t = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "vfdepth_tpu_torch.train",
                          "--config_file", str(cfg_file), "--max_steps", "2"],
                         cwd=str(ROOT), env=env, capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t
    print(f"NCCL world 1: python -m vfdepth_tpu_torch.train on "
          f"{DDP_CONFIG.name} (fake data), 2 steps: exit {res.returncode} "
          f"in {wall:.1f} s", flush=True)
    if res.returncode != 0:
        print(res.stdout[-3000:], res.stderr[-3000:], flush=True)
    check(res.returncode == 0, f"the NCCL run exited {res.returncode}")
    line = next((x for x in res.stdout.splitlines()
                 if x.startswith("data parallel:")), "")
    print(f"NCCL world 1: {line}", flush=True)
    check("backend nccl, world 1" in line, "the run joined no NCCL group")
    counts = json.loads(line.split("collectives ", 1)[1])
    for site in ("batch_norm", "loss", "gradients", "logs", "broadcast"):
        check(counts.get(site, 0) > 0, f"NCCL world 1: no {site} collective")
    check((tmp / "ddad_surround_fusion_ddp" / "models" / "weights_0").is_dir(),
          "NCCL world 1: no weights_0 written")
    check(set(_build.BUILD_DIR.iterdir()) == built,
          "NCCL world 1: the run built a kernel")


def run_data_parallel(device, paths):
    """The data-parallel phases: a torchrun-style NCCL world of one through
    the training command line, then two ranks sharing the card over gloo,
    then the camera-axis grids (``CAM_WORLDS``), every world's cells held
    against the same single-process steps."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp_dir:
        tmp = Path(tmp_dir)
        (tmp / "cli").mkdir()
        run_nccl_cli(tmp / "cli")
        refs = dp_refs(device)
        (tmp / "ranks").mkdir()
        run_two_ranks(device, paths, tmp / "ranks", refs)
        for data, cam, cells in CAM_WORLDS:
            work = tmp / f"cam_{data}x{cam}"
            work.mkdir()
            run_cam_world(device, paths, work, refs, data, cam, cells)
        del refs
        torch.cuda.empty_cache()


def profile(label, fn, top: int = 14):
    """``fn`` once more under ``torch.profiler``: device time by kernel
    (self time, summed over launches), and the device's busy time as the
    union of the device-side spans (kernels may overlap) against the wall
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    # device-side events only (kernels, copies): the CPU-side aten rows
    # carry their kernels' device time too and would count it twice
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    summed = sum(r[1] for r in rows)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, cur = 0.0, None
    for start, end in spans:
        if cur is None or start > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    busy += 0.0 if cur is None else cur[1] - cur[0]
    print(f"profile ({label}): wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms (union of device spans, "
          f"{100 * busy / wall_us:.1f}% of wall), kernel time summed "
          f"{summed / 1e3:.2f} ms over {len(rows)} device ops", flush=True)
    for key, us, count in rows[:top]:
        print(f"  {us / 1e3:8.3f} ms {100 * us / summed:5.1f}%  x{count:<5d} "
              f"{key[:110]}", flush=True)
    ours = {k: (us, count) for k, us, count in rows
            if any(n in k for n in ("backproject_grouped", "sample2d",
                                    "sample3d_", "warp_image_mask",
                                    "backproject_bwd_", "tiles::"))}
    for key, (us, count) in sorted(ours.items()):
        print(f"  port kernel {key[:80]}: {us / 1e3:.3f} ms x{count}",
              flush=True)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import vfdepth_tpu_torch
    from vfdepth_tpu_torch.config import get_config
    from vfdepth_tpu_torch.ops import _build

    check(Path(vfdepth_tpu_torch.__file__).resolve().parent.parent == ROOT,
          "vfdepth_tpu_torch was not imported from this checkout")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; TF32 off", flush=True)
    print(f"nvidia-smi: {smi}", flush=True)

    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {len(built)} kernels in {time.perf_counter() - t0:.1f} s",
          flush=True)
    check(len(built) == 5, f"expected 5 kernels, built {sorted(built)}")
    for res in built.values():
        for line in res.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {res.name}: {line.strip()}", flush=True)

    cfg = get_config(str(CONFIG))
    cfg3 = three_cam_config()
    gen = torch.Generator().manual_seed(0)
    errs = {"K1": check_k1(cfg, device, gen), "K3": check_k3(cfg, device, gen),
            "K2": check_k2(cfg, device, gen), "K4": check_k4(cfg, device, gen),
            "K5": check_k5(cfg, device, gen)}
    errs["K1"] = max(errs["K1"], check_k1_normalised(cfg, device, gen))
    errs["K1b"] = check_k1b(cfg3, device, gen)
    errs["K2b"] = check_k2b(cfg3, device, gen)
    torch.cuda.empty_cache()
    rows = time_kernels(cfg, cfg3, device, gen, errs)
    cfg_mp = mixed_precision_config()
    cfg3_mp = three_cam_bf16_config()
    errs.update(check_bf16_forms(cfg_mp, device, gen))
    torch.cuda.empty_cache()
    errs["K1b-bf16"], errs["K2b-bf16"] = check_k1b_k2b_bf16(cfg3_mp, device,
                                                          gen)
    errs["K4-f32upd-bf16"] = check_k4_f32_updates_bf16(cfg_mp, device, gen)
    torch.cuda.empty_cache()
    rows.update(time_bf16_forms(cfg_mp, cfg3_mp, device, gen, errs))

    # each path: the counts set to 0 just before it, read just after
    paths = {}
    bf16_tols = dict(tols=(BF16_FWD_RTOL, BF16_POSE_ATOL))

    def serve(c, label, rig, per_request, unmerged=None, **kw):
        counts, ms, model, requests, outputs, draws = run_serving_path(
            c, device, label, per_request, rig, **kw)
        print(f"{label} serving path: {N_REQUESTS} requests, per-request ms "
              f"{[round(m, 3) for m in ms]}, "
              f"{1e3 * N_REQUESTS / sum(ms):.3f} framesets/s", flush=True)
        paths[f"{label} serving"] = dict(launches=counts, ms=ms)
        check(model.compute_dtype == (torch.bfloat16 if c.get(
            "mixed_precision", False) else None), f"{label}: compute dtype")
        if unmerged is not None:
            counts, ms = run_unmerged(model, requests[1], outputs[1], label,
                                      unmerged, aug_u=draws[1], **kw)
            paths[f"{label} unmerged request"] = dict(launches=counts,
                                                      ms=[ms])
        del model, outputs
        torch.cuda.empty_cache()

    def train(c, label, rig, per_step, **kw):
        counts, ms = run_training_path(c, device, label, per_step, rig, **kw)
        print(f"{label} training path: {N_STEPS} steps at batch "
              f"{c.batch_size}, per-step ms {[round(m, 3) for m in ms]}, "
              f"{1e3 * N_STEPS * c.batch_size / sum(ms):.3f} framesets/s "
              f"trained", flush=True)
        paths[f"{label} training"] = dict(launches=counts, ms=ms)
        torch.cuda.empty_cache()

    serve(cfg, "6-camera", "even", launches(K1=1, K3=1),
          launches(K1=2, K3=1))
    # K5 is also timed on the coordinates the 6-camera steps hand it (f32
    # and bf16), captured from each path's warm-up step
    k5_calls = []
    train(cfg, "6-camera", "even", launches(K1=1, K2=1, K3=1, K4=1, K5=4),
          k5_calls=k5_calls)
    time_k5_on_step("K5", rows["K5"], k5_calls)
    del k5_calls[:]
    torch.cuda.empty_cache()
    serve(cfg3, "3-camera", "nuscenes", launches(K1b=1, K3=1),
          launches(K1b=2, K3=1))
    # K5's calls do not depend on the rig: one temporal, one spatial and
    # one spatio-temporal warp per context frame
    train(cfg3, "3-camera", "nuscenes",
          launches(K1b=1, K2b=1, K3=1, K4=1, K5=4))
    # mixed precision: every kernel in its bf16 form, no f32 form
    serve(cfg_mp, "6-camera bf16", "even",
          launches(**{"K1-bf16": 1, "K3-bf16": 1}),
          launches(**{"K1-bf16": 2, "K3-bf16": 1}), **bf16_tols)
    train(cfg_mp, "6-camera bf16", "even", launches(
        **{"K1-bf16": 1, "K2-bf16": 1, "K3-bf16": 1, "K4-bf16": 1,
           "K5-bf16": 4}), tols=(BF16_STEP_LOSS_RTOL, BF16_STEP_GRAD_RTOL),
          k5_calls=k5_calls)
    time_k5_on_step("K5-bf16", rows["K5-bf16"], k5_calls)
    del k5_calls[:]
    torch.cuda.empty_cache()
    serve(cfg3_mp, "3-camera bf16", "nuscenes",
          launches(**{"K1b-bf16": 1, "K3-bf16": 1}),
          launches(**{"K1b-bf16": 2, "K3-bf16": 1}), **bf16_tols)
    train(cfg3_mp, "3-camera bf16", "nuscenes", launches(
        **{"K1b-bf16": 1, "K2b-bf16": 1, "K3-bf16": 1, "K4-bf16": 1,
           "K5-bf16": 4}), tols=(BF16_STEP_LOSS_RTOL, BF16_STEP_GRAD_RTOL))
    # f32 updates of the bf16 volume: K4's f32 form on a bf16 cotangent,
    # never its bf16-update form
    cfg_f32u = mixed_precision_config()
    cfg_f32u.set("sampler_3d", "packed_f32grad")
    train(cfg_f32u, "6-camera bf16 packed_f32grad", "even", launches(
        **{"K1-bf16": 1, "K2-bf16": 1, "K3-bf16": 1, "K4-f32upd-bf16": 1,
           "K5-bf16": 4}), tols=(BF16_STEP_LOSS_RTOL, BF16_STEP_GRAD_RTOL))
    # unbatched pose frames: one pose-net pass per context frame, each with
    # its own back-projection, and the depth net's (K1 three times)
    cfg_upf = get_config(str(CONFIG))
    cfg_upf.set("batch_pose_frames", False)
    serve(cfg_upf, "6-camera unbatched pose frames", "even",
          launches(K1=3, K3=1))
    train(cfg_upf, "6-camera unbatched pose frames", "even",
          launches(K1=3, K2=3, K3=1, K4=1, K5=4))
    # depth synthesis (the published augdepth yaml): the voxel volume is
    # decoded twice a request and a step, along the main and the rotated
    # frusta (K3 2, K4 2); K3 and K4 are then held and timed on the rotated
    # coordinates of the warm-up step
    cfg_aug = aug_config()
    serve(cfg_aug, "6-camera aug", "even", launches(K1=1, K3=2),
          launches(K1=2, K3=2))
    k3k4_calls = {}
    train(cfg_aug, "6-camera aug", "even",
          launches(K1=1, K2=1, K3=2, K4=2, K5=4), k3k4_calls=k3k4_calls)
    check_rotated_frusta(rows, k3k4_calls)
    cfg_aug_mp = aug_config(mixed_precision=True)
    serve(cfg_aug_mp, "6-camera aug bf16", "even",
          launches(**{"K1-bf16": 1, "K3-bf16": 2}),
          launches(**{"K1-bf16": 2, "K3-bf16": 2}), **bf16_tols)
    train(cfg_aug_mp, "6-camera aug bf16", "even", launches(
        **{"K1-bf16": 1, "K2-bf16": 1, "K3-bf16": 2, "K4-bf16": 2,
           "K5-bf16": 4}), tols=(BF16_STEP_LOSS_RTOL, BF16_STEP_GRAD_RTOL))
    cfg_aug_f32u = aug_config(mixed_precision=True)
    cfg_aug_f32u.set("sampler_3d", "packed_f32grad")
    train(cfg_aug_f32u, "6-camera aug bf16 packed_f32grad", "even", launches(
        **{"K1-bf16": 1, "K2-bf16": 1, "K3-bf16": 2, "K4-f32upd-bf16": 2,
           "K5-bf16": 4}), tols=(BF16_STEP_LOSS_RTOL, BF16_STEP_GRAD_RTOL))
    # sampler_3d: gather under mixed precision: the gather-bf16 forms in
    # place of K3-bf16 and K4, then held and timed on the step's own inputs
    cfg_gather = mixed_precision_config()
    cfg_gather.set("sampler_3d", "gather")
    serve(cfg_gather, "6-camera bf16 gather", "even",
          launches(**{"K1-bf16": 1, "K3-gather-bf16": 1}),
          launches(**{"K1-bf16": 2, "K3-gather-bf16": 1}), **bf16_tols)
    gather_calls = {}
    train(cfg_gather, "6-camera bf16 gather", "even", launches(
        **{"K1-bf16": 1, "K2-bf16": 1, "K3-gather-bf16": 1,
           "K4-gather-bf16": 1, "K5-bf16": 4}),
          tols=(BF16_STEP_LOSS_RTOL, BF16_STEP_GRAD_RTOL),
          k3k4_calls=gather_calls, sampler="Sample3dGather")
    rows.update(check_gather_forms(gather_calls))
    del gather_calls
    # the warp windows (the JAX package's default) on the "nuscenes" rig:
    # f32 and bf16 at batch 2, the bench's bf16 batch-1 cell, windowed
    # against dense, a forced overflow through the trainer, then the bench
    with tempfile.TemporaryDirectory(prefix="chip_smoke_windows_") as wtmp:
        run_windows(device, rows, paths, Path(wtmp))
    # data parallelism: an NCCL world of one through the training command
    # line, then two ranks over gloo sharing the card, each cell held
    # against the single-process step at the global batch
    run_data_parallel(device, paths)
    # activation checkpointing: each remat value against the plain step,
    # with its step time and peak memory
    run_remat(device, paths)
    # the evaluation and the training loop: the full-width model through
    # Trainer.evaluate (batch 4) and Trainer.learn (pinned prefetch), then
    # the command lines on the tiny config
    check_prefetch(cfg, device)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp_dir:
        tmp = Path(tmp_dir)
        # ImageNet encoders from a local (synthetic) torchvision file
        run_weights_init(device, tmp, paths)
        for mp, label, per_batch, tols in (
                (False, "6-camera", launches(K1=1, K3=1),
                 (FWD_RTOL, POSE_ATOL, EVAL_METRIC_RTOL,
                  EVAL_FRACTION_ATOL)),
                (True, "6-camera bf16",
                 launches(**{"K1-bf16": 1, "K3-bf16": 1}),
                 (BF16_FWD_RTOL, BF16_POSE_ATOL, BF16_EVAL_METRIC_RTOL,
                  BF16_EVAL_FRACTION_ATOL))):
            cfg_eval = get_config(str(CONFIG), mode="eval")
            cfg_eval.set("mixed_precision", mp)
            counts, ms, metric, median = run_evaluation_path(
                cfg_eval, device, label, per_batch, tmp / f"eval_{mp}", tols)
            b = cfg_eval.eval_batch_size
            print(f"{label} evaluation path: {EVAL_BATCHES} batches of {b}, "
                  f"per-batch ms {[round(m, 3) for m in ms]}, "
                  f"{1e3 * b * len(ms) / sum(ms):.3f} framesets/s; metric "
                  f"{json.dumps({k: round(v, 4) for k, v in metric.items()})}"
                  f", median "
                  f"{json.dumps({k: round(v, 4) for k, v in median.items()})}",
                  flush=True)
            paths[f"{label} evaluation"] = dict(launches=counts, ms=ms)
            torch.cuda.empty_cache()
        counts, ms = run_trainer_path(
            get_config(str(CONFIG)), device, "6-camera trainer",
            launches(K1=1, K2=1, K3=1, K4=1, K5=4),
            launches(K1=1, K3=1, K5=4), tmp / "trainer")
        print(f"6-camera trainer path: {TRAINER_EPOCHS * TRAINER_STEPS} "
              f"steps at batch {cfg.batch_size}, the loop {ms:.3f} ms a step "
              f"with the pinned prefetch", flush=True)
        paths["6-camera trainer"] = dict(launches=counts, ms=[ms])
        torch.cuda.empty_cache()
        # the depth-synthesis sweep through Trainer.evaluate at the
        # published eval batch (4), all of its views
        counts, view_ms = run_synthesis_sweep(
            aug_config(mode="eval"), device, "6-camera aug sweep",
            launches(K1=1, K3=2), tmp / "sweep")
        paths["6-camera aug evaluation sweep"] = dict(launches=counts,
                                                      ms=[view_ms])
        run_clis(tmp)
        run_clis(tmp, aug=True)

        # the fsm (Monodepth2) baseline at full width: a request runs no
        # kernel (no voxel volume), a step K5 4 times (render_views)
        for mp, tag, k5 in ((False, "", "K5"), (True, " bf16", "K5-bf16")):
            cfg_fsm = fsm_config(mixed_precision=mp)
            label = f"6-camera fsm{tag}"
            tols = dict(tols=(BF16_FWD_RTOL, BF16_POSE_ATOL)) if mp else {}
            serve(cfg_fsm, label, "even", launches(), **tols)
            step_tols = (dict(tols=(BF16_STEP_LOSS_RTOL, BF16_STEP_GRAD_RTOL))
                         if mp else {})
            train(fsm_config(mixed_precision=mp), label, "even",
                  launches(**{k5: 4}), k5_calls=k5_calls, **step_tols)
            check_k5_calls(k5, rows[k5], k5_calls, "fsm")
            del k5_calls[:]
            learn, evaluated, loop_ms, eval_ms = run_fsm_learn_evaluate(
                fsm_config(mixed_precision=mp), device, f"{label} trainer",
                launches(**{k5: 4}), launches(**{k5: 4}),
                tmp / f"fsm{mp}")
            paths[f"{label} trainer"] = dict(launches=learn, ms=[loop_ms])
            paths[f"{label} evaluation"] = dict(launches=evaluated,
                                                ms=eval_ms)
            torch.cuda.empty_cache()

        # the host pipeline at DDAD's native size, then the readers
        from vfdepth_tpu_torch.training import (VFDepthModel,
                                                create_train_state)
        fsm_model = VFDepthModel(fsm_config(), device=device, seed=0)
        run_host_pipeline(device, fsm_model, create_train_state(fsm_model),
                          paths)
        del fsm_model
        torch.cuda.empty_cache()
        try:
            import PIL  # noqa: F401  (the readers decode with it)
            have_pil = True
        except ImportError:
            have_pil = False
            print("readers: PIL is not installed on this machine; the "
                  "DDAD / nuScenes readers cannot decode images, so only "
                  "the host pipeline above ran", flush=True)
        if have_pil:
            run_readers(device, tmp, paths)
    for key, row in rows.items():
        by_path = {p: v["launches"][key] for p, v in paths.items()}
        check(sum(by_path.values()) > 0, f"{key} launched on no path")
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    print(json.dumps({"kernels": [rows[k] for k in sorted(rows)],
                      "device": kind, "power": smi,
                      "paths": {p: v["ms"] for p, v in paths.items()},
                      "batch": cfg.batch_size}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
