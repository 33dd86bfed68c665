#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``vfdepth_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (the kernels build from ``csrc/`` here, at
first use); exits non-zero, printing no result, without them or outside a
checkout of the repository. Imports nothing of JAX or ``vfdepth_tpu``.

Phases (any failure exits non-zero):
 1. device: the card's name and power limit;
 2. build: the five CUDA kernels (one nvcc each, in parallel), with nvcc's
    register report;
 3. each kernel against its plain PyTorch version at the main paths'
    shapes, plus special inputs: K1 (grouped raw back-projection, serving
    shapes) and K2 (its backward, training shapes): points behind the
    camera, out of the image, non-finite, at near-zero depth, N not a
    multiple of the tile, cotangent rows that no camera may read set to
    NaN; K3 (trilinear frustum sampler) and K4 (its backward): the real
    frustum coordinates plus out-of-range and non-finite ones; K5 (image +
    mask warp): temporal-warp coordinates plus non-finite, huge finite and
    border ones, and its autograd coordinate gradient;
 4. timing with CUDA events (warm-up, then the median of 20 runs) of each
    kernel, its plain version and a PyTorch yardstick the port never calls
    (K3: 5-D ``F.grid_sample``; K4: the autograd backward of 5-D
    ``F.grid_sample`` with respect to its input; K5: 2-D ``F.grid_sample``
    on the RGB), beside the bound: bytes over 3.35 TB/s or f32 operations
    over 67 TFLOP/s, whichever is larger, counted from this run's inputs;
 5. serving path: ``configs/ddad/ddad_surround_fusion.yaml`` at full width
    with seeded random weights answers 3 requests (one 6-camera frameset
    with its -1/+1 context frames each) through ``VFDepthModel.predict``;
    checks shapes, finiteness, the metric depth range, one launch of K1 and
    K3 per request, and request 1 against the same model run with the plain
    versions; then one more request under ``torch.profiler``;
 6. training path: the same config at full width, batch 2 (the config's),
    seeded weights, ``FakeDataset``: one warm-up step, then 3 timed steps
    through ``train_step`` (forward, loss, backward, Adam); checks a finite
    loss, finite gradients non-zero in both nets, moved parameters and
    BatchNorm statistics, and launches per step K1 1, K2 1, K3 1, K4 1,
    K5 4; step 1 again from the same state with the plain versions (loss
    and every gradient within stated tolerances); one more step under
    ``torch.profiler``.
TF32 is off for every phase (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32``): the model is an f32 model, and
the comparisons must see only the kernels' differences.

Output: progress lines, then a ``{"kernels": [...]}`` JSON line, the
``nvidia-smi`` name/power line, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "ddad" / "ddad_surround_fusion.yaml"
N_REQUESTS = 3
N_STEPS = 3
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
K1_TOL = 1e-4                  # x max|feat|: fma contraction, sums in order
K3_TOL = 1e-5                  # x max|vol|: 8-term dot, fma contraction
# the backward kernels add with atomics in a varying order: an f32 sum of
# n terms in another order differs by up to ~n * 2^-24 of its largest
# partial sum; n is ~34 (K2) and ~46 (K4) on average, a few hundred at most
K2_TOL = 2e-5                  # x max|dfeat|
K4_TOL = 2e-5                  # x max|dvol|
K5_TOL = 1e-6                  # absolute: 4-tap sums of [0, 1] inputs, fma
K5_GRAD_TOL = 1e-5             # x max|dcoords|: the same dot of ddx / ddy
FWD_RTOL = 1e-4                # whole forward, kernels vs plain, x max|out|
POSE_ATOL = 1e-5
# training step 1, kernels vs plain versions, from the same state and batch:
# the forward differs by fma contraction (~1e-7 relative), the backward by
# the atomics' order. The auto-mask is a discrete comparison of two
# photometric losses, which SSIM makes sensitive to ~1e-6 input changes; at
# a random init the pose is ~0, every temporal warp is near the identity
# and the two losses tie to within the 1e-5 tie-break noise, so tens of the
# 2.9M pixels flip between two f32 evaluations. Each flip moves the masked
# mean by ~1e-5 of the loss and a gradient (a sum over pixels that largely
# cancels for the pose net) by up to ~1% in relative L2 norm
# (tests/test_torch_train_step.py measures the same effect against JAX)
STEP_LOSS_RTOL = 1e-3
STEP_GRAD_RTOL = 3e-2          # relative L2 norm, per parameter


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
    behind the camera, out of the image, non-finite or at near-zero depth
    (N is then not a multiple of the kernel's 32-point tile)."""
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
        cam3 = torch.cat([cam3, extra], dim=1)
    cam3 = cam3.repeat(batch, 1, 1)
    cams = cam3.shape[0]
    feats = torch.randn(cams, h, w, c, generator=gen).to(device)
    mask = (torch.rand(cams, h, w, generator=gen) > 0.15).float().to(device)
    mask[:, h // 3:h // 2, w // 4:w // 3] = 0.0   # a hole, as a car body
    return feats, mask, cam3.contiguous(), 1.0 / cfg.voxel_size[0], len(g1)


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
        backproject_grouped_raw, backproject_grouped_raw_plain)
    feats, mask, cam3, rel_scale, gs = k1_inputs(cfg, device, gen, True)
    out, valid = backproject_grouped_raw(feats, mask, cam3, rel_scale, 1, gs)
    ref, ref_valid = backproject_grouped_raw_plain(feats, mask, cam3,
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
    from vfdepth_tpu_torch.ops.backproject_sample import backproject_grouped_raw
    b = cfg.batch_size
    feats, mask, cam3, rel_scale, gs = k1_inputs(cfg, device, gen, special,
                                                 batch=b)
    _, valid = backproject_grouped_raw(feats, mask, cam3, rel_scale, b, gs)
    n, c = cam3.shape[1], feats.shape[-1]
    g = torch.randn(b, 2, n, c + 2, generator=gen).to(device)
    seen = valid.reshape(b, 2, gs, n).amax(dim=2) > 0
    g = torch.where(seen[..., None], g, float("nan"))
    return g, cam3, valid, feats.shape[1], feats.shape[2], c, gs, seen


def check_k2(cfg, device, gen):
    from vfdepth_tpu_torch.ops.backproject_sample import (
        backproject_grouped_raw_bwd, backproject_grouped_raw_bwd_plain)
    g, cam3, valid, h, w, c, gs, _ = k2_inputs(cfg, device, gen, True)
    out = backproject_grouped_raw_bwd(g, cam3, valid, h, w, c, gs)
    ref = backproject_grouped_raw_bwd_plain(g, cam3, valid, h, w, c, gs)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "K2 output not finite")
    err = (out - ref).abs().max().item()
    tol = K2_TOL * ref.abs().max().item()
    print(f"K2 check: g {list(g.shape)} max_abs_err={err:.3e} (tol "
          f"{tol:.3e})", flush=True)
    check(err <= tol, f"K2 differs from its plain version: {err} > {tol}")
    return err


def check_k4(cfg, device, gen):
    from vfdepth_tpu_torch.ops.sample3d import (sample3d_trilinear_bwd,
                                                sample3d_trilinear_bwd_plain)
    vol, coords = k3_inputs(cfg, device, gen, True, batch=cfg.batch_size)
    g = torch.randn(vol.shape[0], coords.shape[1], vol.shape[-1],
                    generator=gen).to(device)
    out = sample3d_trilinear_bwd(g, coords, vol.shape)
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


def _row(name, source, replaces, err, ms, plain_ms, bytes_, flops,
         library_ms, shapes):
    b_ms, b_by = bound(bytes_, flops)
    return dict(name=name, route="cuda",
                source=f"vfdepth_tpu_torch/csrc/{source}",
                replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                shapes={k: list(v) for k, v in shapes.items()}, bytes=bytes_,
                flops=flops)


def time_kernels(cfg, device, gen, errs):
    """Each kernel, its plain version and its yardstick at the main paths'
    shapes: K1 and K3 at the serving path's (batch 1), K2, K4 and K5 at the
    training path's (batch 2; K5 one call, the 24 temporal warps)."""
    from vfdepth_tpu_torch.ops.backproject_sample import (
        backproject_grouped_raw, backproject_grouped_raw_bwd,
        backproject_grouped_raw_bwd_plain, backproject_grouped_raw_plain)
    from vfdepth_tpu_torch.ops.sample3d import (
        sample3d_trilinear, sample3d_trilinear_bwd,
        sample3d_trilinear_bwd_plain, sample3d_trilinear_plain)
    from vfdepth_tpu_torch.ops.warp import (warp_image_mask_maps,
                                            warp_image_mask_maps_plain)
    rows = {}
    feats, mask, cam3, rel_scale, gs = k1_inputs(cfg, device, gen, False)
    out, valid = backproject_grouped_raw(feats, mask, cam3, rel_scale, 1, gs)
    live_pairs = valid.sum().item()
    rows["K1"] = _row(
        "backproject_grouped_raw", "backproject_sample.cu",
        "vfdepth_tpu/ops/pallas_sample.py:176", errs["K1"],
        time_ms(lambda: backproject_grouped_raw(feats, mask, cam3, rel_scale,
                                                1, gs)),
        time_ms(lambda: backproject_grouped_raw_plain(
            feats, mask, cam3, rel_scale, 1, gs), reps=10),
        nbytes(feats, mask, cam3, out, valid),
        live_pairs * feats.shape[-1] * 4 * 2, None,
        dict(feats=feats.shape, cam3=cam3.shape, out=out.shape))
    del feats, mask, cam3, out, valid

    # K2: the bytes a run must move are the cotangent rows of the points
    # some camera of their group sees (the others are never read), cam3,
    # valid and the feature gradient
    g, cam3, valid, h, w, c, gs, seen = k2_inputs(cfg, device, gen, False)
    dfeat = backproject_grouped_raw_bwd(g, cam3, valid, h, w, c, gs)
    k2_bytes = (int(seen.sum().item()) * c * 4
                + nbytes(cam3, valid, dfeat))
    rows["K2"] = _row(
        "backproject_grouped_raw_bwd", "backproject_sample_bwd.cu",
        "vfdepth_tpu/ops/pallas_sample.py:301", errs["K2"],
        time_ms(lambda: backproject_grouped_raw_bwd(g, cam3, valid, h, w, c,
                                                    gs)),
        time_ms(lambda: backproject_grouped_raw_bwd_plain(
            g, cam3, valid, h, w, c, gs), reps=5),
        k2_bytes, valid.sum().item() * c * 4 * 2, None,
        dict(g=g.shape, cam3=cam3.shape, valid=valid.shape,
             dfeat=dfeat.shape))
    del g, cam3, valid, dfeat, seen
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
    for key, r in rows.items():
        print(f"{key} {r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    return rows


def kernel_counters():
    """The launch-counting wrapper of each kernel, by row key."""
    from vfdepth_tpu_torch.ops.backproject_sample import (
        backproject_grouped_raw, backproject_grouped_raw_bwd)
    from vfdepth_tpu_torch.ops.sample3d import (sample3d_trilinear,
                                                sample3d_trilinear_bwd)
    from vfdepth_tpu_torch.ops.warp import warp_image_mask_maps
    return {"K1": backproject_grouped_raw, "K2": backproject_grouped_raw_bwd,
            "K3": sample3d_trilinear, "K4": sample3d_trilinear_bwd,
            "K5": warp_image_mask_maps}


def reset_counts():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in kernel_counters().items()}


def run_serving_path(cfg, device):
    """3 full-width requests through ``VFDepthModel.predict``; returns
    (launches per kernel over the 3 requests, per-request ms)."""
    from vfdepth_tpu_torch.data import FakeDataset
    from vfdepth_tpu_torch.training.model import VFDepthModel

    per_request = {"K1": 1, "K2": 0, "K3": 1, "K4": 0, "K5": 0}
    t0 = time.perf_counter()
    model = VFDepthModel(cfg, device=device, seed=0)
    ds = FakeDataset(num_samples=N_REQUESTS, num_cams=cfg.num_cams,
                     height=cfg.height, width=cfg.width,
                     frame_ids=tuple(cfg.frame_ids),
                     fusion_level=cfg.fusion_level)
    requests = [ds.batch([i]) for i in range(N_REQUESTS)]
    model.predict(requests[0])                  # warm-up (not counted)
    torch.cuda.synchronize()
    print(f"serving path set-up (model, data, warm-up): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    reset_counts()
    outputs, ms = [], []
    for i, req in enumerate(requests):
        before = read_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = model.predict(req)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        delta = {k: n - before[k] for k, n in read_counts().items()}
        check(delta == per_request, f"request {i}: kernel launches {delta}, "
                                    f"expected {per_request}")
        outputs.append(out)
        print(f"request {i}: {ms[-1]:.2f} ms", flush=True)
    launches = read_counts()

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
        for s in cfg.scales:
            disp, depth = out[f"disp/{s}"], out[f"depth/{s}"]
            check(tuple(depth.shape) == (b, cams, h, w, 1),
                  f"depth shape {tuple(depth.shape)}")
            check(bool(torch.isfinite(depth).all()), "depth not finite")
            check(bool(((disp >= 0) & (disp <= 1)).all()), "disp not in [0,1]")
            check(bool(((depth >= lo * (1 - 1e-5))
                        & (depth <= hi * (1 + 1e-5))).all()),
                  "depth outside the metric range")
        print(f"request {i}: depth/0 in [{outputs[i]['depth/0'].min().item():.3f},"
              f" {outputs[i]['depth/0'].max().item():.3f}] m; |t| max "
              f"{cam[..., :3, 3].abs().max().item():.4f}", flush=True)

    # request 1 again with the plain versions of the kernels (same weights)
    model.plain_samplers = True
    ref = model.predict(requests[1])
    torch.cuda.synchronize()
    model.plain_samplers = False
    check(read_counts() == launches,
          "the plain reference run launched a kernel")
    for key, val in outputs[1].items():
        diff = (val - ref[key]).abs().max().item()
        if key == "cam_T_cam":
            tol = POSE_ATOL
        else:
            tol = FWD_RTOL * ref[key].abs().max().item()
        print(f"request 1 kernels vs plain: {key} max_abs_diff={diff:.3e} "
              f"(tol {tol:.3e})", flush=True)
        check(diff <= tol, f"{key}: kernels and plain versions disagree")
    profile("request", lambda: model.predict(requests[2]))
    return launches, ms


def _grads(model):
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def run_training_path(cfg, device):
    """Full-width training steps at the config's batch through
    ``train_step``; returns (launches per kernel over the timed steps,
    per-step ms)."""
    from vfdepth_tpu_torch.data import FakeDataset
    from vfdepth_tpu_torch.training import (VFDepthModel, create_train_state,
                                            train_step)

    per_step = {"K1": 1, "K2": 1, "K3": 1, "K4": 1, "K5": 4}
    b = cfg.batch_size
    t0 = time.perf_counter()
    model = VFDepthModel(cfg, device=device, seed=0)
    opt = create_train_state(model)
    ds = FakeDataset(num_samples=b * (N_STEPS + 1), num_cams=cfg.num_cams,
                     height=cfg.height, width=cfg.width,
                     frame_ids=tuple(cfg.frame_ids),
                     fusion_level=cfg.fusion_level)
    batches = [ds.batch(list(range(i * b, (i + 1) * b)))
               for i in range(N_STEPS + 1)]

    def noise_gen(step):      # the same tie-break noise for a repeated step
        return torch.Generator(device).manual_seed(1000 + step)

    logs0 = train_step(model, opt, batches[0], 0, noise_gen(0))   # warm-up
    torch.cuda.synchronize()
    print(f"training path set-up (model, data, warm-up step): "
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
        check(delta == per_step, f"step {step}: kernel launches {delta}, "
                                 f"expected {per_step}")
        losses.append(logs["total_loss"].item())
        if step == 1:
            grads1, logs1 = _grads(model), logs
        print(f"step {step}: {ms[-1]:.2f} ms, loss {losses[-1]:.6f}, "
              f"reproj {logs['reproj_loss'].item():.6f}, spatio "
              f"{logs['spatio_loss'].item():.6f}, spatio-temporal "
              f"{logs['spatio_tempo_loss'].item():.6f}, auto-mask cover "
              f"{logs['amask_cover'].item():.4f}", flush=True)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"training path: peak device memory {peak:.2f} GiB", flush=True)

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
    print(f"training path: {len(moved)} of {len(tracked)} parameters and "
          f"BatchNorm statistics moved", flush=True)

    # step 1 again from the same state and batch, plain versions
    model.load_state_dict(params0)
    opt.load_state_dict(opt0)
    model.plain_samplers = True
    logs_p = train_step(model, opt, batches[1], 1, noise_gen(1))
    torch.cuda.synchronize()
    model.plain_samplers = False
    check(read_counts() == launches, "the plain reference step launched a "
                                     "kernel")
    lk, lp = logs1["total_loss"].item(), logs_p["total_loss"].item()
    n_pix = b * cfg.num_cams * cfg.height * cfg.width
    flips = abs(logs1["amask_cover"].item()
                - logs_p["amask_cover"].item()) * n_pix
    print(f"step 1 kernels vs plain: auto-mask cover differs by {flips:.0f}"
          f" of {n_pix} pixels (net flips)", flush=True)
    check(abs(lk - lp) <= STEP_LOSS_RTOL * abs(lp),
          f"step 1 loss: kernels {lk} vs plain {lp}")
    worst, worst_name = 0.0, ""
    for name, p in model.named_parameters():
        ref = p.grad
        rel = ((grads1[name] - ref).norm() / ref.norm().clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, name
    print(f"step 1 kernels vs plain: loss {lk:.7f} vs {lp:.7f} (rel "
          f"{abs(lk - lp) / abs(lp):.2e}, tol {STEP_LOSS_RTOL:.0e}); worst "
          f"gradient relative L2 difference {worst:.2e} ({worst_name}; tol "
          f"{STEP_GRAD_RTOL:.0e})", flush=True)
    check(worst <= STEP_GRAD_RTOL, f"step 1 gradients: {worst_name} differs "
                                   f"by {worst} (relative L2)")
    del grads1, params0, opt0, logs_p
    opt.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    profile("training step", lambda: train_step(
        model, opt, batches[0], N_STEPS + 1, noise_gen(N_STEPS + 1)))
    return launches, ms


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
            if any(n in k for n in ("backproject_grouped_raw", "sample3d_",
                                    "warp_image_mask"))}
    for key, (us, count) in sorted(ours.items()):
        print(f"  port kernel {key[:80]}: {us / 1e3:.3f} ms x{count}",
              flush=True)


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
    gen = torch.Generator().manual_seed(0)
    errs = {"K1": check_k1(cfg, device, gen), "K3": check_k3(cfg, device, gen),
            "K2": check_k2(cfg, device, gen), "K4": check_k4(cfg, device, gen),
            "K5": check_k5(cfg, device, gen)}
    torch.cuda.empty_cache()
    rows = time_kernels(cfg, device, gen, errs)

    serving, req_ms = run_serving_path(cfg, device)
    print(f"serving path: {N_REQUESTS} requests, per-request ms "
          f"{[round(m, 3) for m in req_ms]}, "
          f"{1e3 * N_REQUESTS / sum(req_ms):.3f} framesets/s", flush=True)
    torch.cuda.empty_cache()
    training, step_ms = run_training_path(cfg, device)
    print(f"training path: {N_STEPS} steps at batch {cfg.batch_size}, "
          f"per-step ms {[round(m, 3) for m in step_ms]}, "
          f"{1e3 * N_STEPS * cfg.batch_size / sum(step_ms):.3f} framesets/s "
          f"trained", flush=True)
    for key, row in rows.items():
        row["launches"] = training[key]
        row["launches_per_step"] = training[key] / N_STEPS
        row["launches_serving"] = serving[key]
        row["launches_per_request"] = serving[key] / N_REQUESTS
    print(json.dumps({"kernels": [rows[k] for k in sorted(rows)],
                      "device": kind, "power": smi, "request_ms": req_ms,
                      "step_ms": step_ms, "batch": cfg.batch_size}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
