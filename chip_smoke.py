#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``vfdepth_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (the kernels build from ``csrc/`` here, at
first use); exits non-zero, printing no result, without them or outside a
checkout of the repository. Imports nothing of JAX or ``vfdepth_tpu``.

Phases (any failure exits non-zero):
 1. device: the card's name and power limit;
 2. build: both CUDA kernels, with nvcc's register report;
 3. K1 (grouped raw back-projection) against its plain PyTorch version at
    the production shapes, plus points behind the camera, out of the image,
    non-finite, and N not a multiple of the kernel's tile;
 4. K3 (trilinear frustum sampler) against its plain version on the real
    frustum coordinates plus out-of-range and non-finite ones;
 5. timing with CUDA events (warm-up, then the median of 20 runs) of each
    kernel, its plain version and, for K3, ``F.grid_sample`` (a yardstick
    the port never calls), beside the bound: bytes over 3.35 TB/s or f32
    operations over 67 TFLOP/s, whichever is larger;
 6. main path: ``configs/ddad/ddad_surround_fusion.yaml`` at full width with
    seeded random weights answers 3 requests (one 6-camera frameset with its
    -1/+1 context frames each) through ``VFDepthModel.predict``; checks
    shapes, finiteness, the metric depth range, one launch of each kernel
    per request, and request 1 against the same model run with the plain
    versions; then one more request under ``torch.profiler`` (device time
    by kernel, device busy share).
TF32 is off for every phase (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32``): the model is an f32 model, and
the comparisons must see only the kernels' differences.

Output: progress lines, then a ``{"kernels": [...]}`` JSON line, the
``nvidia-smi`` name/power line, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
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
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
K1_TOL = 1e-4                  # x max|feat|: fma contraction, sums in order
K3_TOL = 1e-5                  # x max|vol|: 8-term dot, fma contraction
FWD_RTOL = 1e-4                # whole forward, kernels vs plain, x max|out|
POSE_ATOL = 1e-5


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


def k1_inputs(cfg, device, gen, special: bool):
    """Main-path K1 inputs: merged pose+depth features [6, 48, 80, 768], a
    random 0/1 low-res mask with holes, and the fake rig's voxel points
    through the port's ``_project_cam_points`` (cameras group-major).
    ``special`` appends points that are behind the camera, out of the image,
    non-finite or at near-zero depth (N is then not a multiple of the
    kernel's 32-point tile)."""
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
    feats = torch.randn(cams, h, w, c, generator=gen).to(device)
    mask = (torch.rand(cams, h, w, generator=gen) > 0.15).float().to(device)
    mask[:, h // 3:h // 2, w // 4:w // 3] = 0.0   # a hole, as a car body
    return feats, mask, cam3.contiguous(), 1.0 / cfg.voxel_size[0], len(g1)


def k3_inputs(cfg, device, gen, special: bool):
    """Main-path K3 inputs: a [1, 100, 100, 20, 64] yxz volume and the fake
    rig's frustum coordinates (6 cams x 48x80 px x 50 bins) from the port's
    ``VFNet.frustum_coords``; ``special`` appends out-of-range and
    non-finite coordinates."""
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
    vol = torch.randn(1, vy, vx, vz, cfg.voxel_pre_dim[-1],
                      generator=gen).to(device)
    return vol, coords.contiguous()


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


def time_kernels(cfg, device, gen, errs):
    from vfdepth_tpu_torch.ops.backproject_sample import (
        backproject_grouped_raw, backproject_grouped_raw_plain)
    from vfdepth_tpu_torch.ops.sample3d import (sample3d_trilinear,
                                                sample3d_trilinear_plain)
    rows = []
    feats, mask, cam3, rel_scale, gs = k1_inputs(cfg, device, gen, False)
    out, valid = backproject_grouped_raw(feats, mask, cam3, rel_scale, 1, gs)
    live_pairs = valid.sum().item()
    k1_bytes = nbytes(feats, mask, cam3, out, valid)
    k1_flops = live_pairs * feats.shape[-1] * 4 * 2
    b_ms, b_by = bound(k1_bytes, k1_flops)
    rows.append(dict(
        name="backproject_grouped_raw", route="cuda",
        source="vfdepth_tpu_torch/csrc/backproject_sample.cu",
        replaces="vfdepth_tpu/ops/pallas_sample.py:176",
        max_abs_err=errs[0],
        ms=time_ms(lambda: backproject_grouped_raw(feats, mask, cam3,
                                                   rel_scale, 1, gs)),
        plain_ms=time_ms(lambda: backproject_grouped_raw_plain(
            feats, mask, cam3, rel_scale, 1, gs), reps=10),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shapes=dict(feats=list(feats.shape), cam3=list(cam3.shape),
                    out=list(out.shape)), bytes=k1_bytes, flops=k1_flops))
    del feats, mask, cam3, out, valid

    vol, coords = k3_inputs(cfg, device, gen, False)
    out = sample3d_trilinear(vol, coords)
    k3_bytes = nbytes(vol, coords, out)
    k3_flops = coords.shape[1] * vol.shape[-1] * 8 * 2
    b_ms, b_by = bound(k3_bytes, k3_flops)
    # yardstick: F.grid_sample 5-D, align_corners=True, zeros padding, on
    # the volume permuted to [B, C, Z, Y, X] (the permute is not timed)
    vol_czyx = vol.permute(0, 4, 3, 1, 2).contiguous()
    grid = coords.reshape(1, 1, 1, -1, 3)

    def library():
        return F.grid_sample(vol_czyx, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)
    lib_err = (library()[0, :, 0, 0].t() - out).abs().max().item()
    print(f"K3 vs F.grid_sample on the frustum coords: max_abs_diff="
          f"{lib_err:.3e}", flush=True)
    rows.append(dict(
        name="sample3d_trilinear", route="cuda",
        source="vfdepth_tpu_torch/csrc/sample3d.cu",
        replaces="vfdepth_tpu/ops/sample3d_packed.py:101",
        max_abs_err=errs[1],
        ms=time_ms(lambda: sample3d_trilinear(vol, coords)),
        plain_ms=time_ms(lambda: sample3d_trilinear_plain(vol, coords),
                         reps=10),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(library),
        shapes=dict(vol=list(vol.shape), coords=list(coords.shape),
                    out=list(out.shape)), bytes=k3_bytes, flops=k3_flops))
    for r in rows:
        print(f"{r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    return rows


def run_main_path(cfg, device):
    """3 full-width requests through ``VFDepthModel.predict``; returns
    (launches per kernel over the 3 requests, per-request ms)."""
    from vfdepth_tpu_torch.data import FakeDataset
    from vfdepth_tpu_torch.ops.backproject_sample import backproject_grouped_raw
    from vfdepth_tpu_torch.ops.sample3d import sample3d_trilinear
    from vfdepth_tpu_torch.training.model import VFDepthModel

    counters = (backproject_grouped_raw, sample3d_trilinear)
    t0 = time.perf_counter()
    model = VFDepthModel(cfg, device=device, seed=0)
    ds = FakeDataset(num_samples=N_REQUESTS, num_cams=cfg.num_cams,
                     height=cfg.height, width=cfg.width,
                     frame_ids=tuple(cfg.frame_ids),
                     fusion_level=cfg.fusion_level)
    requests = [ds.batch([i]) for i in range(N_REQUESTS)]
    model.predict(requests[0])                  # warm-up (not counted)
    torch.cuda.synchronize()
    print(f"main path set-up (model, data, warm-up): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    for fn in counters:
        fn.launches = 0
    outputs, ms = [], []
    for i, req in enumerate(requests):
        before = [fn.launches for fn in counters]
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = model.predict(req)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        delta = [fn.launches - b for fn, b in zip(counters, before)]
        check(delta == [1, 1], f"request {i}: kernel launches {delta}, "
                               "expected one of each")
        outputs.append(out)
        print(f"request {i}: {ms[-1]:.2f} ms", flush=True)
    launches = [fn.launches for fn in counters]

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
    check([fn.launches for fn in counters] == launches,
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
    profile_request(model, requests[2])
    return launches, ms


def profile_request(model, request, top: int = 12):
    """One more request under ``torch.profiler``: device time by kernel
    (self time, summed over launches), and the device's busy time as the
    union of the device-side spans (kernels may overlap) against the
    request's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.predict(request)
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
    print(f"profile: wall {wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f}"
          f" ms (union of device spans, {100 * busy / wall_us:.1f}% of wall),"
          f" kernel time summed {summed / 1e3:.2f} ms over {len(rows)} device"
          f" ops", flush=True)
    for key, us, count in rows[:top]:
        print(f"  {us / 1e3:8.3f} ms {100 * us / summed:5.1f}%  x{count:<4d} "
              f"{key[:110]}", flush=True)


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
    for res in built.values():
        for line in res.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {res.name}: {line.strip()}", flush=True)

    cfg = get_config(str(CONFIG))
    gen = torch.Generator().manual_seed(0)
    errs = (check_k1(cfg, device, gen), check_k3(cfg, device, gen))
    rows = time_kernels(cfg, device, gen, errs)
    launches, ms = run_main_path(cfg, device)
    mean_ms = sum(ms) / len(ms)
    print(f"main path: {N_REQUESTS} requests, per-request ms "
          f"{[round(m, 3) for m in ms]}, {1e3 / mean_ms:.3f} framesets/s",
          flush=True)
    for row, n in zip(rows, launches):
        row["launches"] = n
        row["launches_per_request"] = n / N_REQUESTS
        row["kernel_ms"] = row["ms"]
    print(json.dumps({"kernels": rows, "device": kind, "power": smi,
                      "request_ms": ms}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
