"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest configures JAX). Every test skips
where there is no CUDA device. Tolerances, relative to the largest input
magnitude: K1 1e-4 (bilinear taps and a group sum of up to 8 cameras,
fma-contracted in the kernel; K1b and the normalised K1 the same), K3
1e-5 (an 8-term weighted sum); validity and nearest mask values are exact.
The backward kernels sum each output in their plan's order, which is not
the plain versions' (tap planes, or one ``index_add_`` per tap): K2, K2b
1e-4 and K4 1e-5 of the largest output magnitude times the square root of
the mean additions one address receives (a rounding error per addition,
random in sign). Their plans equal the plain plans exactly, two launches
give the same bits, and the bf16-update K4 equals its model in plan order
(``tests/helpers_torch_plan.py``) bit for bit. K5: 1e-6 (a 4-tap weighted sum of inputs in
[0, 1], fma-contracted), masks exact, its coordinate gradient 1e-5 of its
largest entry.

The bf16 forms (K1, K1b, K2, K2b, K3, K5 with bf16 tensors; K4 with a
bf16 cotangent, in its f32-update and its bf16-update form) compute in f32
as their plain versions do and round each output once, so an f32
difference of a few ulp can move an output by one bf16 step: 2^-7 of the
largest output magnitude (the f32 forms' bound added for K2, K2b and the
f32-update K4), counts, validity, masks and K1b's last column exact. K1b's
bf16 rows of C+1 values are odd for an even C, so every other row starts
on a 2-byte boundary; the cases cover odd and even C and a feature map
whose base is 2-byte aligned only (scalar reads). K4's bf16-update form rounds every addition to bf16,
where its plain version's ``index_add_`` accumulates in f32: at
coordinates whose base voxels are distinct (one addition per plane entry)
the two agree bit for bit. With collisions each bf16 addition rounds: a
running bf16 sum of k random-sign terms drifts by about 2^-9 * sqrt(k / 3)
of its size, 0.05 for the ~2000 additions the crowded points here give one
plane entry (the JAX package's sequential bf16 scatter: 0.039 against f32).
The bound is a cosine above 0.995 and a relative L2 difference below 0.1,
against the plain version and against the f32-update form.

The gather-bf16 forms (``sampler_3d: gather`` under mixed precision:
``sample3d_gather`` and ``sample3d_gather_bwd``) compute in their plain
versions' literal bf16 arithmetic and order: equal bit for bit, their
plans element for element, two launches the same bits, a hot voxel (3000
points on one 2 x 2 x 2 block) included.

Two checks of the data path on the card close the file, exact both:
``device_prefetch`` against the pageable route, and a checkpoint moved
between the card and the CPU.
"""
import numpy as np
import pytest
import torch

from helpers_torch_plan import (gather_bwd_in_plan_order,
                                k2_in_plan_order, k4_in_plan_order)
from vfdepth_tpu_torch.ops.backproject_sample import (
    backproject_bwd_plan, backproject_bwd_plan_plain,
    backproject_grouped, backproject_grouped_bwd,
    backproject_grouped_bwd_plain, backproject_grouped_plain, sample2d,
    sample2d_bwd, sample2d_bwd_plain, sample2d_plain)
from vfdepth_tpu_torch.ops.sample3d import (sample3d_bwd_plan,
                                            sample3d_bwd_plan_plain,
                                            sample3d_trilinear,
                                            sample3d_trilinear_bwd,
                                            sample3d_trilinear_bwd_bf16,
                                            sample3d_trilinear_bwd_bf16_plain,
                                            sample3d_trilinear_bwd_plain,
                                            sample3d_trilinear_plain)
from vfdepth_tpu_torch.ops import sample3d as s3
from vfdepth_tpu_torch.ops.warp import (warp_image_mask, warp_image_mask_maps,
                                        warp_image_mask_maps_plain)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels run only there")


def _raw_inputs(seed, b, gs, h=16, w=24, c=8, n=5003):
    rng = np.random.RandomState(seed)
    cams = b * 2 * gs
    feats = rng.randn(cams, h, w, c).astype(np.float32)
    mask = (rng.rand(cams, h, w) > 0.3).astype(np.float32)
    z = rng.uniform(-2.0, 10.0, (cams, n)).astype(np.float32)
    px = rng.uniform(-6, w + 6, (cams, n)).astype(np.float32)
    py = rng.uniform(-6, h + 6, (cams, n)).astype(np.float32)
    cam3 = np.stack([px * z, py * z, z], axis=-1)
    cam3[:, 30:35, 0] = np.nan
    cam3[:, 35:40, 1] = np.inf
    cam3[:, 40:42, 2] = np.nan
    return [torch.from_numpy(a).cuda() for a in (feats, mask, cam3)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,gs,c", [(1, 3, 8), (2, 1, 5), (1, 8, 768),
                                    (1, 2, 770)])   # float4 and scalar paths
def test_backproject_kernel_matches_plain(b, gs, c):
    _need_cuda()
    feats, mask, cam3 = _raw_inputs(b * 10 + gs, b, gs, c=c)
    before = backproject_grouped.launches
    out, valid = backproject_grouped(feats, mask, cam3, 0.25, b, gs)
    assert backproject_grouped.launches == before + 1
    ref, ref_valid = backproject_grouped_plain(feats, mask, cam3, 0.25,
                                                   b, gs)
    torch.cuda.synchronize()
    torch.testing.assert_close(valid, ref_valid, rtol=0, atol=0)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=1e-4 * feats.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 8, 64])   # scalar and float4 paths
def test_sample3d_kernel_matches_plain(c):
    _need_cuda()
    rng = np.random.RandomState(c)
    vol = rng.randn(2, 5, 6, 4, c).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (2, 4001, 3)).astype(np.float32)
    coords[:, :4] = [[-1, -1, -1], [1, 1, 1], [-1.002, 0, 0], [0, 1.002, 0]]
    coords[:, 10, 1] = np.nan
    coords[:, 11, 0] = np.inf
    coords[:, 12] = [40.0, -1e9, 3.0]
    vol, coords = torch.from_numpy(vol).cuda(), torch.from_numpy(coords).cuda()
    out = sample3d_trilinear(vol, coords)
    ref = sample3d_trilinear_plain(vol, coords)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=1e-5 * vol.abs().max().item())
    assert (out[:, 10:13] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b,gs,c", [(1, 3, 8), (2, 1, 5), (1, 8, 768),
                                    (1, 2, 770)])   # float4 and scalar paths
def test_backproject_bwd_kernel_matches_plain(b, gs, c):
    _need_cuda()
    feats, mask, cam3 = _raw_inputs(b * 10 + gs + 1, b, gs, c=c)
    _, valid = backproject_grouped(feats, mask, cam3, 0.25, b, gs)
    g = torch.randn(b, 2, cam3.shape[1], c + 2, device="cuda")
    g[..., :5, :] = float("nan")          # rows no camera may read
    g[..., :5, :] = torch.where(valid.reshape(b, 2, gs, -1)[..., :5].amax(
        2)[..., None] > 0, 1.0, g[..., :5, :])
    h, w = feats.shape[1:3]
    before = backproject_grouped_bwd.launches
    got = backproject_grouped_bwd(g, cam3, valid, h, w, c, gs)
    assert backproject_grouped_bwd.launches == before + 1
    ref = backproject_grouped_bwd_plain(g, cam3, valid, h, w, c, gs)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    hits = valid.sum().item() * 4 / (valid.shape[0] * h * w) + 1
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * hits ** 0.5
                               * ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 8, 64])   # scalar and float4 paths
def test_sample3d_bwd_kernel_matches_plain(c):
    _need_cuda()
    rng = np.random.RandomState(c + 1)
    coords = rng.uniform(-1.3, 1.3, (2, 4001, 3)).astype(np.float32)
    coords[:, :2000] = rng.uniform(-1.0, -0.8, (2, 2000, 3))   # crowded
    coords[:, 10, 1] = np.nan
    coords[:, 11, 0] = np.inf
    coords[:, 12] = [40.0, -1e9, 3.0]
    coords = torch.from_numpy(coords).cuda()
    g = torch.randn(2, 4001, c, device="cuda")
    shape = (2, 5, 6, 4, c)
    before = sample3d_trilinear_bwd.launches
    got = sample3d_trilinear_bwd(g, coords, shape)
    assert sample3d_trilinear_bwd.launches == before + 1
    ref = sample3d_trilinear_bwd_plain(g, coords, shape)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * (8 * 4001 / (
        5 * 6 * 4)) ** 0.5 * ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [24 * 40, 1001])
def test_warp_kernel_matches_plain(n):
    _need_cuda()
    rng = np.random.RandomState(n)
    img = torch.from_numpy(rng.rand(3, 24, 40, 3).astype(np.float32)).cuda()
    mask = torch.from_numpy(
        (rng.rand(3, 24, 40, 1) > 0.3).astype(np.float32)).cuda()
    coords = rng.uniform(-1.3, 1.3, (3, n, 2)).astype(np.float32)
    coords[:, :4, 0] = np.nan
    coords[:, 4:6, 1] = np.inf
    coords[:, 6:8] = [3e30, -3e30]
    coords[:, 8:10] = 1.0
    coords = torch.from_numpy(coords).cuda()
    before = warp_image_mask_maps.launches
    got = warp_image_mask_maps(img, mask, coords)
    assert warp_image_mask_maps.launches == before + 1
    ref = warp_image_mask_maps_plain(img, mask, coords)
    torch.cuda.synchronize()
    for name, a, r in zip(("img", "mask", "ddx", "ddy"), got, ref):
        assert torch.isfinite(a).all(), name
        tol = 0.0 if name == "mask" else 1e-6
        torch.testing.assert_close(a, r, rtol=0, atol=tol, msg=name)
    cot = torch.randn(3, n, 3, device="cuda")
    grads = []
    for plain in (False, True):
        c = coords.clone().requires_grad_()
        (warp_image_mask(img, mask, c, plain=plain)[0] * cot).sum().backward()
        grads.append(c.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=0,
                               atol=1e-5 * grads[1].abs().max().item())


def _cams(seed, c, b=3):
    """b cameras of features, masks and camera-plane points."""
    feats, mask, cam3 = _raw_inputs(seed, 2, 1, c=c)
    return feats[:b].contiguous(), mask[:b].contiguous(), cam3[:b].contiguous()


def _norm_coords(seed, b, n, ncols):
    """Normalised points over and past the image, with corners, exact
    nearest-pick ties, non-finite and huge coordinates, and (ncols 3) a rel
    column."""
    rng = np.random.RandomState(seed)
    coords = rng.uniform(-1.3, 1.3, (b, n, ncols)).astype(np.float32)
    coords[:, :4, :2] = [[-1, -1], [1, 1], [-1, 1], [1, -1]]
    coords[:, 4:8, :2] = (np.arange(4)[:, None] + 0.5) / 11.5 - 1.0  # ties
    coords[:, 10, 0] = np.nan
    coords[:, 11, 1] = np.inf
    coords[:, 12, :2] = [1e30, -3e9]
    return torch.from_numpy(coords).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("mode,raw,c", [
    ("bilinear", False, 8), ("bilinear", False, 5), ("mask", False, 768),
    ("mask", False, 6), ("backproject", False, 768),
    ("backproject", True, 768), ("backproject", True, 7)])
def test_sample2d_kernel_matches_plain(mode, raw, c):
    _need_cuda()
    b = 3
    feats, mask, cam3 = _cams(c + raw, c, b)
    coords = cam3 if raw else _norm_coords(
        c, b, cam3.shape[1], 3 if mode == "backproject" else 2)
    if not raw and mode == "backproject":
        coords[:, 100:200, :2] = -3.0        # caller-sanitised points
        coords[:, 100:150, 2] = float("nan")
    m = None if mode == "bilinear" else mask
    before = sample2d.launches
    out, valid = sample2d(feats, m, coords, mode, 0.25, raw)
    assert sample2d.launches == before + 1
    ref, ref_valid = sample2d_plain(feats, m, coords, mode, 0.25, raw)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    if valid is not None:
        torch.testing.assert_close(valid, ref_valid, rtol=0, atol=0)
        assert 0 < valid.sum() < valid.numel()
    if mode != "bilinear":
        torch.testing.assert_close(out[..., -1], ref[..., -1], rtol=0, atol=0)
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=1e-4 * feats.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("raw", [False, True])
def test_normalised_or_raw_grouped_kernel_matches_plain(raw):
    _need_cuda()
    feats, mask, cam3 = _raw_inputs(40 + raw, 1, 3, c=768)
    coords = cam3 if raw else _norm_coords(41, 6, cam3.shape[1], 3)
    out, valid = backproject_grouped(feats, mask, coords, 0.25, 1, 3, raw)
    ref, ref_valid = backproject_grouped_plain(feats, mask, coords, 0.25, 1,
                                               3, raw)
    torch.cuda.synchronize()
    torch.testing.assert_close(valid, ref_valid, rtol=0, atol=0)
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=1e-4 * feats.abs().max().item())
    g = torch.randn(1, 2, coords.shape[1], 770, device="cuda")
    got = backproject_grouped_bwd(g, coords, valid, 16, 24, 768, 3, raw)
    want = backproject_grouped_bwd_plain(g, coords, valid, 16, 24, 768, 3,
                                         raw)
    torch.cuda.synchronize()
    hits = valid.sum().item() * 4 / (valid.shape[0] * 16 * 24) + 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * hits ** 0.5
                               * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("gate,raw,c,ldg", [
    (True, True, 768, 769), (True, False, 768, 769), (False, False, 8, 8),
    (False, False, 8, 9), (True, True, 5, 6)])
def test_sample2d_bwd_kernel_matches_plain(gate, raw, c, ldg):
    _need_cuda()
    b = 3
    feats, mask, cam3 = _cams(60 + c, c, b)
    n = cam3.shape[1]
    coords = cam3 if raw else _norm_coords(c, b, n, 3)
    valid = None
    g = torch.randn(b, n, ldg, device="cuda")
    if gate:
        _, valid = sample2d(feats, mask, coords, "backproject", 0.25, raw)
        g = torch.where(valid[..., None] > 0, g, float("nan"))  # unread rows
    before = sample2d_bwd.launches
    got = sample2d_bwd(g, coords, valid, 16, 24, c, raw)
    assert sample2d_bwd.launches == before + 1
    ref = sample2d_bwd_plain(g, coords, valid, 16, 24, c, raw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    used = n if valid is None else valid.sum().item() / b
    hits = used * 4 / (16 * 24) + 1
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * hits ** 0.5
                               * ref.abs().max().item())


BF16_STEP = 2.0 ** -7     # one bf16 rounding step, relative to a magnitude


def _bf16(*tensors):
    return [t.to(torch.bfloat16) for t in tensors]


@pytest.mark.cuda
@pytest.mark.parametrize("b,gs,c", [(1, 3, 768), (2, 1, 5), (1, 2, 770)])
def test_backproject_bf16_kernels_match_plain(b, gs, c):
    _need_cuda()
    feats, mask, cam3 = _raw_inputs(b * 10 + gs + 2, b, gs, c=c)
    (fb,) = _bf16(feats)
    before = (backproject_grouped.launches, backproject_grouped.launches_bf16)
    out, valid = backproject_grouped(fb, mask, cam3, 0.25, b, gs)
    assert (backproject_grouped.launches,
            backproject_grouped.launches_bf16) == (before[0], before[1] + 1)
    ref, ref_valid = backproject_grouped_plain(fb, mask, cam3, 0.25, b, gs)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and valid.dtype == torch.float32
    torch.testing.assert_close(valid, ref_valid, rtol=0, atol=0)
    torch.testing.assert_close(out[..., -1], ref[..., -1], rtol=0, atol=0)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=BF16_STEP * ref.float().abs().max().item())

    g = torch.randn(b, 2, cam3.shape[1], c + 2, device="cuda")
    g[..., :5, :] = float("nan")          # rows no camera may read
    g[..., :5, :] = torch.where(valid.reshape(b, 2, gs, -1)[..., :5].amax(
        2)[..., None] > 0, 1.0, g[..., :5, :])
    (gb,) = _bf16(g)
    h, w = feats.shape[1:3]
    before = backproject_grouped_bwd.launches_bf16
    got = backproject_grouped_bwd(gb, cam3, valid, h, w, c, gs)
    assert backproject_grouped_bwd.launches_bf16 == before + 1
    want = backproject_grouped_bwd_plain(gb, cam3, valid, h, w, c, gs)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    hits = valid.sum().item() * 4 / (valid.shape[0] * h * w) + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=(
        BF16_STEP + 1e-4 * hits ** 0.5) * want.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 64])   # scalar and vector paths
def test_sample3d_bf16_kernel_matches_plain(c):
    _need_cuda()
    rng = np.random.RandomState(c + 7)
    vol = torch.from_numpy(rng.randn(2, 5, 6, 4, c).astype(np.float32))
    coords = rng.uniform(-1.3, 1.3, (2, 4001, 3)).astype(np.float32)
    coords[:, 10, 1] = np.nan
    coords[:, 12] = [40.0, -1e9, 3.0]
    vol = vol.cuda().to(torch.bfloat16)
    coords = torch.from_numpy(coords).cuda()
    before = sample3d_trilinear.launches_bf16
    out = sample3d_trilinear(vol, coords)
    assert sample3d_trilinear.launches_bf16 == before + 1
    ref = sample3d_trilinear_plain(vol, coords)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=BF16_STEP * vol.float().abs().max().item())
    assert (out[:, [10, 12]] == 0).all()


def _cosine_rel(a, b):
    a, b = a.double().ravel(), b.double().ravel()
    return ((a @ b) / (a.norm() * b.norm())).item(), \
        ((a - b).norm() / b.norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("c,g_bf16", [(64, True), (64, False), (3, True)])
def test_sample3d_bf16_update_kernel(c, g_bf16):
    _need_cuda()
    rng = np.random.RandomState(c + g_bf16)
    shape = (2, 5, 6, 4, c)
    g = torch.randn(2, 4001, c, device="cuda")
    g = g.to(torch.bfloat16) if g_bf16 else g
    # distinct base voxels: one addition per plane entry, so the bf16 sums
    # are single roundings and the kernel equals its plain version exactly
    n_vox = 4 * 5 * 3                    # bases lie in [0, size-2] per axis
    base = np.stack([rng.permutation(n_vox) for _ in range(2)])
    yb, xb, zb = base // 15, (base // 3) % 5, base % 3
    frac = rng.uniform(0.1, 0.9, (2, n_vox, 3))
    pix = np.stack([xb, yb, zb], axis=-1) + frac
    sizes = np.array([6, 5, 4])
    uniq = (pix / (0.5 * (sizes - 1)) - 1.0).astype(np.float32)
    uniq = torch.from_numpy(uniq).cuda()
    before = sample3d_trilinear_bwd_bf16.launches
    got = sample3d_trilinear_bwd_bf16(g[:, :n_vox].contiguous(), uniq, shape)
    assert sample3d_trilinear_bwd_bf16.launches == before + 1
    want = sample3d_trilinear_bwd_bf16_plain(g[:, :n_vox].contiguous(), uniq,
                                             shape)
    torch.cuda.synchronize()
    assert got.dtype == g.dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)

    # crowded points: ~2000 bf16 additions per plane entry, in any order
    coords = rng.uniform(-1.3, 1.3, (2, 4001, 3)).astype(np.float32)
    coords[:, :2000] = rng.uniform(-1.0, -0.8, (2, 2000, 3))
    coords[:, 10, 1] = np.nan
    coords[:, 12] = [40.0, -1e9, 3.0]
    coords = torch.from_numpy(coords).cuda()
    got = sample3d_trilinear_bwd_bf16(g, coords, shape)
    want = sample3d_trilinear_bwd_bf16_plain(g, coords, shape)
    f32 = sample3d_trilinear_bwd(g.float(), coords, shape)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    for ref in (want, f32):
        cos, rel = _cosine_rel(got, ref)
        assert cos > 0.995 and rel < 0.1, (cos, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [24 * 40, 1001])
def test_warp_bf16_kernel_matches_plain(n):
    _need_cuda()
    rng = np.random.RandomState(n + 1)
    img = torch.from_numpy(rng.rand(3, 24, 40, 3).astype(np.float32)).cuda()
    mask = torch.from_numpy(
        (rng.rand(3, 24, 40, 1) > 0.3).astype(np.float32)).cuda()
    img, mask = _bf16(img, mask)
    coords = rng.uniform(-1.3, 1.3, (3, n, 2)).astype(np.float32)
    coords[:, :4, 0] = np.nan
    coords[:, 6:8] = [3e30, -3e30]
    coords = torch.from_numpy(coords).cuda()
    before = warp_image_mask_maps.launches_bf16
    got = warp_image_mask_maps(img, mask, coords)
    assert warp_image_mask_maps.launches_bf16 == before + 1
    ref = warp_image_mask_maps_plain(img, mask, coords)
    torch.cuda.synchronize()
    for name, a, r in zip(("img", "mask", "ddx", "ddy"), got, ref):
        assert a.dtype == torch.bfloat16, name
        assert torch.isfinite(a.float()).all(), name
        tol = 0.0 if name == "mask" else BF16_STEP * r.float().abs().max()
        torch.testing.assert_close(a.float(), r.float(), rtol=0,
                                   atol=float(tol), msg=name)
    cot = torch.randn(3, n, 3, device="cuda").to(torch.bfloat16)
    grads = []
    for plain in (False, True):
        c = coords.clone().requires_grad_()
        warp_image_mask(img, mask, c, plain=plain)[0].backward(cot)
        grads.append(c.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=(
        BF16_STEP * grads[1].abs().max().item()))


def _misaligned(t):
    """A contiguous copy of t whose data starts one element past a 16-byte
    boundary (2-byte aligned for bf16)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mode,raw,c,shifted", [
    ("bilinear", False, 8, False), ("bilinear", False, 5, False),
    ("mask", False, 768, False), ("mask", False, 6, True),
    ("backproject", False, 768, False), ("backproject", False, 256, True),
    ("backproject", True, 768, False), ("backproject", True, 7, False),
    ("backproject", True, 512, True)])
def test_sample2d_bf16_kernel_matches_plain(mode, raw, c, shifted):
    _need_cuda()
    b = 3
    feats, mask, cam3 = _cams(c + raw + 90, c, b)
    (fb,) = _bf16(feats)
    if shifted:
        fb = _misaligned(fb)
    coords = cam3 if raw else _norm_coords(
        c + 1, b, cam3.shape[1], 3 if mode == "backproject" else 2)
    if not raw and mode == "backproject":
        coords[:, 100:200, :2] = -3.0        # caller-sanitised points
        coords[:, 100:150, 2] = float("nan")
    m = None if mode == "bilinear" else mask
    before = (sample2d.launches, sample2d.launches_bf16)
    out, valid = sample2d(fb, m, coords, mode, 0.25, raw)
    assert (sample2d.launches, sample2d.launches_bf16) == (before[0],
                                                           before[1] + 1)
    ref, ref_valid = sample2d_plain(fb, m, coords, mode, 0.25, raw)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()
    if valid is not None:
        assert valid.dtype == torch.float32
        torch.testing.assert_close(valid, ref_valid, rtol=0, atol=0)
        assert 0 < valid.sum() < valid.numel()
    if mode != "bilinear":
        torch.testing.assert_close(out[..., -1], ref[..., -1], rtol=0, atol=0)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=BF16_STEP * ref.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("gate,raw,c,ldg", [
    (True, True, 768, 769), (True, False, 512, 513), (True, True, 256, 257),
    (False, False, 8, 9), (False, False, 7, 7)])
def test_sample2d_bwd_bf16_kernel_matches_plain(gate, raw, c, ldg):
    _need_cuda()
    b = 3
    feats, mask, cam3 = _cams(c + 95, c, b)
    n = cam3.shape[1]
    coords = cam3 if raw else _norm_coords(c + 2, b, n, 3)
    valid = None
    g = torch.randn(b, n, ldg, device="cuda")
    if gate:
        _, valid = sample2d(feats, mask, coords, "backproject", 0.25, raw)
        g = torch.where(valid[..., None] > 0, g, float("nan"))  # unread rows
    (gb,) = _bf16(g)
    before = (sample2d_bwd.launches, sample2d_bwd.launches_bf16)
    got = sample2d_bwd(gb, coords, valid, 16, 24, c, raw)
    assert (sample2d_bwd.launches, sample2d_bwd.launches_bf16) == (
        before[0], before[1] + 1)
    ref = sample2d_bwd_plain(gb, coords, valid, 16, 24, c, raw)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    used = n if valid is None else valid.sum().item() / b
    hits = used * 4 / (16 * 24) + 1
    torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=(
        BF16_STEP + 1e-4 * hits ** 0.5) * ref.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 64])   # scalar and vector paths
def test_sample3d_f32_update_kernel_with_bf16_cotangent(c):
    _need_cuda()
    rng = np.random.RandomState(c + 11)
    coords = rng.uniform(-1.3, 1.3, (2, 4001, 3)).astype(np.float32)
    coords[:, :2000] = rng.uniform(-1.0, -0.8, (2, 2000, 3))   # crowded
    coords[:, 10, 1] = np.nan
    coords[:, 12] = [40.0, -1e9, 3.0]
    coords = torch.from_numpy(coords).cuda()
    gb = torch.randn(2, 4001, c, device="cuda").to(torch.bfloat16)
    shape = (2, 5, 6, 4, c)
    before = (sample3d_trilinear_bwd.launches,
              sample3d_trilinear_bwd.launches_bf16)
    got = sample3d_trilinear_bwd(gb, coords, shape)
    assert (sample3d_trilinear_bwd.launches,
            sample3d_trilinear_bwd.launches_bf16) == (before[0],
                                                      before[1] + 1)
    ref = sample3d_trilinear_bwd_plain(gb, coords, shape)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=(
        BF16_STEP + 1e-5 * (8 * 4001 / (5 * 6 * 4)) ** 0.5)
        * ref.float().abs().max().item())


# The seven redesigned backward forms: K4 (f32 updates; f32 updates of a
# bf16 cotangent; bf16 updates), K2, K2-bf16, K2b, K2b-bf16.
BACKWARD_FORMS = ["K4", "K4-f32upd-bf16", "K4-bf16", "K2", "K2-bf16", "K2b",
                  "K2b-bf16"]


def _hot_k4(seed, c=64):
    """3000 of 4001 points on one base voxel's neighbourhood (hundreds of
    additions per voxel; the tile's list is cut in chunks)."""
    rng = np.random.RandomState(seed)
    coords = rng.uniform(-1.3, 1.3, (2, 4001, 3)).astype(np.float32)
    coords[:, :3000] = rng.uniform(-1.0, -0.97, (2, 3000, 3))
    coords[:, 10, 1] = np.nan
    coords[:, 12] = [40.0, -1e9, 3.0]
    return torch.from_numpy(coords).cuda(), (2, 9, 10, 4, c)


def _hot_k2(seed, form):
    """Raw camera points with 2500 per camera on one pixel's neighbourhood
    (K2: grouped, 1 x 2 x 3 cameras; K2b: 3 cameras, gated)."""
    b, gs, c = 1, 3, 40
    feats, mask, cam3 = _raw_inputs(seed, b, gs, c=c)
    if form.startswith("K2b"):
        feats, mask, cam3 = (t[:3].contiguous() for t in (feats, mask, cam3))
    z = cam3[..., 2:3].abs() + 1.0
    hot = torch.tensor([7.3, 5.6], device="cuda") + 0.2 * torch.rand(
        cam3.shape[0], 2500, 2, device="cuda")
    cam3[:, :2500] = torch.cat([hot * z[:, :2500], z[:, :2500]], -1)
    mask[:, 5:7, 7:9] = 1.0
    return feats, mask, cam3.contiguous(), b, gs, c


def _plans_equal(got, want):
    for name, a in got.fields().items():
        b = want.fields()[name]
        assert torch.equal(a.cpu(), b.cpu()), name


@pytest.mark.cuda
@pytest.mark.parametrize("form", BACKWARD_FORMS)
def test_backward_plan_determinism_and_hot_spot(form):
    """The CUDA plan equals the plain plan element for element, a hot tile
    is cut in chunks, two launches give the same bits, and the result
    agrees with the plain version and with the model of its order."""
    _need_cuda()
    bf16_g = form.endswith("bf16")
    if form.startswith("K4"):
        coords, shape = _hot_k4(70 + len(form))
        planes = form == "K4-bf16"
        g = torch.randn(2, 4001, shape[-1], device="cuda")
        if form != "K4":
            g = g.to(torch.bfloat16)
        plan = sample3d_bwd_plan(coords, shape, planes)
        _plans_equal(plan, sample3d_bwd_plan_plain(coords, shape, planes))
        bwd = sample3d_trilinear_bwd_bf16 if planes else sample3d_trilinear_bwd

        def run():
            return bwd(g, coords, shape)
        ref = (sample3d_trilinear_bwd_bf16_plain if planes
               else sample3d_trilinear_bwd_plain)(g, coords, shape)
        model = k4_in_plan_order(g.cpu(), coords.cpu(), shape, planes)
        adds = 8 * 4001 / (9 * 10 * 4)
    else:
        feats, mask, cam3, b, gs, c = _hot_k2(80 + len(form), form)
        h, w = feats.shape[1:3]
        if form.startswith("K2b"):
            _, valid = sample2d(feats, mask, cam3, "backproject", 0.25, True)
            g = torch.randn(3, cam3.shape[1], c + 1, device="cuda")
            g = torch.where(valid[..., None] > 0, g, float("nan"))
        else:
            _, valid = backproject_grouped(feats, mask, cam3, 0.25, b, gs)
            g = torch.randn(b, 2, cam3.shape[1], c + 2, device="cuda")
        if form.endswith("bf16"):
            g = g.to(torch.bfloat16)
        plan = backproject_bwd_plan(cam3, valid, h, w, True)
        _plans_equal(plan, backproject_bwd_plan_plain(cam3, valid, h, w,
                                                      True))
        if form.startswith("K2b"):
            def run():
                return sample2d_bwd(g, cam3, valid, h, w, c, True)
            ref = sample2d_bwd_plain(g, cam3, valid, h, w, c, True)
            model = k2_in_plan_order(g.cpu(), cam3.cpu(), valid.cpu(), h, w,
                                     c, 0, True)
        else:
            def run():
                return backproject_grouped_bwd(g, cam3, valid, h, w, c, gs)
            ref = backproject_grouped_bwd_plain(g, cam3, valid, h, w, c, gs)
            model = k2_in_plan_order(g.cpu(), cam3.cpu(), valid.cpu(), h, w,
                                     c, gs, True)
        model = model.to(g.dtype)
        adds = valid.sum().item() * 4 / (valid.shape[0] * h * w)
    chunks = plan.chunk_off[1:] - plan.chunk_off[:-1]
    assert int(chunks.max()) >= 2 and int(plan.params[1]) > 0   # cut
    got = run()
    again = run()
    torch.cuda.synchronize()
    assert got.dtype == g.dtype and torch.isfinite(got.float()).all()
    assert torch.equal(got, again)                             # bit for bit
    got, ref = got.float().cpu(), ref.float().cpu()
    if form == "K4-bf16":
        assert torch.equal(got, model.float())
        cos, rel = _cosine_rel(got, ref)
        assert cos > 0.995 and rel < 0.1, (cos, rel)
        return
    rtol = 1e-5 if form.startswith("K4") else 1e-4
    step = 2.0 ** -7 if bf16_g else 0.0
    torch.testing.assert_close(got, ref, rtol=0, atol=(
        step + rtol * (adds + 1) ** 0.5) * ref.abs().max().item())
    torch.testing.assert_close(got, model.float(), rtol=0, atol=(
        step + 1e-6 * (adds + 1) ** 0.5) * ref.abs().max().item())


# The forward samplers' staged stores (K1, K1b): a row whose stride is not
# 16-byte aligned leaves the warp as 16-byte stores, whatever its start.
# N = 5003 is not a multiple of the 32-point tile, and it is odd, so every
# camera's (K1b) or group's (K1) run after the first starts off a 16-byte
# boundary: at elements n * (C + 1) or n * (C + 2) of the output.
FWD_STRIDES = [("grouped", 768), ("grouped", 512), ("grouped", 256),
               ("backproject", 768), ("backproject", 512),
               ("backproject", 256), ("mask", 768), ("bilinear", 768)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("form,c", FWD_STRIDES,
                         ids=[f"{f}-{c}" for f, c in FWD_STRIDES])
def test_forward_sampler_row_strides(form, c, dtype):
    """Every row stride the modes take (grouped 770/514/258, per camera
    769/513/257 and 768) against the plain version, with the tolerances of
    the cases above; the rows of the second and third run, which start at a
    camera's (or group's) offset, are checked on their own too; two
    launches give the same bits."""
    _need_cuda()
    if form == "grouped":
        feats, mask, cam3 = _raw_inputs(c + 5, 2, 1, c=c)   # b = 2, gs = 1
        coords = cam3
    else:
        feats, mask, cam3 = _cams(c + 6, c)
        coords = cam3 if form == "backproject" else _norm_coords(
            c, 3, cam3.shape[1], 2)
    if dtype == "bf16":
        (feats,) = _bf16(feats)
    n = coords.shape[1]
    assert n % 2 == 1

    def run():
        if form == "grouped":
            return backproject_grouped(feats, mask, coords, 0.25, 2, 1)
        m = None if form == "bilinear" else mask
        return sample2d(feats, m, coords, form, 0.25, form == "backproject")
    out, valid = run()
    if form == "grouped":
        ref, ref_valid = backproject_grouped_plain(feats, mask, coords, 0.25,
                                                   2, 1)
    else:
        ref, ref_valid = sample2d_plain(
            feats, None if form == "bilinear" else mask, coords, form, 0.25,
            form == "backproject")
    again, _ = run()
    torch.cuda.synchronize()
    assert out.dtype == feats.dtype
    assert out.shape[-1] == c + {"grouped": 2, "bilinear": 0}.get(form, 1)
    if valid is not None:
        torch.testing.assert_close(valid, ref_valid, rtol=0, atol=0)
    if form != "bilinear":
        torch.testing.assert_close(out[..., -1], ref[..., -1], rtol=0, atol=0)
    scale = (1e-4 * feats.float().abs().max().item() if dtype == "f32"
             else BF16_STEP * ref.float().abs().max().item())
    assert torch.isfinite(out.float()).all()
    rows, ref_rows = out.reshape(-1, n, out.shape[-1]), ref.reshape(
        -1, n, out.shape[-1])
    for k in range(rows.shape[0]):         # each run, from its own offset
        torch.testing.assert_close(rows[k].float(), ref_rows[k].float(),
                                   rtol=0, atol=scale)
    assert torch.equal(out.view(torch.int16 if dtype == "bf16"
                                else torch.int32),
                       again.view(torch.int16 if dtype == "bf16"
                                  else torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c", [64, 12, 7])    # 8 (bf16) / 4-wide, scalar
def test_sample3d_vector_paths(c, dtype):
    """K3 at C = 64 (16-byte vectors: 4 f32 or 8 bf16 channels), at a C
    divisible by 4 but not 8 (4-wide vectors in both) and at an odd C (one
    warp per point), N = 4001 a multiple of no tile, against the plain
    version; two launches give the same bits."""
    _need_cuda()
    rng = np.random.RandomState(c + 11)
    vol = torch.from_numpy(rng.randn(2, 5, 6, 4, c).astype(np.float32))
    coords = rng.uniform(-1.3, 1.3, (2, 4001, 3)).astype(np.float32)
    coords[:, :2] = [[-1, -1, -1], [1, 1, 1]]
    coords[:, 10, 1] = np.nan
    coords[:, 12] = [40.0, -1e9, 3.0]
    vol = vol.cuda()
    if dtype == "bf16":
        (vol,) = _bf16(vol)
    coords = torch.from_numpy(coords).cuda()
    before = (sample3d_trilinear.launches, sample3d_trilinear.launches_bf16)
    out = sample3d_trilinear(vol, coords)
    again = sample3d_trilinear(vol, coords)
    bf16 = dtype == "bf16"
    assert (sample3d_trilinear.launches, sample3d_trilinear.launches_bf16) \
        == (before[0] + 2 * (not bf16), before[1] + 2 * bf16)
    ref = sample3d_trilinear_plain(vol, coords)
    torch.cuda.synchronize()
    assert out.dtype == vol.dtype
    tol = (BF16_STEP if bf16 else 1e-5) * vol.float().abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)
    assert (out[:, [10, 12]] == 0).all()
    view = torch.int16 if bf16 else torch.int32
    assert torch.equal(out.view(view), again.view(view))


def _gather_inputs(seed, c, hot: bool):
    rng = np.random.RandomState(seed)
    shape = (2, 9, 10, 4, c)
    vol = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        torch.bfloat16).cuda()
    coords = rng.uniform(-1.3, 1.3, (2, 4001, 3)).astype(np.float32)
    coords[:, :4] = [[-1, -1, -1], [1, 1, 1], [-1.002, 0, 0], [0, 1.002, 0]]
    if hot:
        coords[:, 100:3100] = rng.uniform(-1.0, -0.97, (2, 3000, 3))
    coords[:, 10, 1] = np.nan
    coords[:, 11, 0] = np.inf
    coords[:, 12] = [40.0, -1e9, 3.0]
    g = torch.from_numpy(rng.randn(2, 4001, c).astype(np.float32)).to(
        torch.bfloat16).cuda()
    return vol, torch.from_numpy(coords).cuda(), g, shape


@pytest.mark.cuda
@pytest.mark.parametrize("c,hot", [(64, False), (7, False), (64, True)])
def test_gather_bf16_forward_matches_plain_bits(c, hot):
    """Even C takes the 2-channel path, odd C the scalar one."""
    _need_cuda()
    vol, coords, _, _ = _gather_inputs(80 + c, c, hot)
    out = s3.sample3d_gather(vol, coords)
    again = s3.sample3d_gather(vol, coords)
    ref = s3.sample3d_gather_plain(vol, coords)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))
    assert torch.equal(out.view(torch.int16), again.view(torch.int16))
    assert (out[:, 10:13] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("c,hot", [(64, False), (7, False), (64, True)])
def test_gather_bf16_backward_plan_and_bits(c, hot):
    """The card's plan equals the plain plan, the kernel the plain version
    and the tap-by-tap model bit for bit, a relaunch the same bits; the hot
    block gives its voxels thousands of additions each."""
    _need_cuda()
    _, coords, g, shape = _gather_inputs(90 + c, c, hot)
    order, start = s3.sample3d_gather_bwd_plan(coords, shape)
    p_order, p_start = s3.sample3d_gather_bwd_plan_plain(coords, shape)
    assert torch.equal(order, p_order) and torch.equal(start, p_start)
    runs = start[1:] - start[:-1]
    if hot:
        assert int(runs.max()) > 1000
    dvol = s3.sample3d_gather_bwd(g, coords, shape)
    again = s3.sample3d_gather_bwd(g, coords, shape)
    ref = s3.sample3d_gather_bwd_plain(g, coords, shape)
    torch.cuda.synchronize()
    bits = dvol.view(torch.int16)
    assert torch.equal(bits, ref.view(torch.int16))
    assert torch.equal(bits, again.view(torch.int16))
    if not hot:
        model = gather_bwd_in_plan_order(g.cpu(), coords.cpu(), shape)
        assert torch.equal(dvol.cpu().view(torch.int16),
                           model.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("ahead", [1, 2])
def test_device_prefetch_matches_pageable_route(ahead):
    """50 full-width batches (6 cameras at 384x640, 5 distinct ones in
    turn, one float64) through ``device_prefetch`` (pinned, on a side
    stream) against the pageable route (``VFDepthModel._to_device``'s
    ``.to(device, float32)``), every tensor bit for bit. Each case is built
    so that one fault shows on every batch. One batch ahead, the consumer
    reads each batch as soon as it is yielded, its own stream empty: a
    consumer that did not wait for the copies, queued just before, would
    read memory still being written. Two batches ahead (the trainer's
    depth), the consumer queues 60 ms of device work before each read and
    drops the batch at once: the next batch is pinned and copied well
    within that time, so memory handed back to the side stream without
    ``record_stream`` would hold the next batch when it is read."""
    _need_cuda()
    from vfdepth_tpu_torch.data import FakeDataset, device_prefetch
    dev = torch.device("cuda")
    ds = FakeDataset(num_samples=5, num_cams=6, height=384, width=640,
                     fusion_level=2, with_depth=True)
    distinct = [ds.batch([i]) for i in range(5)]
    distinct[1] = {k: v.astype(np.float64) for k, v in distinct[1].items()}
    refs = [{k: torch.as_tensor(v).to(dev, torch.float32)
             for k, v in b.items()} for b in distinct]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
    start.record()
    torch.cuda._sleep(2 * 10 ** 7)
    end.record()
    end.synchronize()
    sleep = int(60 * 2 * 10 ** 7 / start.elapsed_time(end))
    consumer = torch.cuda.current_stream(dev)
    mismatches = []
    n = 0
    torch.cuda.synchronize()
    for got in device_prefetch((distinct[i % 5] for i in range(50)),
                               size=ahead, device=dev):
        if ahead == 2:
            torch.cuda._sleep(sleep)
        ref = refs[n % 5]
        assert got.keys() == ref.keys()
        mismatches.append(sum((got[k].view(torch.int32)
                               != ref[k].view(torch.int32)).sum()
                              for k in ref))
        del got
        if ahead == 1:
            consumer.synchronize()
        n += 1
    assert n == 50
    assert int(torch.stack(mismatches).sum()) == 0


@pytest.mark.cuda
def test_checkpoint_moves_between_card_and_cpu(tmp_path):
    """A checkpoint written from the card loads on the CPU, and one written
    from the CPU loads on the card: parameters, BatchNorm statistics and
    Adam's moments bit for bit, the update count on the CPU."""
    _need_cuda()
    from vfdepth_tpu_torch import presets
    from vfdepth_tpu_torch.data import FakeDataset
    from vfdepth_tpu_torch.training import (VFDepthModel, create_train_state,
                                            load_checkpoint, save_checkpoint,
                                            train_step)
    cfg = presets.micro_config()
    card = VFDepthModel(cfg, device="cuda")
    opt = create_train_state(card)
    ds = FakeDataset(num_samples=1, num_cams=cfg.num_cams, height=cfg.height,
                     width=cfg.width, fusion_level=cfg.fusion_level,
                     rig="nuscenes")
    train_step(card, opt, ds.batch([0]), 0,
               torch.Generator("cuda").manual_seed(0))
    path = save_checkpoint(str(tmp_path / "card"), 0, card, opt, 1)

    def same(a, a_opt, b, b_opt):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x.cpu(), y.cpu()), k
        for p, q in zip(a.parameters(), b.parameters()):
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(a_opt.state[p][key].cpu(),
                                   b_opt.state[q][key].cpu()), key
            assert b_opt.state[q]["step"].device.type == "cpu"
            assert b_opt.state[q]["exp_avg"].device == q.device

    cpu = VFDepthModel(cfg, device="cpu", seed=3)
    cpu_opt = create_train_state(cpu)
    assert load_checkpoint(path, cpu, cpu_opt) == 1
    same(card, opt, cpu, cpu_opt)
    path = save_checkpoint(str(tmp_path / "cpu"), 0, cpu, cpu_opt, 1)
    back = VFDepthModel(cfg, device="cuda", seed=4)
    back_opt = create_train_state(back)
    assert load_checkpoint(path, back, back_opt) == 1
    same(cpu, cpu_opt, back, back_opt)
