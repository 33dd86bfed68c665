"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest configures JAX). Every test skips
where there is no CUDA device. Tolerances, relative to the largest input
magnitude: K1 1e-4 (bilinear taps and a group sum of up to 8 cameras,
fma-contracted in the kernel), K3 1e-5 (an 8-term weighted sum);
validity is exact. The backward kernels add with atomics in a varying
order: K2 1e-4 and K4 1e-5 of the largest output magnitude times the
square root of the most additions one address receives (a rounding error
per addition, random in sign). K5: 1e-6 (a 4-tap weighted sum of inputs in
[0, 1], fma-contracted), masks exact, its coordinate gradient 1e-5 of its
largest entry.
"""
import numpy as np
import pytest
import torch

from vfdepth_tpu_torch.ops.backproject_sample import (
    backproject_grouped_raw, backproject_grouped_raw_bwd,
    backproject_grouped_raw_bwd_plain, backproject_grouped_raw_plain)
from vfdepth_tpu_torch.ops.sample3d import (sample3d_trilinear,
                                            sample3d_trilinear_bwd,
                                            sample3d_trilinear_bwd_plain,
                                            sample3d_trilinear_plain)
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
    before = backproject_grouped_raw.launches
    out, valid = backproject_grouped_raw(feats, mask, cam3, 0.25, b, gs)
    assert backproject_grouped_raw.launches == before + 1
    ref, ref_valid = backproject_grouped_raw_plain(feats, mask, cam3, 0.25,
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
    _, valid = backproject_grouped_raw(feats, mask, cam3, 0.25, b, gs)
    g = torch.randn(b, 2, cam3.shape[1], c + 2, device="cuda")
    g[..., :5, :] = float("nan")          # rows no camera may read
    g[..., :5, :] = torch.where(valid.reshape(b, 2, gs, -1)[..., :5].amax(
        2)[..., None] > 0, 1.0, g[..., :5, :])
    h, w = feats.shape[1:3]
    before = backproject_grouped_raw_bwd.launches
    got = backproject_grouped_raw_bwd(g, cam3, valid, h, w, c, gs)
    assert backproject_grouped_raw_bwd.launches == before + 1
    ref = backproject_grouped_raw_bwd_plain(g, cam3, valid, h, w, c, gs)
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
