"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest configures JAX). Every test skips
where there is no CUDA device. Tolerances, relative to the largest input
magnitude: K1 1e-4 (bilinear taps and a group sum of up to 8 cameras,
fma-contracted in the kernel), K3 1e-5 (an 8-term weighted sum);
validity is exact.
"""
import numpy as np
import pytest
import torch

from vfdepth_tpu_torch.ops.backproject_sample import (
    backproject_grouped_raw, backproject_grouped_raw_plain)
from vfdepth_tpu_torch.ops.sample3d import (sample3d_trilinear,
                                            sample3d_trilinear_plain)


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
