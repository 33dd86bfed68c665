"""Sampling and resize ops of the PyTorch port against the JAX package.

On the CPU the kernel wrappers run their plain PyTorch versions; those are
held here against the JAX functions the CUDA kernels replace:

* K1 (grouped raw back-projection) against the Pallas kernel in interpret
  mode. The Pallas kernel casts features and tap weights to bf16 and emits
  bf16, so values agree to bf16 precision: atol = rtol = 3e-2, as
  tests/test_pallas_sample.py holds the kernel itself. Validity and counts
  come from f32 comparisons in both: exact.
* K1 in f32 against the JAX gather path (``backproject_features`` with
  ``sampler_2d="gather"``, summed into the two camera groups): same
  arithmetic in another order, 1e-4. (The two differ only at exact
  nearest-pick ties, round-half-even against "frac > 0.5", which these
  inputs do not hit.)
* K3 (trilinear frustum sampler) against ``grid_sample_3d_packed(..., "f32",
  "yxz")`` in interpret mode: identical f32 arithmetic up to summation
  order, 1e-5.

tests/test_torch_kernels_cuda.py holds each CUDA kernel against its plain
version on the card.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vfdepth_tpu.data.fake import FakeDataset
from vfdepth_tpu.models import vfnet as jvfnet
from vfdepth_tpu.ops import resize as jresize
from vfdepth_tpu.ops.pallas_sample import (_fwd_call_grouped,
                                           sample_backproject_grouped_raw_pallas)
from vfdepth_tpu.ops.sample3d_packed import grid_sample_3d_packed
from vfdepth_tpu_torch.models.vfnet import backproject_features_grouped
from vfdepth_tpu_torch.ops import resize as tresize
from vfdepth_tpu_torch.ops.backproject_sample import (
    backproject_grouped_raw, backproject_grouped_raw_plain)
from vfdepth_tpu_torch.ops.sample3d import (sample3d_trilinear,
                                            sample3d_trilinear_plain)

jax.config.update("jax_platforms", "cpu")

GROUPS = ((0, 3, 4), (1, 2, 5))
TINY_VOXEL = dict(voxel_str_p=(-46.0, -46.0, -10.5),
                  voxel_unit_size=(4.0, 4.0, 3.0), voxel_size=(24, 24, 8))


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("out_hw", [(5, 11), (14, 18)])
def test_resize_bilinear_matches_jax(align_corners, out_hw):
    rng = np.random.RandomState(0)
    img = rng.randn(2, 3, 7, 9, 4).astype(np.float32)
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(img), out_hw,
                                              align_corners=align_corners))
    got = tresize.resize_bilinear(torch.from_numpy(img), out_hw,
                                  align_corners=align_corners)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    nchw = tresize.resize_bilinear(torch.from_numpy(img).movedim(-1, -3),
                                   out_hw, align_corners=align_corners,
                                   channels_last=False)
    np.testing.assert_allclose(nchw.movedim(-3, -1).numpy(), want, atol=1e-6)


def test_upsample2x_nearest_matches_jax():
    img = np.random.RandomState(1).randn(2, 5, 7, 3).astype(np.float32)
    want = np.asarray(jresize.upsample2x_nearest(jnp.asarray(img)))
    got = tresize.upsample2x_nearest(torch.from_numpy(img))
    np.testing.assert_array_equal(got.numpy(), want)
    nchw = tresize.upsample2x_nearest(torch.from_numpy(img).movedim(-1, 1),
                                      channels_last=False)
    np.testing.assert_array_equal(nchw.movedim(1, -1).numpy(), want)


def _raw_inputs(seed, b=1, gs=3, h=16, w=24, c=8, n=1500):
    """Features, a 0/1 mask with holes, and camera-plane points that mix
    in-image, behind-camera, near-zero-depth, out-of-image and non-finite
    cases."""
    rng = np.random.RandomState(seed)
    cams = b * 2 * gs
    feats = rng.randn(cams, h, w, c).astype(np.float32)
    mask = (rng.rand(cams, h, w) > 0.3).astype(np.float32)
    z = rng.uniform(-2.0, 10.0, (cams, n)).astype(np.float32)
    z[:, :20] = rng.uniform(-1e-7, 1e-7, (cams, 20))
    px = rng.uniform(-6, w + 6, (cams, n)).astype(np.float32)
    py = rng.uniform(-6, h + 6, (cams, n)).astype(np.float32)
    cam3 = np.stack([px * z, py * z, z], axis=-1)
    cam3[:, 30:35, 0] = np.nan
    cam3[:, 35:40, 1] = np.inf
    cam3[:, 40:42, 2] = np.nan
    return feats, mask, cam3


def test_backproject_plain_matches_pallas_interpret():
    b, gs, rel_scale = 1, 3, 1.0 / 24.0
    feats, mask, cam3 = _raw_inputs(0, b=b, gs=gs)
    cams, h, w, c = feats.shape
    n = cam3.shape[1]
    feat_j, cnt_j = sample_backproject_grouped_raw_pallas(
        jnp.asarray(feats), jnp.asarray(mask[..., None]), jnp.asarray(cam3),
        rel_scale, b, gs)
    _, valid_j = _fwd_call_grouped(
        jnp.asarray(feats.reshape(cams, h * w, c)), jnp.asarray(cam3),
        jnp.asarray(mask), h, w, b, gs, raw=True, rel_scale=rel_scale)
    out, valid = backproject_grouped_raw_plain(
        torch.from_numpy(feats), torch.from_numpy(mask),
        torch.from_numpy(cam3), rel_scale, b, gs)
    assert out.shape == (b, 2, n, c + 2) and valid.shape == (cams, n)
    np.testing.assert_array_equal(out[..., -1].numpy(), np.asarray(cnt_j))
    np.testing.assert_array_equal(valid.numpy(),
                                  np.asarray(valid_j, np.float32)[..., 0])
    # invalid points (non-finite depths included) add exact zeros
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out[..., :-1].numpy(), np.asarray(feat_j),
                               atol=3e-2, rtol=3e-2)
    assert 0 < valid.sum() < valid.numel()


def test_backproject_plain_matches_jax_gather_path():
    rng = np.random.RandomState(3)
    ds = FakeDataset(num_samples=1, height=64, width=96)
    batch = ds.batch([0])
    feats = rng.randn(1, 6, 8, 12, 5).astype(np.float32)
    mask = (rng.rand(1, 6, 64, 96, 1) > 0.2).astype(np.float32)
    k, ext_inv = batch["K/3"], batch["extrinsics_inv"]
    feat_j, _, count_j = jvfnet.backproject_features(
        jnp.asarray(feats), jnp.asarray(mask), jnp.asarray(k),
        jnp.asarray(ext_inv), sampler_2d="gather", **TINY_VOXEL)
    feat_j = np.asarray(feat_j)
    want = np.stack([feat_j[:, list(g)].sum(1) for g in GROUPS], axis=1)
    got, count = backproject_features_grouped(
        torch.from_numpy(feats), torch.from_numpy(mask), torch.from_numpy(k),
        torch.from_numpy(ext_inv), groups=GROUPS, **TINY_VOXEL)
    np.testing.assert_array_equal(count.numpy(), np.asarray(count_j))
    assert count.max() >= 2           # overlapping cameras are exercised
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def _sample3d_inputs(seed):
    rng = np.random.RandomState(seed)
    vol = rng.randn(2, 5, 6, 4, 3).astype(np.float32)       # [B, y, x, z, C]
    coords = rng.uniform(-1.3, 1.3, (2, 400, 3)).astype(np.float32)
    coords[:, :4] = [[-1, -1, -1], [1, 1, 1], [-1.002, 0, 0], [0, 1.002, 0]]
    coords[:, 10, 1] = np.nan
    coords[:, 11, 0] = np.inf
    coords[:, 12, 2] = -np.inf
    coords[:, 13] = [40.0, -1e9, 3.0]
    return vol, coords


def test_sample3d_plain_matches_packed_interpret():
    vol, coords = _sample3d_inputs(4)
    want = np.asarray(grid_sample_3d_packed(jnp.asarray(vol),
                                            jnp.asarray(coords), "f32", "yxz"))
    got = sample3d_trilinear_plain(torch.from_numpy(vol),
                                   torch.from_numpy(coords))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_array_equal(got[:, 10:14].numpy(), 0.0)


def test_wrappers_take_plain_version_on_cpu():
    feats, mask, cam3 = _raw_inputs(5, gs=2, n=300)
    args = (torch.from_numpy(feats), torch.from_numpy(mask),
            torch.from_numpy(cam3), 0.5, 1, 2)
    before = backproject_grouped_raw.launches
    for a, b in zip(backproject_grouped_raw(*args),
                    backproject_grouped_raw_plain(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    vol, coords = _sample3d_inputs(6)
    torch.testing.assert_close(
        sample3d_trilinear(torch.from_numpy(vol), torch.from_numpy(coords)),
        sample3d_trilinear_plain(torch.from_numpy(vol),
                                 torch.from_numpy(coords)), rtol=0, atol=0)
    assert backproject_grouped_raw.launches == before
    assert sample3d_trilinear.launches == 0


def test_wrappers_reject_bad_inputs():
    feats, mask, cam3 = (torch.from_numpy(a) for a in _raw_inputs(7, gs=2,
                                                                    n=64))
    with pytest.raises(TypeError):
        backproject_grouped_raw(feats.double(), mask, cam3, 0.5, 1, 2)
    with pytest.raises(ValueError):
        backproject_grouped_raw(feats, mask, cam3, 0.5, 2, 2)
    with pytest.raises(ValueError):
        backproject_grouped_raw(feats.to("meta"), mask.to("meta"),
                                cam3.to("meta"), 0.5, 1, 2)
    vol = torch.zeros(1, 4, 4, 4, 2)
    with pytest.raises(TypeError):
        sample3d_trilinear(vol.half(), torch.zeros(1, 5, 3).half())
    with pytest.raises(ValueError):
        sample3d_trilinear(vol.to("meta"), torch.zeros(1, 5, 3, device="meta"))

