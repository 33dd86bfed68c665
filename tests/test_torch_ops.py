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
* K2 (K1's backward, through the ``BackprojectGrouped`` Function)
  against ``jax.vjp`` of the grouped raw Pallas sampler in interpret mode,
  whose backward kernel rounds the cotangent to bf16 and emits bf16: 3e-2 of
  the largest entry, as the forward; and against torch autograd of the
  port's own plain K1: the same f32 products summed in another order, 1e-5.
* K4 (K3's backward, through ``Sample3dTrilinear``) against ``jax.vjp`` of
  ``grid_sample_3d_packed(..., "f32", "yxz")`` (interpret mode, f32
  updates): 1e-5 of the largest entry.

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
    BackprojectGrouped, backproject_grouped,
    backproject_grouped_bwd, backproject_grouped_bwd_plain,
    backproject_grouped_plain)
from vfdepth_tpu_torch.ops.sample3d import (Sample3dTrilinear,
                                            sample3d_trilinear,
                                            sample3d_trilinear_bwd,
                                            sample3d_trilinear_bwd_plain,
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
    out, valid = backproject_grouped_plain(
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
    before = backproject_grouped.launches
    for a, b in zip(backproject_grouped(*args),
                    backproject_grouped_plain(*args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    vol, coords = _sample3d_inputs(6)
    torch.testing.assert_close(
        sample3d_trilinear(torch.from_numpy(vol), torch.from_numpy(coords)),
        sample3d_trilinear_plain(torch.from_numpy(vol),
                                 torch.from_numpy(coords)), rtol=0, atol=0)
    assert backproject_grouped.launches == before
    assert sample3d_trilinear.launches == 0


def test_wrappers_reject_bad_inputs():
    feats, mask, cam3 = (torch.from_numpy(a) for a in _raw_inputs(7, gs=2,
                                                                    n=64))
    with pytest.raises(TypeError):
        backproject_grouped(feats.double(), mask, cam3, 0.5, 1, 2)
    with pytest.raises(ValueError):
        backproject_grouped(feats, mask, cam3, 0.5, 2, 2)
    with pytest.raises(ValueError):
        backproject_grouped(feats.to("meta"), mask.to("meta"),
                                cam3.to("meta"), 0.5, 1, 2)
    vol = torch.zeros(1, 4, 4, 4, 2)
    with pytest.raises(TypeError):
        sample3d_trilinear(vol.half(), torch.zeros(1, 5, 3).half())
    with pytest.raises(ValueError):
        sample3d_trilinear(vol.to("meta"), torch.zeros(1, 5, 3, device="meta"))



def _backproject_grad(feats, mask, cam3, g, b, gs, rel_scale):
    """dfeats through the port's Function (plain versions on the CPU)."""
    f = torch.from_numpy(feats).requires_grad_()
    out, _ = BackprojectGrouped.apply(f, torch.from_numpy(mask),
                                         torch.from_numpy(cam3), rel_scale,
                                         b, gs)
    (out * torch.from_numpy(g)).sum().backward()
    return f.grad.numpy()


@pytest.mark.parametrize("b,gs", [(1, 3), (2, 2)])
def test_backproject_backward_matches_pallas_interpret(b, gs):
    rel_scale = 1.0 / 24.0
    feats, mask, cam3 = _raw_inputs(10 + gs, b=b, gs=gs, n=1200)
    n, c = cam3.shape[1], feats.shape[-1]
    g = np.random.RandomState(gs).randn(b, 2, n, c + 2).astype(np.float32)
    g[..., -1] = 0.0                 # the valid column has no cotangent in JAX
    _, vjp = jax.vjp(lambda f: sample_backproject_grouped_raw_pallas(
        f, jnp.asarray(mask[..., None]), jnp.asarray(cam3), rel_scale, b, gs),
        jnp.asarray(feats))
    (want,) = vjp((jnp.asarray(g[..., :-1]), jnp.zeros((b, 2, n))))
    want = np.asarray(want, np.float32)
    got = _backproject_grad(feats, mask, cam3, g, b, gs, rel_scale)
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=3e-2 * np.abs(want).max())


def test_backproject_backward_matches_autograd_of_plain_forward():
    b, gs, rel_scale = 1, 3, 0.5
    feats, mask, cam3 = _raw_inputs(12, b=b, gs=gs, n=900)
    g = np.random.RandomState(1).randn(b, 2, 900, feats.shape[-1] + 2)
    g = g.astype(np.float32)
    f = torch.from_numpy(feats).requires_grad_()
    out, _ = backproject_grouped_plain(f, torch.from_numpy(mask),
                                           torch.from_numpy(cam3), rel_scale,
                                           b, gs)
    (want,) = torch.autograd.grad(out, f, torch.from_numpy(g))
    got = _backproject_grad(feats, mask, cam3, g, b, gs, rel_scale)
    np.testing.assert_allclose(got, want.numpy(), rtol=0,
                               atol=1e-5 * want.abs().max().item())


def test_sample3d_backward_matches_packed_interpret():
    vol, coords = _sample3d_inputs(8)
    g = np.random.RandomState(9).randn(*coords.shape[:2], vol.shape[-1])
    g = g.astype(np.float32)
    _, vjp = jax.vjp(lambda v: grid_sample_3d_packed(
        v, jnp.asarray(coords), "f32", "yxz"), jnp.asarray(vol))
    (want,) = vjp(jnp.asarray(g))
    want = np.asarray(want)
    v = torch.from_numpy(vol).requires_grad_()
    (Sample3dTrilinear.apply(v, torch.from_numpy(coords))
     * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_backward_wrappers_take_plain_version_on_cpu_and_check_inputs():
    feats, mask, cam3 = (torch.from_numpy(a) for a in _raw_inputs(13, n=300))
    _, valid = backproject_grouped(feats, mask, cam3, 0.5, 1, 3)
    g = torch.randn(1, 2, 300, feats.shape[-1] + 2)
    h, w, c = feats.shape[1:]
    torch.testing.assert_close(
        backproject_grouped_bwd(g, cam3, valid, h, w, c, 3),
        backproject_grouped_bwd_plain(g, cam3, valid, h, w, c, 3),
        rtol=0, atol=0)
    with pytest.raises(ValueError):
        backproject_grouped_bwd(g[:, :, :10], cam3, valid, h, w, c, 3)
    with pytest.raises(TypeError):
        backproject_grouped_bwd(g.double(), cam3, valid, h, w, c, 3)
    vol, coords = (torch.from_numpy(a) for a in _sample3d_inputs(14))
    g3 = torch.randn(*coords.shape[:2], vol.shape[-1])
    torch.testing.assert_close(
        sample3d_trilinear_bwd(g3, coords, vol.shape),
        sample3d_trilinear_bwd_plain(g3, coords, vol.shape), rtol=0, atol=0)
    with pytest.raises(ValueError):
        sample3d_trilinear_bwd(g3[..., :2], coords, vol.shape)
    with pytest.raises(ValueError):
        sample3d_trilinear_bwd(g3.to("meta"), coords.to("meta"), vol.shape)
    assert backproject_grouped_bwd.launches == 0
    assert sample3d_trilinear_bwd.launches == 0
