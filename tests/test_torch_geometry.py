"""Geometry of the PyTorch port against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: pose algebra is a handful of f32 products and sums taken in
another order -> atol 1e-5. Grids: XLA's CPU compiler rewrites
``jnp.linspace``'s division as a reciprocal multiply (and folds constants),
so it is not correctly rounded; the port's grids agree to within
1e-6 x the grid's magnitude (a few ulp), not bit for bit.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vfdepth_tpu.config import get_config as jax_get_config
from vfdepth_tpu.data.fake import FakeDataset
from vfdepth_tpu.geometry import pose as jpose
from vfdepth_tpu.geometry import projection as jproj
from vfdepth_tpu.geometry import se3 as jse3
from vfdepth_tpu_torch.geometry import pose as tpose
from vfdepth_tpu_torch.geometry import projection as tproj
from vfdepth_tpu_torch.geometry import se3 as tse3

jax.config.update("jax_platforms", "cpu")


def _grid_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("invert", [False, True])
def test_vec_to_matrix_matches_jax(invert):
    rng = np.random.RandomState(0)
    aa = (rng.randn(2, 6, 3) * 0.3).astype(np.float32)
    aa[0, 0] = 0.0                      # the small-angle branch
    tr = rng.randn(2, 6, 3).astype(np.float32)
    want = jse3.vec_to_matrix(jnp.asarray(aa), jnp.asarray(tr), invert=invert)
    got = tse3.vec_to_matrix(torch.from_numpy(aa), torch.from_numpy(tr),
                             invert=invert)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _rig(batch=2):
    ds = FakeDataset(num_samples=batch, height=64, width=96)
    return ds.batch(list(range(batch)))


def test_invert_pose_matches_jax():
    rng = np.random.RandomState(1)
    mats = np.array(jse3.vec_to_matrix(
        jnp.asarray(rng.randn(3, 4, 3).astype(np.float32)),
        jnp.asarray(rng.randn(3, 4, 3).astype(np.float32))))
    want = jse3.invert_pose(jnp.asarray(mats))
    got = tse3.invert_pose(torch.from_numpy(mats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_distribute_pose_matches_jax():
    rng = np.random.RandomState(2)
    batch = _rig()
    canon = np.array(jse3.vec_to_matrix(
        jnp.asarray((rng.randn(2, 3) * 0.1).astype(np.float32)),
        jnp.asarray(rng.randn(2, 3).astype(np.float32))))
    ext, ext_inv = batch["extrinsics"], batch["extrinsics_inv"]
    want = jpose.distribute_pose(jnp.asarray(canon), jnp.asarray(ext),
                                 jnp.asarray(ext_inv))
    got = tpose.distribute_pose(torch.from_numpy(canon), torch.from_numpy(ext),
                                torch.from_numpy(ext_inv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("config", ["configs/tiny_fake.yaml",
                                    "configs/ddad/ddad_surround_fusion.yaml"])
def test_voxel_points_match_jax(config):
    cfg = jax_get_config(config)
    args = (tuple(cfg.voxel_str_p), tuple(cfg.voxel_unit_size),
            tuple(cfg.voxel_size))
    want = jproj.voxel_points_homo(*args)
    got = tproj.voxel_points_homo(*args)
    assert got.shape == want.shape
    _grid_close(got, want)
    # (y, x, z) flat order, z fastest
    vx, vy, vz = cfg.voxel_size
    pts = got.numpy()[:3].reshape(3, vy, vx, vz)
    assert np.all(np.diff(pts[2], axis=2) > 0)
    assert np.all(np.diff(pts[0], axis=1) > 0)
    assert np.all(np.diff(pts[1], axis=0) > 0)


def test_linspace_matches_jnp_formula():
    for a, b, n in [(-50.0, 49.0, 100), (-15.0, 13.5, 20), (2.0, 50.0, 50),
                    (-46.0, 46.0, 24), (2.0, 50.0, 12)]:
        got = tproj.linspace_f32(a, b, n)
        _grid_close(got, jnp.linspace(a, b, n, dtype=jnp.float32))
        assert got[0].item() == a and got[-1].item() == b


def test_pixel_grid_exact():
    got = tproj.pixel_grid_homo(5, 7).numpy()
    np.testing.assert_array_equal(got, np.asarray(jproj.pixel_grid_homo(5, 7)))


def test_frustum_world_points_match_jax():
    batch = _rig()
    inv_k = batch["inv_K/3"]
    ext = batch["extrinsics"]
    bins_t = tproj.linspace_f32(2.0, 50.0, 12)
    bins_j = jnp.asarray(bins_t.numpy())     # same bins: the grids are tested above
    want = jproj.frustum_world_points(jnp.asarray(inv_k), jnp.asarray(ext),
                                      8, 12, bins_j)
    got = tproj.frustum_world_points(torch.from_numpy(inv_k),
                                     torch.from_numpy(ext), 8, 12, bins_t)
    assert got.shape == want.shape == (2, 6, 12, 96, 3)
    _grid_close(got, want)
