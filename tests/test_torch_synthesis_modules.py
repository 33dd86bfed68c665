"""The depth-synthesis branch's modules in the port against the JAX
package, on the CPU, on the same numpy inputs made from a seed.

* ``augment_extrinsics`` on the JAX key's own uniform draw: 1e-6
  (f32 Rodrigues and one 4x4 product; the config's angles act as radians);
* ``grid_sample_2d`` (the plain gather sampler of ``warp_depth``), bilinear
  and nearest, with non-finite, huge finite, +-1 border and exact
  half-pixel coordinates: values 1e-6 of their magnitude, gradients with
  respect to the map and the coordinates 1e-5 of the largest entry (the
  same four taps summed in the same order; XLA may fuse a multiply-add);
  nearest ties round half to even in both;
* ``warp_depth`` on a random scene (values and gradients 1e-5 of their
  magnitude, masks exact: no coordinate lies within 1e-5 of a pixel centre
  or the border) and on an exact scene (K = I, identity transform, target
  depth 4, a 9x5 image: every coordinate lands on a pixel centre, so source
  depths of exactly ``min_depth`` and ``max_depth`` reach the clip and the
  strict range test as ties; the clip's derivative there is JAX's 1/2);
* ``render_views``' depth-synthesis branch on the fake rig at 32x48: the
  warped depths and masks as above, gradients with respect to both depths
  1e-5 of the largest entry;
* ``depth_synthesis_loss`` with ties (a warped depth equal to the aug depth
  and one of 0, where |.| and the clip at 1 meet their kinks, and constant
  disparity rows): values 1e-6, gradients 1e-5 of the largest entry;
* ``aug_depth_params``: equal, bit for bit;
* the published ``configs/ddad/ddad_surround_fusion_augdepth.yaml`` builds
  in the port and its keys reach the loss and the model.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vfdepth_tpu.config import get_config as jax_get_config
from vfdepth_tpu.data.fake import FakeDataset
from vfdepth_tpu.geometry import view_rendering as jvr
from vfdepth_tpu.losses.composite import (
    depth_synthesis_loss as jax_synthesis_loss)
from vfdepth_tpu.models.vfnet import augment_extrinsics as jax_augment
from vfdepth_tpu.ops.grid_sample import grid_sample_2d as jax_grid_sample
from vfdepth_tpu.utils.visualize import aug_depth_params as jax_params
from vfdepth_tpu_torch.config import get_config
from vfdepth_tpu_torch.geometry import view_rendering as tvr
from vfdepth_tpu_torch.losses import depth_synthesis_loss
from vfdepth_tpu_torch.models.vfnet import augment_extrinsics
from vfdepth_tpu_torch.ops.grid_sample import grid_sample_2d
from vfdepth_tpu_torch.utils.visualize import aug_depth_params
from helpers_torch_threads import port_threads  # noqa: F401

jax.config.update("jax_platforms", "cpu")
AUG_YAML = "configs/ddad/ddad_surround_fusion_augdepth.yaml"
MIN_D, MAX_D = 1.5, 200.0


def _close(got, want, rel, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-12),
                               err_msg=what)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


@pytest.mark.parametrize("seed", [0, 1])
def test_augment_extrinsics_matches_jax(seed):
    ext = FakeDataset(num_samples=2).batch([0, 1])["extrinsics"]
    key = jax.random.PRNGKey(seed)
    want = jax_augment(key, jnp.asarray(ext), (15, 15, 40))
    u = np.array(jax.random.uniform(key, ext.shape[:2] + (3,)))
    src = _t(ext, grad=True)
    got = augment_extrinsics(torch.from_numpy(u), src, (15, 15, 40))
    assert not got.requires_grad           # stop_gradient
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    rot = got[..., :3, :3] @ torch.linalg.inv(src[..., :3, :3]).detach()
    # radians: angles up to 20 rad about z give rotations far from I
    assert (rot - torch.eye(3)).abs().max() > 0.5


def _sample_inputs(seed):
    """img [2, 3, 3, 5, 2]: y in [0, 2] and x in [0, 4] unnormalise
    exactly (size - 1 is a power of 2), so half-pixel coordinates are
    exact ties for nearest; coords [2, 3, 4, 6, 2] with special entries."""
    rng = np.random.RandomState(seed)
    img = rng.randn(2, 3, 3, 5, 2).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (2, 3, 4, 6, 2)).astype(np.float32)
    special = [(np.nan, 0.0), (0.1, np.inf), (-np.inf, 0.2), (1e10, 0.0),
               (0.0, -3e9), (1.0, 1.0), (-1.0, -1.0), (1.0, -1.0),
               (0.25, 0.5), (-0.75, -0.5), (0.75, 0.0), (-0.25, 0.5)]
    flat = coords.reshape(-1, 2)
    for i, (x, y) in enumerate(special):
        flat[3 * i] = (x, y)
    return img, flat.reshape(coords.shape)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample_2d_matches_jax(mode):
    img, coords = _sample_inputs(3)
    rng = np.random.RandomState(4)
    cot = rng.randn(2, 3, 4, 6, 2).astype(np.float32)
    cot_f = rng.randn(2, 3, 4, 6, 1).astype(np.float32)

    def jfn(im, co):
        out, fin = jax_grid_sample(im, co, mode=mode, with_finite_mask=True)
        return jnp.sum(out * cot) + jnp.sum(fin * cot_f), (out, fin)

    (_, (want, want_f)), (g_img, g_co) = (
        jfn(jnp.asarray(img), jnp.asarray(coords)),
        jax.grad(lambda a, b: jfn(a, b)[0], argnums=(0, 1))(
            jnp.asarray(img), jnp.asarray(coords)))
    ti, tc = _t(img, True), _t(coords, True)
    got, got_f = grid_sample_2d(ti, tc, mode=mode, with_finite_mask=True)
    ((got * _t(cot)).sum() + (got_f * _t(cot_f)).sum()).backward()
    _close(got.detach(), want, 1e-6, "values")
    np.testing.assert_array_equal(got_f.detach().numpy(), np.asarray(want_f))
    assert np.asarray(want_f).min() == 0.0          # non-finite seen
    _close(ti.grad, g_img, 1e-5, "map gradient")
    g_co = np.nan_to_num(np.asarray(g_co))
    if mode == "bilinear":
        assert np.abs(g_co).max() > 0                # through the weights
        _close(tc.grad, g_co, 1e-5, "coordinate gradient")
    else:                       # rounding has no derivative, in either
        assert tc.grad is None and not g_co.any()
    # without the mask: the same samples
    np.testing.assert_array_equal(
        grid_sample_2d(_t(img), _t(coords), mode=mode).numpy(),
        got.detach().numpy())


def test_grid_sample_2d_nearest_rounds_half_to_even():
    img = np.arange(15, dtype=np.float32).reshape(1, 3, 5, 1)
    # x = 0.5, 1.5, 2.5, 3.5 and y = 0.5, 1.5 in pixels
    coords = np.array([[[-0.75, -0.5], [-0.25, -0.5], [0.25, 0.5],
                        [0.75, 0.5]]], np.float32)
    got = grid_sample_2d(_t(img), _t(coords), mode="nearest").numpy()
    want = np.asarray(jax_grid_sample(jnp.asarray(img), jnp.asarray(coords),
                                      mode="nearest"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, :, 0], [0.0, 2.0, 12.0, 14.0])


def _intrinsics(h, w, n):
    k = np.tile(np.eye(4, dtype=np.float32), n + (1, 1))
    k[..., 0, 0], k[..., 1, 1] = 0.9 * w, 0.9 * w
    k[..., 0, 2], k[..., 1, 2] = w / 2.0, h / 2.0
    return k, np.linalg.inv(k).astype(np.float32)


def _pose(rng, n, ang=0.05, trans=0.5):
    from scipy.spatial.transform import Rotation
    t = np.tile(np.eye(4, dtype=np.float32), n + (1, 1))
    rots = Rotation.from_rotvec(rng.randn(int(np.prod(n)), 3) * ang)
    t[..., :3, :3] = rots.as_matrix().reshape(n + (3, 3))
    t[..., :3, 3] = rng.randn(*n, 3) * trans
    return t.astype(np.float32)


def _warp_scene(kind):
    """(src_depth, src_mask, src_inv_k, src_k, tar_depth, tar_inv_k,
    transform) for warp_depth, leading dims [1, 2, 3]."""
    rng = np.random.RandomState(7)
    n = (1, 2, 3)
    if kind == "random":
        h, w = 16, 24
        k, ik = _intrinsics(h, w, n)
        src = rng.uniform(1.0, 250.0, n + (h, w, 1)).astype(np.float32)
        tar = rng.uniform(3.0, 40.0, n + (h, w, 1)).astype(np.float32)
        tform = _pose(rng, n)
    else:
        h, w = 5, 9
        k = ik = np.tile(np.eye(4, dtype=np.float32), n + (1, 1))
        src = rng.uniform(2.0, 50.0, n + (h, w, 1)).astype(np.float32)
        src[..., 1, 2, 0] = MIN_D
        src[..., 3, 6, 0] = MAX_D
        src[..., 2, 4, 0] = 1.0
        src[..., 0, 8, 0] = 300.0
        tar = np.full(n + (h, w, 1), 4.0, np.float32)
        tform = np.tile(np.eye(4, dtype=np.float32), n + (1, 1))
    mask = (rng.rand(*n, h, w, 1) > 0.2).astype(np.float32)
    return src, mask, ik, k, tar, ik, tform


@pytest.mark.parametrize("kind", ["random", "exact"])
def test_warp_depth_matches_jax(kind):
    src, mask, sik, sk, tar, tik, tform = _warp_scene(kind)
    rng = np.random.RandomState(8)
    cot = rng.randn(*src.shape).astype(np.float32)

    def jfn(s, t):
        d, m = jvr.warp_depth(s, jnp.asarray(mask), jnp.asarray(sik),
                              jnp.asarray(sk), t, jnp.asarray(tik),
                              jnp.asarray(tform), MIN_D, MAX_D)
        return jnp.sum(d * cot), (d, m)

    _, (want_d, want_m) = jfn(jnp.asarray(src), jnp.asarray(tar))
    g_src, g_tar = jax.grad(lambda a, b: jfn(a, b)[0], argnums=(0, 1))(
        jnp.asarray(src), jnp.asarray(tar))
    ts, tt = _t(src, True), _t(tar, True)
    got_d, got_m = tvr.warp_depth(ts, _t(mask), _t(sik), _t(sk), tt, _t(tik),
                                  _t(tform), MIN_D, MAX_D)
    (got_d * _t(cot)).sum().backward()
    _close(got_d.detach(), want_d, 1e-5, "depth")
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    want_m = np.asarray(want_m)
    assert 0.05 < want_m.mean() < 0.95
    _close(ts.grad, g_src, 1e-5, "source depth gradient")
    _close(tt.grad, g_tar, 1e-5, "target depth gradient")
    if kind == "exact":
        d = got_d.detach().numpy()
        assert (d[..., 1, 2, 0] == MIN_D).all() and (d[..., 3, 6, 0]
                                                     == MAX_D).all()
        assert (want_m[..., 1, 2, 0] == 0).all() and (want_m[..., 3, 6, 0]
                                                      == 0).all()
        # the clip's derivative at a bound: 1/2 (jnp.clip), not torch's 1
        g = ts.grad.numpy()
        np.testing.assert_allclose(g[..., 1, 2, 0], 0.5 * cot[..., 1, 2, 0],
                                   rtol=1e-6)
        np.testing.assert_array_equal(g[..., 2, 4, 0], 0.0)
    else:
        assert np.abs(np.asarray(g_tar)).max() > 0


def _render_scene():
    rng = np.random.RandomState(9)
    h, w = 32, 48
    batch = FakeDataset(num_samples=1, height=h, width=w).batch([0])
    rel_cam = jax_get_config("configs/tiny_fake.yaml").rel_cam_array
    depth = rng.uniform(2.0, 30.0, (1, 6, h, w, 1)).astype(np.float32)
    depth_aug = rng.uniform(2.0, 30.0, (1, 6, h, w, 1)).astype(np.float32)
    cam = np.tile(np.eye(4, dtype=np.float32), (1, 6, 2, 1, 1))
    cam[..., :3, 3] = rng.randn(1, 6, 2, 3) * 0.3
    ext_aug = np.asarray(jax_augment(jax.random.PRNGKey(2),
                                     jnp.asarray(batch["extrinsics"]),
                                     (0.2, 0.2, 0.5)))
    return batch, rel_cam, depth, depth_aug, cam, ext_aug


def test_render_views_depth_synthesis_branch_matches_jax():
    batch, rel_cam, depth, depth_aug, cam, ext_aug = _render_scene()
    frames = (0, -1, 1)
    rng = np.random.RandomState(10)
    cot = rng.randn(1, 6, 3, 32, 48, 1).astype(np.float32)

    def common(lib, a):
        return dict(colors={f: a(batch[f"color/{f}/0"]) for f in frames},
                    mask=a(batch["mask"]), k=a(batch["K/0"]),
                    inv_k=a(batch["inv_K/0"]), cam_t_cam=a(cam),
                    spatio_pose=None, spatio_tempo_pose=None,
                    rel_cam=a(rel_cam), frame_ids=frames, spatio=False,
                    spatio_temporal=False, aug_depth=True,
                    extrinsics=a(batch["extrinsics"]),
                    extrinsics_aug=a(ext_aug), min_depth=MIN_D,
                    max_depth=MAX_D)

    def jfn(d, da):
        r = jvr.render_views(depth=d, depth_aug=da, warp_op="quad",
                             **common(jvr, jnp.asarray))
        return jnp.sum(r.tform_depth * cot), r

    _, want = jfn(jnp.asarray(depth), jnp.asarray(depth_aug))
    g_d, g_da = jax.grad(lambda a, b: jfn(a, b)[0], argnums=(0, 1))(
        jnp.asarray(depth), jnp.asarray(depth_aug))
    td, tda = _t(depth, True), _t(depth_aug, True)
    got = tvr.render_views(depth=td, depth_aug=tda,
                           **common(tvr, lambda a: torch.from_numpy(
                               np.array(a))))
    (got.tform_depth * _t(cot)).sum().backward()
    assert got.tform_depth.shape == (1, 6, 3, 32, 48, 1)
    _close(got.tform_depth.detach(), want.tform_depth, 1e-5, "tform_depth")
    np.testing.assert_array_equal(got.tform_depth_mask.numpy(),
                                  np.asarray(want.tform_depth_mask))
    m = np.asarray(want.tform_depth_mask)
    assert 0.05 < m.mean() < 0.95 and m[:, :, 2].mean() > m[:, :, :2].mean()
    _close(td.grad, g_d, 1e-5, "depth gradient")
    _close(tda.grad, g_da, 1e-5, "aug depth gradient")


def test_depth_synthesis_loss_matches_jax():
    rng = np.random.RandomState(11)
    b, cams, h, w = 2, 6, 8, 12
    da = rng.uniform(2.0, 30.0, (b, cams, h, w, 1)).astype(np.float32)
    tf = rng.uniform(2.0, 30.0, (b, cams, 3, h, w, 1)).astype(np.float32)
    tf[:, :, 0, :3] = da[:, :, :3]                # |d_aug - d_warp| = 0
    tf[:, :, 1, 5:] = 0.0                         # con = 1: the clip's kink
    tm = (rng.rand(b, cams, 3, h, w, 1) > 0.3).astype(np.float32)
    disp = rng.uniform(0.1, 0.9, (b, cams, h, w, 1)).astype(np.float32)
    disp[..., 2:5, :, :] = 0.4                    # constant rows: abs at 0
    cot_c = rng.randn(cams).astype(np.float32)
    cot_s = rng.randn(cams).astype(np.float32)

    def jfn(a, t, d):
        con, sm = jax_synthesis_loss(a, t, jnp.asarray(tm), d)
        return jnp.sum(con * cot_c) + jnp.sum(sm * cot_s), (con, sm)

    args = [jnp.asarray(x) for x in (da, tf, disp)]
    _, (w_con, w_sm) = jfn(*args)
    grads = jax.grad(lambda *a: jfn(*a)[0], argnums=(0, 1, 2))(*args)
    ts = [_t(x, True) for x in (da, tf, disp)]
    con, sm = depth_synthesis_loss(ts[0], ts[1], _t(tm), ts[2])
    ((con * _t(cot_c)).sum() + (sm * _t(cot_s)).sum()).backward()
    _close(con.detach(), w_con, 1e-6, "consistency")
    _close(sm.detach(), w_sm, 1e-6, "smoothness")
    for name, t, g in zip(("aug depth", "warped depth", "aug disparity"),
                          ts, grads):
        _close(t.grad, g, 1e-5, name)
    # the ties took JAX's derivatives: +1 for |0|, 1/2 at the clip
    g_tf = ts[1].grad.numpy()
    assert np.abs(g_tf[:, :, 0, :3]).max() > 0


def test_aug_depth_params_equal_jax():
    k = FakeDataset(num_samples=2).batch([0, 1])["K/3"]
    want, got = jax_params(k), aug_depth_params(k)
    assert len(got) == len(want) == 767
    for (wk, *wa), (gk, *ga) in zip(want, got):
        np.testing.assert_array_equal(gk, wk)
        assert ga == wa


def test_published_augdepth_yaml_builds():
    from vfdepth_tpu_torch.training.model import VFDepthModel
    cfg = get_config(AUG_YAML)
    model = VFDepthModel(cfg, device="cpu")
    assert model.aug_depth and model.loss_cfg.aug_depth
    assert model.aug_angle == (15, 15, 40)
    assert (model.loss_cfg.depth_con_coeff,
            model.loss_cfg.depth_sm_coeff) == (0.03, 0.05)
    fn = model.depth_net.fusion_net
    assert (fn.voxel_size, fn.proj_d_bins, fn.num_cams) == ((100, 100, 20),
                                                           50, 6)
    assert (fn.img_h, fn.img_w) == (48, 80)
    # train mode keeps the sweep off, eval mode reads it
    assert not cfg.syn_visualize
    ev = get_config(AUG_YAML, mode="eval")
    assert ev.syn_visualize and ev.syn_idx == 102 and ev.batch_size == 4
