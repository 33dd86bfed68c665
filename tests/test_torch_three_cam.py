"""The 3-camera front rig (DDAD's front three cameras, overlap groups
([0], [1, 2]): unequal, so the back-projection runs per camera, kernel
K1b) of the port against the JAX package, on the CPU.

``presets.micro_config`` (32x64, 12x12x4 voxels) on ``FakeDataset``'s
"nuscenes" rig (front and +-55 degrees, so cameras 1 and 2 overlap camera
0), from the flax init carried over; JAX's CPU path runs the ungrouped f32
gather sampler, the port the plain versions of its kernels:

* the per-camera back-projection: features 1e-4 of their magnitude (same
  f32 arithmetic in another order), validity and counts exact;
* the camera poses and renders with one neighbour missing: ``rel_cam`` holds
  -1 for cameras 1 and 2, which both frameworks index as the last camera
  and mask later; poses 1e-5, renders 1e-4, masks exact, as
  tests/test_torch_render.py holds the 6-camera rig;
* ``predict``: disparity and depth 1e-4 of their magnitude, poses 1e-5
  absolute, as tests/test_torch_model.py;
* one training step, as tests/test_torch_train_step.py holds the 6-camera
  one. At the micro config's focal-length scale (300) the metric depth is
  ~0.5 m and no camera sees into its neighbours (both frameworks give a
  spatial and a spatio-temporal loss of exactly 0), so the step runs at a
  scale of 15 (depths ~10 m) with an ego-motion of 0.2-0.6 m, where both
  terms are live. The auto-masks then agree on all but 12 of the 6,144
  pixels (0.2%; measured 5); loss and scalar logs agree to 2e-5 of their
  magnitude, 3e-3 for the four that average over the auto-mask (one
  flipped pixel moves them ~4e-4; measured 4e-4); gradients, as a relative
  L2 error, to 1e-2 (depth net; measured 3.9e-3: a flipped pixel weighs 6x
  more among 6,144 pixels than among the 6-camera test's 36,864) and 5e-2
  (pose net; measured 2.9e-3); BatchNorm statistics to 1e-5;
* the parameter tree does not depend on the number of cameras: the flax
  tree of the 6-camera model of the same widths loads into the 3-camera
  port model.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from helpers_torch_step import (check_batchnorm, check_gradients, check_logs,
                                step_pair)
from vfdepth_tpu import presets as jpresets
from vfdepth_tpu.config import DDAD_CAM_LIST
from vfdepth_tpu.data.fake import FakeDataset
from vfdepth_tpu.geometry import pose as jpose
from vfdepth_tpu.geometry import view_rendering as jvr
from vfdepth_tpu.models import vfnet as jvfnet
from vfdepth_tpu.training.model import VFDepthModel as JaxModel
from vfdepth_tpu_torch import presets
from vfdepth_tpu_torch.geometry import pose as tpose
from vfdepth_tpu_torch.geometry import view_rendering as tvr
from vfdepth_tpu_torch.models.vfnet import backproject_features
from vfdepth_tpu_torch.training.model import VFDepthModel
from vfdepth_tpu_torch.weights import load_flax_params

jax.config.update("jax_platforms", "cpu")
FRAMES = (0, -1, 1)


def _cfgs(**over):
    jcfg, tcfg = jpresets.micro_config(**over), presets.micro_config(**over)
    for cfg in (jcfg, tcfg):
        cfg.set("warp_window", False)
    return jcfg, tcfg


def _batch(cfg, b=1):
    return FakeDataset(num_samples=b, num_cams=cfg.num_cams,
                       height=cfg.height, width=cfg.width,
                       fusion_level=cfg.fusion_level,
                       rig="nuscenes").batch(list(range(b)))


def _close(got, want, rel, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-12),
                               err_msg=what)


def test_the_rig_runs_the_ungrouped_sampler():
    jcfg, tcfg = _cfgs()
    assert tcfg.num_cams == 3 and tuple(map(tuple, tcfg.overlap_groups)) == (
        (0,), (1, 2))
    assert not VFDepthModel(tcfg, device="cpu").grouped
    assert tcfg.rel_cam_array.tolist() == [[1, 2], [0, -1], [0, -1]]
    assert jcfg.rel_cam_array.tolist() == tcfg.rel_cam_array.tolist()


def test_backproject_features_matches_jax_gather_path():
    jcfg, _ = _cfgs()
    batch = _batch(jcfg)
    rng = np.random.RandomState(0)
    h, w = jcfg.height // 8, jcfg.width // 8
    feats = rng.randn(1, 3, h, w, 6).astype(np.float32)
    mask = (rng.rand(1, 3, jcfg.height, jcfg.width, 1) > 0.2).astype(
        np.float32)
    vox = dict(voxel_str_p=tuple(jcfg.voxel_str_p),
               voxel_unit_size=tuple(jcfg.voxel_unit_size),
               voxel_size=tuple(jcfg.voxel_size))
    args = (feats, mask, batch["K/3"], batch["extrinsics_inv"])
    jf, jv, jc = jvfnet.backproject_features(*map(jnp.asarray, args),
                                             sampler_2d="gather", **vox)
    tf, tv, tc = backproject_features(*map(torch.from_numpy, args), **vox)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tc.max() >= 2              # overlapping cameras are exercised
    _close(tf.numpy(), jf, 1e-4)


def _scene(seed):
    jcfg, _ = _cfgs()
    batch = _batch(jcfg)
    rng = np.random.RandomState(seed)
    h, w = jcfg.height, jcfg.width
    depth = rng.uniform(2.0, 30.0, (1, 3, h, w, 1)).astype(np.float32)
    cam = np.tile(np.eye(4, dtype=np.float32), (1, 3, 2, 1, 1))
    ang = rng.randn(1, 3, 2) * 0.01
    cam[..., 0, 0] = cam[..., 1, 1] = np.cos(ang)
    cam[..., 0, 1], cam[..., 1, 0] = -np.sin(ang), np.sin(ang)
    cam[..., :3, 3] = rng.randn(1, 3, 2, 3) * 0.3
    return batch, jcfg.rel_cam_array, depth, cam.astype(np.float32)


def test_camera_poses_and_renders_with_a_missing_neighbour():
    batch, rel_cam, depth, cam = _scene(1)
    colors = {f: batch[f"color/{f}/0"] for f in FRAMES}
    e, ei = batch["extrinsics"], batch["extrinsics_inv"]
    k, ik = batch["K/0"], batch["inv_K/0"]
    js, jst = jpose.relative_cam_poses(*map(jnp.asarray, (e, ei, cam,
                                                          rel_cam)))
    ts, tst = tpose.relative_cam_poses(*map(torch.from_numpy, (e, ei, cam)),
                                       torch.from_numpy(rel_cam).long())
    _close(ts.numpy(), js, 1e-5, "spatio")
    _close(tst.numpy(), jst, 1e-5, "spatio_tempo")
    jr = jvr.render_views({f: jnp.asarray(c) for f, c in colors.items()},
                          jnp.asarray(batch["mask"]), jnp.asarray(k),
                          jnp.asarray(ik), jnp.asarray(depth),
                          jnp.asarray(cam), js, jst, jnp.asarray(rel_cam),
                          FRAMES, do_intensity_align=True, warp_op="quad")
    tr = tvr.render_views({f: torch.from_numpy(c) for f, c in colors.items()},
                          torch.from_numpy(batch["mask"]),
                          torch.from_numpy(k), torch.from_numpy(ik),
                          torch.from_numpy(depth), torch.from_numpy(cam), ts,
                          tst, torch.from_numpy(rel_cam), FRAMES,
                          do_intensity_align=True)
    for field in ("temporal_img", "overlap_img"):
        _close(getattr(tr, field).numpy(), getattr(jr, field), 1e-4, field)
    for field in ("temporal_mask", "overlap_mask"):
        np.testing.assert_array_equal(getattr(tr, field).numpy(),
                                      np.asarray(getattr(jr, field)),
                                      err_msg=field)
    # the side cameras see only their one neighbour, the front camera two
    assert 0 < np.asarray(jr.overlap_mask)[:, 1:].mean() < np.asarray(
        jr.overlap_mask)[:, :1].mean()


@pytest.fixture(scope="module")
def init():
    jcfg, _ = _cfgs()
    batch = _batch(jcfg)
    params, stats = JaxModel(jcfg).init(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    return batch, params, stats, *jax.tree_util.tree_map(np.array,
                                                         (params, stats))


def test_predict_matches_jax(init):
    batch, params, stats, np_params, np_stats = init
    jcfg, tcfg = _cfgs()
    jm = JaxModel(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    cam, disps, *_ = jm.predict_pose_depth(params, stats, jbatch,
                                           jax.random.PRNGKey(1), False)
    want = {"cam_T_cam": cam, "disp/0": disps[0],
            "depth/0": jm.to_depth(disps[0], jbatch["K/0"])}
    model = VFDepthModel(tcfg, device="cpu")
    load_flax_params(model, np_params, np_stats)
    got = model.predict(batch)
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key].numpy()
        assert g.shape == np.asarray(w).shape, key
        assert np.isfinite(g).all(), key
        if key == "cam_T_cam":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=key)
        else:
            _close(g, w, 1e-4, key)


def test_six_camera_parameters_load_into_the_three_camera_model(init):
    """The flax tree does not depend on the number of cameras."""
    _, _, _, np_params, np_stats = init
    jcfg6 = jpresets.micro_config(cameras=DDAD_CAM_LIST)
    batch6 = FakeDataset(num_samples=1, num_cams=6, height=jcfg6.height,
                         width=jcfg6.width,
                         fusion_level=jcfg6.fusion_level).batch([0])
    p6, s6 = JaxModel(jcfg6).init(
        jax.random.PRNGKey(2), {k: jnp.asarray(v) for k, v in batch6.items()})
    p6, s6 = jax.tree_util.tree_map(np.array, (p6, s6))
    assert (jax.tree_util.tree_map(np.shape, (p6, s6))
            == jax.tree_util.tree_map(np.shape, (np_params, np_stats)))
    model = VFDepthModel(_cfgs()[1], device="cpu")
    load_flax_params(model, p6, s6)             # raises on any gap
    name, p = next(iter(model.named_parameters()))
    assert p.abs().max() > 0, name


@pytest.fixture(scope="module")
def step():
    jcfg, tcfg = _cfgs()
    for cfg in (jcfg, tcfg):
        cfg.set("focal_length_scale", 15.0)
    return step_pair(jcfg, tcfg, _batch(jcfg), translation=(40.0, 20.0, 60.0))


def test_step_auto_masks_agree(step):
    want, got = step["amask"]
    assert got.shape == want.shape
    assert 0.05 < want.mean() < 0.95
    assert (got != want).sum() <= 12


def test_step_loss_and_scalar_logs(step):
    check_logs(step, masked_tol=3e-3)
    # the overlap terms are live, on cameras with one neighbour and two
    assert step["logs"]["spatio_loss"] > 0
    assert step["logs"]["spatio_tempo_loss"] > 0


@pytest.mark.parametrize("net,tol", [("depth_net", 1e-2), ("pose_net", 5e-2)])
def test_step_gradients(step, net, tol):
    check_gradients(step, net, tol)


@pytest.mark.parametrize("net", ["depth_net", "pose_net"])
def test_step_batchnorm_statistics(step, net):
    check_batchnorm(step, net)
