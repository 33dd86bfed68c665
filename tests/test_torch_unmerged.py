"""``tpu.merge_backprojection: false`` in the port against the JAX package,
on the CPU: each net back-projects its own features (``FusedPoseNet`` /
``FusedDepthNet`` ``forward``, the JAX ``__call__``s, through the model's
``predict_pose`` and ``predict_depth``) instead of one merged pass.

* ``predict`` on the 6-camera tiny config (grouped sampler, kernel K1, twice)
  and on the 3-camera micro config (per-camera sampler, kernel K1b, twice)
  against JAX ``predict_pose`` + ``predict_depth`` (eval mode, the f32
  gather path): disparity and depth 1e-4 of their magnitude, poses 1e-5
  absolute, as tests/test_torch_model.py holds the merged path; and against
  the port's own merged path from the same weights: the sampler is
  channel-wise, so the two agree to 1e-5 of the outputs' magnitude.
* one training step on the 3-camera rig, held as tests/test_torch_three_cam.py
  holds the merged one (the same bounds, for the same reasons; BatchNorm
  statistics come from the two nets' separate passes here).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from helpers_torch_step import (check_batchnorm, check_gradients, check_logs,
                                step_pair)
from vfdepth_tpu import presets as jpresets
from vfdepth_tpu.config import get_config as jax_get_config
from vfdepth_tpu.data.fake import FakeDataset
from vfdepth_tpu.training.model import VFDepthModel as JaxModel
from vfdepth_tpu_torch import presets
from vfdepth_tpu_torch.config import get_config
from vfdepth_tpu_torch.training.model import VFDepthModel
from vfdepth_tpu_torch.weights import load_flax_params

jax.config.update("jax_platforms", "cpu")
TINY = "configs/tiny_fake.yaml"


def _cfgs(rig):
    if rig == "6cam":
        jcfg, tcfg = jax_get_config(TINY), get_config(TINY)
    else:
        jcfg, tcfg = jpresets.micro_config(), presets.micro_config()
    for cfg in (jcfg, tcfg):
        cfg.set("merge_backprojection", False)
        cfg.set("warp_window", False)
    return jcfg, tcfg


def _batch(cfg):
    return FakeDataset(num_samples=1, num_cams=cfg.num_cams,
                       height=cfg.height, width=cfg.width,
                       fusion_level=cfg.fusion_level,
                       rig="nuscenes").batch([0])


@pytest.mark.parametrize("rig,grouped", [("6cam", True), ("3cam", False)])
def test_predict_matches_jax_and_the_merged_path(rig, grouped):
    jcfg, tcfg = _cfgs(rig)
    batch = _batch(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JaxModel(jcfg)
    assert not jm._can_merge_backproject()
    params, stats = jm.init(jax.random.PRNGKey(0), jbatch)
    cam, _ = jm.predict_pose(params["pose_net"], stats["pose_net"], jbatch,
                             False)
    disps, *_ = jm.predict_depth(params["depth_net"], stats["depth_net"],
                                 jbatch, jax.random.PRNGKey(1), False)
    want = {"cam_T_cam": cam, "disp/0": disps[0],
            "depth/0": jm.to_depth(disps[0], jbatch["K/0"])}

    model = VFDepthModel(tcfg, device="cpu")
    assert model.grouped == grouped and not model._can_merge_backproject()
    load_flax_params(model, *jax.tree_util.tree_map(np.array,
                                                    (params, stats)))
    got = model.predict(batch)
    model.merge_backproject = True
    merged = model.predict(batch)
    assert set(got) == set(want) == set(merged)
    for key, w in want.items():
        w, g = np.asarray(w), got[key].numpy()
        assert g.shape == w.shape and np.isfinite(g).all(), key
        if key == "cam_T_cam":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=key)
        np.testing.assert_allclose(merged[key].numpy(), g, rtol=0,
                                   atol=1e-5 * np.abs(g).max(), err_msg=key)


@pytest.fixture(scope="module")
def step():
    jcfg, tcfg = _cfgs("3cam")
    for cfg in (jcfg, tcfg):
        cfg.set("focal_length_scale", 15.0)
    return step_pair(jcfg, tcfg, _batch(jcfg), translation=(40.0, 20.0, 60.0))


def test_step_loss_and_scalar_logs(step):
    want, got = step["amask"]
    assert (got != want).sum() <= 12
    check_logs(step, masked_tol=3e-3)
    assert step["logs"]["spatio_tempo_loss"] > 0


@pytest.mark.parametrize("net,tol", [("depth_net", 1e-2), ("pose_net", 5e-2)])
def test_step_gradients(step, net, tol):
    check_gradients(step, net, tol)


@pytest.mark.parametrize("net", ["depth_net", "pose_net"])
def test_step_batchnorm_statistics(step, net):
    check_batchnorm(step, net)
