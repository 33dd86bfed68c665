"""Unbatched pose frames (``tpu.batch_pose_frames: false``) in the port
against the JAX package, on the CPU: the pose net runs once per context
frame, in the order of ``frame_ids[1:]`` (the reference VFDepth's own way of
predicting pose), and the two nets back-project their own features (JAX
``_can_merge_backproject`` is off), so kernel K1 runs three times.

The tiny config (``configs/tiny_fake.yaml``, frames (0, -1, 1), batch 1,
``tpu.warp_window`` off), f32, from the flax init carried over; JAX's CPU
path runs the f32 gather sampler, the port the plain versions of its
kernels:

* ``predict`` against JAX ``predict_pose`` + ``predict_depth`` (eval mode):
  disparity and depth 1e-4 of their magnitude, poses 1e-5 absolute, as
  tests/test_torch_model.py holds the merged path (sums in another order);
  in eval mode one pass per frame computes what one batched pass does, so
  the step below is what tells the two apart;
* one training step, with tests/test_torch_train_step.py's tolerances and
  for its reasons: the auto-masks agree on all but 12 of 36,864 pixels
  (0.03%; a near-tie flips between two f32 evaluations); loss and scalar
  logs 2e-5 of their magnitude, 1e-3 for the four that average over the
  auto-mask; gradients, as a relative L2 error, 5e-3 (depth net) and 5e-2
  (pose net); the BatchNorm running statistics 1e-5 of their magnitude.
  Each pose pass normalises with its own batch statistics and updates the
  running statistics in turn (the -1 pair first, then the +1 pair): the
  statistics after the step are held against JAX's, which threads them
  through its loop, and against the order reversed, which must miss them.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from helpers_torch_step import (by_port_name, check_batchnorm,
                                check_gradients, check_logs, step_pair)
from vfdepth_tpu.config import get_config as jax_get_config
from vfdepth_tpu.data.fake import FakeDataset
from vfdepth_tpu.training.model import VFDepthModel as JaxModel
from vfdepth_tpu_torch.config import get_config
from vfdepth_tpu_torch.training.model import VFDepthModel
from vfdepth_tpu_torch.weights import load_flax_params
from helpers_torch_threads import port_threads  # noqa: F401

jax.config.update("jax_platforms", "cpu")
TINY = "configs/tiny_fake.yaml"


def _cfgs():
    jcfg, tcfg = jax_get_config(TINY), get_config(TINY)
    for cfg in (jcfg, tcfg):
        cfg.set("batch_pose_frames", False)
        cfg.set("warp_window", False)
    return jcfg, tcfg


def _batch(cfg):
    return FakeDataset(num_samples=1, num_cams=cfg.num_cams,
                       height=cfg.height, width=cfg.width,
                       fusion_level=cfg.fusion_level).batch([0])


def test_predict_matches_jax():
    jcfg, tcfg = _cfgs()
    batch = _batch(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JaxModel(jcfg)
    assert not jm._can_merge_backproject()
    params, stats = jm.init(jax.random.PRNGKey(0), jbatch)

    @jax.jit
    def run(params, stats, batch):
        cam, _ = jm.predict_pose(params["pose_net"], stats["pose_net"],
                                 batch, False)
        disps, *_ = jm.predict_depth(params["depth_net"], stats["depth_net"],
                                     batch, jax.random.PRNGKey(1), False)
        return cam, disps[0], jm.to_depth(disps[0], batch["K/0"])
    want = dict(zip(("cam_T_cam", "disp/0", "depth/0"),
                    map(np.asarray, run(params, stats, jbatch))))

    model = VFDepthModel(tcfg, device="cpu")
    assert not model._can_merge_backproject()
    load_flax_params(model, *jax.tree_util.tree_map(np.array,
                                                    (params, stats)))
    got = model.predict(batch)
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key].numpy()
        assert g.shape == w.shape and np.isfinite(g).all(), key
        atol = 1e-5 if key == "cam_T_cam" else 1e-4 * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=key)


@pytest.fixture(scope="module")
def step():
    jcfg, tcfg = _cfgs()
    return step_pair(jcfg, tcfg, _batch(jcfg))


def test_step_auto_masks_agree(step):
    want, got = step["amask"]
    assert got.shape == want.shape
    assert 0.1 < want.mean() < 0.9
    assert (got != want).sum() <= 12


def test_step_loss_and_scalar_logs(step):
    check_logs(step, masked_tol=1e-3)


@pytest.mark.parametrize("net,tol", [("depth_net", 5e-3), ("pose_net", 5e-2)])
def test_step_gradients(step, net, tol):
    check_gradients(step, net, tol)


@pytest.mark.parametrize("net", ["depth_net", "pose_net"])
def test_step_batchnorm_statistics(step, net):
    check_batchnorm(step, net)


def test_step_pose_statistics_follow_the_frame_order(step):
    """The pose passes of a train-mode forward with the context frames in
    the other order ((0, 1, -1): the +1 pair first) leave running
    statistics that miss JAX's by far more than the tolerance; in the
    config's order they match (the step above)."""
    _, tcfg = _cfgs()
    batch = _batch(tcfg)
    want = by_port_name({"pose_net": step["new_stats"]["pose_net"]})
    for frames, agrees in (((0, -1, 1), True), ((0, 1, -1), False)):
        tcfg.set("frame_ids", list(frames))
        model = VFDepthModel(tcfg, device="cpu")
        load_flax_params(model, *step["weights"])
        with torch.no_grad(), model._bn_mode(True):
            model.predict_pose(model._to_device(batch))
        bufs = dict(model.named_buffers())
        worst = max(np.abs(bufs[k].numpy() - w).max() / np.abs(w).max()
                    for k, w in want.items())
        assert (worst <= 1e-5) == agrees, (frames, worst)
