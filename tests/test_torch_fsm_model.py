"""The fsm (Monodepth2) baseline as a whole in the port against the JAX
package, on the CPU, in f32: ``model.depth_model: fsm`` and
``model.pose_model: fsm`` (``configs/ddad/ddad_baseline.yaml``'s nets) on the
tiny config (6 cameras at 64x96, ``tpu.warp_window`` off), with the
baseline's ``pose_loss_coeff`` 0.1, from the flax init carried over.

* ``predict`` against JAX ``predict_pose`` + ``predict_depth`` (eval mode),
  with batched and unbatched pose frames: disparity and depth 1e-4 of their
  magnitude, poses 1e-5 absolute (tests/test_torch_model.py's bounds);
* one training step against JAX's (``helpers_torch_step``), with batched
  and unbatched pose frames, with tests/test_torch_train_step.py's bounds
  and for its reasons: auto-masks within 12 pixels, loss and scalar logs
  (the ``pose`` consistency term among them) 2e-5 of their magnitude and
  1e-3 for those over the auto-mask, gradients 5e-3 (depth net) and 5e-2
  (pose net) relative L2, BatchNorm statistics 1e-5;
* a mixed pair (the fusion depth net, the fsm pose net) serves as JAX's;
* a JAX checkpoint of the fsm nets converts
  (``scripts/convert_jax_checkpoint.py``) and evaluates as JAX's does, with
  ``models_to_load: [depth_net]`` as the baseline config loads
  (tests/test_torch_convert_checkpoint.py's bounds).

The batch's rig is ``FakeDataset``'s yawed by 0.1 rad: on the unyawed rig
camera 0's alignment into its own frame is exact, and JAX's gradient of the
pose-consistency loss is nan there (tests/test_torch_fsm_modules.py shows
it against the port's finite one), so no gradient could be compared. The
pose head's motion bias is 0.04, 0.02, 0.06 m: with the default 0.02, 0.01,
0.03 m of ``helpers_torch_step.with_motion`` the per-camera warps of the
fsm nets leave 21 pixels of the auto-mask within the f32 rounding of a tie.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from helpers_torch_step import (check_batchnorm, check_gradients, check_logs,
                                step_pair)
from test_torch_convert_checkpoint import (FRACTION_PIXELS, METRIC_RTOL,
                                           _converter, _fake,
                                           _with_random_adam)
from vfdepth_tpu.config import get_config as jax_get_config
from vfdepth_tpu.data.fake import FakeDataset as JaxFake
from vfdepth_tpu.data.loader import BatchLoader as JaxLoader
from vfdepth_tpu.geometry.se3 import vec_to_matrix
from vfdepth_tpu.training.checkpoint import save_checkpoint as jax_save
from vfdepth_tpu.training.model import VFDepthModel as JaxModel
from vfdepth_tpu.training.step import create_train_state as jax_create_state
from vfdepth_tpu.training.trainer import Trainer as JaxTrainer
from vfdepth_tpu_torch.config import get_config
from vfdepth_tpu_torch.data import BatchLoader, FakeDataset
from vfdepth_tpu_torch.training.model import VFDepthModel
from vfdepth_tpu_torch.training.trainer import Trainer
from vfdepth_tpu_torch.utils.metrics import METRIC_NAMES
from vfdepth_tpu_torch.weights import load_flax_params
from helpers_torch_threads import port_threads  # noqa: F401

jax.config.update("jax_platforms", "cpu")
TINY = "configs/tiny_fake.yaml"
MOTION = (4.0, 2.0, 6.0)


def fsm_cfgs(depth_model="fsm", pose_model="fsm", batch_pose_frames=True,
             mixed=False):
    jcfg, tcfg = jax_get_config(TINY), get_config(TINY)
    for cfg in (jcfg, tcfg):
        cfg.set("depth_model", depth_model)
        cfg.set("pose_model", pose_model)
        cfg.set("batch_pose_frames", batch_pose_frames)
        cfg.set("mixed_precision", mixed)
        cfg.set("warp_window", False)
        cfg.set("pose_loss_coeff", 0.1)
    return jcfg, tcfg


def yawed_batch(cfg):
    batch = FakeDataset(num_samples=1, num_cams=cfg.num_cams,
                        height=cfg.height, width=cfg.width,
                        fusion_level=cfg.fusion_level).batch([0])
    yaw = np.asarray(vec_to_matrix(jnp.asarray([0.0, 0.0, 0.1]),
                                   jnp.zeros(3)))
    batch["extrinsics"] = (yaw @ batch["extrinsics"]).astype(np.float32)
    batch["extrinsics_inv"] = np.linalg.inv(batch["extrinsics"]).astype(
        np.float32)
    return batch


def jax_predict(jm, params, stats, jbatch, compiler_options=None):
    """JAX ``predict_pose`` + ``predict_depth`` in eval mode, jitted:
    (cam_T_cam, disp/0, depth/0) as numpy."""
    def run(params, stats, batch):
        cam, _ = jm.predict_pose(params["pose_net"], stats["pose_net"],
                                 batch, False)
        disps, *_ = jm.predict_depth(params["depth_net"], stats["depth_net"],
                                     batch, jax.random.PRNGKey(1), False)
        return cam, disps[0], jm.to_depth(disps[0], batch["K/0"])
    fn = jax.jit(run).lower(params, stats, jbatch).compile(
        compiler_options=compiler_options)
    return [np.asarray(a, np.float32) for a in fn(params, stats, jbatch)]


@pytest.mark.parametrize("depth_model,pose_model,batch_pose_frames", [
    ("fsm", "fsm", True), ("fsm", "fsm", False), ("fusion", "fsm", True)],
    ids=["fsm-batched", "fsm-unbatched", "fusion-depth-fsm-pose"])
def test_predict_matches_jax(depth_model, pose_model, batch_pose_frames):
    jcfg, tcfg = fsm_cfgs(depth_model, pose_model, batch_pose_frames)
    batch = yawed_batch(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JaxModel(jcfg)
    assert not jm._can_merge_backproject()
    params, stats = jm.init(jax.random.PRNGKey(0), jbatch)
    want = dict(zip(("cam_T_cam", "disp/0", "depth/0"),
                    jax_predict(jm, params, stats, jbatch)))

    model = VFDepthModel(tcfg, device="cpu")
    assert not model._can_merge_backproject()
    load_flax_params(model, *jax.tree_util.tree_map(np.array,
                                                    (params, stats)))
    got = model.predict(batch)
    assert set(got) == set(want)
    cams = want["cam_T_cam"]
    if pose_model == "fsm":      # a pose per camera, not one distributed
        assert np.abs(cams[0, 0] - cams[0, 1]).max() > 1e-4
    for key, w in want.items():
        g = got[key].numpy()
        assert g.shape == w.shape and np.isfinite(g).all(), key
        atol = 1e-5 if key == "cam_T_cam" else 1e-4 * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=key)


@pytest.fixture(scope="module", params=[True, False],
                ids=["batched", "unbatched"])
def step(request):
    jcfg, tcfg = fsm_cfgs(batch_pose_frames=request.param)
    return step_pair(jcfg, tcfg, yawed_batch(jcfg), translation=MOTION)


def test_step_auto_masks_agree(step):
    want, got = step["amask"]
    assert got.shape == want.shape
    assert 0.1 < want.mean() < 0.9
    assert (got != want).sum() <= 12


def test_step_loss_and_scalar_logs(step):
    assert "pose" in step["logs"] and step["logs"]["pose"] > 0
    check_logs(step, masked_tol=1e-3)


@pytest.mark.parametrize("net,tol", [("depth_net", 5e-3), ("pose_net", 5e-2)])
def test_step_gradients(step, net, tol):
    check_gradients(step, net, tol)


@pytest.mark.parametrize("net", ["depth_net", "pose_net"])
def test_step_batchnorm_statistics(step, net):
    check_batchnorm(step, net)


def test_fsm_checkpoint_converts_and_evaluates_as_jax(tmp_path):
    """The baseline's nets saved by JAX (orbax, with an Adam state),
    converted, and scored by both packages' ``Trainer.evaluate`` loading
    ``models_to_load: [depth_net]``."""
    jcfg, tcfg = fsm_cfgs()
    for cfg, side in ((jcfg, "jax"), (tcfg, "port")):
        cfg.set("models_to_load", ["depth_net"])
        cfg.set("log_path", str(tmp_path / f"{side}_log"))
    jm = JaxModel(jcfg)
    jbatch = {k: jnp.asarray(v)
              for k, v in _fake(JaxFake, jcfg).batch([0]).items()}
    state, _ = jax_create_state(jm, jax.random.PRNGKey(0), jbatch,
                                steps_per_epoch=4)
    state = _with_random_adam(state)
    jax_dir = jax_save(str(tmp_path / "jax"), 0, state)
    port_dir = _converter().convert(jax_dir, tcfg, str(tmp_path / "port"), 0)
    jcfg.set("load_weights_dir", jax_dir)
    tcfg.set("load_weights_dir", port_dir)

    want = JaxTrainer(jcfg, jm, use_tb=False).evaluate(
        JaxLoader(_fake(JaxFake, jcfg), 1, shuffle=False, num_workers=0),
        state, load_weights=True)
    model = VFDepthModel(tcfg, device="cpu", seed=11)
    loader = BatchLoader(_fake(FakeDataset, tcfg), 1, shuffle=False,
                         num_workers=0)
    got = Trainer(tcfg, model, use_tb=False).evaluate(loader)
    depth_state = model.depth_net.state_dict()
    fresh = VFDepthModel(tcfg, device="cpu", seed=11)
    assert any(not np.array_equal(v.numpy(),
                                  fresh.depth_net.state_dict()[k].numpy())
               for k, v in depth_state.items())     # loaded, not the seed
    valid = min(int(((b["depth"] > tcfg.eval_min_depth)
                     & (b["depth"] < tcfg.eval_max_depth)).sum(axis=(2, 3, 4))
                    .min()) for b in loader)
    assert valid > 100
    for g, w in zip(got, want):
        assert set(g) == set(w) == set(METRIC_NAMES)
        for k in METRIC_NAMES:
            assert np.isfinite(g[k]), k
            tol = (FRACTION_PIXELS / valid if k in ("a1", "a2", "a3")
                   else METRIC_RTOL * abs(w[k]))
            assert abs(g[k] - w[k]) <= tol, (k, g[k], w[k])


@pytest.mark.parametrize("config", ["configs/ddad/ddad_baseline.yaml",
                                    "configs/nuscenes/nusc_baseline.yaml"])
def test_published_baseline_configs_train(config):
    """The published fsm configs hold no voxel keys; the port builds them
    (the JAX package reads the voxel keys for every pair and raises), and a
    training forward gives a finite loss with the pose-consistency term,
    here at 64x96."""
    cfg = get_config(config)
    assert cfg.depth_model == cfg.pose_model == "fsm"
    assert cfg.get("voxel_str_p") is None
    cfg.set("height", 64)
    cfg.set("width", 96)
    model = VFDepthModel(cfg, device="cpu")
    batch = FakeDataset(num_samples=1, num_cams=cfg.num_cams, height=64,
                        width=96, fusion_level=cfg.fusion_level).batch([0])
    _, loss, logs = model(batch, step=0,
                          noise=torch.zeros(model.noise_shape(batch)))
    assert np.isfinite(float(loss)) and float(logs["pose"]) > 0
