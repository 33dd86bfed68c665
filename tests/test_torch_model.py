"""The port's serving path as a whole against the JAX package, on the CPU.

``VFDepthModel.predict`` (port, plain versions of the kernels) against JAX
``predict_pose_depth(..., train=False)`` + ``to_depth`` on the same tiny
batch and the same weights (the flax init, carried over):

* default tiny config: merged back-projection through the ungrouped f32
  gather path on the JAX side; all f32, so outputs agree to 1e-4 of their
  magnitude (sums in another order);
* ``tpu.sampler_2d: pallas``: the grouped Pallas kernel in interpret mode,
  which rounds features and tap weights to bf16 (2^-9 relative each); the
  rounding averages down through the convolutions to ~1e-3 on disparity
  and depth: held to 3e-3 of their magnitude, poses to 1e-4.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vfdepth_tpu.config import get_config as jax_get_config
from vfdepth_tpu.data.fake import FakeDataset
from vfdepth_tpu.training.model import VFDepthModel as JaxModel
from vfdepth_tpu_torch.config import get_config
from vfdepth_tpu_torch.training.model import VFDepthModel
from vfdepth_tpu_torch.weights import load_flax_params

jax.config.update("jax_platforms", "cpu")
TINY = "configs/tiny_fake.yaml"


@pytest.fixture(scope="module")
def shared():
    cfg = jax_get_config(TINY)
    ds = FakeDataset(num_samples=1, num_cams=cfg.num_cams, height=cfg.height,
                     width=cfg.width, fusion_level=cfg.fusion_level)
    batch = ds.batch([0])
    params, stats = JaxModel(cfg).init(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    np_params, np_stats = jax.tree_util.tree_map(np.array, (params, stats))
    return batch, params, stats, np_params, np_stats


@pytest.mark.parametrize("sampler_2d,rel,pose_atol", [
    (None, 1e-4, 1e-5), ("pallas", 3e-3, 1e-4)])
def test_predict_matches_jax(shared, sampler_2d, rel, pose_atol):
    batch, params, stats, np_params, np_stats = shared
    jcfg, tcfg = jax_get_config(TINY), get_config(TINY)
    if sampler_2d:
        jcfg.set("sampler_2d", sampler_2d)
        tcfg.set("sampler_2d", sampler_2d)
    jm = JaxModel(jcfg)
    assert (jm._bp_groups is not None) == (sampler_2d == "pallas")
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
        w = np.asarray(w)
        g = got[key].numpy()
        assert g.shape == w.shape, key
        assert np.isfinite(g).all(), key
        atol = pose_atol if key == "cam_T_cam" else rel * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=key)
