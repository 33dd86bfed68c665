"""The JAX package's default windowed warps against the port's dense ones,
on the CPU.

JAX's ``tpu.warp_window: true`` (its default) sizes static windows around
the pixels that can see a neighbouring camera (``configure_warp_window``)
and warps only inside them; the port always warps densely, which by
construction computes the same images, masks and gradients wherever the
windows hold every such pixel (``geometry/view_rendering.py``). Here JAX
sizes real windows and runs its windowed step; the port runs its dense step
from the same weights, batch and tie-break noise.

``presets.micro_config`` on ``FakeDataset``'s "nuscenes" rig at 128x256
and a focal-length scale of 15 (depths ~10 m, ego-motion 0.2-0.6 m): on
this canvas JAX sizes spatial windows of ((128, 128), (48, 64)) and
spatio-temporal ones of ((128, 192), (16, 64)), a fraction of the image
(at the micro config's own 32x64 every window is the whole image and JAX
warps densely). The step's ``warp_window_overflow`` is 0: no pixel that
sees a neighbour falls outside its window. Tolerances as
tests/test_torch_three_cam.py holds the same rig's dense step, for its
reasons: the auto-masks agree on all but 0.2% of the pixels; loss and
scalar logs 2e-5 of their magnitude, 3e-3 for the four that average over
the auto-mask; gradients, as a relative L2 error, 1e-2 (depth net) and
5e-2 (pose net); BatchNorm statistics 1e-5.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from helpers_torch_step import (check_batchnorm, check_gradients, check_logs,
                                jax_step, port_step, with_motion)
from vfdepth_tpu import presets as jpresets
from vfdepth_tpu.data.fake import FakeDataset
from vfdepth_tpu.training.model import VFDepthModel as JaxModel
from vfdepth_tpu_torch import presets
from vfdepth_tpu_torch.training.model import VFDepthModel
from vfdepth_tpu_torch.weights import load_flax_params

jax.config.update("jax_platforms", "cpu")
SIZE = dict(height=128, width=256)


def _cfg(module):
    cfg = module.micro_config(**SIZE)
    cfg.set("focal_length_scale", 15.0)
    return cfg


@pytest.fixture(scope="module")
def windowed():
    jcfg, tcfg = _cfg(jpresets), _cfg(presets)
    assert jcfg.get("warp_window", True)       # the JAX default
    batch = FakeDataset(num_samples=1, num_cams=jcfg.num_cams,
                        height=jcfg.height, width=jcfg.width,
                        fusion_level=jcfg.fusion_level,
                        rig="nuscenes").batch([0])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JaxModel(jcfg)
    jm.configure_warp_window(batch)
    params, stats = jm.init(jax.random.PRNGKey(0), jbatch)
    params = with_motion(params, (40.0, 20.0, 60.0))
    np_grads, logs, np_new_stats, noise, amask = jax_step(jm, params, stats,
                                                          jbatch)
    np_params, np_stats = jax.tree_util.tree_map(np.asarray, (params, stats))
    model = VFDepthModel(tcfg, device="cpu")
    load_flax_params(model, np_params, np_stats)
    tlogs, tmask = port_step(model, batch, noise)
    logs = {k: float(v) for k, v in logs.items()}
    return dict(window_hw=(jm.warp_window, jm.warp_window_hw),
                overflow=logs.pop("warp_window_overflow", None),
                np_grads=np_grads, new_stats=np_new_stats, model=model,
                logs=logs, tlogs=tlogs, amask=(amask, tmask))


def test_jax_sizes_windows_and_none_overflows(windowed):
    on, (spatio_hw, st_hw) = windowed["window_hw"]
    assert on and spatio_hw is not None and st_hw is not None
    area = SIZE["height"] * SIZE["width"]
    for hw in (spatio_hw, st_hw):
        assert sum(h * w for h, w in hw) < 0.9 * area, hw
    assert windowed["overflow"] == 0.0


def test_auto_masks_agree(windowed):
    want, got = windowed["amask"]
    assert got.shape == want.shape
    assert 0.05 < want.mean() < 0.95
    assert (got != want).sum() <= 2e-3 * want.size


def test_loss_and_scalar_logs(windowed):
    check_logs(windowed, masked_tol=3e-3)
    assert windowed["logs"]["spatio_loss"] > 0
    assert windowed["logs"]["spatio_tempo_loss"] > 0


@pytest.mark.parametrize("net,tol", [("depth_net", 1e-2), ("pose_net", 5e-2)])
def test_gradients(windowed, net, tol):
    check_gradients(windowed, net, tol)


@pytest.mark.parametrize("net", ["depth_net", "pose_net"])
def test_batchnorm_statistics(windowed, net):
    check_batchnorm(windowed, net)
