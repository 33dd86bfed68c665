"""The fsm (Monodepth2) baseline under mixed precision
(``tpu.mixed_precision: true``, bf16 networks) in the port against the JAX
package, on the CPU: the tiny config, 6 cameras, with
tests/test_torch_fsm_model.py's rig, motion and ``pose_loss_coeff``.

JAX runs jitted with XLA's excess precision off, as
tests/test_torch_mixed_model.py runs the fusion model, and for its
reasons; the bounds are that file's, for the same reasons (two bf16
programs part ways by flipped roundings that every later layer spreads):

* ``predict``: disparity and depth within 1e-2 of their magnitude, poses
  2e-4 absolute; the port's bf16 and f32 outputs as far apart as JAX's
  (0.5x-2x), so the nets compute in bf16;
* one training step, with batched and with unbatched pose frames: loss and
  scalar logs (``pose`` among them) within 1e-2 of their magnitude; each
  parameter's gradient within 0.5 relative L2, and each net's gradients
  taken together within 1.5x JAX's own bf16-to-f32 distance; the port's
  bf16-to-f32 distance within 0.5x-2x of JAX's; BatchNorm statistics
  within 1e-2 of their magnitude; parameters, gradients and statistics f32.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from helpers_torch_step import by_port_name, jax_step, port_step, with_motion
from test_torch_fsm_model import MOTION, fsm_cfgs, jax_predict, yawed_batch
from vfdepth_tpu.training.model import VFDepthModel as JaxModel
from vfdepth_tpu_torch.training.model import VFDepthModel
from vfdepth_tpu_torch.weights import load_flax_params
from helpers_torch_threads import port_threads  # noqa: F401

jax.config.update("jax_platforms", "cpu")
STEP = 3
STRICT = {"xla_allow_excess_precision": False}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def shared():
    jcfg, _ = fsm_cfgs()
    batch = yawed_batch(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params, stats = JaxModel(jcfg).init(jax.random.PRNGKey(0), jbatch)
    return batch, jbatch, params, stats


def _port(tcfg, params, stats):
    model = VFDepthModel(tcfg, device="cpu")
    load_flax_params(model, *jax.tree_util.tree_map(np.asarray,
                                                    (params, stats)))
    return model


def test_predict_matches_jax_in_bf16(shared):
    batch, jbatch, params, stats = shared
    out = {}
    for mixed in (False, True):
        jcfg, tcfg = fsm_cfgs(mixed=mixed)
        out[("jax", mixed)] = jax_predict(JaxModel(jcfg), params, stats,
                                          jbatch, STRICT)
        got = _port(tcfg, params, stats).predict(batch)
        out[("port", mixed)] = [got[k].numpy() for k in
                                ("cam_T_cam", "disp/0", "depth/0")]
    for i, name in enumerate(("cam_T_cam", "disp/0", "depth/0")):
        g, w = out[("port", True)][i], out[("jax", True)][i]
        assert g.shape == w.shape and g.dtype == np.float32, name
        assert np.isfinite(g).all(), name
        atol = 2e-4 if name == "cam_T_cam" else 1e-2 * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)
    for i in (0, 1):       # poses, disparity
        jax_gap = _rel(out[("jax", True)][i], out[("jax", False)][i])
        port_gap = _rel(out[("port", True)][i], out[("port", False)][i])
        assert 0.5 * jax_gap < port_gap < 2.0 * jax_gap, (i, port_gap,
                                                           jax_gap)


@pytest.fixture(scope="module", params=[True, False],
                ids=["batched", "unbatched"])
def steps(request, shared):
    """JAX's and the port's gradients, scalar logs and BatchNorm statistics
    after one step, f32 and bf16, from the same weights."""
    batch, jbatch, params, stats = shared
    params = with_motion(params, MOTION)
    out = {}
    for mixed in (False, True):
        jcfg, tcfg = fsm_cfgs(batch_pose_frames=request.param, mixed=mixed)
        grads, logs, new_stats, noise, _ = jax_step(
            JaxModel(jcfg), params, stats, jbatch, STEP, STRICT)
        out[("jax", mixed)] = dict(
            grads=by_port_name(grads),
            logs={k: float(v) for k, v in logs.items()},
            stats=by_port_name(new_stats))
        model = _port(tcfg, params, stats)
        tlogs, _ = port_step(model, batch, noise, STEP)
        out[("port", mixed)] = dict(
            model=model, logs=tlogs,
            grads={k: p.grad.numpy() for k, p in model.named_parameters()},
            stats={k: v.numpy() for k, v in model.named_buffers()})
    return out


def test_step_loss_and_logs_match_jax_in_bf16(steps):
    want, got = steps[("jax", True)]["logs"], steps[("port", True)]["logs"]
    assert set(got) == set(want) and "pose" in got
    for key, w in want.items():
        assert np.isfinite(got[key]), key
        assert abs(got[key] - w) <= 1e-2 * max(abs(w), 1e-3), (key, got[key],
                                                               w)


def _flat(steps, side, mixed, net):
    grads = steps[(side, mixed)]["grads"]
    return np.concatenate([grads[k].ravel() for k in sorted(grads)
                           if k.startswith(net + ".")])


@pytest.mark.parametrize("net", ["depth_net", "pose_net"])
def test_step_gradients_match_jax_in_bf16(steps, net):
    want = steps[("jax", True)]["grads"]
    got = steps[("port", True)]["grads"]
    names = [k for k in want if k.startswith(net + ".")]
    assert set(names) == {k for k in got if k.startswith(net + ".")}
    for name in names:
        g, w = got[name], want[name]
        assert g.dtype == np.float32 and np.isfinite(g).all(), name
        assert np.linalg.norm(w) > 0, name
        assert _rel(g, w) <= 0.5, (name, _rel(g, w))
    jax_gap = _rel(_flat(steps, "jax", True, net),
                   _flat(steps, "jax", False, net))
    port_vs_jax = _rel(_flat(steps, "port", True, net),
                       _flat(steps, "jax", True, net))
    assert port_vs_jax <= 1.5 * jax_gap, (port_vs_jax, jax_gap)
    port_gap = _rel(_flat(steps, "port", True, net),
                    _flat(steps, "port", False, net))
    assert 0.5 * jax_gap < port_gap < 2.0 * jax_gap, (port_gap, jax_gap)


def test_step_keeps_f32_state_and_matches_jax_batchnorm_in_bf16(steps):
    port = steps[("port", True)]
    for name, p in port["model"].named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
    want = steps[("jax", True)]["stats"]
    assert want
    for name, w in want.items():
        got = port["stats"][name]
        assert got.dtype == np.float32, name
        np.testing.assert_allclose(got, w, rtol=0,
                                   atol=1e-2 * np.abs(w).max(), err_msg=name)
