"""Mixed precision (``tpu.mixed_precision: true``) on the 3-camera front rig
in the port against the JAX package, on the CPU: the per-camera sampler in
its bf16 forms (kernels K1b and K2b), merged and unmerged
(``tpu.merge_backprojection: false``: each net's own back-projection).

``presets.micro_config(mixed_precision=True)`` (32x64, 12x12x4 voxels) on
``FakeDataset``'s "nuscenes" rig, from the flax init carried over; JAX runs
jitted once per config with XLA's excess precision off, as
tests/test_torch_mixed_model.py runs it (its CPU path takes the gather
sampler, which rounds its tap weights to bf16 and sums the taps in bf16;
the port's K1b combines in f32 and rounds once). The tolerances are that
file's, for its reasons: two bf16 programs that round the same values at
the same points part ways by an ulp here and there, and each later bf16
layer spreads the flips, so port-vs-JAX sits about as far apart as JAX bf16
from JAX f32:

* ``predict``: disparity and depth 1e-2 of their magnitude, poses 2e-4;
  the port computes in bf16: its bf16 and f32 outputs differ as JAX's do
  (within 2x);
* one training step at ``focal_length_scale`` 5 (depths ~30 m), where the
  overlap losses are live in every camera: at 15
  (tests/test_torch_three_cam.py) the spatio-temporal overlap left under
  the auto-mask holds 3 pixels in one camera, so a single flip of the auto-mask between two bf16 runs
  (they differ in ~40 of 6,144 pixels, f32 runs in ~5) moves that
  camera's masked mean from 0.44 to 0; at 5 each camera keeps 95 pixels or
  more. Loss and scalar logs within 1e-2 of their magnitude (measured
  5.7e-3 at worst); each parameter's gradient within 0.5 relative L2
  (measured 0.46, where JAX's own bf16 and f32 gradients of that
  parameter differ by 0.48); each net's gradients together within 1.5x
  JAX's bf16-vs-f32 difference; the port's bf16 and f32 gradients differ
  as JAX's do (within 2x); BatchNorm statistics within 3e-2 of their
  magnitude (measured 1.8e-2: the micro config's deepest maps are 1x2
  pixels, so a channel's statistics average 6 values and keep the bf16
  spread that larger maps average down; JAX's own bf16 and f32 statistics
  differ by up to 2.5e-2 there); parameters and gradients f32.

The casting points of the per-camera fusion are checked per module, where
the check discriminates (tests/test_torch_mixed_modules.py).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from helpers_torch_step import by_port_name, jax_step, port_step, with_motion
from vfdepth_tpu import presets as jpresets
from vfdepth_tpu.data.fake import FakeDataset
from vfdepth_tpu.training.model import VFDepthModel as JaxModel
from vfdepth_tpu_torch import presets
from vfdepth_tpu_torch.training.model import VFDepthModel
from vfdepth_tpu_torch.weights import load_flax_params
from helpers_torch_threads import port_threads  # noqa: F401

jax.config.update("jax_platforms", "cpu")
STRICT = {"xla_allow_excess_precision": False}
STEP = 3
RUNS = [(True, True), (True, False), (False, True)]   # (mixed, merged)


def _cfgs(mixed: bool, merged: bool, **over):
    jcfg = jpresets.micro_config(mixed_precision=mixed)
    tcfg = presets.micro_config(mixed_precision=mixed)
    for cfg in (jcfg, tcfg):
        cfg.set("warp_window", False)
        cfg.set("merge_backprojection", merged)
        for key, value in over.items():
            cfg.set(key, value)
    return jcfg, tcfg


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def shared():
    jcfg, _ = _cfgs(False, True)
    batch = FakeDataset(num_samples=1, num_cams=jcfg.num_cams,
                        height=jcfg.height, width=jcfg.width,
                        fusion_level=jcfg.fusion_level,
                        rig="nuscenes").batch([0])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params, stats = JaxModel(jcfg).init(jax.random.PRNGKey(0), jbatch)
    return batch, jbatch, params, stats


def _port(tcfg, params, stats):
    model = VFDepthModel(tcfg, device="cpu")
    load_flax_params(model, *jax.tree_util.tree_map(np.asarray,
                                                    (params, stats)))
    return model


@pytest.fixture(scope="module")
def predictions(shared):
    batch, jbatch, params, stats = shared
    out = {}
    for mixed, merged in RUNS:
        jcfg, tcfg = _cfgs(mixed, merged)
        jm = JaxModel(jcfg)
        assert jm._can_merge_backproject() == merged

        def run(p, s, b):
            if merged:
                cam, disps, *_ = jm.predict_pose_depth(
                    p, s, b, jax.random.PRNGKey(1), False)
            else:
                cam, _ = jm.predict_pose(p["pose_net"], s["pose_net"], b,
                                         False)
                disps, *_ = jm.predict_depth(p["depth_net"], s["depth_net"],
                                             b, jax.random.PRNGKey(1), False)
            return cam, disps[0], jm.to_depth(disps[0], b["K/0"])
        fn = jax.jit(run).lower(params, stats, jbatch).compile(
            compiler_options=STRICT)
        out[("jax", mixed, merged)] = [np.asarray(a, np.float32)
                                       for a in fn(params, stats, jbatch)]
        model = _port(tcfg, params, stats)
        assert not model.grouped
        assert model._can_merge_backproject() == merged
        got = model.predict(batch)
        out[("port", mixed, merged)] = [got[k].numpy() for k in
                                        ("cam_T_cam", "disp/0", "depth/0")]
    return out


@pytest.mark.parametrize("merged", [True, False])
def test_predict_matches_jax(predictions, merged):
    want = predictions[("jax", True, merged)]
    got = predictions[("port", True, merged)]
    for name, g, w in zip(("cam_T_cam", "disp/0", "depth/0"), got, want):
        assert g.shape == w.shape and g.dtype == np.float32, name
        assert np.isfinite(g).all(), name
        atol = 2e-4 if name == "cam_T_cam" else 1e-2 * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)


def test_predict_computes_in_bf16(predictions):
    """The port's bf16 and f32 outputs differ as JAX's do (within 2x)."""
    for i in (0, 1):       # poses, disparity
        jax_gap = _rel(predictions[("jax", True, True)][i],
                       predictions[("jax", False, True)][i])
        port_gap = _rel(predictions[("port", True, True)][i],
                        predictions[("port", False, True)][i])
        assert jax_gap > 0
        assert 0.5 * jax_gap < port_gap < 2.0 * jax_gap, (i, port_gap,
                                                           jax_gap)


@pytest.fixture(scope="module")
def steps(shared):
    """JAX's and the port's gradients, scalar logs and BatchNorm statistics
    after one step from the same weights (a pose-head bias of a real
    ego-motion), bf16 merged and unmerged, and f32."""
    batch, jbatch, params, stats = shared
    params = with_motion(params, (40.0, 20.0, 60.0))
    out = {}
    for mixed, merged in RUNS:
        jcfg, tcfg = _cfgs(mixed, merged, focal_length_scale=5.0)
        grads, logs, new_stats, noise, _ = jax_step(
            JaxModel(jcfg), params, stats, jbatch, STEP, STRICT)
        out[("jax", mixed, merged)] = dict(
            grads=by_port_name(grads), stats=by_port_name(new_stats),
            logs={k: float(v) for k, v in logs.items()})
        model = _port(tcfg, params, stats)
        tlogs, _ = port_step(model, batch, noise, STEP)
        out[("port", mixed, merged)] = dict(
            model=model, logs=tlogs,
            grads={k: p.grad.numpy() for k, p in model.named_parameters()},
            stats={k: v.numpy() for k, v in model.named_buffers()})
    return out


@pytest.mark.parametrize("merged", [True, False])
def test_step_loss_and_logs_match_jax(steps, merged):
    want = steps[("jax", True, merged)]["logs"]
    got = steps[("port", True, merged)]["logs"]
    assert set(got) == set(want)
    for key, w in want.items():
        assert np.isfinite(got[key]), key
        assert abs(got[key] - w) <= 1e-2 * max(abs(w), 1e-3), (key, got[key],
                                                               w)
    # the overlap terms are live
    assert want["spatio_loss"] > 0 and want["spatio_tempo_loss"] > 0


def _flat(steps, side, mixed, net, merged=True):
    grads = steps[(side, mixed, merged)]["grads"]
    return np.concatenate([grads[k].ravel() for k in sorted(grads)
                           if k.startswith(net + ".")])


@pytest.mark.parametrize("merged", [True, False])
@pytest.mark.parametrize("net", ["depth_net", "pose_net"])
def test_step_gradients_match_jax(steps, net, merged):
    want = steps[("jax", True, merged)]["grads"]
    got = steps[("port", True, merged)]["grads"]
    names = [k for k in want if k.startswith(net + ".")]
    assert set(names) == {k for k in got if k.startswith(net + ".")}
    for name in names:
        g, w = got[name], want[name]
        assert g.dtype == np.float32 and np.isfinite(g).all(), name
        assert np.linalg.norm(w) > 0, name
        assert _rel(g, w) <= 0.5, (name, _rel(g, w))
    jax_gap = _rel(_flat(steps, "jax", True, net, merged),
                   _flat(steps, "jax", False, net))
    port_vs_jax = _rel(_flat(steps, "port", True, net, merged),
                       _flat(steps, "jax", True, net, merged))
    assert port_vs_jax <= 1.5 * jax_gap, (port_vs_jax, jax_gap)


@pytest.mark.parametrize("net", ["depth_net", "pose_net"])
def test_step_gradients_come_from_bf16_networks(steps, net):
    """The port's bf16 and f32 gradients differ as JAX's do (within 2x)."""
    jax_gap = _rel(_flat(steps, "jax", True, net),
                   _flat(steps, "jax", False, net))
    port_gap = _rel(_flat(steps, "port", True, net),
                    _flat(steps, "port", False, net))
    assert 0.5 * jax_gap < port_gap < 2.0 * jax_gap, (port_gap, jax_gap)


@pytest.mark.parametrize("merged", [True, False])
def test_step_keeps_f32_state_and_matches_jax_batchnorm(steps, merged):
    port = steps[("port", True, merged)]
    for name, p in port["model"].named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
    want = steps[("jax", True, merged)]["stats"]
    assert want
    for name, w in want.items():
        got = port["stats"][name]
        assert got.dtype == np.float32, name
        np.testing.assert_allclose(got, w, rtol=0,
                                   atol=3e-2 * np.abs(w).max(), err_msg=name)
