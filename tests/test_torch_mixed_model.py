"""The port's mixed-precision slice as a whole against the JAX package's, on
the CPU (``tpu.mixed_precision: true``, the tiny config, 6 cameras).

``predict`` and one training step of the port (plain versions of the
kernels, bf16 networks) against the JAX model with the same flax weights,
batch and tie-break noise. JAX runs jitted once per config with XLA's
excess precision off (``xla_allow_excess_precision``), so it rounds to bf16
where its program says, as the port and eager JAX do; with it on, XLA's CPU
compiler keeps f32 values across fused bf16 casts. JAX's CPU path takes the
gather sampler and the quad warp; the port takes K1-K5 in their bf16 forms.

Tolerances, with their reasons:

* Two bf16 programs that round the same values at the same points still
  part ways: their f32 accumulations differ by an ulp here and there, a
  few values then round to the other bf16 neighbour, and every later layer
  spreads those flips (ResNet-18's deepest level differs in a third of its
  values; tests/test_torch_mixed_modules.py). At the disparity the port
  and JAX sit about as far apart (relative L2 7e-4) as JAX bf16 and JAX f32
  (8e-4); JAX's own eager and jitted bf16 runs sit 2-3e-4 apart. So the
  outputs are held to a few bf16 steps: disparity and depth 1e-2 of their
  magnitude, poses 2e-4. The ratio "port vs JAX bf16 over JAX bf16 vs JAX
  f32" is measured at 0.9-0.95 on the disparity and 0.85-0.9 on the
  gradients, so it cannot show that the casting points match: a port that
  scaled LeakyReLU by an f32 0.1 instead of JAX's bf16 0.1 measured the
  same ratio. tests/test_torch_mixed_modules.py makes that check per
  module, where it discriminates (the same LeakyReLU fault fails it), and
  this file checks the slice for what it can show: the port computes in
  bf16 (its bf16 and f32 runs differ as much as JAX's do, within 2x) and
  agrees with JAX within the spread above.
* Training step: the port's warps return bf16 images (the TPU kernel's
  output dtype) where JAX's CPU quad warp returns f32 from the same bf16
  sources, which moves the photometric losses by ~2e-3 of their size and
  the gradients of the layers next to the loss by 5-8% (JAX's own bf16
  and f32 gradients of those layers differ by 1-2%); deeper, the spread
  above dominates, and the gradients of a bf16 network at a random init
  differ between any two bf16 runs by ~20% in all (JAX bf16 against f32:
  23% for the depth net, 28% for the pose net). So: loss and logs within
  1e-2 of their magnitude; each net's gradients, taken together, within
  1.5x JAX's bf16-vs-f32 difference (measured 0.89x and 0.85x); each
  parameter's gradient within 0.5 relative L2 (measured 0.36 at worst);
  BatchNorm statistics within 1e-2 of their magnitude (measured 8e-3).
* Parameters, gradients and BatchNorm statistics stay f32.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vfdepth_tpu.config import get_config as jax_get_config
from vfdepth_tpu.data.fake import FakeDataset
from vfdepth_tpu.training.model import VFDepthModel as JaxModel
from vfdepth_tpu_torch.config import get_config
from vfdepth_tpu_torch.training.model import VFDepthModel
from vfdepth_tpu_torch.weights import load_flax_params

from helpers_torch_step import by_port_name, jax_step, port_step, with_motion
from helpers_torch_threads import port_threads  # noqa: F401

jax.config.update("jax_platforms", "cpu")
TINY = "configs/tiny_fake.yaml"
STEP = 3
STRICT = {"xla_allow_excess_precision": False}


def _cfgs(mixed: bool):
    jcfg, tcfg = jax_get_config(TINY), get_config(TINY)
    for cfg in (jcfg, tcfg):
        cfg.set("warp_window", False)
        cfg.set("mixed_precision", mixed)
    return jcfg, tcfg


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def shared():
    cfg = jax_get_config(TINY)
    ds = FakeDataset(num_samples=1, num_cams=cfg.num_cams, height=cfg.height,
                     width=cfg.width, fusion_level=cfg.fusion_level)
    batch = ds.batch([0])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params, stats = JaxModel(cfg).init(jax.random.PRNGKey(0), jbatch)
    return batch, jbatch, params, stats


def _port(mixed: bool, params, stats):
    model = VFDepthModel(_cfgs(mixed)[1], device="cpu")
    load_flax_params(model, *jax.tree_util.tree_map(np.asarray,
                                                    (params, stats)))
    return model


@pytest.fixture(scope="module")
def predictions(shared):
    batch, jbatch, params, stats = shared
    out = {}
    for mixed in (False, True):
        jm = JaxModel(_cfgs(mixed)[0])

        def run(p, s, b):
            cam, disps, *_ = jm.predict_pose_depth(p, s, b,
                                                   jax.random.PRNGKey(1),
                                                   False)
            return cam, disps[0], jm.to_depth(disps[0], b["K/0"])
        fn = jax.jit(run).lower(params, stats, jbatch).compile(
            compiler_options=STRICT)
        out[("jax", mixed)] = [np.asarray(a, np.float32)
                               for a in fn(params, stats, jbatch)]
        got = _port(mixed, params, stats).predict(batch)
        out[("port", mixed)] = [got[k].numpy() for k in
                                ("cam_T_cam", "disp/0", "depth/0")]
    return out


def test_predict_matches_jax(predictions):
    want, got = predictions[("jax", True)], predictions[("port", True)]
    for name, g, w in zip(("cam_T_cam", "disp/0", "depth/0"), got, want):
        assert g.shape == w.shape and g.dtype == np.float32, name
        assert np.isfinite(g).all(), name
        atol = 2e-4 if name == "cam_T_cam" else 1e-2 * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)


def test_predict_computes_in_bf16(predictions):
    """The port's bf16 and f32 outputs differ as JAX's do (within 2x): the
    bf16 networks are in effect, and the slice is not an f32 model."""
    for i in (0, 1):       # poses, disparity
        jax_gap = _rel(predictions[("jax", True)][i],
                       predictions[("jax", False)][i])
        port_gap = _rel(predictions[("port", True)][i],
                        predictions[("port", False)][i])
        assert jax_gap > 0
        assert 0.5 * jax_gap < port_gap < 2.0 * jax_gap, (i, port_gap,
                                                           jax_gap)


@pytest.fixture(scope="module")
def steps(shared):
    """JAX's and the port's gradients, scalar logs and BatchNorm statistics
    after one step, f32 and mixed precision, from the same weights."""
    batch, jbatch, params, stats = shared
    params = with_motion(params)
    out = {}
    for mixed in (False, True):
        jcfg, tcfg = _cfgs(mixed)
        grads, logs, new_stats, noise, _ = jax_step(
            JaxModel(jcfg), params, stats, jbatch, STEP, STRICT)
        out[("jax", mixed)] = dict(
            grads=by_port_name(grads),
            logs={k: float(v) for k, v in logs.items()},
            stats=by_port_name(new_stats))
        model = _port(mixed, params, stats)
        tlogs, _ = port_step(model, batch, noise, STEP)
        out[("port", mixed)] = dict(
            model=model, logs=tlogs,
            grads={k: p.grad.numpy() for k, p in model.named_parameters()},
            stats={k: v.numpy() for k, v in model.named_buffers()})
    return out


def test_step_loss_and_logs_match_jax(steps):
    want, got = steps[("jax", True)]["logs"], steps[("port", True)]["logs"]
    assert set(got) == set(want)
    for key, w in want.items():
        assert np.isfinite(got[key]), key
        assert abs(got[key] - w) <= 1e-2 * max(abs(w), 1e-3), (key, got[key],
                                                               w)


def _flat(steps, side, mixed, net):
    grads = steps[(side, mixed)]["grads"]
    return np.concatenate([grads[k].ravel() for k in sorted(grads)
                           if k.startswith(net + ".")])


@pytest.mark.parametrize("net", ["depth_net", "pose_net"])
def test_step_gradients_match_jax(steps, net):
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


@pytest.mark.parametrize("net", ["depth_net", "pose_net"])
def test_step_gradients_come_from_bf16_networks(steps, net):
    """The port's bf16 and f32 gradients differ as JAX's do (within 2x)."""
    jax_gap = _rel(_flat(steps, "jax", True, net),
                   _flat(steps, "jax", False, net))
    port_gap = _rel(_flat(steps, "port", True, net),
                    _flat(steps, "port", False, net))
    assert 0.5 * jax_gap < port_gap < 2.0 * jax_gap, (port_gap, jax_gap)


def test_step_keeps_f32_state_and_matches_jax_batchnorm(steps):
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
