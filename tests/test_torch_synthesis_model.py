"""The depth-synthesis model of the port against the JAX package's, on the
CPU (``helpers_torch_synthesis.aug_configs``: the tiny config, 6 cameras
at 64x96, 12 depth bins, with ``aug_depth``), in f32 and under mixed
precision (``tpu.mixed_precision: true``, bf16 networks).

Both sides start from the flax init (carried over with
``load_flax_params``; the aug decode adds no parameter), the steps from it
with a pose-head bias of a real ego-motion, 0.4-0.6 m
(``helpers_torch_synthesis.MOTION`` says why so large). The rotated
views' draw is JAX's own: ``uniform(split(rng)[1], (b, cams, 3))`` (``rng``
folded with the step in a train step), handed to the port as ``aug_u``;
the tie-break noise likewise. JAX runs jitted, the bf16 programs with
XLA's excess precision off (as in ``tests/test_torch_mixed_model.py``).

f32, at the bounds of ``tests/test_torch_model.py`` and
``test_torch_train_step.py``:

* ``predict`` against JAX ``forward(train=False)``, merged and unmerged
  back-projection: every output, ``disp/0/aug`` and ``depth/0/aug``
  included, 1e-4 of its magnitude, poses 1e-5 (f32 sums in another
  order);
* one ``train_step`` (``training/step.py``: forward, loss, backward, Adam
  from a carried state) against JAX's step: scalar logs 2e-5 of their
  magnitude (the depth-synthesis logs included) and 1e-3 for those that
  average over the auto-mask; auto-masks within 12 pixels; gradients per
  parameter 5e-3 (depth net) and 5e-2 (pose net) relative L2; BatchNorm
  running statistics 1e-5 of their magnitude -- ``reduce_dim_0`` /
  ``reduce_dim_1`` and the decoder run twice in the step (the main, then
  the rotated decode), so flax updates their statistics twice in that
  order, and so must the port; updated parameters 2e-2 * lr;
* the same step at ``helpers_torch_step.with_motion``'s default motion
  (0.02-0.03 m) with the auto-mask pinned to ones on both sides (JAX's and
  the port's ``losses.composite.auto_mask`` patched for the step): every
  log 2e-5 of its magnitude, gradients 5e-3 / 5e-2 as above. Read on the
  CPU at this motion: unpinned, 7 of the 36,864 scale-0 auto-mask pixels
  differ between the sides and the depth net's gradients by 1.7e-2
  relative L2 (worst parameter 2.1e-2, about 2.4e-3 a flipped pixel);
  pinned, 2.1e-5 (worst 6.1e-5), the pose net's 1.3e-4 (worst 4.6e-4),
  every log within 2.4e-6. So the 2% is the auto-mask's ties, not the
  depth-synthesis terms, and ``MOTION`` keeps the real mask in the other
  step tests.

bf16 (K3-bf16 twice, K4's bf16-update form twice under the default
``sampler_3d: packed``; the rotated decode casts where the main one does;
``warp_depth`` and the depth-synthesis loss stay f32, on the f32
disparity's metric depths), at ``test_torch_mixed_model.py``'s spread:

* ``predict``: every output 1e-2 of its magnitude, poses 2e-4; the port's
  bf16 and f32 disparities (main and rotated) differ as JAX's do, within
  2x (the bf16 networks are in effect);
* one step: loss and logs 1e-2 of their magnitude; each parameter's
  gradient within 0.5 relative L2, each net's within 1.5x JAX's own
  bf16-vs-f32 difference, and the port's bf16-vs-f32 difference within
  2x of JAX's; BatchNorm statistics 1e-2 of their magnitude; parameters
  and gradients stay f32.
"""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from helpers_torch_step import (by_port_name, check_batchnorm,
                                check_gradients, check_logs, jax_step,
                                with_motion)
from helpers_torch_synthesis import MOTION, aug_configs, jax_aug_draw
from vfdepth_tpu.data.fake import FakeDataset
from vfdepth_tpu.losses import composite as jax_composite
from vfdepth_tpu.training.model import VFDepthModel as JaxModel
from vfdepth_tpu.training.step import make_optimizer as jax_make_optimizer
from vfdepth_tpu_torch.losses import composite as port_composite
from vfdepth_tpu_torch.training import (VFDepthModel, create_train_state,
                                        train_step)
from vfdepth_tpu_torch.weights import load_flax_params, load_optax_adam_state
from helpers_torch_threads import PORT_THREADS, port_threads  # noqa: F401

jax.config.update("jax_platforms", "cpu")
STEP = 3
CARRIED_COUNT = 7
STRICT = {"xla_allow_excess_precision": False}
AUG_LOGS = ("depth_con_loss", "depth_sm_loss", "depth_loss")
KEYS = ("cam_T_cam", "disp/0", "depth/0", "disp/0/aug", "depth/0/aug")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def shared():
    jcfg, _ = aug_configs()
    ds = FakeDataset(num_samples=1, num_cams=jcfg.num_cams,
                     height=jcfg.height, width=jcfg.width,
                     fusion_level=jcfg.fusion_level)
    batch = ds.batch([0])
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
    """JAX ``forward(train=False)`` and the port's ``predict`` on one draw,
    keyed (side, merged, mixed): f32 merged and unmerged, bf16 merged."""
    batch, jbatch, params, stats = shared
    rng = jax.random.PRNGKey(5)
    aug_u = torch.from_numpy(jax_aug_draw(rng, 1, 6))
    out = {}
    for merged, mixed in ((True, False), (False, False), (True, True)):
        jcfg, tcfg = aug_configs(mixed_precision=mixed)
        for cfg in (jcfg, tcfg):
            cfg.set("merge_backprojection", merged)
        jm = JaxModel(jcfg)
        model = _port(tcfg, params, stats)
        assert jm._can_merge_backproject() == merged
        assert model._can_merge_backproject() == merged
        fn = jax.jit(lambda p, s, b, r: jm.forward(p, s, b, r,
                                                   train=False)[0])
        want = fn.lower(params, stats, jbatch, rng).compile(
            compiler_options=STRICT)(params, stats, jbatch, rng)
        got = model.predict(batch, aug_u=aug_u)
        assert set(got) == set(want) == set(KEYS)
        out[("jax", merged, mixed)] = {k: np.asarray(want[k], np.float32)
                                       for k in KEYS}
        out[("port", merged, mixed)] = {k: got[k].numpy() for k in KEYS}
    return out


@pytest.mark.parametrize("merged", [True, False])
def test_predict_matches_jax_forward(predictions, merged):
    want = predictions[("jax", merged, False)]
    got = predictions[("port", merged, False)]
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape and np.isfinite(g).all(), key
        atol = 1e-5 if key == "cam_T_cam" else 1e-4 * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=key)
    # the rotated views are other views
    assert np.abs(want["disp/0/aug"] - want["disp/0"]).max() > 1e-3


def test_predict_bf16_matches_jax(predictions):
    want = predictions[("jax", True, True)]
    got = predictions[("port", True, True)]
    for key in KEYS:
        g, w = got[key], want[key]
        assert g.shape == w.shape and g.dtype == np.float32, key
        assert np.isfinite(g).all(), key
        atol = 2e-4 if key == "cam_T_cam" else 1e-2 * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=key)


@pytest.mark.parametrize("key", ["disp/0", "disp/0/aug"])
def test_predict_computes_in_bf16(predictions, key):
    jax_gap = _rel(predictions[("jax", True, True)][key],
                   predictions[("jax", True, False)][key])
    port_gap = _rel(predictions[("port", True, True)][key],
                    predictions[("port", True, False)][key])
    assert jax_gap > 0
    assert 0.5 * jax_gap < port_gap < 2.0 * jax_gap, (port_gap, jax_gap)


def _carried_state(params, seed):
    """An optax Adam state after CARRIED_COUNT updates (as
    tests/test_torch_train_step.py builds it)."""
    rng = np.random.RandomState(seed)
    mu = jax.tree_util.tree_map(
        lambda p: jnp.asarray(1e-3 * rng.randn(*p.shape), jnp.float32), params)
    nu = jax.tree_util.tree_map(
        lambda p: jnp.asarray(1e-8 * (0.5 + rng.rand(*p.shape)), jnp.float32),
        params)
    return optax.ScaleByAdamState(count=jnp.asarray(CARRIED_COUNT, jnp.int32),
                                  mu=mu, nu=nu)


def _step_aug_u():
    return jax_aug_draw(jax.random.fold_in(jax.random.PRNGKey(11), STEP), 1,
                        6)


@pytest.fixture(scope="module")
def step_pair(shared):
    batch, jbatch, params, stats = shared
    jcfg, tcfg = aug_configs()
    params = with_motion(params, MOTION)
    jm = JaxModel(jcfg)
    grads, logs, new_stats, noise, amask = jax_step(jm, params, stats,
                                                    jbatch, STEP)
    tx = jax_make_optimizer(jcfg.learning_rate, jcfg.scheduler_step_size, 0)
    state = (_carried_state(params, 0), optax.EmptyState())
    updated = jax.jit(lambda g, s, p: optax.apply_updates(
        p, tx.update(g, s, p)[0]))(grads, state, params)

    model = _port(tcfg, params, stats)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = create_train_state(model)
    load_optax_adam_state(opt, model,
                          jax.tree_util.tree_map(np.asarray, state))
    threads = torch.get_num_threads()
    torch.set_num_threads(PORT_THREADS)
    try:
        # the auto-mask of the port's step, as the log sees it
        captured = {}
        real_forward = model.forward

        def forward(*args, **kw):
            out = real_forward(*args, **kw)
            captured["amask"] = out[2]["reproj_mask"].detach().numpy()
            return out
        model.forward = forward
        tlogs = train_step(model, opt, batch, STEP, torch.Generator(),
                           noise=torch.from_numpy(np.array(noise)),
                           aug_u=torch.from_numpy(_step_aug_u()))
    finally:
        torch.set_num_threads(threads)
        del model.forward
    return dict(np_grads=grads, new_stats=new_stats, model=model,
                noise=noise, logs={k: float(v) for k, v in logs.items()},
                tlogs={k: float(v) for k, v in tlogs.items()},
                amask=(np.asarray(amask), captured["amask"]),
                updated=by_port_name(jax.tree_util.tree_map(np.asarray,
                                                            updated)),
                before=before, lr=jcfg.learning_rate)


def test_step_loss_and_logs(step_pair):
    assert set(AUG_LOGS) <= set(step_pair["logs"])
    check_logs(step_pair, masked_tol=1e-3)
    logs = step_pair["logs"]
    assert logs["depth_con_loss"] > 0 and logs["depth_sm_loss"] > 0
    np.testing.assert_allclose(
        logs["depth_loss"],
        0.03 * logs["depth_con_loss"] + 0.05 * logs["depth_sm_loss"],
        rtol=1e-5)


def test_step_auto_masks_agree(step_pair):
    want, got = step_pair["amask"]
    assert got.shape == want.shape and 0.1 < want.mean() < 0.9
    assert (got != want).sum() <= 12


@pytest.mark.parametrize("net,tol", [("depth_net", 5e-3), ("pose_net", 5e-2)])
def test_step_gradients(step_pair, net, tol):
    check_gradients(step_pair, net, tol)


@pytest.mark.parametrize("net", ["depth_net", "pose_net"])
def test_step_batchnorm_statistics(step_pair, net):
    check_batchnorm(step_pair, net)


def test_step_adam_update(step_pair):
    want, before, lr = (step_pair["updated"], step_pair["before"],
                        step_pair["lr"])
    worst = 0.0
    for name, p in step_pair["model"].named_parameters():
        assert np.abs(want[name] - before[name].numpy()).max() > 0.1 * lr
        worst = max(worst, np.abs(p.detach().numpy() - want[name]).max())
    assert worst <= 2e-2 * lr, worst / lr


@pytest.fixture(scope="module")
def pinned_pair(shared):
    """JAX's step and the port's (forward and backward, no update) at
    ``with_motion``'s default motion, the auto-mask pinned to ones on both
    sides."""
    batch, jbatch, params, stats = shared
    jcfg, tcfg = aug_configs()
    params = with_motion(params)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_composite, "auto_mask",
                      lambda reproj, ident: jnp.ones_like(reproj))
        patch.setattr(port_composite, "auto_mask",
                      lambda reproj, ident: torch.ones_like(reproj))
        grads, logs, new_stats, noise, amask = jax_step(
            JaxModel(jcfg), params, stats, jbatch, STEP)
        model = _port(tcfg, params, stats)
        threads = torch.get_num_threads()
        torch.set_num_threads(PORT_THREADS)
        try:
            _, loss, tlogs = model(batch, step=STEP,
                                   noise=torch.from_numpy(np.array(noise)),
                                   aug_u=torch.from_numpy(_step_aug_u()))
            loss.backward()
        finally:
            torch.set_num_threads(threads)
    return dict(np_grads=grads, new_stats=new_stats, model=model,
                logs={k: float(v) for k, v in logs.items()},
                tlogs={k: float(v.detach()) for k, v in tlogs.items()
                       if v.dim() == 0},
                amask=(np.asarray(amask),
                       tlogs["reproj_mask"].detach().numpy()))


def test_pinned_step_logs(pinned_pair):
    want, got = pinned_pair["amask"]
    assert (want == 1).all() and (got == 1).all()
    assert set(AUG_LOGS) <= set(pinned_pair["logs"])
    check_logs(pinned_pair, masked_tol=2e-5)


@pytest.mark.parametrize("net,tol", [("depth_net", 5e-3), ("pose_net", 5e-2)])
def test_pinned_step_gradients(pinned_pair, net, tol):
    check_gradients(pinned_pair, net, tol)


@pytest.fixture(scope="module")
def bf16_steps(shared, step_pair):
    """JAX's and the port's gradients, scalar logs and BatchNorm statistics
    after one bf16 step (forward and backward, no update), beside the f32
    step's gradients (``step_pair``: the same weights, batch and draws)."""
    batch, jbatch, params, stats = shared
    params = with_motion(params, MOTION)
    jcfg, tcfg = aug_configs(mixed_precision=True)
    grads, logs, new_stats, noise, _ = jax_step(
        JaxModel(jcfg), params, stats, jbatch, STEP, STRICT)
    np.testing.assert_array_equal(noise, step_pair["noise"])
    model = _port(tcfg, params, stats)
    threads = torch.get_num_threads()
    torch.set_num_threads(PORT_THREADS)
    try:
        _, loss, tlogs = model(batch, step=STEP,
                               noise=torch.from_numpy(np.array(noise)),
                               aug_u=torch.from_numpy(_step_aug_u()))
        loss.backward()
    finally:
        torch.set_num_threads(threads)
    return {
        "jax": dict(grads=by_port_name(grads),
                    logs={k: float(v) for k, v in logs.items()},
                    stats=by_port_name(new_stats)),
        "port": dict(model=model,
                     logs={k: float(v.detach()) for k, v in tlogs.items()
                           if v.dim() == 0},
                     grads={k: p.grad.numpy()
                            for k, p in model.named_parameters()},
                     stats={k: v.numpy() for k, v in model.named_buffers()}),
        "jax_f32": by_port_name(step_pair["np_grads"]),
        "port_f32": {k: p.grad.numpy() for k, p in
                     step_pair["model"].named_parameters()}}


def test_step_bf16_loss_and_logs_match_jax(bf16_steps):
    want, got = bf16_steps["jax"]["logs"], bf16_steps["port"]["logs"]
    assert set(got) == set(want) and set(AUG_LOGS) <= set(got)
    for key, w in want.items():
        assert np.isfinite(got[key]), key
        assert abs(got[key] - w) <= 1e-2 * max(abs(w), 1e-3), (key, got[key],
                                                               w)


def _flat(grads, net):
    return np.concatenate([grads[k].ravel() for k in sorted(grads)
                           if k.startswith(net + ".")])


@pytest.mark.parametrize("net", ["depth_net", "pose_net"])
def test_step_bf16_gradients_match_jax(bf16_steps, net):
    want = bf16_steps["jax"]["grads"]
    got = bf16_steps["port"]["grads"]
    names = [k for k in want if k.startswith(net + ".")]
    assert set(names) == {k for k in got if k.startswith(net + ".")}
    for name in names:
        g, w = got[name], want[name]
        assert g.dtype == np.float32 and np.isfinite(g).all(), name
        assert np.linalg.norm(w) > 0, name
        assert _rel(g, w) <= 0.5, (name, _rel(g, w))
    jax_gap = _rel(_flat(want, net), _flat(bf16_steps["jax_f32"], net))
    port_vs_jax = _rel(_flat(got, net), _flat(want, net))
    assert port_vs_jax <= 1.5 * jax_gap, (port_vs_jax, jax_gap)
    port_gap = _rel(_flat(got, net), _flat(bf16_steps["port_f32"], net))
    assert 0.5 * jax_gap < port_gap < 2.0 * jax_gap, (port_gap, jax_gap)


def test_step_bf16_keeps_f32_state_and_matches_jax_batchnorm(bf16_steps):
    port = bf16_steps["port"]
    for name, p in port["model"].named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
    want = bf16_steps["jax"]["stats"]
    assert want
    for name, w in want.items():
        got = port["stats"][name]
        assert got.dtype == np.float32, name
        np.testing.assert_allclose(got, w, rtol=0,
                                   atol=1e-2 * np.abs(w).max(), err_msg=name)
