"""The depth-synthesis sweep and the training loop under ``aug_depth``, the
port against the JAX package on the CPU (``helpers_torch_synthesis``'s
tiny depth-synthesis config).

* ``synthesize_sweep`` at batch 2 against JAX's from the same flax
  weights, on one view of each segment of ``aug_depth_params`` (picked by
  index, ``SEGMENT_VIEWS``: the roll and pitch extremes, the end of the
  focal morph, yaws of 90 and 180 degrees, where camera 0's decode turns
  furthest from its own frustum): each view's disparity 1e-4 of its
  magnitude (f32 sums in another order, as ``predict``). The port decodes
  camera 0 alone where JAX decodes every camera and keeps camera 0; with
  BatchNorm in eval mode the cameras decode independently, which this
  comparison shows;
* ``Trainer.evaluate`` with ``syn_visualize`` (the sweep capped at
  ``CAP`` views by ``synthesize_sweep``'s ``max_views``): the batches
  before ``syn_idx`` are skipped, that batch is predicted once and swept,
  and the logger writes its per-camera disparities and one ``syn`` image a
  view, then the evaluation stops;
* two steps of ``Trainer.learn`` (one epoch of 2 batches of 2; the port
  validates at step 0, JAX does not) against JAX's, the port handed JAX's
  tie-break noise and rotated views' draws through ``noise_fn`` and
  ``aug_fn``: each step's loss within 1e-3 of its magnitude (the step
  tests' bound for the logs
  that average over the auto-mask), the final parameters' displacements
  within 0.3 per parameter and 0.15 per net (relative L2; Adam's young
  moments make each update about lr * sign(g), see
  ``tests/test_torch_trainer.py``), BatchNorm statistics 5e-2 of their
  magnitude (the validation updates none).
"""
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from helpers_torch_step import by_port_name, with_motion
from helpers_torch_synthesis import MOTION, aug_configs
from vfdepth_tpu.data.fake import FakeDataset as JaxFake
from vfdepth_tpu.data.loader import BatchLoader as JaxLoader
from vfdepth_tpu.training.model import VFDepthModel as JaxModel
from vfdepth_tpu.training.step import create_train_state as jax_create_state
from vfdepth_tpu.training import synthesis as jax_synthesis
from vfdepth_tpu.training.trainer import Trainer as JaxTrainer
from vfdepth_tpu_torch.data import BatchLoader, FakeDataset
from vfdepth_tpu_torch.training import VFDepthModel
from vfdepth_tpu_torch.training import synthesis
from vfdepth_tpu_torch.training import trainer as trainer_module
from vfdepth_tpu_torch.training.trainer import Trainer
from vfdepth_tpu_torch.weights import load_flax_params
from helpers_torch_threads import PORT_THREADS, port_threads  # noqa: F401

jax.config.update("jax_platforms", "cpu")
# one view of each segment of the 767-view sweep: (index, roll, pitch, yaw)
# in degrees; index 355 ends the focal morph
SEGMENT_VIEWS = ((38, 10.0, 0.0, 0.0), (177, 0.0, 5.0, 0.0),
                 (355, 0.0, 0.0, 0.0), (497, 0.0, 0.0, 90.0),
                 (587, 0.0, 0.0, 180.0))
CAP = 3
SEED = 7
LOSS_TOL, DISP_REL_TOL, NET_DISP_REL_TOL, BN_TOL = 1e-3, 0.3, 0.15, 5e-2


def _fake(cls, cfg, n, **kw):
    return cls(num_samples=n, num_cams=cfg.num_cams, height=cfg.height,
               width=cfg.width, fusion_level=cfg.fusion_level, **kw)


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = aug_configs()
    batch = _fake(JaxFake, jcfg, 2).batch([0, 1])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JaxModel(jcfg)
    params, stats = jm.init(jax.random.PRNGKey(0), jbatch)
    return jm, tcfg, batch, jbatch, params, stats


def _port(tcfg, params, stats):
    model = VFDepthModel(tcfg, device="cpu")
    load_flax_params(model, *jax.tree_util.tree_map(np.asarray,
                                                    (params, stats)))
    return model


def _picking(views_fn, idx):
    """``aug_depth_params`` restricted to the views ``idx``."""
    def pick(k, n_steps=75):
        views = views_fn(k, n_steps)
        return [views[i] for i in idx]
    return pick


def test_segment_views_are_the_segments(weights):
    k = weights[2][f"K/{weights[1].fusion_level + 1}"]
    views = synthesis.aug_depth_params(k)
    assert len(views) == 767
    for i, *angles in SEGMENT_VIEWS:
        np.testing.assert_allclose(views[i][1:], np.deg2rad(angles),
                                   rtol=1e-6, err_msg=str(i))
    # the morph's end: camera 0's focal length is camera 1's over 1.5
    np.testing.assert_allclose(views[355][0][:, 0, 0, 0],
                               1.5 * views[0][0][:, 1, 0, 0], rtol=1e-6)


def test_sweep_matches_jax(weights, monkeypatch):
    jm, tcfg, batch, jbatch, params, stats = weights
    idx = [view[0] for view in SEGMENT_VIEWS]
    for module in (jax_synthesis, synthesis):
        monkeypatch.setattr(module, "aug_depth_params",
                            _picking(module.aug_depth_params, idx))
    want = jax_synthesis.synthesize_sweep(jm, params, stats, jbatch)
    got = synthesis.synthesize_sweep(_port(tcfg, params, stats), batch)
    assert len(got) == len(want) == len(idx)
    for i, g, w in zip(idx, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape == (2, tcfg.height, tcfg.width, 1), i
        assert g.dtype == np.float32 and np.isfinite(g).all(), i
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=f"view {i}")
    # the views differ: the sweep moves the camera
    for g in got[1:]:
        assert np.abs(g - got[0]).max() > 0


def test_evaluate_sweeps_syn_idx_and_stops(weights, tmp_path, monkeypatch):
    params, stats = weights[-2:]
    _, tcfg = aug_configs()
    for key, value in (("syn_visualize", True), ("syn_idx", 1),
                       ("eval_visualize", False), ("log_path", str(tmp_path)),
                       ("batch_size", 2)):
        tcfg.set(key, value)
    model = _port(tcfg, params, stats)
    loader = BatchLoader(_fake(FakeDataset, tcfg, 6, with_depth=True), 2,
                         shuffle=False, num_workers=0)
    batches = list(loader)
    trainer = Trainer(tcfg, model, use_tb=False)
    seen, logged = [], {}
    real_predict, real_log = model.predict, trainer.logger.log_result

    def predict(batch, aug_u=None):
        seen.append(batch)
        assert aug_u is not None and tuple(aug_u.shape) == (2, 6, 3)
        return real_predict(batch, aug_u=aug_u)

    def log_result(outputs, idx, syn_visualize=False):
        logged.update(outputs=outputs, idx=idx, syn=syn_visualize)
        return real_log(outputs, idx, syn_visualize=syn_visualize)
    model.predict, trainer.logger.log_result = predict, log_result
    real_sweep = synthesis.synthesize_sweep
    monkeypatch.setattr(synthesis, "synthesize_sweep",
                        functools.partial(real_sweep, max_views=CAP))
    trainer.evaluate(loader, load_weights=False)
    assert len(seen) == 1
    np.testing.assert_array_equal(seen[0]["color_aug/0/0"],
                                  batches[1]["color_aug/0/0"])
    assert logged["idx"] == 1 and logged["syn"]
    assert {"disp/0/aug", "depth/0/aug"} <= set(logged["outputs"])
    vis = logged["outputs"]["disp_vis"]
    del model.predict
    assert len(vis) == CAP
    for g, w in zip(vis, real_sweep(model, batches[1], max_views=CAP)):
        np.testing.assert_array_equal(g, w)
    syn = sorted(os.listdir(tmp_path / "syn_results"))
    assert syn == [f"{i:03d}_syndisp.jpg" for i in range(CAP)]
    for cam in range(tcfg.num_cams):
        cam_dir = tmp_path / "vis_results" / f"cam{cam}"
        assert sorted(os.listdir(cam_dir)) == ["002_disp.jpg", "003_disp.jpg"]


def _jax_draws(jm, b):
    """JAX's tie-break noise and rotated views' draw of step ``s`` in
    ``Trainer.learn``: the key ``fold_in(PRNGKey(SEED), s)`` split as
    ``forward`` splits it."""
    shape = (b, jm.num_cams, len(jm.frame_ids) - 1, jm.height, jm.width, 1)

    @jax.jit
    def draw(step):
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), step)
        k_noise, k_aug = jax.random.split(key)
        noise = []
        for _ in jm.scales:
            k_noise, k1 = jax.random.split(k_noise)
            noise.append(jax.random.normal(k1, shape))
        return jnp.stack(noise), jax.random.uniform(k_aug,
                                                    (b, jm.num_cams, 3))
    return draw


def _learn_cfg(cfg, root):
    for key, value in (("num_fake_samples", 4), ("batch_size", 2),
                       ("num_epochs", 1), ("log_frequency", 100),
                       ("save_frequency", 1), ("log_path", str(root)),
                       ("save_weights_root", str(root / "models"))):
        cfg.set(key, value)
    return cfg


@pytest.fixture(scope="module")
def learn_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("aug_learn")
    jcfg, tcfg = aug_configs()
    jcfg, tcfg = _learn_cfg(jcfg, root / "jax"), _learn_cfg(tcfg,
                                                            root / "port")
    jm = JaxModel(jcfg)
    loader = JaxLoader(_fake(JaxFake, jcfg, 4), 2, shuffle=True,
                       num_workers=0, seed=42)
    first = {k: jnp.asarray(v) for k, v in next(iter(loader)).items()}
    state, _ = jax_create_state(jm, jax.random.PRNGKey(0), first,
                                steps_per_epoch=loader.steps_per_epoch)
    state = state._replace(params=with_motion(state.params, MOTION))
    start = jax.tree_util.tree_map(np.asarray,
                                   (state.params, state.batch_stats))
    jax_losses = []
    real_build = JaxTrainer._build_step

    def recording_build(self, tx, example_batch):
        step_fn = real_build(self, tx, example_batch)

        def recording(state, batch, rng):
            state, logs = step_fn(state, batch, rng)
            jax_losses.append(float(logs["total_loss"]))
            return state, logs
        return recording
    JaxTrainer._build_step = recording_build
    try:
        # no validation on this side: it changes no training state, and
        # the port's (at step 0) is held to change none either
        final = JaxTrainer(jcfg, jm, use_tb=False).learn(
            loader, None, state=state, seed=SEED)
    finally:
        JaxTrainer._build_step = real_build
    final = jax.tree_util.tree_map(np.asarray, final)
    draw = _jax_draws(jm, 2)

    model = VFDepthModel(tcfg, device="cpu")
    load_flax_params(model, *start)
    losses, drawn = [], []
    real_step = trainer_module.train_step

    def recording_step(*args, **kw):
        drawn.append(kw.get("aug_u"))
        logs = real_step(*args, **kw)
        losses.append(float(logs["total_loss"]))
        return logs

    def noise_fn(step, shape):
        noise = torch.from_numpy(np.array(draw(step)[0]))
        assert tuple(noise.shape) == tuple(shape)
        return noise

    def aug_fn(step, shape):
        aug = torch.from_numpy(np.array(draw(step)[1]))
        assert tuple(aug.shape) == tuple(shape)
        return aug

    threads = torch.get_num_threads()
    torch.set_num_threads(PORT_THREADS)
    trainer_module.train_step = recording_step
    try:
        Trainer(tcfg, model, use_tb=False).learn(
            BatchLoader(_fake(FakeDataset, tcfg, 4), 2, shuffle=True,
                        num_workers=0, seed=42),
            BatchLoader(_fake(FakeDataset, tcfg, 1, with_depth=True), 1,
                        shuffle=False, num_workers=0),
            seed=SEED, noise_fn=noise_fn, aug_fn=aug_fn)
    finally:
        trainer_module.train_step = real_step
        torch.set_num_threads(threads)
    return dict(jax_losses=jax_losses, losses=losses, drawn=drawn,
                final=final, start=start, model=model)


def test_learn_losses_match_jax(learn_runs):
    want, got = learn_runs["jax_losses"], learn_runs["losses"]
    assert len(want) == len(got) == 2
    assert all(d is not None for d in learn_runs["drawn"])
    for step, (w, g) in enumerate(zip(want, got)):
        assert np.isfinite(g) and abs(g - w) <= LOSS_TOL * abs(w), (step, g,
                                                                     w)


def test_learn_parameters_and_statistics_match_jax(learn_runs):
    final, (start, _) = learn_runs["final"], learn_runs["start"]
    model = learn_runs["model"]
    want, base = by_port_name(final.params), by_port_name(start)
    got = dict(model.named_parameters())
    nets = {}
    for name, w in want.items():
        dw = w - base[name]
        dg = got[name].detach().numpy() - base[name]
        assert np.abs(dw).max() > 0, name
        rel = np.linalg.norm(dg - dw) / np.linalg.norm(dw)
        assert rel <= DISP_REL_TOL, (name, rel)
        net = nets.setdefault(name.split(".")[0], [0.0, 0.0])
        net[0] += float(np.sum((dg - dw) ** 2))
        net[1] += float(np.sum(dw ** 2))
    assert set(nets) == {"depth_net", "pose_net"}
    for net, (diff, norm) in nets.items():
        assert np.sqrt(diff / norm) <= NET_DISP_REL_TOL, net
    bufs = dict(model.named_buffers())
    for name, w in by_port_name(final.batch_stats).items():
        np.testing.assert_allclose(bufs[name].numpy(), w, rtol=BN_TOL,
                                   atol=BN_TOL * np.abs(w).max(),
                                   err_msg=name)
