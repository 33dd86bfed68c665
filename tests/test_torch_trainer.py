"""Two epochs of the port's ``Trainer.learn`` against the JAX package's, on
the CPU.

``configs/tiny_fake.yaml`` (6 cameras at 64x96) with 8 fake samples at
batch 2 (4 steps an epoch), 2 epochs, ``scheduler_step_size`` 1 (the rate
drops tenfold at the epoch boundary), ``log_frequency`` 2 (validation at
steps 0, 2, 4, 5 and 6 on a 2-batch loader, so its iterator cycles twice)
and ``save_frequency`` 1, logs and checkpoints redirected into a temporary
directory; ``tpu.warp_window`` off on both sides (on the tiny config's
even rig the windows would cover the image and turn themselves off;
``tests/test_torch_warp_window.py`` holds the windows of both packages). Both start from the flax init with a pose-head bias of a real
ego-motion (``helpers_torch_step.with_motion``: at the init the auto-mask is
a coin toss), and the port gets the JAX run's per-step tie-break noise
through ``learn``'s ``noise_fn``. The JAX run happens once, in a module
fixture; the port runs its CPU convolutions on a fixed 2 threads
(``PORT_THREADS``), as the step tests do.

Compared:
* the rate of every step: the JAX optimizer's StepLR at the same update
  count (1e-4 for 4 steps, then 1e-5), to f32 rounding (rtol 1e-6);
* the loss of every step (JAX's jitted step wrapped to record its logs):
  step 0 within 1e-3 of its magnitude (the step tests' bound for the logs
  that average over the auto-mask), every step within 5e-3 (measured:
  5.5e-5 at step 0, 1.1e-3 at most). The loss moves 2-6% from one batch to
  the next, so another batch order or a lost step shows;
* the final parameters, each as its displacement from the common start:
  the relative L2 difference of the two displacements, per parameter
  within 0.3 and per net within 0.15 (measured: 0.16 and 0.061 / 0.079).
  Adam's update is about lr * sign(g) while its moments are young, so
  every gradient entry near 0 that the two frameworks round to opposite
  signs moves its parameter 2 lr apart, and the auto-mask flips a few
  pixels a step (the step tests measure 3 of 36,864): that is the spread,
  at the step tests' one-step tolerances;
* the BatchNorm running statistics after the 8 updates: 5e-2 of their
  magnitude (one step agrees to 1e-5, the step tests; 8 steps of slightly
  different parameters feed them, measured 1.5e-2; a validation that
  updated them would move them by a multiple of that);
* ``weights_0`` and ``weights_1``: the port's bit-equal to its live model
  and optimizer at each epoch's end, and to JAX's orbax checkpoints at the
  bounds above; the saved step 4 and 8;
* the validation loader's iterator is restarted when it runs out.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from helpers_torch_step import by_port_name, with_motion
from vfdepth_tpu.config import get_config as jax_get_config
from vfdepth_tpu.data.fake import FakeDataset as JaxFake
from vfdepth_tpu.data.loader import BatchLoader as JaxLoader
from vfdepth_tpu.training.checkpoint import _restore_as_numpy
from vfdepth_tpu.training.model import VFDepthModel as JaxModel
from vfdepth_tpu.training.step import create_train_state as jax_create_state
from vfdepth_tpu.training.step import make_lr_schedule as jax_lr_schedule
from vfdepth_tpu.training.trainer import Trainer as JaxTrainer
from vfdepth_tpu_torch.config import get_config
from vfdepth_tpu_torch.data import BatchLoader, FakeDataset
from vfdepth_tpu_torch.training import (VFDepthModel, create_train_state,
                                        load_checkpoint)
from vfdepth_tpu_torch.training import trainer as trainer_module
from vfdepth_tpu_torch.training.trainer import Trainer
from vfdepth_tpu_torch.weights import load_flax_params
from helpers_torch_threads import PORT_THREADS, port_threads  # noqa: F401

jax.config.update("jax_platforms", "cpu")
TINY = "configs/tiny_fake.yaml"
SEED = 7
N_SAMPLES, BATCH, EPOCHS = 8, 2, 2
STEPS = EPOCHS * N_SAMPLES // BATCH
LR0 = 1e-4
LOSS_TOL_FIRST, LOSS_TOL = 1e-3, 5e-3
DISP_REL_TOL, NET_DISP_REL_TOL = 0.3, 0.15
BN_TOL = 5e-2


def _cfg(get, root):
    cfg = get(TINY)
    for key, value in (("num_fake_samples", N_SAMPLES),
                       ("batch_size", BATCH), ("num_epochs", EPOCHS),
                       ("scheduler_step_size", 1), ("log_frequency", 2),
                       ("save_frequency", 1), ("learning_rate", LR0),
                       ("warp_window", False), ("log_path", str(root)),
                       ("save_weights_root", str(root / "models"))):
        cfg.set(key, value)
    return cfg


def _datasets(fake, cfg):
    common = dict(num_cams=cfg.num_cams, height=cfg.height, width=cfg.width,
                  fusion_level=cfg.fusion_level)
    return (fake(num_samples=N_SAMPLES, **common),
            fake(num_samples=2, with_depth=True, **common))


class _Counting:
    """An iterable that counts how often an iterator is made of it."""

    def __init__(self, inner):
        self.inner, self.iters = inner, 0

    def __iter__(self):
        self.iters += 1
        return iter(self.inner)


def _jax_noise(jm, b):
    """JAX's tie-break noise of step ``s`` in ``Trainer.learn``: the key
    ``fold_in(PRNGKey(SEED), s)`` split as ``forward`` and ``total_loss``
    split it (``helpers_torch_step.jax_step``)."""
    shape = (b, jm.num_cams, len(jm.frame_ids) - 1, jm.height, jm.width, 1)

    @jax.jit
    def draw(step):
        key = jax.random.split(jax.random.fold_in(
            jax.random.PRNGKey(SEED), step))[0]
        noise = []
        for _ in jm.scales:
            key, k1 = jax.random.split(key)
            noise.append(jax.random.normal(k1, shape))
        return jnp.stack(noise)
    return draw


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer")
    # --- the JAX package's Trainer.learn ---------------------------------
    jcfg = _cfg(jax_get_config, root / "jax")
    jm = JaxModel(jcfg)
    train_ds, val_ds = _datasets(JaxFake, jcfg)
    loader = JaxLoader(train_ds, BATCH, shuffle=True, num_workers=0, seed=42)
    first = {k: jnp.asarray(v) for k, v in next(iter(loader)).items()}
    state, _ = jax_create_state(jm, jax.random.PRNGKey(0), first,
                                steps_per_epoch=loader.steps_per_epoch)
    state = state._replace(params=with_motion(state.params))
    start = jax.tree_util.tree_map(np.asarray,
                                   (state.params, state.batch_stats))
    jax_logs = []
    real_build = JaxTrainer._build_step

    def recording_build(self, tx, example_batch):
        step_fn = real_build(self, tx, example_batch)

        def recording(state, batch, rng):
            state, logs = step_fn(state, batch, rng)
            jax_logs.append(float(logs["total_loss"]))
            return state, logs
        return recording
    JaxTrainer._build_step = recording_build
    try:
        final = JaxTrainer(jcfg, jm, use_tb=False).learn(
            loader, JaxLoader(val_ds, 1, shuffle=False, num_workers=0),
            state=state, seed=SEED)
    finally:
        JaxTrainer._build_step = real_build
    final = jax.tree_util.tree_map(np.asarray, final)
    draw = _jax_noise(jm, BATCH)

    # --- the port's, from the same weights and noise ---------------------
    tcfg = _cfg(get_config, root / "port")
    model = VFDepthModel(tcfg, device="cpu")
    load_flax_params(model, *start)
    train_ds, val_ds = _datasets(FakeDataset, tcfg)
    val_loader = _Counting(BatchLoader(val_ds, 1, shuffle=False,
                                       num_workers=0))
    record = dict(lrs=[], losses=[], epoch_end={})
    real_step = trainer_module.train_step

    def recording_step(model, optimizer, batch, step, generator, noise=None,
                       aug_u=None):
        logs = real_step(model, optimizer, batch, step, generator, noise,
                         aug_u)
        record["lrs"].append([g["lr"] for g in optimizer.param_groups])
        record["losses"].append(float(logs["total_loss"]))
        if (step + 1) % (N_SAMPLES // BATCH) == 0:
            record["epoch_end"][step // (N_SAMPLES // BATCH)] = (
                {k: v.clone() for k, v in model.state_dict().items()},
                {id(p): {k: v.clone() for k, v in s.items()}
                 for p, s in optimizer.state.items()})
        return logs

    def noise_fn(step, shape):
        noise = torch.from_numpy(np.array(draw(step)))
        assert tuple(noise.shape) == tuple(shape)
        return noise

    threads = torch.get_num_threads()
    torch.set_num_threads(PORT_THREADS)
    trainer_module.train_step = recording_step
    try:
        opt = Trainer(tcfg, model, use_tb=False).learn(
            BatchLoader(train_ds, BATCH, shuffle=True, num_workers=0,
                        seed=42), val_loader, seed=SEED, noise_fn=noise_fn)
    finally:
        trainer_module.train_step = real_step
        torch.set_num_threads(threads)
    return dict(jax_logs=jax_logs, jcfg=jcfg, tcfg=tcfg, start=start, final=final, model=model,
                opt=opt, record=record, val_loader=val_loader, root=root)


def test_rate_of_every_step(runs):
    schedule = jax_lr_schedule(LR0, 1, N_SAMPLES // BATCH)
    want = [float(schedule(count)) for count in range(STEPS)]
    got = runs["record"]["lrs"]
    assert len(got) == STEPS
    for count, (lrs, w) in enumerate(zip(got, want)):
        assert len(lrs) == 2            # depth net, pose net
        for lr in lrs:
            assert abs(lr - w) <= 1e-6 * w, (count, lr, w)
    assert want[3] == pytest.approx(LR0) and want[4] == pytest.approx(LR0 / 10)
    assert int(runs["final"].step) == STEPS
    for state in runs["opt"].state.values():
        assert float(state["step"]) == STEPS


def _check_params(got_named, want_tree, start_tree, what):
    """Each parameter's displacement from the start, and each net's."""
    want = by_port_name(want_tree)
    start = by_port_name(start_tree)
    assert set(want) <= set(got_named)
    nets = {}
    for name, w in want.items():
        g = got_named[name].detach().numpy()
        dw, dg = w - start[name], g - start[name]
        assert np.abs(dw).max() > 0, (what, name)        # JAX trained it
        rel = np.linalg.norm(dg - dw) / np.linalg.norm(dw)
        assert rel <= DISP_REL_TOL, (what, name, rel)
        net = nets.setdefault(name.split(".")[0], [0.0, 0.0])
        net[0] += float(np.sum((dg - dw) ** 2))
        net[1] += float(np.sum(dw ** 2))
    assert set(nets) == {"depth_net", "pose_net"}
    for net, (diff, norm) in nets.items():
        assert np.sqrt(diff / norm) <= NET_DISP_REL_TOL, (what, net)


def _check_stats(got_named, want_tree, what):
    want = by_port_name(want_tree)
    assert want
    for name, w in want.items():
        g = got_named[name].detach().numpy()
        np.testing.assert_allclose(g, w, rtol=BN_TOL,
                                   atol=BN_TOL * np.abs(w).max(),
                                   err_msg=f"{what} {name}")


def test_loss_of_every_step(runs):
    want, got = runs["jax_logs"], runs["record"]["losses"]
    assert len(want) == len(got) == STEPS
    for step, (w, g) in enumerate(zip(want, got)):
        tol = LOSS_TOL_FIRST if step == 0 else LOSS_TOL
        assert np.isfinite(g) and abs(g - w) <= tol * abs(w), (step, g, w)


def test_final_parameters_match_jax(runs):
    final, start = runs["final"], runs["start"]
    params = dict(runs["model"].named_parameters())
    _check_params(params, final.params, start[0], "live")


def test_batchnorm_statistics_match_jax(runs):
    bufs = dict(runs["model"].named_buffers())
    _check_stats(bufs, runs["final"].batch_stats, "live")
    moved = by_port_name(runs["final"].batch_stats)
    assert all(np.abs(v - (0.0 if k.endswith("mean") else 1.0)).max() > 0
               for k, v in moved.items())


def _load_port(tcfg, path):
    model = VFDepthModel(tcfg, device="cpu", seed=99)
    opt = create_train_state(model, steps_per_epoch=N_SAMPLES // BATCH)
    step = load_checkpoint(path, model, opt)
    return model, opt, step


@pytest.mark.parametrize("epoch", [0, 1])
def test_checkpoints_hold_the_live_model(runs, epoch):
    """``weights_<epoch>`` equals the live model and optimizer at that
    epoch's end, bit for bit, with its step."""
    tcfg = runs["tcfg"]
    path = os.path.join(tcfg.save_weights_root, f"weights_{epoch}")
    model, opt, step = _load_port(tcfg, path)
    assert step == (epoch + 1) * N_SAMPLES // BATCH
    live_state, live_opt = runs["record"]["epoch_end"][epoch]
    for k, v in model.state_dict().items():
        assert torch.equal(v, live_state[k]), k
    live_params = [p for g in runs["opt"].param_groups for p in g["params"]]
    loaded = [p for g in opt.param_groups for p in g["params"]]
    for p_live, p in zip(live_params, loaded):
        for k, v in live_opt[id(p_live)].items():
            assert torch.equal(opt.state[p][k], v), k


@pytest.mark.parametrize("epoch", [0, 1])
def test_checkpoints_match_jax(runs, epoch):
    jpath = os.path.join(runs["jcfg"].save_weights_root, f"weights_{epoch}")
    restored = _restore_as_numpy(os.path.abspath(jpath))
    assert int(np.asarray(restored["step"])) == (epoch + 1) * 4
    model, _, _ = _load_port(
        runs["tcfg"],
        os.path.join(runs["tcfg"].save_weights_root, f"weights_{epoch}"))
    _check_params(dict(model.named_parameters()), restored["params"],
                  runs["start"][0], f"weights_{epoch}")
    _check_stats(dict(model.named_buffers()), restored["batch_stats"],
                 f"weights_{epoch}")


def test_validation_cycles_its_iterator(runs):
    # validations at steps 0, 2, 4, 5, 6 over a 2-batch loader: made at the
    # start, then again at the 3rd and 5th validation
    assert runs["val_loader"].iters == 3


class _Writer:
    """Stands in for a TensorBoard writer: records what it is given."""

    def __init__(self):
        self.scalars, self.images = [], []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, step))

    def add_image(self, tag, image, step):
        assert image.ndim == 3 and image.shape[0] == 3, tag
        self.images.append((tag, step))

    def close(self):
        pass


def test_panels_and_a_run_cut_by_max_steps(tmp_path):
    """The port alone, its own noise: image panels of the train batch and
    of validation at each log checkpoint where a writer takes them, and a
    run that ``max_steps`` ends in its second of three epochs saves that
    epoch (``save_frequency`` 1) and stops."""
    cfg = _cfg(get_config, tmp_path)
    cfg.set("num_epochs", 3)
    model = VFDepthModel(cfg, device="cpu")
    train_ds, val_ds = _datasets(FakeDataset, cfg)
    trainer = Trainer(cfg, model, use_tb=False)
    trainer.logger.writers = {"train": _Writer(), "val": _Writer()}
    writers = dict(trainer.logger.writers)
    trainer.learn(BatchLoader(train_ds, BATCH, num_workers=2),
                  BatchLoader(val_ds, 1, shuffle=False, num_workers=0),
                  max_steps=6)
    assert sorted(os.listdir(cfg.save_weights_root)) == ["weights_0",
                                                         "weights_1"]
    for epoch, step in ((0, 4), (1, 6)):
        path = os.path.join(cfg.save_weights_root, f"weights_{epoch}")
        assert _load_port(cfg, path)[2] == step
    for mode in ("train", "val"):
        w = writers[mode]
        assert {s for _, s in w.images} == {0, 2, 4, 5}, mode
        assert ("total_loss", 0) in w.scalars, mode
        titles = {t for t, s in w.images if s == 0}
        for cam in range(cfg.num_cams):
            for panel in ("", "/disp", "/self_occ_mask", "/reproj",
                          "/reproj_mask", "/sp", "/sp_mask", "/sp_tm_1",
                          "/pred_0", "/pred_1"):
                assert f"cam/{cam}{panel}" in titles, (mode, cam, panel)


def test_logged_rate_counts_the_steps_since_the_last_checkpoint(
        tmp_path, monkeypatch):
    """The examples/s of a log checkpoint: the steps since the previous
    one over their wall time, read after ``reduce_logs``, the checkpoint's
    validation left out. A clock that only the steps (step k takes
    0.5 (k + 1) s) and the validation (10 s) move: the checkpoints at steps
    0, 2 and 4 log the mean of steps 0, 1-2 and 3-4."""
    clock = [0.0]
    real_step = trainer_module.train_step
    taken = []

    def step(*args, **kwargs):
        taken.append(0.5 * (len(taken) + 1))
        clock[0] += taken[-1]
        return real_step(*args, **kwargs)
    monkeypatch.setattr(trainer_module, "train_step", step)
    monkeypatch.setattr(trainer_module.time, "time", lambda: clock[0])
    cfg = _cfg(get_config, tmp_path)
    model = VFDepthModel(cfg, device="cpu")
    train_ds, val_ds = _datasets(FakeDataset, cfg)
    trainer = Trainer(cfg, model, use_tb=False)
    real_validate = trainer._validate

    def validate(*args):
        clock[0] += 10.0
        return real_validate(*args)
    trainer._validate = validate
    durations = []
    trainer.logger.log_time = (
        lambda epoch, batch_idx, duration, loss, start: durations.append(
            duration))
    trainer.learn(BatchLoader(train_ds, BATCH, num_workers=0),
                  BatchLoader(val_ds, 1, shuffle=False, num_workers=0),
                  max_steps=5)
    assert durations == [0.5, (1.0 + 1.5) / 2, (2.0 + 2.5) / 2]


def test_pretrain_resumes_from_the_saved_step(tmp_path, monkeypatch):
    """With ``pretrain`` the trainer loads the checkpoint's nets and Adam
    state and counts on from its step, as the JAX package's ``learn`` takes
    the restored ``state.step``: the StepLR boundary (4 updates here) is
    already behind it, so every step runs at the dropped rate."""
    cfg = _cfg(get_config, tmp_path / "first")
    cfg.set("num_epochs", 1)
    model = VFDepthModel(cfg, device="cpu")
    train_ds, _ = _datasets(FakeDataset, cfg)
    Trainer(cfg, model, use_tb=False).learn(
        BatchLoader(train_ds, BATCH, num_workers=0))
    saved = os.path.join(cfg.save_weights_root, "weights_0")

    again = _cfg(get_config, tmp_path / "again")
    again.set("num_epochs", 1)
    for key, value in (("pretrain", True), ("load_weights_dir", saved),
                       ("models_to_load", ["depth_net", "pose_net"])):
        again.set(key, value)
    seen = []
    real_step = trainer_module.train_step

    def recording(model, optimizer, batch, step, generator, noise=None,
                  aug_u=None):
        logs = real_step(model, optimizer, batch, step, generator, noise,
                         aug_u)
        seen.append((step, [g["lr"] for g in optimizer.param_groups]))
        return logs
    monkeypatch.setattr(trainer_module, "train_step", recording)
    resumed = VFDepthModel(again, device="cpu", seed=5)
    opt = Trainer(again, resumed, use_tb=False).learn(
        BatchLoader(train_ds, BATCH, num_workers=0), max_steps=7)
    assert [s for s, _ in seen] == [4, 5, 6]
    assert all(lr == pytest.approx(LR0 / 10) for _, lrs in seen for lr in lrs)
    assert {float(s["step"]) for s in opt.state.values()} == {7.0}
    path = os.path.join(again.save_weights_root, "weights_0")
    assert _load_port(again, path)[2] == 7
