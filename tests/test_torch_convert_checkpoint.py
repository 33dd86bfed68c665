"""A checkpoint of the JAX package carried into the port
(``scripts/convert_jax_checkpoint.py``), then evaluated by both, on the
CPU, at ``presets.micro_config`` (3 cameras at 32x64).

JAX's ``save_checkpoint`` writes an orbax ``weights_0`` of the flax init
with an Adam state of seeded random moments and count 5 (step 5); the
converter turns it into the port's ``weights_0``. Then the port's
``Trainer.evaluate`` (``predict``) from the converted checkpoint and JAX's
``Trainer.evaluate`` (its eval step) from the orbax one score the same
``FakeDataset(with_depth=True)`` batches, loading the config's
``models_to_load``.

Tolerances: the converted parameters, BatchNorm statistics and Adam
moments are copies (exact; the moments as ``load_optax_adam_state`` lays
them out). The two depth maps differ by f32 summation order (~1e-6 of
their size), so every metric agrees to 1e-4 of its magnitude, except the
fractions a1-a3: a pixel whose error ratio lies within that rounding of a
threshold may fall on either side, and moves its camera's fraction by one
over that camera's valid-pixel count. They are bounded by two such pixels
of the smallest camera (averaged over cameras and batches, one pixel
weighs less).
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from helpers_torch_step import by_port_name
from vfdepth_tpu.data.fake import FakeDataset as JaxFake
from vfdepth_tpu.data.loader import BatchLoader as JaxLoader
from vfdepth_tpu.presets import micro_config as jax_micro
from vfdepth_tpu.training.checkpoint import save_checkpoint as jax_save
from vfdepth_tpu.training.model import VFDepthModel as JaxModel
from vfdepth_tpu.training.step import create_train_state as jax_create_state
from vfdepth_tpu.training.trainer import Trainer as JaxTrainer
from vfdepth_tpu_torch import presets
from vfdepth_tpu_torch.data import BatchLoader, FakeDataset
from vfdepth_tpu_torch.training import (VFDepthModel, create_train_state,
                                        load_checkpoint)
from vfdepth_tpu_torch.training.trainer import Trainer
from vfdepth_tpu_torch.utils.metrics import METRIC_NAMES
from helpers_torch_threads import port_threads  # noqa: F401

jax.config.update("jax_platforms", "cpu")
ROOT = Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "scripts" / "convert_jax_checkpoint.py"
N_EVAL = 3
METRIC_RTOL = 1e-4
FRACTION_PIXELS = 2


def _converter():
    spec = importlib.util.spec_from_file_location("convert_jax_checkpoint",
                                                  SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _fake(fake, cfg):
    return fake(num_samples=N_EVAL, num_cams=cfg.num_cams, height=cfg.height,
                width=cfg.width, fusion_level=cfg.fusion_level,
                with_depth=True)


def _with_random_adam(state):
    """The state with Adam moments of seeded random values, count 5."""
    rng = np.random.RandomState(3)
    adam, rest = state.opt_state[0], state.opt_state[1:]

    def rand(x, square=False):
        v = rng.standard_normal(x.shape).astype(np.float32) * 1e-3
        return jnp.asarray(v * v if square else v)
    adam = adam._replace(
        count=jnp.asarray(5, adam.count.dtype),
        mu=jax.tree_util.tree_map(rand, adam.mu),
        nu=jax.tree_util.tree_map(lambda x: rand(x, True), adam.nu))
    return state._replace(step=jnp.asarray(5, jnp.int32),
                          opt_state=(adam, *rest))


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    root = tmp_path_factory.mktemp("convert")
    jcfg = jax_micro()
    jcfg.set("log_path", str(root / "jax_log"))
    jm = JaxModel(jcfg)
    batch = {k: jnp.asarray(v)
             for k, v in _fake(JaxFake, jcfg).batch([0]).items()}
    state, _ = jax_create_state(jm, jax.random.PRNGKey(0), batch,
                                steps_per_epoch=4)
    state = _with_random_adam(state)
    jax_dir = jax_save(str(root / "jax"), 0, state)
    saved = jax.tree_util.tree_map(np.asarray, state)

    tcfg = presets.micro_config()
    tcfg.set("log_path", str(root / "port_log"))
    port_dir = _converter().convert(jax_dir, tcfg, str(root / "port"), 0)
    return dict(jcfg=jcfg, jm=jm, state=state, saved=saved, tcfg=tcfg,
                jax_dir=jax_dir, port_dir=port_dir)


def test_converted_checkpoint_holds_the_jax_state(converted):
    tcfg, saved = converted["tcfg"], converted["saved"]
    assert sorted(os.listdir(converted["port_dir"])) == [
        "adam.pth", "depth_net.pth", "pose_net.pth"]
    model = VFDepthModel(tcfg, device="cpu", seed=5)
    opt = create_train_state(model)
    assert load_checkpoint(converted["port_dir"], model, opt) == 5
    state = model.state_dict()
    for tree in (saved.params, saved.batch_stats):
        for name, value in by_port_name(tree).items():
            assert np.array_equal(state[name].numpy(), value), name
    params = dict(model.named_parameters())
    adam = saved.opt_state[0]
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        for name, value in by_port_name(tree).items():
            got = opt.state[params[name]]
            assert np.array_equal(got[key].numpy(), value), (key, name)
            assert float(got["step"]) == 5


def test_evaluate_from_converted_matches_jax(converted):
    jcfg, tcfg = converted["jcfg"], converted["tcfg"]
    assert list(tcfg.models_to_load) == list(jcfg.models_to_load)
    jcfg.set("load_weights_dir", converted["jax_dir"])
    tcfg.set("load_weights_dir", converted["port_dir"])
    jloader = JaxLoader(_fake(JaxFake, jcfg), 1, shuffle=False,
                        num_workers=0)
    want = JaxTrainer(jcfg, converted["jm"], use_tb=False).evaluate(
        jloader, converted["state"], load_weights=True)

    # the port starts from other weights: the checkpoint must replace them
    model = VFDepthModel(tcfg, device="cpu", seed=11)
    loader = BatchLoader(_fake(FakeDataset, tcfg), 1, shuffle=False,
                         num_workers=0)
    got = Trainer(tcfg, model, use_tb=False).evaluate(loader)

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


def test_converter_command_line(converted, tmp_path):
    """The script as a command: its arguments, the epoch taken from the
    directory's name, and the written directory on the last line."""
    cfg_file = ROOT / "configs" / "tiny_fake.yaml"
    res = subprocess.run([sys.executable, str(SCRIPT), "--help"],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "--jax_dir" in res.stdout
    module = _converter()
    with pytest.raises(SystemExit, match="weights_<epoch>"):
        module.main(["--config_file", str(cfg_file), "--jax_dir",
                     str(tmp_path / "elsewhere"), "--out_root",
                     str(tmp_path)])
    args = module.parse_args(["--config_file", str(cfg_file), "--jax_dir",
                              converted["jax_dir"], "--out_root", "out"])
    assert args.jax_dir.endswith("weights_0")
    assert torch.load(os.path.join(converted["port_dir"], "adam.pth"),
                      weights_only=True)["step"] == 5
