"""The plain reference against the program at a micro size on the CPU,
and the timed paths driven end to end with their check (CPU)."""
from __future__ import annotations

import time

import pytest
import torch

from benchmark import cells, micro, program, scene
from benchmark import weights as weights_mod
from benchmark.augdepth_probe import augdepth
from benchmark.reference.model import RefModel, RefTrainer, draw

SEED = 2 ** 33 + 7      # larger than 32 bits, as the driver's are


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config(name: str) -> dict:
    """A micro configuration; "augdepth" is the fusion one with the
    published depth synthesis on."""
    if name != "augdepth":
        return micro.config(name)
    cfg = augdepth(micro.config("vfdepth_ddad_fusion"))
    # at 96 pixels' width the published focal_length_scale (300) puts every
    # depth under min_depth, where warp_depth masks every pixel and the
    # consistency term reads 0; at 30 the depths lie at 4.6-8.7 m
    cfg["training"]["focal_length_scale"] = 30
    return cfg


@pytest.mark.parametrize("name", ["vfdepth_ddad_fusion", "vfdepth_ddad_fsm",
                                  "augdepth"])
def test_reference_matches_the_program(name):
    cfg = _config(name)
    port = program.build_model(cfg, SEED, "cpu")
    ref = RefModel.on(cfg, "cpu")
    weights_mod.load(ref, weights_mod.make(program.param_spec(cfg), SEED,
                                           "cpu"))
    frames = scene.make_framesets(2, SEED, cfg, "cpu")
    one = scene.collate(frames[:1])
    # serving an aug configuration wants the rotated views' draw; the
    # reference serves the main decode alone, which the draw does not touch
    aug = ({"aug_u": torch.rand(1, 6, 3, generator=torch.Generator()
                                .manual_seed(5))} if ref.aug_depth else {})
    got, want = port.predict(one, **aug), ref.predict(one)
    # both float32; the samplers sum their taps in other orders
    rel = ((got["depth/0"] - want["depth/0"]).abs()
           / want["depth/0"]).max()
    assert float(rel) < 1e-5
    assert float((got["cam_T_cam"] - want["cam_T_cam"]).abs().max()) < 1e-6

    from vfdepth_tpu_torch.training.step import create_train_state, train_step
    two = scene.collate(frames)
    opt = create_train_state(port, steps_per_epoch=0, batch=two)
    logs = train_step(port, opt, two, 0, torch.Generator().manual_seed(3))
    trainer = RefTrainer(ref, 1e-4)
    trainer.step(two, **draw(ref, two, torch.Generator().manual_seed(3)))
    # at this size an auto-mask pixel within rounding of its tie moves the
    # loss by ~2e-5 and a gradient leaf by up to ~1%; under depth synthesis
    # a warped pixel at the depth range's bound or its mask's nearest tie
    # likewise (augdepth reads 2.9e-5 and 0.6%)
    assert abs(float(logs["total_loss"]) - trainer.losses[0]) \
        < 1e-3 * trainer.losses[0]
    for k, p in port.named_parameters():
        g = float(opt.state[p]["exp_avg"].norm()) / 0.1
        want_g = trainer.first_grad_norms[k]
        assert abs(g - want_g) <= 0.05 * max(want_g, 1e-6), k


@pytest.mark.parametrize("name", ["vfdepth_ddad_fusion", "augdepth"])
def test_the_draws_are_the_programs(name):
    """The program's step handed the harness's draws takes the step it
    takes drawing them from the same generator itself, bit for bit."""
    from vfdepth_tpu_torch.training.step import create_train_state, train_step
    cfg = _config(name)
    with torch.device("meta"):
        ref = RefModel(cfg)
    two = scene.collate(scene.make_framesets(2, SEED, cfg, "cpu"))
    logs, params = [], []
    for handed in (False, True):
        model = program.build_model(cfg, SEED, "cpu")
        opt = create_train_state(model, steps_per_epoch=0, batch=two)
        gen = torch.Generator().manual_seed(3)
        drawn = draw(ref, two, gen) if handed else {}
        logs.append(train_step(model, opt, two, 0, gen, **drawn))
        params.append(dict(model.named_parameters()))
    assert sorted(logs[0]) == sorted(logs[1])
    if ref.aug_depth:
        assert float(logs[0]["depth_con_loss"]) > 0
    for k, v in logs[0].items():
        assert torch.equal(v, logs[1][k]), k
    for k, v in params[0].items():
        assert torch.equal(v, params[1][k]), k


@pytest.mark.parametrize("name,mix", [("vfdepth_ddad_fusion", "train_b2"),
                                      ("vfdepth_ddad_fsm", "train_b2"),
                                      ("vfdepth_ddad_fusion", "serve_b1"),
                                      ("augdepth", "train_b2")])
def test_timed_path_and_check(name, mix):
    cfg, traffic = _config(name), micro.traffic(mix)
    t0 = time.perf_counter()
    if traffic["kind"] == "train":
        run = cells.train(cfg, traffic, SEED, 1.0, False, "cpu", t0)
        assert run["steps"] >= 1 and run["framesets"] == 2 * run["steps"]
        assert len(run["spans"]["batch_wait"]) == run["steps"]
        numbers = cells.check_train(cfg, SEED, run, "cpu")
        assert numbers["loss_gap"] < 1e-3
        assert numbers["grad_gap"] < 0.05 and numbers["change_gap"] < 0.1
    else:
        run = cells.serve(cfg, traffic, SEED, 1.0, False, "cpu", t0)
        assert run["requests"] == len(run["spans"]["request"]) >= 1
        numbers = cells.check_serve(cfg, SEED, run, "cpu")
        assert numbers["depth_gap"] < 1e-5 and numbers["pose_gap"] < 1e-6
    assert run["setup_s"] > 0 and run["window_s"] >= 1.0
