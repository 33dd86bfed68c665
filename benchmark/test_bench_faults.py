"""A run with its timed path broken underneath comes out not correct
(CPU, micro size, the cells' own limits): a step that returns its state
unchanged, half of each batch left out with the mean over the rest, an
answer altered where it is produced. The look for a card is skipped: the
cells are driven on the CPU directly."""
from __future__ import annotations

import time

import pytest
import torch

from benchmark import cells, compare, micro

SEED = 2 ** 32 + 11


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _frozen(real):
    def step(model, opt, batch, *args, **kwargs):
        before = {k: v.clone() for k, v in model.state_dict().items()}
        logs = real(model, opt, batch, *args, **kwargs)
        model.load_state_dict(before)
        return logs
    return step


def _half(real):
    def step(model, opt, batch, *args, **kwargs):
        k = batch["color/0/0"].shape[0] // 2
        return real(model, opt, {n: v[:k] for n, v in batch.items()}, *args,
                    **kwargs)
    return step


@pytest.mark.parametrize("workload,config", [
    ("fusion_train_b2", "vfdepth_ddad_fusion"),
    ("fsm_train_b2", "vfdepth_ddad_fsm")])
@pytest.mark.parametrize("fault", [_frozen, _half])
def test_broken_training_step_is_not_correct(monkeypatch, workload, config,
                                             fault):
    from vfdepth_tpu_torch.training import step as step_mod
    monkeypatch.setattr(step_mod, "train_step", fault(step_mod.train_step))
    cfg, traffic = micro.config(config), micro.traffic("train_b2")
    run = cells.train(cfg, traffic, SEED, 0.5, False, "cpu",
                      time.perf_counter())
    numbers = cells.check_train(cfg, SEED, run, "cpu")
    assert not compare.verdict(numbers, compare.limits(workload)), numbers


def test_altered_answer_is_not_correct(monkeypatch):
    from vfdepth_tpu_torch.training.model import VFDepthModel
    real = VFDepthModel.predict

    def altered(self, batch, *args, **kwargs):
        out = real(self, batch, *args, **kwargs)
        out["depth/0"] = out["depth/0"] * 1.01
        return out
    monkeypatch.setattr(VFDepthModel, "predict", altered)
    cfg, traffic = micro.config("vfdepth_ddad_fusion"), micro.traffic(
        "serve_b1")
    run = cells.serve(cfg, traffic, SEED, 0.5, False, "cpu",
                      time.perf_counter())
    numbers = cells.check_serve(cfg, SEED, run, "cpu")
    assert not compare.verdict(numbers, compare.limits("fusion_serve_b1"))
