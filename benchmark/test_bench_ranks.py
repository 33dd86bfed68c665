"""The several-card launcher rehearsed on the CPU: two gloo ranks at a
micro size run the same steps, and the reference at the global batch
checks them; with the gradient exchange left out the run is not correct."""
from __future__ import annotations

import time

import torch

from benchmark import compare, micro, ranks

SEED = 2 ** 33 + 21


def _rank(*args):
    torch.set_num_threads(2)
    ranks.rank_main(*args)


def _rank_without_exchange(*args):
    torch.set_num_threads(2)
    from vfdepth_tpu_torch.training import step as step_mod
    step_mod.average_gradients = lambda params: None
    ranks.rank_main(*args)


def _launch(target, port):
    cfg = micro.config("vfdepth_ddad_fusion")
    traffic = micro.traffic("train_b2_dp4", pool=4, warm_steps=0)
    return ranks.launch(cfg, traffic, SEED, 0.5, False, 2, port,
                        time.perf_counter(), target=target, use_cpu=True)


def test_two_ranks_take_the_same_steps_and_check():
    runs, numbers = _launch(_rank, 29531)
    assert len(runs) == 2 and runs[0]["steps"] == runs[1]["steps"] >= 1
    assert numbers["loss_gap"] < 1e-3 and numbers["grad_gap"] < 0.05


def test_exchange_left_out_is_not_correct():
    _, numbers = _launch(_rank_without_exchange, 29533)
    assert not compare.verdict(numbers, compare.limits("fusion_train_dp4"))
