"""The control comes out not correct: the plain reference computed one
precision below the configuration's (TF32 on, where the configuration
states float32 with TF32 off), in the program's place, at the cell's own
size, against the cell's limits. Needs a card; run there with

    python -m pytest --noconftest -m cuda benchmark/test_bench_control_cuda.py
"""
from __future__ import annotations

import pytest
import torch

from benchmark import compare, control
from benchmark.run import ROOT, cell_of, load_json

# the benchmark's one-card cells, a later one included without an edit
CELLS = [w["name"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]
         if int(w["chips"]) == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _, cfg, traffic = cell_of(load_json(ROOT / "BENCHMARK.json"), workload)
    fn = (control.train_readings if traffic["kind"] == "train"
          else control.serve_readings)
    readings = fn(cfg, traffic, 2 ** 31 + 17, torch.device("cuda", 0))
    assert not compare.verdict(readings["control_tf32"],
                               compare.limits(workload))
