"""What runs on the card loads neither JAX nor the JAX package (compared
by whole top-level module names), and the plain reference loads nothing of
the program (CPU, fresh interpreters)."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    tops = _loaded("import benchmark.reference.model, benchmark.flops, "
                   "benchmark.compare, benchmark.weights, benchmark.scene")
    assert "vfdepth_tpu_torch" not in tops
    assert not tops & {"jax", "jaxlib", "flax", "vfdepth_tpu"}


def test_a_run_loads_no_jax():
    tops = _loaded(
        "import time, torch\n"
        "torch.set_num_threads(2)\n"
        "from benchmark import cells, micro, run\n"
        "cfg = micro.config('vfdepth_ddad_fusion')\n"
        "r = cells.serve(cfg, micro.traffic('serve_b1'), 5, 0.2, False, "
        "'cpu', time.perf_counter())\n"
        "cells.check_serve(cfg, 5, r, 'cpu')\n"
        "assert run.forbidden_modules() == []")
    assert "vfdepth_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "vfdepth_tpu"}
