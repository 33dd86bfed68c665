"""The port's benchmark (``python -m vfdepth_tpu_torch.bench``) on the CPU.

The bench's own configuration is the production model at 384x640, too
large for a CPU test: ``bench_config`` is replaced by the 6-camera micro
model at 32x64 (what the bench times is its concern on the card). With
``--cpu`` and ``BENCH_STEPS=2`` ``main`` must run its headline cell and
both extras (the "even" rig and batch 2) and print one JSON line with the
root ``bench.py``'s keys, finite and positive, plus the device it ran on;
each timed window goes to stderr. No JAX.
"""
import json
import math

import pytest

from vfdepth_tpu_torch import bench, presets
from helpers_torch_threads import port_threads  # noqa: F401


def _micro(batch_size, height, width, use_bf16):
    return presets.micro_config(cameras=presets.DDAD_CAM_LIST,
                                height=height, width=width,
                                batch_size=batch_size,
                                mixed_precision=use_bf16)


@pytest.fixture
def cpu_bench(monkeypatch):
    monkeypatch.setattr(bench, "bench_config", _micro)
    for key, value in (("BENCH_HEIGHT", "32"), ("BENCH_WIDTH", "64"),
                       ("BENCH_STEPS", "2")):
        monkeypatch.setenv(key, value)
    for key in ("BENCH_RIG", "BENCH_BATCH", "BENCH_EXTRAS", "BENCH_BF16"):
        monkeypatch.delenv(key, raising=False)


def test_bench_prints_the_root_bench_keys(cpu_bench, capsys):
    assert bench.main(["--cpu"]) == 0
    out, err = capsys.readouterr()
    result = json.loads(out.strip().splitlines()[-1])
    assert {"metric", "value", "unit", "vs_baseline", "extra"} <= set(result)
    assert result["metric"] == "6cam_samples_per_sec_per_chip"
    assert "batch 1, 32x64, bf16 train step" in result["unit"]
    assert result["device"].startswith("cpu")
    extra = result["extra"]
    assert set(extra) == {"step_ms", "mfu_pct_bf16_peak",
                          "even_rig_samples_per_sec",
                          "batch2_samples_per_sec"}
    numbers = [result["value"], result["vs_baseline"], *extra.values()]
    assert all(math.isfinite(v) and v > 0 for v in numbers), numbers
    assert result["vs_baseline"] == pytest.approx(
        result["value"] / bench.BASELINE_SAMPLES_PER_SEC, abs=1e-3)
    # three timed windows a run: the headline, the even rig, batch 2
    windows = [line for line in err.splitlines() if ": window " in line]
    assert len(windows) == 3 * bench.REPEATS
    assert sum("even batch 1" in w for w in windows) == bench.REPEATS
    assert sum("nuscenes batch 2" in w for w in windows) == bench.REPEATS


def test_bench_needs_the_card_unless_asked_for_the_cpu(cpu_bench,
                                                       monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
