"""The benchmark finds its cells, configurations, traffic, limits and
metric readers by name, and a cell and a metric join it as new files and
entries alone (CPU)."""
from __future__ import annotations

import filecmp
import importlib.util
import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import run

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return run.load_json(ROOT / "BENCHMARK.json")


def test_every_cell_resolves(bench):
    for cell in bench["workloads"]:
        entry, cfg, traffic = run.cell_of(bench, cell["name"])
        assert entry is cell
        assert traffic["kind"] in ("train", "serve")
        assert int(traffic.get("ranks", 1)) <= int(cell["chips"])
        assert (ROOT / "benchmark" / "limits" / f"{cell['name']}.json").is_file()
        for traced in (False, True):
            for metric in run.metrics_of(bench, cell["name"], traced):
                assert callable(run.reader(metric["name"]))
        # every cell reports set-up, another end-to-end metric and a
        # per-layer one
        e2e = {m["name"] for m in run.metrics_of(bench, cell["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert run.metrics_of(bench, cell["name"], True)


def test_contract_shapes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in bench["configs"]]
    cells = [w["name"] for w in bench["workloads"]]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) \
        == len(cells)
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= 1
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))


def _load_run(root: Path):
    spec = importlib.util.spec_from_file_location(
        "copied_run", root / "benchmark" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_add_cell_and_metric_as_new_files(tmp_path, bench):
    """A later cell (a new traffic mix and its limits) and a later metric
    (a reader) need new files and entries only: every file already there
    stays as it is."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    new = json.loads(json.dumps(bench))
    traffic = run.load_json(ROOT / "benchmark" / "traffic" / "train_b2.json")
    traffic.update(batch=1, why="batch 1 a step")
    (tmp_path / "benchmark" / "traffic" / "train_b1.json").write_text(
        json.dumps(traffic))
    (tmp_path / "benchmark" / "limits" / "fsm_train_b1.json").write_text(
        (ROOT / "benchmark" / "limits" / "fsm_train_b2.json").read_text())
    (tmp_path / "benchmark" / "metrics" / "steps_in_window.train.py"
     ).write_text('def read(r):\n    return r["framesets"] / r["batch"]\n')
    if "vfdepth_ddad_fsm" not in {c["name"] for c in new["configs"]}:
        new["configs"].append({
            "name": "vfdepth_ddad_fsm",
            "source": "https://github.com/42dot/VFDepth/blob/main/configs/"
                      "ddad/ddad_baseline.yaml",
            "file": "benchmark/configs/vfdepth_ddad_fsm.json",
            "reduced": ["weights_init", "dataset", "data_path"],
            "why": "the published FSM baseline"})
    new["workloads"].append({"name": "fsm_train_b1", "config":
                             "vfdepth_ddad_fsm", "traffic": "train_b1",
                             "chips": 1, "why": "batch 1"})
    new["per_layer"].append({"name": "steps_in_window.train", "unit": "steps",
                             "better": "higher", "source": "host_clock",
                             "layer": "entry",
                             "moves": "train_framesets_per_s",
                             "workloads": ["fsm_train_b1"]})
    for m in new["end_to_end"]:
        if m["name"] == "train_framesets_per_s":
            m["workloads"].append("fsm_train_b1")
    copied = _load_run(tmp_path)
    cell, cfg, got = copied.cell_of(new, "fsm_train_b1")
    assert got["batch"] == 1 and cfg["model"]["depth_model"] == "fsm"
    names = [m["name"] for m in copied.metrics_of(new, "fsm_train_b1", True)]
    assert names == ["steps_in_window.train"]
    assert copied.reader("steps_in_window.train")(
        {"framesets": 12, "batch": 1}) == 12
    assert "train_framesets_per_s" in [
        m["name"] for m in copied.metrics_of(new, "fsm_train_b1", False)]
    # nothing that was there changed
    cmp = filecmp.dircmp(ROOT / "benchmark", tmp_path / "benchmark",
                         ignore=["__pycache__"])

    def same(d):
        assert not d.diff_files and not d.left_only, (d.diff_files,
                                                      d.left_only)
        for sub in d.subdirs.values():
            same(sub)
    same(cmp)
