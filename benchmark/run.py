"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. The cell names
its configuration (``benchmark/configs/<name>.json``) and its traffic mix
(``benchmark/traffic/<name>.json``); each metric is read by
``benchmark/metrics/<metric name>.py``. With ``--trace 0`` the line carries
the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones. The
program under test is ``vfdepth_tpu_torch`` on CUDA; without enough cards
the run prints no result and fails.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` with
``--trace 1``), then ``compared``, each number compared with its limit.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import socket  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "vfdepth_tpu")
THREADS = 2


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_of(bench: dict, workload: str):
    """(workload entry, configuration dict, traffic dict)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the benchmark has "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return (cell, load_json(ROOT / conf["file"]),
            load_json(ROOT / "benchmark" / "traffic"
                      / f"{cell['traffic']}.json"))


def metrics_of(bench: dict, workload: str, traced: bool) -> list:
    """The cell's metric entries: end-to-end ones without a trace,
    per-layer ones with it (a metric with a ``workloads`` list only in
    those cells)."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def reader(name: str):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def record(cfg: dict, traffic: dict, cell: dict, runs: list) -> dict:
    """The readers' view of a run: rank 0's record with the world's
    counts."""
    from benchmark import flops as flops_mod
    r = dict(runs[0])
    peaks = load_json(ROOT / "benchmark" / "peaks.json")
    kind = traffic["kind"]
    r.update(kind=kind, chips=int(cell["chips"]),
             peak_flops=float(peaks["flops"][cfg.get("peak", "f32")]),
             hbm_bytes_per_s=float(peaks["hbm_bytes_per_s"]),
             peak_bytes=max(x["peak_bytes"] for x in runs),
             setup_s=max(x["setup_s"] for x in runs),
             window_s=max(x["window_s"] for x in runs))
    if kind == "train":
        r["framesets"] = sum(x["framesets"] for x in runs)
        r["units_per_chip"] = r["framesets"] / int(traffic["batch"]) / len(
            runs)
        r["flops"] = flops_mod.count(cfg, int(traffic["batch"]), True)
    else:
        r["units_per_chip"] = r["requests"]
        r["flops"] = flops_mod.count(cfg, int(traffic["batch"]), False)
    return r


def result_line(bench, workload, cfg, traffic, cell, runs, numbers, lim,
                traced, device_kind) -> dict:
    from benchmark import compare
    r = record(cfg, traffic, cell, runs)
    metrics = {}
    for m in metrics_of(bench, workload, traced):
        value = reader(m["name"])(r)
        if value is None:
            if not traced:
                raise RuntimeError(f"{m['name']} has nothing to read in "
                                   f"{workload}")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    kind = traffic["kind"]
    device = {"platform": "gpu", "kind": device_kind,
              "count": int(cell["chips"]),
              "memory_peak_bytes": int(r["peak_bytes"])}
    line = {"correct": compare.verdict(numbers, lim),
            "attempted": int(r["steps"] if kind == "train"
                             else r["requests"]),
            "failed": 0, "metrics": metrics, "device": device}
    if traced:
        tr = r["trace"]
        device.update(busy_s=tr.busy_s(), window_s=r["trace_wall"])
        line["breakdown"] = {"device_ops": tr.top_ops(10),
                             "idle_gaps": r["host_trace"].idle_gaps(10)}
    line["compared"] = {k: {"value": numbers[k], "limit": v}
                        for k, v in lim.items()}
    return line


def run_single(workload, cfg, traffic, seed, seconds, trace, device):
    from benchmark import cells
    if traffic["kind"] == "train":
        run = cells.train(cfg, traffic, seed, seconds, trace, device, T_START)
        t0 = time.perf_counter()
        numbers = cells.check_train(cfg, seed, run, device)
        st = run["spans"]["step_start"]
        gaps = sorted(b - a for a, b in zip(st, st[1:])) or [0.0]
        print(f"run: step ms min {1e3 * gaps[0]:.3f}, median "
              f"{1e3 * gaps[len(gaps) // 2]:.3f}, max {1e3 * gaps[-1]:.3f}",
              file=sys.stderr)
    else:
        run = cells.serve(cfg, traffic, seed, seconds, trace, device, T_START)
        t0 = time.perf_counter()
        numbers = cells.check_serve(cfg, seed, run, device)
        req = sorted(run["spans"]["request"])
        print(f"run: request ms min {1e3 * req[0]:.3f}, median "
              f"{1e3 * req[len(req) // 2]:.3f}, max {1e3 * req[-1]:.3f}",
              file=sys.stderr)
    print(f"run: set-up {run['setup_s']:.3f} s, window {run['window_s']:.3f} "
          f"s, check {time.perf_counter() - t0:.3f} s; warp window overflow "
          f"of the checked steps {run.get('overflow')}", file=sys.stderr)
    return [run], numbers


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(workload, cfg, traffic, seed, seconds, trace, world):
    """One process a card, over NCCL, each running the cell on its shard;
    rank 0's record and the reference's check come back with the others'
    counts."""
    from benchmark import ranks
    return ranks.launch(cfg, traffic, seed, seconds, trace, world,
                        _free_port(), T_START)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = load_json(Path.cwd() / "BENCHMARK.json")
    cell, cfg, traffic = cell_of(bench, args.workload)
    import torch
    # the host launches the device's work; a few threads for its own
    # tensor copies keep it from contending with itself
    torch.set_num_threads(THREADS)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run: the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from benchmark import compare
    lim = compare.limits(args.workload)
    world = int(traffic.get("ranks", 1))
    if world > 1:
        runs, numbers = run_ranks(args.workload, cfg, traffic, args.seed,
                                  args.seconds, bool(args.trace), world)
    else:
        runs, numbers = run_single(args.workload, cfg, traffic, args.seed,
                                   args.seconds, bool(args.trace),
                                   torch.device("cuda", 0))
    line = result_line(bench, args.workload, cfg, traffic, cell, runs,
                       numbers, lim, bool(args.trace),
                       torch.cuda.get_device_name(0))
    bad = forbidden_modules()
    if bad:
        print(f"run: modules of the JAX package or JAX are loaded: {bad}",
              file=sys.stderr)
        return 3
    for k, v in numbers.items():
        if k not in lim:
            print(f"reading {k}: {v!r}", file=sys.stderr)
    for k, v in line["compared"].items():
        print(f"compared {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
