"""Where a cell's time goes, by the program's spans: one cell of the
benchmark driven through ``benchmark.cells`` on the card, then its traced
stretch with host operators read by ``benchmark/spans.py``.

    python3 scripts/chip_spans.py --workload fusion_train_b2 --seed 1601 \
        [--seconds 10] [--units 3]

Prints, a step (training) or a request (serving): each ``vf.*`` span's
calls, host self time, device time of what it launched and the idle time
under it; the same stretch's idle gaps labelled by the innermost host
operator (the benchmark's breakdown); the host calls that wait for the
device by span and operator; the shares the spans cover; the cell's
per-layer metrics; the stretch's wall time a unit, with and without the
host's operators recorded; and what ``span`` costs with no profiler.
``--units`` traces that many steps or requests (the traffic's own count
by default). The window is not the benchmark's: its numbers are in
``benchmark/run.py --trace 1``'s line.
"""
from __future__ import annotations

import argparse
import collections
import subprocess
import sys
import time
import timeit
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import cells, run, spans  # noqa: E402


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    return out or torch.cuda.get_device_name(0)


def _span_cost_us(n: int = 200_000) -> float:
    """Microseconds a ``with span(...)`` block costs with no profiler."""
    from vfdepth_tpu_torch.utils.tracing import span

    def block():
        with span("vf.cost"):
            pass
    return 1e6 * min(timeit.repeat(block, number=n, repeat=5)) / n


def _sync_sites(sp: spans.Spans, units: int, n: int = 12):
    """Waiting calls by (span, innermost host operator): calls and host ms
    a unit, most waiting first."""
    by = collections.defaultdict(lambda: [0, 0.0])
    for c in sp.trace.launch.values():
        if c.get("name") not in spans.SYNC_CALLS:
            continue
        own = sp.owner(c.get("tid"), c["ts"])
        op = sp.trace._innermost(c.get("tid"), c["ts"])
        key = (own["name"] if own else "(no span)",
               op["name"] if op else "(no operator)", c["name"])
        by[key][0] += 1
        by[key][1] += c["dur"]
    rows = sorted(by.items(), key=lambda kv: -kv[1][1])[:n]
    return [(k, v[0] / units, v[1] / 1e3 / units) for k, v in rows]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--units", type=int, default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_spans: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(run.THREADS)
    bench = run.load_json(ROOT / "BENCHMARK.json")
    cell, cfg, traffic = run.cell_of(bench, args.workload)
    kind = traffic["kind"]
    if args.units:
        key = "trace_steps" if kind == "train" else "trace_requests"
        traffic = dict(traffic, **{key: args.units})
    device = torch.device("cuda", 0)
    print(f"card: {_card()}; torch {torch.__version__}", flush=True)
    fn = cells.train if kind == "train" else cells.serve
    out = fn(cfg, traffic, args.seed, args.seconds, True, device,
             time.perf_counter())
    units = out["trace_units"]
    r = run.record(cfg, traffic, cell, [out])
    sp = spans.Spans(out["host_trace"])
    unit = "step" if kind == "train" else "request"
    print(f"\n{args.workload}, seed {args.seed}: {units} {unit}s traced; "
          f"ms a {unit}: device-only stretch "
          f"{1e3 * out['trace_wall'] / units:.3f}, with host operators "
          f"{1e3 * out['host_trace_wall'] / units:.3f}")
    print(f"\n{'span':28s} {'calls':>6s} {'self ms':>9s} {'device ms':>10s} "
          f"{'idle ms':>9s}   (a {unit})")
    for name, calls, self_ms, dev_ms, idle_ms in sp.table(units):
        print(f"{name:28s} {calls:6.2f} {self_ms:9.3f} {dev_ms:10.3f} "
              f"{idle_ms:9.3f}")
    print("\nidle gaps by innermost host operator (s in the stretch):")
    for name, s in out["host_trace"].idle_gaps(10):
        print(f"  {s:8.4f}  {name}")
    print(f"\nwaiting calls a {unit} by (span, operator, call): calls, "
          f"host ms")
    for key, n, ms in _sync_sites(sp, units):
        print(f"  {n:7.2f} {ms:9.3f}  {' / '.join(key)}")
    print("\ncoverage: " + ", ".join(
        f"{k} {100 * v:.2f}%" for k, v in sp.coverage(kind).items()))
    print("\nper-layer metrics of the cell (this stretch):")
    for m in run.metrics_of(bench, args.workload, True):
        value = run.reader(m["name"])(r)
        print(f"  {m['name']}: {value!r} {m['unit']}")
    print(f"\nspan with no profiler: {_span_cost_us():.4f} us a block")
    return 0


if __name__ == "__main__":
    sys.exit(main())
