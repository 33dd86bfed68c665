"""The published depth-synthesis training step on the card, at published
widths, through the benchmark's own timed path and check, before it is a
cell: the readings from which its limits and its bound are set.

    python3 benchmark/augdepth_probe.py --checks 1 2 3 --controls 4 5 6 \
        --windows 7 8 9 --out readings.jsonl

The configuration is ``configs/vfdepth_ddad_fusion.json`` with the three
keys that 42dot/VFDepth's ``configs/ddad/ddad_surround_fusion_augdepth.yaml``
changes (``augdepth``), under the ``train_b2`` traffic. ``--checks``: for
each seed a short window of ``cells.train``, then ``cells.check_train``
(the numbers compared, the check's seconds, the reference's peak
memory). ``--controls``: ``control.py``'s readings (the TF32 control, half
of each batch left out, a state left unchanged). ``--windows``: a window
of ``--window-seconds`` each, its framesets a second and the check. One
JSON line a seed and stage on standard output, and the same lines appended
to ``--out``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# what the published augdepth configuration changes in the fusion one
AUGDEPTH = {"training": {"aug_depth": True},
            "loss": {"depth_con_coeff": 0.03, "depth_sm_coeff": 0.05}}


def augdepth(cfg: dict) -> dict:
    """A copy of a fusion configuration with depth synthesis on."""
    out = copy.deepcopy(cfg)
    for section, keys in AUGDEPTH.items():
        out[section].update(keys)
    return out


def _emit(line: dict, out: Path) -> None:
    text = json.dumps(line)
    print(text, flush=True)
    with open(out, "a") as f:
        f.write(text + "\n")


def probe(cfg: dict, traffic: dict, device, args, out: Path) -> None:
    """The stages of ``args`` (``main``'s options) on ``device``."""
    import torch
    from benchmark import cells, control
    cuda = torch.device(device).type == "cuda"
    kind = torch.cuda.get_device_name(0) if cuda else str(device)
    # the first run's set-up counts from the process's start, as a
    # benchmark run's does; a later one's from its own start
    starts = [T_START]

    def timed_and_checked(stage, seed, seconds):
        t_start = starts.pop() if starts else time.perf_counter()
        run = cells.train(cfg, traffic, seed, seconds, False, device,
                          t_start)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        numbers = cells.check_train(cfg, seed, run, device)
        _emit({"stage": stage, "seed": seed, "device": kind,
               "setup_s": run["setup_s"], "window_s": run["window_s"],
               "steps": run["steps"],
               "framesets_per_s": run["framesets"] / run["window_s"],
               "peak_bytes": run["peak_bytes"],
               "check_s": time.perf_counter() - t0,
               "ref_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                  if cuda else 0),
               "overflow": run["overflow"], "numbers": numbers}, out)

    for seed in args.checks:
        timed_and_checked("check", seed, args.check_seconds)
    for seed in args.windows:
        timed_and_checked("window", seed, args.window_seconds)
    for seed in args.controls:
        t0 = time.perf_counter()
        readings = control.train_readings(cfg, traffic, seed, device)
        _emit({"stage": "control", "seed": seed, "device": kind,
               "seconds": time.perf_counter() - t0, **readings}, out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checks", type=int, nargs="*", default=[])
    p.add_argument("--controls", type=int, nargs="*", default=[])
    p.add_argument("--windows", type=int, nargs="*", default=[])
    p.add_argument("--check-seconds", type=float, default=3.0)
    p.add_argument("--window-seconds", type=float, default=51.0)
    p.add_argument("--out", type=Path, required=True,
                   help="the JSON lines file the readings are appended to")
    args = p.parse_args(argv)

    import torch
    from benchmark.run import THREADS, load_json
    torch.set_num_threads(THREADS)
    if not torch.cuda.is_available():
        print("augdepth_probe: needs a CUDA device", file=sys.stderr)
        return 2
    cfg = augdepth(load_json(ROOT / "benchmark" / "configs"
                             / "vfdepth_ddad_fusion.json"))
    traffic = load_json(ROOT / "benchmark" / "traffic" / "train_b2.json")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    probe(cfg, traffic, torch.device("cuda", 0), args, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
