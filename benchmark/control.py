"""The control of ``correct`` and the readings of the faults a cell can
have, at the cell's own size, on the card.

    python3 benchmark/control.py --workload <name> --seeds 1 2 3

The control is the plain reference put in the program's place and
computed one precision below the configuration's: float32 with TF32 on in
cuDNN and matmul, where the configuration states float32 with TF32 off.
For a training cell the faults are read too: half of each batch left out
(the reference stepped on the first half, the mean taken over it), a step
that returns its state unchanged (``change_gap`` reads 1 by its
definition; nothing is run for it) and, on several ranks, the exchange
between them left out (the reference stepped on rank 0's shard alone). A
serving cell's answer altered where it is produced is read as one depth
map scaled by 1.01. Each line printed is one seed's numbers, as the
benchmark compares them; the benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import cells, compare, program, scene  # noqa: E402
from benchmark import weights as weights_mod  # noqa: E402
from benchmark.reference.model import RefModel, RefTrainer, draws  # noqa: E402
from benchmark.run import cell_of, load_json  # noqa: E402


def _tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def ref_steps(cfg, seed, batches, device, tf32=False, keep=None):
    """The reference's checked steps -> (losses, first gradient norms, the
    change's norms), as the program's run records them; ``keep`` takes
    that many framesets of each batch and of each draw, on its batch
    axis."""
    _tf32(tf32)
    ref = RefModel.on(cfg, device)
    ref.checkpoint = batches[0]["color/0/0"].shape[0] > 2
    weights_mod.load(ref, weights_mod.make(program.param_spec(cfg), seed,
                                           device))
    w0 = {k: p.detach().clone() for k, p in ref.named_parameters()}
    trainer = RefTrainer(ref, float(cfg["training"]["learning_rate"]))
    gen = torch.Generator(device).manual_seed(seed)
    for batch in batches:
        specs = draws(ref, batch)
        drawn = {d.name: d.sample(gen) for d in specs}
        if keep:
            batch = {key: v[:keep] for key, v in batch.items()}
            drawn = {d.name: drawn[d.name].narrow(d.batch_axis, 0, keep)
                     for d in specs}
        trainer.step(batch, **drawn)
    with torch.no_grad():
        change = {k: float((p - w0[k]).norm())
                  for k, p in ref.named_parameters()}
    out = {"losses": trainer.losses, "grad": trainer.first_grad_norms,
           "change": change, "depth": trainer.depth_stats}
    del ref, trainer, w0
    torch.cuda.empty_cache()
    _tf32(False)
    return out


def train_readings(cfg, traffic, seed, device):
    n, world = int(traffic["check_steps"]), int(traffic.get("ranks", 1))
    b = int(traffic["batch"])
    pool = (cells.global_batches(cfg, traffic, seed, device, world)
            if world > 1 else
            cells._pool(cfg, dict(traffic, pool=n), seed, device))
    base = ref_steps(cfg, seed, pool, device)
    out = {}
    faults = [("control_tf32", dict(tf32=True)),
              ("fault_half_batch", dict(keep=b * world // 2))]
    if world > 1:
        # every exchange left out: rank 0's shard alone
        faults.append(("fault_no_exchange", dict(keep=b)))
    for name, kw in faults:
        run = ref_steps(cfg, seed, pool, device, **kw)
        out[name] = compare.train_numbers(
            run["losses"], base["losses"], run["grad"], base["grad"],
            run["change"], base["change"], run["depth"], base["depth"])
    frozen = {k: 0.0 for k in base["change"]}
    unchanged = compare.train_numbers(
        base["losses"], base["losses"], base["grad"], base["grad"], frozen,
        base["change"], base["depth"], base["depth"])
    out["fault_state_unchanged"] = {
        k: unchanged[k] for k in ("change_gap", "change_gap_median")}
    return out


def serve_readings(cfg, traffic, seed, device):
    n = int(traffic["check_requests"])
    frames = [scene.collate([f], cells.serve_keys(cfg))
              for f in scene.make_framesets(n, seed, cfg, device)]

    def answers(tf32):
        _tf32(tf32)
        ref = RefModel.on(cfg, device)
        weights_mod.load(ref, weights_mod.make(program.param_spec(cfg), seed,
                                               device))
        res = []
        for f in frames:
            r = ref.predict(f)
            res.append({"depth/0": r["depth/0"].cpu(),
                        "cam_T_cam": r["cam_T_cam"].cpu()})
        del ref
        torch.cuda.empty_cache()
        _tf32(False)
        return res
    base, low = answers(False), answers(True)
    altered = [dict(base[0], **{"depth/0": base[0]["depth/0"] * 1.01})]
    return {"control_tf32": compare.serve_numbers(list(zip(low, base))),
            "fault_altered_answer": compare.serve_numbers(
                list(zip(altered, base[:1])))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    _, cfg, traffic = cell_of(load_json(Path.cwd() / "BENCHMARK.json"),
                              args.workload)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        fn = train_readings if traffic["kind"] == "train" else serve_readings
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **fn(cfg, traffic, seed, device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
