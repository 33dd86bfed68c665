"""The timed paths of the program under test, driven as its users drive
them, and the check of what they produced against the plain reference.

``train`` is ``Trainer.learn``'s inner loop: batches from the program's
``device_prefetch`` (pinned on the host and uploaded on a side stream
ahead of the step) over a pool of distinct host batches, cycled, and the
program's ``train_step`` with the learner's generator. The set-up builds
the model and the optimizer once, sizes the warp windows from the first
batch (``create_train_state``), and drives the first steps through that
same feed and call: the first three are the ones the reference follows.
The window then goes on with the same objects. At most two steps are in
flight: before step i the host waits for step i - 2 to finish, as a loop
that reads its losses one step late does.

``serve`` is one vehicle's stream of framesets over
``VFDepthModel.predict``, a closed loop with one client: each request
hands a host frameset to the program, which uploads it, and copies the
scale-0 depth of every camera and ``cam_T_cam`` back to the host; the
next request starts when that one is on the host. Its latency runs from
the frameset in hand to the answers on the host.

Each returns a plain dict of numbers, spans and, for a traced run, the
device trace of a stretch of steps or requests at the window's end.
"""
from __future__ import annotations

import collections
import gc
import itertools
import random
import time
from typing import Callable, Dict, List, Mapping, Optional

import torch

from . import compare, counts, program, scene
from . import trace as trace_mod
from . import weights as weights_mod



def serve_keys(cfg: Mapping):
    """What a serving client sends: the frames' images, the calibration
    at full and at the fusion resolution, the mask."""
    lev = int(cfg["model"]["fusion_level"]) + 1
    return (*(f"color_aug/{f}/0" for f in cfg["training"]["frame_ids"]),
            "K/0", f"K/{lev}", f"inv_K/{lev}", "mask", "extrinsics",
            "extrinsics_inv")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _pool(cfg, traffic, seed, device, rank=0, world=1) -> List[Dict]:
    """This rank's shard of the traffic's pool of host batches."""
    b, n = int(traffic["batch"]), int(traffic["pool"])
    mine = list(range(rank, n, world))
    frames = scene.make_framesets(n * b, seed, cfg, device,
                                  indices=[i * b + j for i in mine
                                           for j in range(b)])
    return [scene.collate(frames[k * b:(k + 1) * b])
            for k in range(len(mine))]


def global_batches(cfg, traffic, seed, device, world: int) -> List[Dict]:
    """The global batches of the checked steps of ``world`` ranks: at step
    i rank r takes its shard's batch i, the pool's r + world * i, and the
    global batch stacks the ranks' in rank order."""
    b, n = int(traffic["batch"]), int(traffic["pool"])
    per = n // world
    steps = [[r + world * (i % per) for r in range(world)]
             for i in range(int(traffic["check_steps"]))]
    need = sorted({g for s in steps for g in s})
    frames = scene.make_framesets(n * b, seed, cfg, device,
                                  indices=[g * b + j for g in need
                                           for j in range(b)])
    at = {g: frames[k * b:(k + 1) * b] for k, g in enumerate(need)}
    return [scene.collate([f for g in s for f in at[g]]) for s in steps]


def _traced(fn, device, warm) -> Dict:
    """Two traced stretches of the same work: the device's activity alone
    (busy and idle time, kernels), then with the host's operators (which
    operator launched a kernel, what the host did in a gap). A first
    profiled unit (``warm``) starts the profiler's machinery and is
    dropped."""
    trace_mod.profiled(warm, device)
    tr, wall = trace_mod.profiled(fn, device)
    host, host_wall = trace_mod.profiled(fn, device, host_ops=True)
    return dict(trace=tr, trace_wall=wall, host_trace=host,
                host_trace_wall=host_wall)


def train(cfg: Mapping, traffic: Mapping, seed: int, seconds: float,
          trace: bool, device, t_start: float, rank: int = 0, world: int = 1,
          fixed_steps: Optional[Callable[[float], int]] = None) -> Dict:
    """One rank of a training cell; see the module's docstring.
    ``fixed_steps`` (several ranks) turns a measured step time into the
    window's number of steps, the same on every rank."""
    from vfdepth_tpu_torch.data import loader
    from vfdepth_tpu_torch.training import step as step_mod

    program.set_precision(cfg)
    pool = _pool(cfg, traffic, seed, device, rank, world)
    model = program.build_model(cfg, seed, device)
    opt = step_mod.create_train_state(model, steps_per_epoch=0,
                                      batch=pool[0])
    gen = torch.Generator(device).manual_seed(seed)
    feed = loader.device_prefetch(itertools.cycle(pool),
                                  size=int(cfg["tpu"]["prefetch_depth"]),
                                  device=device)
    params = dict(model.named_parameters())
    out: Dict = {"losses": [], "overflow": [], "depth": []}
    step = 0

    def one(spans: Optional[Dict[str, List[float]]] = None):
        nonlocal step
        t0 = time.perf_counter()
        batch = next(feed)
        t1 = time.perf_counter()
        logs = step_mod.train_step(model, opt, batch, step, gen)
        t2 = time.perf_counter()
        if spans is not None:
            spans["batch_wait"].append(t1 - t0)
            spans["dispatch"].append(t2 - t1)
            spans["step_start"].append(t0)
        step += 1
        return logs

    n_check = int(traffic["check_steps"])
    for i in range(n_check):
        logs = one()
        out["losses"].append(float(logs["total_loss"]))
        out["depth"].append({k: float(logs[f"depth/{k}"])
                             for k in ("mean", "max", "min")})
        out["overflow"].append(float(logs.get("warp_window_overflow", 0.0)))
        if i == 0:
            out["grad"] = {k: float(opt.state[p]["exp_avg"].norm()) / 0.1
                           for k, p in params.items()}
    w0 = weights_mod.make(program.param_spec(cfg), seed, device)
    with torch.no_grad():
        out["change"] = {k: float((p - w0[k]).norm())
                         for k, p in params.items()}
    del w0
    # steps that warm the host and the device after the checked ones; the
    # last ones are timed
    for _ in range(int(traffic["warm_steps"])):
        one()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(2):
        one()
    _sync(device)
    n_fixed = fixed_steps(
        (time.perf_counter() - t0) / 2) if fixed_steps else None
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    out["setup_s"] = time.perf_counter() - t_start

    spans = collections.defaultdict(list)
    inflight: List = []
    first = step
    t0 = time.perf_counter()
    while (step - first < n_fixed if n_fixed is not None
           else time.perf_counter() - t0 < seconds):
        one(spans)
        if torch.device(device).type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            inflight.append(ev)
            if len(inflight) > 2:
                inflight.pop(0).synchronize()
    _sync(device)
    out["window_s"] = time.perf_counter() - t0
    out["steps"] = step - first
    out["framesets"] = out["steps"] * int(traffic["batch"])
    out["spans"] = dict(spans)
    if trace:
        n_tr = int(traffic["trace_steps"])
        out.update(_traced(lambda: [one() for _ in range(n_tr)], device,
                           one), trace_units=n_tr)
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                         if torch.device(device).type == "cuda" else 0)
    out["check_batches"] = pool[:n_check]
    out["vars"] = counts.variables(cfg, pool[0], device)
    del model, opt, feed, params, pool
    _free(device)
    return out


def check_train(cfg: Mapping, seed: int, run: Mapping, device
                ) -> Dict[str, float]:
    """The reference follows the checked steps from the same weights,
    batches and draws -> the numbers compared."""
    from .reference.model import RefModel, RefTrainer, draw
    program.set_precision(cfg)
    ref = RefModel.on(cfg, device)
    weights_mod.load(ref, weights_mod.make(program.param_spec(cfg), seed,
                                           device))
    # above the published batch the nets' activations are recomputed in
    # the backward pass, so a global batch fits on one card
    ref.checkpoint = run["check_batches"][0]["color/0/0"].shape[0] > 2
    w0 = {k: p.detach().clone() for k, p in ref.named_parameters()}
    trainer = RefTrainer(ref, float(cfg["training"]["learning_rate"]))
    gen = torch.Generator(device).manual_seed(seed)
    for batch in run["check_batches"]:
        trainer.step(batch, **draw(ref, batch, gen))
    with torch.no_grad():
        change = {k: float((p - w0[k]).norm())
                  for k, p in ref.named_parameters()}
    numbers = compare.train_numbers(run["losses"], trainer.losses,
                                    run["grad"], trainer.first_grad_norms,
                                    run["change"], change, run["depth"],
                                    trainer.depth_stats)
    del ref, trainer, w0
    _free(device)
    return numbers


def serve(cfg: Mapping, traffic: Mapping, seed: int, seconds: float,
          trace: bool, device, t_start: float) -> Dict:
    """One vehicle's stream of requests in a closed loop, one client; see
    the module's docstring."""
    program.set_precision(cfg)
    n = int(traffic["pool"])
    pool = [scene.collate([f], serve_keys(cfg))
            for f in scene.make_framesets(n, seed, cfg, device)]
    model = program.build_model(cfg, seed, device)
    answers: List = []
    spans = collections.defaultdict(list)

    def request(i: int, timed: bool = False):
        frame = pool[i % n]
        t0 = time.perf_counter()
        res = model.predict(frame)
        t1 = time.perf_counter()
        depth, pose = res["depth/0"].cpu(), res["cam_T_cam"].cpu()
        t2 = time.perf_counter()
        if timed:
            spans["dispatch"].append(t1 - t0)
            spans["request"].append(t2 - t0)
            answers.append((i % n, depth, pose))

    for i in range(int(traffic["warm_requests"])):
        request(i)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    out: Dict = {"setup_s": time.perf_counter() - t_start}
    i = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        request(i, timed=True)
        i += 1
    out["window_s"] = time.perf_counter() - t0
    out["requests"] = i
    out["spans"] = dict(spans)
    if trace:
        n_tr = int(traffic["trace_requests"])
        out.update(_traced(lambda: [request(i + j) for j in range(n_tr)],
                           device, lambda: request(i)), trace_units=n_tr)
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                         if torch.device(device).type == "cuda" else 0)
    out["vars"] = counts.variables(cfg, pool[0], device)
    # the sample the reference checks: drawn from the seed, the last
    # request always in it
    k = min(int(traffic["check_requests"]), len(answers))
    picks = sorted(set(random.Random(seed).sample(range(len(answers)), k)
                       ) | {len(answers) - 1})
    out["check"] = [(answers[j][0], answers[j][1], answers[j][2])
                    for j in picks]
    out["check_frames"] = {j: pool[j] for j, _, _ in out["check"]}
    del model, answers
    _free(device)
    return out


def check_serve(cfg: Mapping, seed: int, run: Mapping, device
                ) -> Dict[str, float]:
    from .reference.model import RefModel
    program.set_precision(cfg)
    ref = RefModel.on(cfg, device)
    weights_mod.load(ref, weights_mod.make(program.param_spec(cfg), seed,
                                           device))
    cache: Dict = {}
    pairs = []
    for j, depth, pose in run["check"]:
        if j not in cache:
            r = ref.predict(run["check_frames"][j])
            cache[j] = {"depth/0": r["depth/0"].cpu(),
                        "cam_T_cam": r["cam_T_cam"].cpu()}
        pairs.append(({"depth/0": depth, "cam_T_cam": pose}, cache[j]))
    del ref
    _free(device)
    return compare.serve_numbers(pairs)
