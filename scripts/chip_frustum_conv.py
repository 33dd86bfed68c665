"""The depth net's frustum convolutions (``VFNet.reduce_dim_0``, 3,200 ->
256 channels, and ``reduce_dim_1``, 256 -> 128; reflect-padded 3x3 on 48x80
pixels) timed alone on the card by route, and a survey of which
convolutions of the whole model run cuDNN's FFT algorithms.

    python3 scripts/chip_frustum_conv.py [--reps 20] [--seed 1] [--no-survey]
        [--out build/frustum_conv.json]

Each layer takes its input as the model hands it over: ``reduce_dim_0``
K3's output ``[N, h*w, d*C]`` viewed as channels_last ``[N, d*C, h, w]``,
``reduce_dim_1`` ``reduce_dim_0``'s NCHW output. Routes:

* ``batch``: ``ConvBlock`` on the whole batch (``F.pad(mode="reflect")``
  writes an NCHW copy, then one conv call);
* ``nhwc``: the reflect pad on the NHWC memory (a 3-D reflect pad of the
  ``[N, 1, h, w, C]`` view) and the conv on the channels_last result;
* ``per_image``: ``ConvBlock(per_image=True)``, one conv call an image.

For 6 images (a serving request of the published DDAD fusion config) and
12 (a training step at batch 2), each of forward, input gradient and weight
gradient: device ms (CUDA events, median of ``--reps`` calls after warm-up),
host ms to enqueue a call, the profiler's device ops a call with their
names, and the bound: the conv's FLOPs over 67 TFLOP/s (f32, no tensor
cores). TF32 is off in cuDNN and matmul, as in the benchmark. Each route's
output and gradients, without the activation, are compared with the same
block's in f64 (largest difference over the largest magnitude).

The survey runs one ``predict`` of the published config (benchmark
weights and framesets), records every ``conv2d`` call's shapes and
layouts, and replays each alone at batch 1 and 2, listing the FFT kernels
(names with ``fft`` or ``cf32``) of its forward and of its backward.

Prints a table and writes every number to ``--out`` as JSON. Needs a CUDA
device; no cell of the benchmark runs it.
"""
from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402

from vfdepth_tpu_torch.models.blocks import ConvBlock, activation  # noqa: E402

PEAK_FLOPS = 67e12
H, W, BINS, C_PRE = 48, 80, 50, 64
LAYERS = {"reduce_dim_0": (BINS * C_PRE, 256), "reduce_dim_1": (256, 128)}
FFT_MARKS = ("fft", "cf32")


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    except OSError:
        out = ""
    return out or torch.cuda.get_device_name(0)


def nhwc_route(block: ConvBlock, x: torch.Tensor) -> torch.Tensor:
    """The block padded on its input's NHWC memory and convolved
    channels_last (cuDNN is handed NHWC tensors)."""
    nhwc = x.permute(0, 2, 3, 1)[:, None]
    p = block.pad
    padded = F.pad(nhwc, (0, 0, p, p, p, p), mode="reflect")[:, 0]
    return activation(block.conv(padded.permute(0, 3, 1, 2)), block.nonlin)


def _route(block: ConvBlock, per_image: bool):
    def run(x):
        block.per_image = per_image
        return block(x)
    return run


def _device_ops(fn, tries: int = 3):
    """(device ops a call, {kernel name: count}) by the profiler, over one
    call after one warm call; a profile that saw no device op (short
    profiles on the card sometimes come back empty) is taken again."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    names = {}
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                names[e.name] = names.get(e.name, 0) + 1
        if names:
            break
    return sum(names.values()), names


def _time(fn, reps: int):
    """(median device ms a call by CUDA events, median host ms to enqueue)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        fn()
        host.append(1e3 * (time.perf_counter() - t0))
        b.record()
        b.synchronize()
        dev.append(a.elapsed_time(b))
    return statistics.median(dev), statistics.median(host)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _input(layer: str, layout: str, n: int, cin: int, dev):
    """(leaf, the layer's input view, leaf gradient -> NCHW)."""
    if layer == "reduce_dim_0" or layout == "nhwc":
        leaf = torch.randn(n, H, W, cin, device=dev, requires_grad=True)
        return (leaf, leaf.permute(0, 3, 1, 2),
                lambda g: g.permute(0, 3, 1, 2))
    leaf = torch.randn(n, cin, H, W, device=dev, requires_grad=True)
    return leaf, leaf, lambda g: g


def frustum_rows(reps: int, seed: int, dev="cuda"):
    rows, checks = [], []
    for name, (cin, cout) in LAYERS.items():
        torch.manual_seed(seed)
        block = ConvBlock(cin, cout, 3).to(dev)
        w, b = block.conv.weight, block.conv.bias
        routes = {"batch": _route(block, False),
                  "nhwc": lambda x: nhwc_route(block, x),
                  "per_image": _route(block, True)}
        for n in (6, 12):
            flops = 2.0 * n * H * W * cout * cin * 9
            bound_ms = 1e3 * flops / PEAK_FLOPS
            torch.manual_seed(seed + n)
            values = torch.randn(n, cin, H, W, device=dev)
            g_nchw = torch.randn(n, cout, H, W, device=dev)
            for route, fwd in routes.items():
                leaf, x, _ = _input(name, route, n, cin, dev)
                with torch.no_grad():
                    x.copy_(values)
                    y0 = fwd(x)
                g = torch.empty_like(y0).copy_(g_nchw)    # in y's layout
                y = fwd(x)
                phases = {
                    "forward": lambda: _nograd(fwd, x),
                    "input_grad": lambda: torch.autograd.grad(
                        y, [leaf], g, retain_graph=True),
                    "weight_grad": lambda: torch.autograd.grad(
                        y, [w, b], g, retain_graph=True),
                }
                for phase, fn in phases.items():
                    ms, host_ms = _time(fn, reps)
                    ops, names = _device_ops(fn)
                    top = sorted(names.items(), key=lambda kv: -kv[1])[:6]
                    rows.append(dict(
                        layer=name, images=n, route=route, phase=phase,
                        device_ms=ms, host_ms=host_ms, device_ops=ops,
                        bound_ms=bound_ms, share=bound_ms / ms,
                        fft=any(m in k.lower() for k in names
                                for m in FFT_MARKS),
                        tf32=any("tf32" in k.lower() for k in names),
                        kernels=[f"{k[:90]} x{c}" for k, c in top]))
                del y, y0, leaf, x
            checks += _checks(name, n, block, routes, values, g_nchw, dev)
            del values, g_nchw
            torch.cuda.empty_cache()
    return rows, checks


def _checks(name, n, block, routes, values, g_nchw, dev):
    """Each route's output and gradients against the same block in f64,
    without the activation (whose kink a rounding can cross): the largest
    difference over the largest magnitude."""
    nonlin, block.nonlin = block.nonlin, None
    ref = copy.deepcopy(block).double()
    ref.per_image = False
    xr = values.double().requires_grad_(True)
    yr = ref(xr)
    want = (yr,) + torch.autograd.grad(
        yr, [xr, ref.conv.weight, ref.conv.bias], g_nchw.double())
    out = []
    for route, fwd in routes.items():
        leaf, x, to_nchw = _input(name, route, n, values.shape[1], dev)
        with torch.no_grad():
            x.copy_(values)
        y = fwd(x)
        g = torch.empty_like(y).copy_(g_nchw)
        dx, dw, db = torch.autograd.grad(
            y, [leaf, block.conv.weight, block.conv.bias], g)
        got = (y.detach(), to_nchw(dx), dw, db)
        out.append(dict(layer=name, images=n, route=route, **{
            part: _rel(a.double(), b.detach())
            for part, a, b in zip(("y", "dx", "dw", "db"), got, want)}))
    block.nonlin = nonlin
    return out


def _nograd(fwd, x):
    with torch.no_grad():
        return fwd(x)


def _is_nhwc(x: torch.Tensor) -> bool:
    return (x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last))


class _Convs(TorchFunctionMode):
    """Records every ``conv2d`` call: the innermost module entered, shapes,
    whether the input is channels_last, and the call's arguments."""

    def __init__(self):
        super().__init__()
        self.module = "?"
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (F.conv2d, torch.conv2d):
            x, wt = args[0], args[1]
            rest = list(args[3:])
            self.calls.append(dict(
                module=self.module, x=tuple(x.shape), w=tuple(wt.shape),
                nhwc=_is_nhwc(x), dtype=str(x.dtype),
                bias=(len(args) > 2 and args[2] is not None)
                or kwargs.get("bias") is not None,
                args=[tuple(a) if isinstance(a, (list, tuple)) else a
                      for a in rest], kwargs={k: v for k, v in kwargs.items()
                                              if k != "bias"}))
        return func(*args, **kwargs)


def survey(seed: int, cfg=None, dev="cuda"):
    from benchmark import cells, program, scene
    cfg = cfg or json.loads(
        (ROOT / "benchmark/configs/vfdepth_ddad_fusion.json").read_text())
    program.set_precision(cfg)
    model = program.build_model(cfg, seed, dev)
    frame = scene.collate(scene.make_framesets(1, seed, cfg, dev),
                          cells.serve_keys(cfg))
    mode = _Convs()
    hooks = []
    for net_name, net in (("depth_net", model.depth_net),
                          ("pose_net", model.pose_net)):
        for name, mod in net.named_modules():
            full = f"{net_name}.{name}" if name else net_name

            def pre(_m, _a, full=full):
                mode.module = full
            hooks.append(mod.register_forward_pre_hook(pre))
    with mode:
        model.predict(frame)
    for h in hooks:
        h.remove()
    del model
    torch.cuda.empty_cache()
    seen, rows = set(), []
    for c in mode.calls:
        key = (c["module"], c["x"], c["w"], c["nhwc"])
        if key in seen:
            continue
        seen.add(key)
        for scale in (1, 2):
            shape = (c["x"][0] * scale,) + c["x"][1:]
            if c["nhwc"]:
                x = torch.randn(shape[0], shape[2], shape[3], shape[1],
                                device=dev).permute(0, 3, 1, 2)
            else:
                x = torch.randn(shape, device=dev)
            x.requires_grad_(True)
            wt = torch.randn(c["w"], device=dev, requires_grad=True)
            bias = (torch.randn(c["w"][0], device=dev, requires_grad=True)
                    if c["bias"] else None)

            def fwd():
                return F.conv2d(x, wt, bias, *c["args"], **c["kwargs"])
            y = fwd()
            g = torch.ones_like(y)

            def bwd():
                torch.autograd.grad(y, [x, wt], g, retain_graph=True)
            row = dict(module=c["module"], x=list(shape), w=list(c["w"]),
                       nhwc=c["nhwc"])
            for phase, fn in (("forward", fwd), ("backward", bwd)):
                ops, names = _device_ops(fn)
                row[phase] = dict(ops=ops, fft=sorted(
                    k[:70] for k in names
                    if any(m in k.lower() for m in FFT_MARKS)))
            rows.append(row)
            del y, g, x, wt, bias
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--no-survey", action="store_true")
    p.add_argument("--out", type=Path,
                   default=ROOT / "build" / "frustum_conv.json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_frustum_conv: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = dict(card=_card(), torch=torch.__version__,
               cuda=torch.version.cuda,
               cudnn=torch.backends.cudnn.version())
    print(json.dumps(out))
    rows, checks = frustum_rows(args.reps, args.seed)
    out.update(rows=rows, checks=checks)
    print("layer images route phase device_ms host_ms ops bound_ms share "
          "fft tf32")
    for r in rows:
        print(f"{r['layer']} {r['images']} {r['route']} {r['phase']} "
              f"{r['device_ms']:.3f} {r['host_ms']:.3f} {r['device_ops']} "
              f"{r['bound_ms']:.3f} {100 * r['share']:.1f}% {r['fft']} "
              f"{r['tf32']}")
        for k in r["kernels"]:
            print("    ", k)
    for c in checks:
        print("check", json.dumps(c))
    if not args.no_survey:
        out["survey"] = survey(args.seed)
        for r in out["survey"]:
            print("survey", json.dumps(r))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
