"""The program's spans (``vfdepth_tpu_torch/utils/tracing.py``) on the CPU.

One micro model (``presets.micro_config``, 3 cameras at 32x64, the plain
samplers) feeds one batch through ``device_prefetch``, runs one
``train_step`` and serves one request. Without a profiler ``span`` is the
shared no-op, and the step's loss, gradients, updated parameters and the
request's outputs are the same bits as under ``torch.profiler`` with CPU
activity. Under the profiler the exported trace holds every span of the
layers, each inside the span listed as its parent, as often as a step or
a request opens it (``vf.geometry.render`` once per scale). Under depth
synthesis the step also opens ``vf.nets.depth.aug``,
``vf.geometry.warp_depth`` and ``vf.losses.synthesis``.
"""
import collections
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vfdepth_tpu_torch import presets
from vfdepth_tpu_torch.data import FakeDataset
from vfdepth_tpu_torch.data.loader import device_prefetch
from vfdepth_tpu_torch.training import (VFDepthModel, create_train_state,
                                        train_step)
from vfdepth_tpu_torch.utils import tracing
from helpers_torch_threads import fixed_threads, port_threads  # noqa: F401


def _tree(n_scales):
    """(span, its parent, opened how often) over one batch fed, one step
    and one request of the merged fusion path."""
    step = "vf.train_step"
    fwd = "vf.step.forward"
    return [("vf.loader.pin", None, 1), ("vf.loader.upload", None, 1),
            (step, None, 1), (fwd, step, 1),
            ("vf.step.backward", step, 1),
            ("vf.parallel.grad_average", step, 1),
            ("vf.step.optimizer", step, 1),
            ("vf.geometry.poses", fwd, 1), ("vf.geometry.windows", fwd, 1),
            ("vf.geometry.render", fwd, n_scales), ("vf.losses", fwd, 1),
            ("vf.predict", None, 1)] + [
        (name, parent, 1)
        for parent in (fwd, "vf.predict")
        for name in ("vf.model.upload", "vf.nets.encode",
                     "vf.nets.backproject", "vf.nets.pose", "vf.nets.depth")]


def _spans(events):
    """The ``vf.*`` spans of an exported trace, each with its parent: the
    shortest other span of the same thread that holds it."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("name", "").startswith("vf.")]
    out = []
    for e in spans:
        holders = [p for p in spans if p is not e and p["tid"] == e["tid"]
                   and p["ts"] <= e["ts"]
                   and e["ts"] + e["dur"] <= p["ts"] + p["dur"]]
        parent = min(holders, key=lambda p: p["dur"]) if holders else None
        out.append((e["name"], parent["name"] if parent else None))
    return out


def _aug_tree(n_scales):
    """The spans of one batch fed and one step under depth synthesis: the
    step's spans, the rotated view's decode inside the depth net's span,
    its depth warp inside each scale's render and its loss terms inside
    the losses' span, once a scale."""
    step = [t for t in _tree(n_scales)
            if "vf.predict" not in (t[0], t[1])]
    return step + [("vf.nets.depth.aug", "vf.nets.depth", 1),
                   ("vf.geometry.warp_depth", "vf.geometry.render",
                    n_scales),
                   ("vf.losses.synthesis", "vf.losses", n_scales)]


def _run(cfg, tmp_path=None, serve=True):
    """One batch fed, one step and (``serve``) one request of a fresh
    seeded model; under the profiler (``tmp_path`` given) with the trace's
    events."""
    model = VFDepthModel(cfg, device="cpu", seed=0)
    model.plain_samplers = True
    ds = FakeDataset(num_samples=1, num_cams=cfg.num_cams, height=cfg.height,
                     width=cfg.width, fusion_level=cfg.fusion_level,
                     rig="nuscenes")
    host = ds.batch([0])
    opt = create_train_state(model, steps_per_epoch=0, batch=host)
    gen = torch.Generator().manual_seed(0)

    def work():
        batch = next(device_prefetch(iter([host]), device="cpu"))
        logs = train_step(model, opt, batch, 0, gen)
        return logs, model.predict(host) if serve else {}

    with fixed_threads():
        if tmp_path is None:
            logs, out = work()
            events = None
        else:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                logs, out = work()
            path = tmp_path / "trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return logs, grads, params, out, events


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = presets.micro_config()
    plain = _run(cfg)
    traced = _run(cfg, tmp_path_factory.mktemp("trace"))
    return cfg, plain, traced


def test_span_is_the_shared_no_op_without_a_profiler():
    assert tracing.span("vf.a") is tracing.span("vf.b") is tracing._NOOP
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.span("vf.a") is not tracing._NOOP
    assert tracing.span("vf.a") is tracing._NOOP


def test_a_traced_step_and_request_give_the_same_bits(runs):
    _, plain, traced = runs
    for a, b in zip(plain[:4], traced[:4]):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert plain[1], "the step left no gradient"


def test_every_span_nested_and_counted(runs):
    cfg, _, traced = runs
    got = collections.Counter(_spans(traced[4]))
    want = {(name, parent): n for name, parent, n in _tree(len(cfg.scales))}
    assert got == want


@pytest.fixture(scope="module")
def aug_runs(tmp_path_factory):
    cfg = presets.micro_config(aug_depth=True)
    plain = _run(cfg, serve=False)
    traced = _run(cfg, tmp_path_factory.mktemp("aug_trace"), serve=False)
    return cfg, plain, traced


def test_depth_synthesis_spans_nested_and_counted(aug_runs):
    """Under ``aug_depth`` the rotated decode, the depth warp and the
    synthesis loss open their spans inside the ones that held them
    before, so every reader of those attributes the same operations; the
    traced step gives the same bits as the untraced one. (A fusion step
    opens none of them: ``test_every_span_nested_and_counted``.)"""
    cfg, plain, traced = aug_runs
    got = collections.Counter(_spans(traced[4]))
    want = {(name, parent): n
            for name, parent, n in _aug_tree(len(cfg.scales))}
    assert got == want
    for a, b in zip(plain[:3], traced[:3]):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert "depth_con_loss" in plain[0] and plain[1]


def test_unmerged_nets_open_one_pose_and_one_depth_span(tmp_path):
    """Without the merged back-projection each net's whole call is its
    span; there is no encode or back-projection span."""
    cfg = presets.micro_config()
    model = VFDepthModel(cfg, device="cpu", seed=0)
    model.plain_samplers = True
    model.merge_backproject = False
    ds = FakeDataset(num_samples=1, num_cams=cfg.num_cams, height=cfg.height,
                     width=cfg.width, fusion_level=cfg.fusion_level,
                     rig="nuscenes")
    with fixed_threads(), profile(activities=[ProfilerActivity.CPU]) as prof:
        model.predict(ds.batch([0]))
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert collections.Counter(_spans(events)) == {
        ("vf.predict", None): 1, ("vf.model.upload", "vf.predict"): 1,
        ("vf.nets.pose", "vf.predict"): 1,
        ("vf.nets.depth", "vf.predict"): 1}
