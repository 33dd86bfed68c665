"""The depth-synthesis readers (``aug_decode_device_ms.train``,
``synthesis_device_ms.train``) on hand-built trace events (CPU): one
training step whose forward opens the rotated decode's span inside the
depth net's, the depth warp's inside the render's and the synthesis
loss's inside the losses', with the backward's kernels launched from
autograd's thread. Each reader gives the device time launched inside its
spans, forward only, and nothing (None) where the trace holds none of
them: a fusion step, or a program without the spans."""
from __future__ import annotations

import pytest

from benchmark import run
from benchmark.test_bench_spans import _call, _dev, _op
from benchmark.trace import Trace

AUTOGRAD = 2
UNITS = 2


def _step(aug: bool):
    """One training step (the stretch counts it as two units); with
    ``aug`` the depth-synthesis spans and their kernels."""
    ev = [
        _op("vf.train_step", 0, 300),
        _op("vf.step.forward", 5, 195),
        _op("vf.nets.depth", 10, 60),
        _call("cudaLaunchKernel", 12, 1, 1),
        _dev("kernel", "sample3d", 14, 6, 1),
        _op("vf.geometry.render", 80, 50),
        _call("cudaLaunchKernel", 82, 1, 4),
        _dev("kernel", "warp_image_mask", 84, 8, 4),
        _op("vf.losses", 140, 50),
        _call("cudaLaunchKernel", 142, 1, 6),
        _dev("kernel", "reprojection", 144, 5, 6),
        _op("vf.step.backward", 200, 90),
        _op("autograd::engine::evaluate_function", 205, 80, tid=AUTOGRAD),
        _call("cudaLaunchKernel", 210, 1, 8, tid=AUTOGRAD),
        _dev("kernel", "sample3d_bwd", 212, 30, 8),
    ]
    if aug:
        ev += [
            _op("vf.nets.depth.aug", 40, 25),
            _call("cudaLaunchKernel", 42, 1, 2),
            _dev("kernel", "sample3d", 44, 7, 2),
            _call("cudaLaunchKernel", 55, 1, 3),
            _dev("kernel", "decoder_conv", 56, 9, 3),
            _op("vf.geometry.warp_depth", 110, 15),
            _call("cudaLaunchKernel", 112, 1, 5),
            _dev("kernel", "grid_sample", 114, 4, 5),
            _op("vf.losses.synthesis", 170, 15),
            _call("cudaLaunchKernel", 172, 1, 7),
            _dev("kernel", "depth_consistency", 174, 3, 7),
        ]
    return ev


def _record(kind, events):
    return {"kind": kind, "host_trace": Trace(events), "trace_units": UNITS}


def _read(name, r):
    return run.reader(name)(r)


def test_depth_synthesis_readers():
    r = _record("train", _step(aug=True))
    assert _read("aug_decode_device_ms.train", r) == pytest.approx(
        (7 + 9) / 1e3 / UNITS)
    assert _read("synthesis_device_ms.train", r) == pytest.approx(
        (4 + 3) / 1e3 / UNITS)
    # the spans nest inside the ones that held their kernels before: the
    # forward's reader still counts every forward kernel, the backward's
    # the backward's alone
    assert _read("forward_device_ms.train", r) == pytest.approx(
        (6 + 7 + 9 + 8 + 4 + 5 + 3) / 1e3 / UNITS)
    assert _read("backward_device_ms.train", r) == pytest.approx(
        30 / 1e3 / UNITS)


@pytest.mark.parametrize("case", ["fusion_step", "no_entry_span",
                                  "serving", "untraced"])
def test_depth_synthesis_readers_read_nothing_without_their_spans(case):
    if case == "fusion_step":
        r = _record("train", _step(aug=False))
    elif case == "no_entry_span":
        r = _record("train", [e for e in _step(aug=True)
                              if not e["name"].startswith("vf.")])
    elif case == "serving":
        r = _record("serve", _step(aug=True))
    else:
        r = {"kind": "train", "host_trace": None, "trace_units": UNITS}
    for name in ("aug_decode_device_ms.train", "synthesis_device_ms.train"):
        assert _read(name, r) is None, name
