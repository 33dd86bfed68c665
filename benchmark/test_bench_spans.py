"""``benchmark/spans.py`` and the readers of the program's spans on
hand-built trace events (CPU): a span tree on the step's thread, kernels
launched from a second thread inside ``vf.step.backward``, a kernel found
by its host operator's external id alone, host calls that wait for the
device inside and outside the entry span, and host-to-device copies with
their bytes; the exact values each reader gives."""
from __future__ import annotations

import pytest

from benchmark import run, spans
from benchmark.trace import Trace

MAIN, AUTOGRAD = 1, 2
UNITS = 2


def _op(name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _call(name, ts, dur, corr, tid=MAIN):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
            "dur": dur, "tid": tid, "args": {"correlation": corr}}


def _dev(cat, name, ts, dur, corr, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": 7, "args": dict(correlation=corr, **args)}


def _train_events():
    """One training step (the stretch counts it as two units)."""
    return [
        _op("vf.loader.pin", 0, 10), _op("vf.loader.upload", 10, 10),
        _call("cudaEventSynchronize", 5, 1, 90),
        _call("cudaMemcpyAsync", 12, 1, 1),
        _dev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 15, 5, 1,
             bytes=4_000_000),
        _op("vf.train_step", 20, 180),
        _op("vf.step.forward", 25, 75),
        _op("vf.nets.encode", 30, 30),
        _call("cudaLaunchKernel", 35, 1, 2),
        _dev("kernel", "encode_kernel", 40, 20, 2),
        _call("cudaLaunchKernel", 65, 1, 3),
        _dev("kernel", "loss_kernel", 70, 10, 3),
        _call("cudaMemcpyAsync", 75, 1, 4),
        _dev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 80, 2, 4,
             bytes=1_000_000),
        _call("cudaStreamSynchronize", 78, 5, 5),
        # a driver-API launch: no runtime call, its host operator's id
        _op("aten::convolution", 85, 5, **{"External id": 77}),
        _dev("kernel", "driver_kernel", 88, 4, 999, **{"External id": 77}),
        _op("vf.step.backward", 100, 80),
        _op("autograd::engine::evaluate_function", 105, 60, tid=AUTOGRAD),
        _call("cudaLaunchKernel", 110, 1, 6, tid=AUTOGRAD),
        _dev("kernel", "conv_bwd_kernel", 110, 30, 6),
        _call("cudaLaunchKernel", 150, 1, 7, tid=AUTOGRAD),
        _dev("kernel", "bn_bwd_kernel", 150, 10, 7),
        _op("vf.step.optimizer", 180, 15),
        _call("cudaLaunchKernel", 185, 1, 8),
        _dev("kernel", "adam_kernel", 185, 5, 8),
        _call("cudaMemcpy", 190, 3, 9),
        # after the step: not the entry span's
        _call("cudaStreamSynchronize", 205, 7, 10),
    ]


def _serve_events():
    return [
        _op("vf.predict", 0, 100),
        _op("vf.model.upload", 0, 20),
        _call("cudaMemcpyAsync", 2, 1, 1),
        _dev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 3, 4, 1,
             bytes=3_000_000),
        _call("cudaStreamSynchronize", 3, 4, 2),
        _op("vf.nets.depth", 20, 70),
        _call("cudaLaunchKernel", 25, 1, 3),
        _dev("kernel", "decode_kernel", 30, 50, 3),
        _call("cudaMemcpyAsync", 85, 1, 4),
        _dev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 86, 1, 4,
             bytes=1_000_000),
        _call("cudaStreamSynchronize", 85, 2, 5),
        # the client's copy of the answer, after the request
        _call("cudaMemcpyAsync", 105, 1, 6),
        _dev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 106, 2, 6,
             bytes=500_000),
        _call("cudaStreamSynchronize", 105, 3, 7),
    ]


def _record(kind, events):
    return {"kind": kind, "host_trace": Trace(events), "trace_units": UNITS}


def _read(name, r):
    return run.reader(name)(r)


def test_training_readers():
    r = _record("train", _train_events())
    assert _read("host_syncs.train", r) == 2 / UNITS
    assert _read("sync_wait_ms.train", r) == pytest.approx(8e-3 / UNITS)
    assert _read("forward_device_ms.train", r) == pytest.approx(
        (20 + 10 + 2 + 4) / 1e3 / UNITS)
    assert _read("backward_device_ms.train", r) == pytest.approx(
        (30 + 10) / 1e3 / UNITS)
    assert _read("optimizer_device_ms.train", r) == pytest.approx(
        5 / 1e3 / UNITS)
    assert _read("upload_mb.train", r) == pytest.approx(5.0 / UNITS)
    for name in ("host_syncs.serve", "sync_wait_ms.serve", "upload_mb.serve"):
        assert _read(name, r) is None


def test_serving_readers():
    r = _record("serve", _serve_events())
    assert _read("host_syncs.serve", r) == 2 / UNITS
    assert _read("sync_wait_ms.serve", r) == pytest.approx(6e-3 / UNITS)
    assert _read("upload_mb.serve", r) == pytest.approx(4.0 / UNITS)
    for name in ("host_syncs.train", "forward_device_ms.train",
                 "upload_mb.train"):
        assert _read(name, r) is None


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_nothing_to_read_without_spans(kind):
    """A program without spans (the parent of the spans), or a run without
    a trace: every reader gives None and raises nothing."""
    events = _train_events() if kind == "train" else _serve_events()
    bare = [e for e in events if not e["name"].startswith("vf.")]
    names = [f"{n}.{kind}" for n in ("host_syncs", "sync_wait_ms",
                                       "upload_mb")] + (
        [f"{p}_device_ms.train" for p in ("forward", "backward", "optimizer")]
        if kind == "train" else [])
    for r in (_record(kind, bare),
              {"kind": kind, "host_trace": None, "trace_units": UNITS}):
        for name in names:
            assert _read(name, r) is None, name


def test_split_coverage_and_table():
    sp = spans.Spans(Trace(_train_events()))
    cov = sp.coverage("train")
    assert cov["device_in_spans"] == 1.0
    assert cov["split_of_device"] == pytest.approx(1.0)
    rows = {row[0]: row[1:] for row in sp.table(1)}
    assert rows["vf.train_step"][0] == 1
    # host self time: the step's own 20-25 and 195-200
    assert rows["vf.train_step"][1] == pytest.approx(10 / 1e3)
    assert rows["vf.nets.encode"][2] == pytest.approx(20 / 1e3)
    # device busy 15-20, 40-60, 70-82, 88-92, 110-140, 150-160, 185-190:
    # the idle gaps 20-40 (step 5, forward 5, encode 10), 60-70
    # (forward), 82-88 (forward), 92-110 (forward 8, backward 10), 140-150
    # (backward), 160-185 (backward 20, optimizer 5)
    assert rows["vf.nets.encode"][3] == pytest.approx(10 / 1e3)
    assert rows["vf.train_step"][3] == pytest.approx(5 / 1e3)
    assert rows["vf.step.forward"][3] == pytest.approx((5 + 10 + 6 + 8) / 1e3)
    assert rows["vf.step.backward"][3] == pytest.approx((10 + 10 + 20) / 1e3)
    assert rows["vf.step.optimizer"][3] == pytest.approx(5 / 1e3)
    assert cov["idle_in_spans"] == 1.0


def test_the_other_thread_first_then_any():
    """A launch on a thread with a span of its own goes to that span, even
    inside another thread's span."""
    events = _train_events() + [
        _op("vf.geometry.render", 120, 10, tid=AUTOGRAD),
        _call("cudaLaunchKernel", 125, 1, 50, tid=AUTOGRAD),
        _dev("kernel", "render_kernel", 141, 2, 50)]
    sp = spans.Spans(Trace(events))
    owners = {op["name"]: (s["name"] if s else None)
              for op, s in sp.device_ops}
    assert owners["render_kernel"] == "vf.geometry.render"
    assert owners["conv_bwd_kernel"] == "vf.step.backward"
