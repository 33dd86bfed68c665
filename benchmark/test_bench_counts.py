"""The yardstick's arithmetic against hand-worked values (CPU): FLOPs of a
convolution, a frustum sample's rows and points, a kernel's roofline
share, a rate over the whole window, a p95 over every request and the
device's busy time as the union of overlapping spans."""
from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest
import torch

from benchmark import counts, flops, readers
from benchmark.trace import Trace

METRICS = Path(__file__).resolve().parent / "metrics"


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_flops_of_one_convolution():
    with torch.device("meta"):
        conv = torch.nn.Conv2d(64, 128, 3, padding=1)
        x = torch.empty(2, 64, 48, 80)
        got = flops.of(lambda: conv(x))
    # 2 FLOPs a multiply-add, per output element cin * 3 * 3 of them
    assert got["conv"] == 2 * (2 * 128 * 48 * 80) * 64 * 9
    assert got["total"] == got["conv"]


def test_frustum_rows_and_live_points():
    # a 3x3x3 volume: (0, 0, 0) lands on voxel (1, 1, 1) exactly (one row,
    # weight 1), (0.25, 0, 0) between x = 1 and 2 (two rows, one shared),
    # x = 2 outside (no weight anywhere)
    ndc = torch.tensor([[[0.0, 0.0, 0.0], [0.25, 0.0, 0.0],
                         [2.0, 0.0, 0.0]]])
    assert counts.frustum_counts(ndc, (3, 3, 3)) == (2, 2)


def _kernel(name, ts, dur, grid=(1, 1, 1)):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"grid": list(grid)}}


def test_k3_roofline_share():
    tr = Trace([_kernel("void sample3d_trilinear_kernel<float>(float const*)",
                        0.0, 1.0)])
    var = dict(rows=10, vc=64, fpts=100, live=50)
    r = {"trace": tr, "vars": var, "hbm_bytes_per_s": 3.35e12,
         "peak_flops": 67e12}
    nbytes = 4 * (10 * 64 + 100 * 3 + 100 * 64)
    want = 100.0 * (nbytes / 3.35e12) / 1e-6
    assert readers.port_kernels_roofline(r) == pytest.approx(want, rel=1e-12)


def test_rate_over_the_whole_window():
    read = _reader("train_framesets_per_s")
    assert read({"kind": "train", "framesets": 30, "window_s": 7.5}) == 4.0
    assert read({"kind": "serve"}) is None


def test_p95_over_every_request():
    read = _reader("request_ms_p95")
    lat = [i / 1000.0 for i in range(1, 201)]      # 1..200 ms
    # inclusive: 1 + 0.95 * 199 = 190.05th value
    assert read({"kind": "serve", "spans": {"request": lat}}) == \
        pytest.approx(190.05)


def test_idle_is_the_union_of_overlapping_spans():
    tr = Trace([_kernel("a", 0.0, 10.0), _kernel("b", 5.0, 10.0),
                {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
                 "ts": 20.0, "dur": 5.0}])
    assert tr.busy_s() == pytest.approx(20e-6)
    read = _reader("device_idle_pct.train")
    r = {"kind": "train", "trace": tr, "trace_wall": 40e-6}
    assert read(r) == pytest.approx(50.0)


def test_mfu_over_chips_and_window():
    read = _reader("mfu_pct")
    r = {"flops": {"total": 5e12}, "units_per_chip": 20, "window_s": 10.0,
         "peak_flops": 67e12}
    assert read(r) == pytest.approx(100.0 * 5e12 * 20 / 10.0 / 67e12)


def _k5_share(grid, var):
    tr = Trace([_kernel("void warp_image_mask_kernel<float>(float const*)",
                        0.0, 1.0, grid=(grid, 1, 1))])
    r = {"trace": tr, "vars": var, "hbm_bytes_per_s": 3.35e12,
         "peak_flops": 67e12}
    return readers.port_kernels_roofline(r)


@pytest.mark.parametrize("grid, sources", [
    # a dense launch of 2 warps of 16x32: sources read whole
    (4, 2 * 16 * 32),
    # a launch over windows of 256 target pixels: its sources counted as
    # its target pixels, not the two whole images
    (1, 256),
])
def test_k5_counts_the_sources_a_launch_reads(grid, sources):
    var = dict(k5_nb=2, H=16, W=32)
    pixels = grid * 256
    nbytes = 4 * (4 * sources + 12 * pixels)
    want = 100.0 * (nbytes / 3.35e12) / 1e-6
    assert _k5_share(grid, var) == pytest.approx(want, rel=1e-12)


def test_step_mfu_over_the_device_span():
    # busy 0-10 us and 30-40 us: the span is 40 us, idle gap included
    tr = Trace([_kernel("a", 0.0, 10.0), _kernel("b", 30.0, 10.0)])
    read = _reader("step_mfu_pct.train")
    r = {"kind": "train", "trace": tr, "trace_units": 2,
         "flops": {"total": 1e6}, "peak_flops": 67e12}
    assert read(r) == pytest.approx(100.0 * 2e6 / (40e-6 * 67e12))
    assert _reader("step_mfu_pct.serve")(r) is None
