"""Arithmetic shared by the metric readers of ``benchmark/metrics/``.

A reader is a file ``benchmark/metrics/<metric name>.py`` with a function
``read(r)`` that takes the run's record (``run.py``: the cell's kind, the
window's counts and host spans, the analytic FLOPs, the peaks, and in a
traced run two traces of ``trace_units`` steps or requests each: ``trace``
of the device's activity alone, ``host_trace`` with the host's operators)
and returns the metric's value, or None where the cell has nothing for it
to read.
"""
from __future__ import annotations

import importlib.util
import re
import statistics
from pathlib import Path
from types import ModuleType
from typing import Callable, List, Mapping, Optional

from .trace import grid_size

KERNELS_DIR = Path(__file__).resolve().parent / "kernels"


def span_ms(r: Mapping, kind: str, name: str) -> Optional[float]:
    """The mean host milliseconds of a span in the window, per step or
    request, in cells of ``kind``."""
    values = r["spans"].get(name) if r["kind"] == kind else None
    return 1e3 * statistics.fmean(values) if values else None


def p95(values: List[float]) -> float:
    """The 95th percentile of every value (linear between order
    statistics, Python's inclusive method)."""
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def traced(r: Mapping, kind: str) -> bool:
    return r["kind"] == kind and r.get("trace") is not None


def _matcher(names) -> Callable[[str], bool]:
    pats = [re.compile(r"(^|[\s:])" + re.escape(n) + r"\s*[<(]")
            for n in names]
    return lambda s: any(p.search(s) for p in pats)


def kernel_ops() -> List[ModuleType]:
    """The port kernels' operation files ``benchmark/kernels/<op>.py``:
    each names the kernels that implement the operation (``KERNELS``), the
    kernel whose launches carry its bound (``BOUND_PER_LAUNCH_OF``), and
    the bytes and FLOPs of one such launch (``nbytes(v)``, ``flops(v)``) from
    the cell's variables (``counts.py``) and the launch's ``grid``."""
    out = []
    for path in sorted(KERNELS_DIR.glob("*.py")):
        spec = importlib.util.spec_from_file_location(
            "benchmark_kernel_" + path.stem, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out.append(mod)
    return out


def port_kernels_roofline(r: Mapping) -> Optional[float]:
    """The port kernels' least time (each launch of an operation's main
    kernel: bytes over the HBM rate against FLOPs over the peak, the
    larger) over the device time of all their kernels, in percent; None
    where the trace holds none of them."""
    tr, var = r["trace"], r["vars"]
    bound = spent = 0.0
    for op in kernel_ops():
        spent += tr.device_s(_matcher(op.KERNELS))
        for k in tr.kernels(_matcher(op.BOUND_PER_LAUNCH_OF)):
            v = dict(var, grid=grid_size(k))
            bound += max(op.nbytes(v) / r["hbm_bytes_per_s"],
                         op.flops(v) / r["peak_flops"])
    return 100.0 * bound / spent if spent > 0 else None


def conv_roofline(r: Mapping) -> Optional[float]:
    """Analytic convolution FLOPs of the traced stretch over the device
    time of the kernels that PyTorch's convolution operators (forward and
    backward) launched, against the precision's peak, in percent."""
    spent = r["host_trace"].device_s_under(("convolution",))
    if spent <= 0:
        return None
    return 100.0 * r["flops"]["conv"] * r["trace_units"] / (
        spent * r["peak_flops"])


def idle_pct(r: Mapping) -> float:
    return 100.0 * (1.0 - r["trace"].busy_s() / r["trace_wall"])


def step_mfu(r: Mapping) -> Optional[float]:
    """Analytic FLOPs of the traced stretch over the device's span of it
    (the first device operation's start to the last one's end, idle gaps
    included) and the precision's peak, in percent."""
    span = r["trace"].device_span_s()
    if span <= 0:
        return None
    return 100.0 * r["flops"]["total"] * r["trace_units"] / (
        span * r["peak_flops"])


def collective_ms(r: Mapping) -> Optional[float]:
    tr = r["trace"]
    spent = sum(k["dur"] for k in tr.kernels(lambda s: "nccl" in s.lower()))
    return spent / 1e3 / r["trace_units"] if spent > 0 else None
