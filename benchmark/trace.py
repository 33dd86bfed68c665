"""Reading the device from a ``torch.profiler`` trace.

``profiled(fn)`` runs ``fn`` under the profiler (CPU and CUDA activity),
exports the Chrome trace to a temporary file, reads it back and deletes
it. ``Trace`` then gives: the device's busy time as the union of its
kernel, copy and memset spans (the rule of the program's ``bench.py
profile_steps``), the device time of kernels by name, of kernels launched
inside given host operators (each kernel's launch, found by its
correlation id, sits inside a stack of host operators on its thread), the
launch grid of each kernel, and the idle gaps between busy spans with the
innermost host operator open at each gap's middle.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profiled(fn: Callable[[], None], device,
             host_ops: bool = False) -> Tuple["Trace", float]:
    """(the trace of ``fn``, the wall seconds of ``fn`` ending in a device
    sync, the profiler's own start and stop left out). Recording the
    host's operators (``host_ops``) costs the host tens of microseconds an
    operator, which stretches the gaps between the device's work; without
    it the trace holds the device's activity and the CUDA calls."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops
                                      else [])
    torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Trace(events), wall


class Trace:
    def __init__(self, events: Iterable[dict]):
        self.device: List[dict] = []
        self.ops: Dict[object, List[dict]] = collections.defaultdict(list)
        self.launch: Dict[object, dict] = {}
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                self.device.append(e)
            elif cat == "cpu_op":
                self.ops[e.get("tid")].append(e)
            elif cat == "cuda_runtime" and "correlation" in e.get("args", {}):
                self.launch[e["args"]["correlation"]] = e
        for lst in self.ops.values():
            lst.sort(key=lambda e: (e["ts"], -e["dur"]))
        self._starts = {tid: [e["ts"] for e in lst]
                        for tid, lst in self.ops.items()}

    # ---------------------------------------------------------- busy time
    def busy_intervals(self) -> List[Tuple[float, float]]:
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in self.device)
        merged: List[List[float]] = []
        for s, t in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        return [(s, t) for s, t in merged]

    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals()) / 1e6

    def device_span_s(self) -> float:
        """Seconds from the first device operation's start to the last
        one's end."""
        if not self.device:
            return 0.0
        return (max(e["ts"] + e["dur"] for e in self.device)
                - min(e["ts"] for e in self.device)) / 1e6

    def kernels(self, match: Optional[Callable[[str], bool]] = None
                ) -> List[dict]:
        return [e for e in self.device if e.get("cat") == "kernel"
                and (match is None or match(e.get("name", "")))]

    def device_s(self, match: Callable[[str], bool]) -> float:
        return sum(e["dur"] for e in self.kernels(match)) / 1e6

    def top_ops(self, n: int = 10) -> List[List]:
        by = collections.Counter()
        for e in self.device:
            by[e.get("name", "?")[:120]] += e["dur"] / 1e6
        return [[k, v] for k, v in by.most_common(n)]

    # ------------------------------------------------------- host context
    def _innermost(self, tid, ts: float, walk: int = 4000) -> Optional[dict]:
        """The innermost host operator open on thread ``tid`` at ``ts``:
        operators nest on a thread, so the latest-starting one that is
        still open."""
        lst = self.ops.get(tid, [])
        i = bisect.bisect_right(self._starts.get(tid, []), ts)
        for e in reversed(lst[max(0, i - walk):i]):
            if e["ts"] + e["dur"] >= ts:
                return e
        return None

    def device_s_under(self, words: Iterable[str]) -> float:
        """Device seconds of kernels launched inside a host operator whose
        name holds one of ``words`` (the launch found by its correlation
        id, the operators' spans merged per thread)."""
        words = tuple(words)
        spans: Dict[object, List[List[float]]] = {}
        for tid, lst in self.ops.items():
            merged: List[List[float]] = []
            for e in lst:
                if any(w in e["name"] for w in words):
                    s, t = e["ts"], e["ts"] + e["dur"]
                    if merged and s <= merged[-1][1]:
                        merged[-1][1] = max(merged[-1][1], t)
                    else:
                        merged.append([s, t])
            spans[tid] = merged
        starts = {tid: [m[0] for m in v] for tid, v in spans.items()}
        total = 0.0
        for e in self.kernels():
            rt = self.launch.get(e.get("args", {}).get("correlation"))
            if rt is None or rt.get("tid") not in spans:
                continue
            lst = spans[rt["tid"]]
            i = bisect.bisect_right(starts[rt["tid"]], rt["ts"]) - 1
            if i >= 0 and lst[i][1] >= rt["ts"]:
                total += e["dur"]
        return total / 1e6

    def idle_gaps(self, n: int = 10, longest: int = 400) -> List[List]:
        """The idle time of the ``longest`` gaps between busy spans, summed
        by the innermost host operator open at each gap's middle (the
        shortest such operator over the threads), longest first."""
        busy = self.busy_intervals()
        gaps = sorted(((b - a, 0.5 * (a + b)) for (_, a), (b, _)
                       in zip(busy, busy[1:]) if b > a), reverse=True)
        by = collections.Counter()
        for length, mid in gaps[:longest]:
            found = [e for e in (self._innermost(tid, mid) for tid in self.ops)
                     if e is not None]
            inner = min(found, key=lambda e: e["dur"]) if found else None
            by[inner["name"][:120] if inner else "no host operator"] += \
                length / 1e6
        return [[k, v] for k, v in by.most_common(n)]


def grid_size(kernel: dict) -> int:
    g = kernel.get("args", {}).get("grid", [0, 0, 0])
    out = 1
    for v in g:
        out *= int(v)
    return out
