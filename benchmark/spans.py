"""The program's spans in a traced stretch, and what falls inside them.

The program marks its layers with spans named ``vf.*``
(``vfdepth_tpu_torch/utils/tracing.py``): in a trace with the host's
operators (``Trace.ops``) each is a host operator on the thread that
opened it, on the clock of the device's activity. Here:

- a device operation (kernel, copy, memset) belongs to the span that its
  launch falls inside. The launch is the CUDA runtime call of the same
  correlation id (``Trace.launch``), or, where the trace keeps none (a
  driver-API launch), the start of the host operator of the same external
  id. First choice: the innermost ``vf.*`` span open on the launching
  thread. Otherwise the innermost one open on any thread: the backward's
  kernels, launched by autograd's device thread while the step's thread
  waits in ``vf.step.backward``, go to that span;
- a host call that waits for the device (``SYNC_CALLS``) belongs to a
  span by the same rule;
- the idle time between the device's busy spans is cut at the spans'
  boundaries, and each piece goes to the innermost span open on any thread
  over it.

A pattern names a span (``vf.train_step``) or, ending in a dot, a family
(``vf.loader.``); an operation is under a pattern where its span or one
that holds it on the same thread matches. The readers of
``benchmark/metrics/`` divide by the stretch's ``trace_units`` and read
nothing (None) where the program has no entry span: a program without
spans, or a cell of the other kind.
"""
from __future__ import annotations

import bisect
import collections
import functools
import weakref
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

PREFIX = "vf."
# host calls that return only when the device has caught up
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
ENTRY = {"train": "vf.train_step", "serve": "vf.predict"}
# what a training step's device time splits into
SPLIT = {"forward": ("vf.step.forward",), "backward": ("vf.step.backward",),
         "optimizer": ("vf.step.optimizer",), "loader": ("vf.loader.",)}


def _matches(name: str, patterns: Iterable[str]) -> bool:
    return any(name == p or (p.endswith(".") and name.startswith(p))
               for p in patterns)


class _Timeline:
    """The innermost of a set of spans at each moment: the spans'
    boundaries cut time into pieces, each held by the shortest span that
    holds all of it (None between spans)."""

    def __init__(self, spans: List[dict]):
        cuts = sorted({t for e in spans
                       for t in (e["ts"], e["ts"] + e["dur"])})
        self.cuts = cuts
        self.inner: List[Optional[dict]] = []
        for a, b in zip(cuts, cuts[1:]):
            mid = 0.5 * (a + b)
            held = [e for e in spans
                    if e["ts"] <= mid <= e["ts"] + e["dur"]]
            self.inner.append(min(held, key=lambda e: e["dur"])
                              if held else None)

    def at(self, ts: float) -> Optional[dict]:
        i = bisect.bisect_right(self.cuts, ts) - 1
        return self.inner[i] if 0 <= i < len(self.inner) else None

    def pieces(self, a: float, b: float):
        """(span or None, length) of the pieces of [a, b]."""
        cuts = self.cuts
        if not cuts:
            yield None, b - a
            return
        if a < cuts[0]:
            yield None, min(b, cuts[0]) - a
        i = max(bisect.bisect_right(cuts, a) - 1, 0)
        while i < len(self.inner) and cuts[i] < b:
            lo, hi = max(a, cuts[i]), min(b, cuts[i + 1])
            if hi > lo:
                yield self.inner[i], hi - lo
            i += 1
        if b > cuts[-1]:
            yield None, b - max(a, cuts[-1])


class Spans:
    """The ``vf.*`` spans of one ``Trace`` and what they hold."""

    def __init__(self, trace):
        self.trace = trace
        by_tid: Dict[object, List[dict]] = collections.defaultdict(list)
        self.external: Dict[object, dict] = {}
        for tid, ops in trace.ops.items():
            for e in ops:
                if e.get("name", "").startswith(PREFIX):
                    by_tid[tid].append(e)
                ext = e.get("args", {}).get("External id")
                if ext is not None:
                    self.external.setdefault(ext, e)
        self.spans = [e for lst in by_tid.values() for e in lst]
        self.threads = {tid: _Timeline(lst) for tid, lst in by_tid.items()}
        self.anywhere = _Timeline(self.spans)
        self.parent: Dict[int, Optional[dict]] = {}
        for lst in by_tid.values():
            for e in lst:
                held = [p for p in lst if p is not e and p["ts"] <= e["ts"]
                        and e["ts"] + e["dur"] <= p["ts"] + p["dur"]]
                self.parent[id(e)] = (min(held, key=lambda p: p["dur"])
                                      if held else None)

    def has(self, name: str) -> bool:
        return any(e["name"] == name for e in self.spans)

    def owner(self, tid, ts: float) -> Optional[dict]:
        """The span of a host call on thread ``tid`` at ``ts``."""
        line = self.threads.get(tid)
        own = line.at(ts) if line is not None else None
        return own if own is not None else self.anywhere.at(ts)

    def under(self, span: Optional[dict], patterns: Iterable[str]) -> bool:
        patterns = tuple(patterns)
        while span is not None:
            if _matches(span["name"], patterns):
                return True
            span = self.parent.get(id(span))
        return False

    def launch(self, op: dict) -> Optional[Tuple[object, float]]:
        """(thread, time) of a device operation's launch."""
        args = op.get("args", {})
        call = self.trace.launch.get(args.get("correlation"))
        if call is not None:
            return call.get("tid"), call["ts"]
        host = self.external.get(args.get("External id"))
        return (host.get("tid"), host["ts"]) if host is not None else None

    @functools.cached_property
    def device_ops(self) -> List[Tuple[dict, Optional[dict]]]:
        """(device operation, its span or None)."""
        out = []
        for op in self.trace.device:
            at = self.launch(op)
            out.append((op, self.owner(*at) if at is not None else None))
        return out

    def device_us(self, patterns: Iterable[str]) -> float:
        patterns = tuple(patterns)
        return sum(op["dur"] for op, s in self.device_ops
                   if self.under(s, patterns))

    def syncs(self, patterns: Iterable[str]) -> List[dict]:
        """The host's calls that wait for the device, under ``patterns``."""
        patterns = tuple(patterns)
        return [c for c in self.trace.launch.values()
                if c.get("name") in SYNC_CALLS
                and self.under(self.owner(c.get("tid"), c["ts"]), patterns)]

    def upload_bytes(self, patterns: Iterable[str]) -> float:
        """Bytes of the host-to-device copies launched under
        ``patterns``."""
        patterns = tuple(patterns)
        return float(sum(op.get("args", {}).get("bytes", 0)
                         for op, s in self.device_ops
                         if op.get("cat") == "gpu_memcpy"
                         and "HtoD" in op.get("name", "")
                         and self.under(s, patterns)))

    def idle_pieces(self) -> List[Tuple[Optional[dict], float]]:
        """(span or None, µs) of the idle time between busy spans."""
        busy = self.trace.busy_intervals()
        out = []
        for (_, a), (b, _) in zip(busy, busy[1:]):
            if b > a:
                out.extend(self.anywhere.pieces(a, b))
        return out

    def self_us(self, span: dict) -> float:
        """The span's host time that no span inside it covers."""
        line = self.threads[span["tid"]]
        return sum(n for s, n in line.pieces(span["ts"],
                                             span["ts"] + span["dur"])
                   if s is span)

    def table(self, units: int) -> List[List]:
        """[span name, calls, host self ms, device ms, idle ms] a unit, in
        order of first opening, then the time no span holds."""
        rows: Dict[str, List[float]] = {}
        for e in sorted(self.spans, key=lambda e: e["ts"]):
            row = rows.setdefault(e["name"], [0.0, 0.0, 0.0, 0.0])
            row[0] += 1
            row[1] += self.self_us(e)
        rows["(no span)"] = [0.0, 0.0, 0.0, 0.0]
        for op, s in self.device_ops:
            rows[s["name"] if s else "(no span)"][2] += op["dur"]
        for s, n in self.idle_pieces():
            rows[s["name"] if s else "(no span)"][3] += n
        return [[k, v[0] / units] + [x / 1e3 / units for x in v[1:]]
                for k, v in rows.items()]

    def coverage(self, kind: str) -> Dict[str, float]:
        """Shares of the stretch that the spans hold: device time launched
        inside a span, idle time under one, and (training) the step's split
        over the device time."""
        ops = self.device_ops
        total = sum(op["dur"] for op, _ in ops)
        idle = self.idle_pieces()
        idle_total = sum(n for _, n in idle)
        out = {"device_in_spans": sum(op["dur"] for op, s in ops if s)
               / total if total else 0.0,
               "idle_in_spans": sum(n for s, n in idle if s) / idle_total
               if idle_total else 0.0}
        if kind == "train":
            out["split_of_device"] = sum(self.device_us(p)
                                         for p in SPLIT.values()) / total \
                if total else 0.0
        return out


_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def of(r: Mapping, kind: str) -> Optional[Spans]:
    """The spans of the run's stretch with host operators, in a traced run
    of a ``kind`` cell whose program opens its entry span; else None."""
    if r["kind"] != kind or r.get("host_trace") is None:
        return None
    tr = r["host_trace"]
    if tr not in _CACHE:
        _CACHE[tr] = Spans(tr)
    sp = _CACHE[tr]
    return sp if sp.has(ENTRY[kind]) else None


def host_syncs(r: Mapping, kind: str) -> Optional[float]:
    """Calls a unit that wait for the device inside the entry span."""
    sp = of(r, kind)
    return (len(sp.syncs((ENTRY[kind],))) / r["trace_units"]
            if sp is not None else None)


def sync_wait_ms(r: Mapping, kind: str) -> Optional[float]:
    """Host ms a unit in those calls."""
    sp = of(r, kind)
    if sp is None:
        return None
    return sum(c["dur"] for c in sp.syncs((ENTRY[kind],))) / 1e3 / r[
        "trace_units"]


def device_ms(r: Mapping, part: str) -> Optional[float]:
    """Device ms a training step launched under one part of ``SPLIT``."""
    sp = of(r, "train")
    return (sp.device_us(SPLIT[part]) / 1e3 / r["trace_units"]
            if sp is not None else None)


def upload_mb(r: Mapping, kind: str) -> Optional[float]:
    """Host-to-device bytes a unit (1e6 B): in training the loader's and
    the step's, in serving the request's."""
    sp = of(r, kind)
    if sp is None:
        return None
    pats = (("vf.loader.", ENTRY[kind]) if kind == "train"
            else (ENTRY[kind],))
    return sp.upload_bytes(pats) / 1e6 / r["trace_units"]
