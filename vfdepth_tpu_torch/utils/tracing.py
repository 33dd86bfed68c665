"""Named spans of the program on the profiler's clock.

``span(name)`` marks a stretch of the host's work: the entry calls
(``vf.train_step``, ``vf.predict``), the step's forward, backward and
optimizer, the nets, geometry and losses inside the forward, and the
loader's pinning and upload. While a ``torch.profiler`` session records,
it is a ``RecordFunction`` of that name, opened through PyTorch's fast
entry (``_RecordFunctionFast``, which skips the dispatcher that
``torch.profiler.record_function`` goes through): the span is kept in the
profiler's memory beside the host's operators and CUDA calls, on the
clock of the device trace, and an exported trace lists it among the
host's operators (category ``cpu_op``, where ``record_function``'s spans
are ``user_annotation``) on the thread that opened it. So every kernel
launch, copy, synchronising call and idle gap can be put down to the
innermost span open at that moment (``benchmark/spans.py`` does that
arithmetic). Otherwise it is one shared no-op context, and costs one
attribute check.

A span holds no counter of its own: the counts (synchronising calls,
copy bytes, launches) are read from the trace between its boundaries. No
span stays open across a ``yield``.
"""
from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _profiler

_NOOP = contextlib.nullcontext()


def span(name: str):
    """A context marking ``name`` in the trace while a profiler records;
    the shared no-op context otherwise."""
    if _profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(name)
    return _NOOP
