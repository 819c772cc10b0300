"""Named spans of the port's phases, on the profiler's own clock.

``with span("prober.slab_step"): ...`` records a host span in the running
``torch.profiler``, so the span shares its clock with the device trace and
its export, and every device idle gap falls inside a named phase. The span
is a record of the profiler's function scope (``_RecordFunctionFast``),
not ``record_function``'s user scope: a user-scope span also makes a
device-side annotation as long as the work it launched, which a reader of
the device's events would count as device work. With no profiler running,
``span`` returns one shared no-op context: no aten op and no record,
which costs microseconds a use even with no profiler running where the
check costs a fraction of one. There is no switch of its own: tracing is
on exactly while a profiler runs.
"""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def enabled() -> bool:
    """True while a ``torch.profiler`` / autograd profiler runs."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """A host span ``name`` in the running profiler, else the shared no-op
    context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)
