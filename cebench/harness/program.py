"""What the program itself counts: its always-on launch counts and the
slab tally it keeps while a profiler runs.

:func:`counters` and :func:`tally` each read nothing where the program
lacks what they read (a parent of the change that added it), so that a
reader returns None there. ``core.run_window`` reads both just before and
just after the traced calls (``MetricCtx.counters``); the program's spans
are read from the profiler (``trace.Summary.program_spans``).
"""
from __future__ import annotations


def counters() -> dict:
    """The program's always-on counters now, where the program has them:
    ``slab_loops``, the launches of the slab loop (``ops.WORK
    ["slab_loop"]``, one a call on the card), and ``slab_steps``, the
    launches of the one-step slab kernel (``ops.WORK["slab_qualify"]``,
    the host loop of pooled stopping and of CPU tensors)."""
    from repro_torch.kernels import ops
    work = getattr(ops, "WORK", {})
    return {key: work[name]["calls"]
            for key, name in (("slab_loops", "slab_loop"),
                              ("slab_steps", "slab_qualify"))
            if name in work}


def tally() -> dict | None:
    """The program's slab tally now (``prober.read_tally``: it counts only
    while a profiler runs; ``calls`` is the estimates it sums), or None
    where the program keeps none."""
    from repro_torch.core import prober
    read = getattr(prober, "read_tally", None)
    return None if read is None else read()


def diff(before: dict, after: dict) -> dict:
    """``after - before`` for the keys both have."""
    return {k: after[k] - before[k] for k in after if k in before}
