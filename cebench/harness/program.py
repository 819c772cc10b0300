"""What the program itself records of a traced call: its spans and its
counters.

While a profiler runs, the port puts each phase of an estimate in a
profiler span of its own (names starting with :data:`PREFIXES`:
``estimator.estimate_batch``, ``prober.slab_step``, ...;
``src/repro_torch/core/prober.py`` lists them). :func:`program_spans`
reduces the profiler's events over the traced calls to figures a span
name, each inclusive of the spans nested in it. :func:`counters` reads the
program's always-on step count, and :func:`tally` the slab tally it keeps
only while a profiler runs; each is left out where the program lacks it
(the parent of the change that added them), so that a reader returns None
there.

``trace.collect`` keeps the device time under the harness's own spans
alone; :func:`collect` keeps it under the program's too. :func:`collect`
and :func:`idle_gaps` repeat ``trace.collect`` and the gap walk of
``trace.summarize``: they are to be folded back into ``trace.py`` (a
``Summary.program_spans`` field) when the harness itself reads program
spans, and deleted here then.
"""
from __future__ import annotations

from bisect import bisect_left
from collections import defaultdict

from cebench.harness import trace

PREFIXES = ("estimator.", "prober.", "pq.")


def collect(prof) -> list[trace.Ev]:
    """The profiler's events as ``trace.Ev`` records, as ``trace.collect``
    makes them, with the device time under each program span too."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.events():
        dev = e.device_type != DeviceType.CPU
        tree = trace._device_us(e) if not dev and e.name.startswith(
            ("cebench.",) + PREFIXES) else 0.0
        out.append(trace.Ev(e.name, dev, float(e.time_range.start),
                            float(e.time_range.end), int(e.thread), tree))
    return out


def _window(evs):
    """(t0, t1) of the traced calls, or None."""
    batches = [e for e in evs if not e.device and e.name == trace.BATCH]
    if not batches:
        return None
    return min(e.start for e in batches), max(e.end for e in batches)


def idle_gaps(evs) -> list[tuple[float, float]]:
    """The device's idle intervals (µs) over the traced calls, as
    ``trace.summarize`` finds them."""
    w = _window(evs)
    if w is None:
        return []
    t0, t1 = w
    device = [e for e in evs if e.device and t0 <= e.start < t1
              and not e.name.startswith("cebench.")]
    busy = trace._union((max(e.start, t0), min(e.end, t1)) for e in device
                        if e.end > t0 and e.start < t1)
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    return gaps


def _overlap(intervals, gaps) -> float:
    """Length of the overlap of two lists of disjoint sorted intervals."""
    total, j = 0.0, 0
    for s, e in intervals:
        while j < len(gaps) and gaps[j][1] <= s:
            j += 1
        k = j
        while k < len(gaps) and gaps[k][0] < e:
            total += min(e, gaps[k][1]) - max(s, gaps[k][0])
            k += 1
    return total


def _count_in(starts: list[float], intervals) -> int:
    """How many of the sorted ``starts`` fall in the intervals [s, e)."""
    return sum(bisect_left(starts, e) - bisect_left(starts, s)
               for s, e in intervals)


def program_spans(evs) -> dict:
    """Span name → ``{calls, host_s, device_s, launches, syncs, idle_s}``
    over the traced calls, for the program's spans: host seconds inside
    the span, device seconds of the work launched inside it, the launch
    and sync runtime calls (``trace.LAUNCH_PREFIXES``, ``SYNC_CALLS``) of
    its thread inside it, and the device's idle seconds inside it. Every
    figure includes the spans nested in it. Empty where the program has
    no span or the profiler saw no traced call."""
    w = _window(evs)
    if w is None:
        return {}
    t0, t1 = w
    inside = [e for e in evs if not e.device and t0 <= e.start < t1]
    spans: dict = defaultdict(list)
    for e in inside:
        if e.name.startswith(PREFIXES):
            spans[e.name].append(e)
    if not spans:
        return {}
    launches: dict = defaultdict(list)
    syncs: dict = defaultdict(list)
    for e in inside:
        if e.name.startswith(trace.LAUNCH_PREFIXES):
            launches[e.tid].append(e.start)
        elif e.name in trace.SYNC_CALLS:
            syncs[e.tid].append(e.start)
    for d in (launches, syncs):
        for v in d.values():
            v.sort()
    gaps = idle_gaps(evs)
    out = {}
    for name, es in sorted(spans.items()):
        by_tid: dict = defaultdict(list)
        for e in es:
            by_tid[e.tid].append((e.start, e.end))
        ivs = [trace._union(v) for v in by_tid.values()]
        merged = trace._union(iv for v in ivs for iv in v)
        out[name] = {
            "calls": len(es),
            "host_s": sum(e.end - e.start for e in es) / 1e6,
            "device_s": sum(e.tree_us for e in es) / 1e6,
            "launches": sum(_count_in(launches[t], iv)
                            for t, iv in zip(by_tid, ivs)),
            "syncs": sum(_count_in(syncs[t], iv)
                         for t, iv in zip(by_tid, ivs)),
            "idle_s": _overlap(merged, gaps) / 1e6,
        }
    return out


def counters() -> dict:
    """The program's always-on counters now: ``slab_steps`` (the
    ``slab_qualify`` calls of ``ops.WORK``) where the program has it."""
    from repro_torch.kernels import ops
    work = getattr(ops, "WORK", {}).get("slab_qualify")
    return {} if work is None else {"slab_steps": work["calls"]}


def tally() -> dict | None:
    """The program's slab tally now (``prober.read_tally``: it counts only
    while a profiler runs), or None where the program keeps none."""
    from repro_torch.core import prober
    read = getattr(prober, "read_tally", None)
    return None if read is None else read()


def traced_tally(before: dict | None, ctx) -> dict | None:
    """The tally's growth since ``before``, where it sums exactly the
    traced calls of ``ctx.summary`` (as many calls as traced batches);
    None where the program keeps no tally, the run was not traced, or
    other profiled calls moved the tally too."""
    if before is None or ctx.summary is None:
        return None
    t = diff(before, tally())
    return t if t.get("calls") == ctx.summary.batches else None


def diff(before: dict, after: dict) -> dict:
    """``after - before`` for the keys both have."""
    return {k: after[k] - before[k] for k in after if k in before}
