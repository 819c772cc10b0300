"""What a traced run reads from ``torch.profiler``.

The harness wraps each batch of the traced window in a ``record_function``
span (``BATCH``), and calls into a layer in a span of its own (``SPAN_*``).
While a profiler runs, the program puts each phase of its work in a span
of its own too, named ``<module>.<phase>`` (``estimator.estimate_batch``,
``prober.slab_loop``, ...: :data:`PROGRAM_SPAN`). :func:`collect` flattens
the profiler's events once; :func:`summarize` reduces them to counts and
times over the traced batches, the program's spans among them, which the
per-layer metric readers (``cebench/metrics/``) take their numbers from.
"""
from __future__ import annotations

import re
from bisect import bisect_left
from collections import defaultdict
from typing import NamedTuple

BATCH = "cebench.batch"
SPAN_RINGS = "cebench.ring_cumsums"
SPAN_LUTS = "cebench.pq_luts"
# (module, function, span): the program's functions that a traced run
# wraps in a span of their own
LAYER_SPANS = (("repro_torch.core.prober", "ring_cumsums", SPAN_RINGS),
               ("repro_torch.core.pq", "build_query_lut", SPAN_LUTS))
# runtime calls that start work on the device, and calls that make the
# host wait for it (a blocking copy waits as a synchronise does)
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cuStreamSynchronize",
              "cuCtxSynchronize", "cudaMemcpy", "cuMemcpyDtoH")
NO_OP = "host, outside any operator"
# a span of the program: dotted lower-case words, as ``utils/spans.span``
# names them (the profiler's own events read ``aten::...``, ``cuda...``)
PROGRAM_SPAN = re.compile(r"[a-z][a-z0-9_]*(\.[a-z0-9_]+)+")


def is_program_span(name: str) -> bool:
    return not name.startswith("cebench.") and bool(
        PROGRAM_SPAN.fullmatch(name))


class Ev(NamedTuple):
    name: str
    device: bool        # ran on the device (kernel, copy, set)
    start: float        # microseconds, the profiler's clock
    end: float
    tid: int
    tree_us: float = 0.0   # host spans: device time of all they launched


class Summary(NamedTuple):
    batches: int
    window_s: float
    busy_s: float
    launches: int
    syncs: int
    span_device_s: dict     # span name -> device seconds under it
    kernel_s: dict          # device operation name -> seconds
    device_ops: list        # [[name, seconds]], the 10 longest
    idle_gaps: list         # [[what the host did, seconds]], the 10 longest
    program_spans: dict     # the program's span name -> figures
                            # (:func:`program_spans`)


def _device_us(e) -> float:
    if hasattr(e, "device_time_total"):
        return e.device_time_total
    return e.cuda_time_total


def collect(prof) -> list[Ev]:
    """The profiler's events as :class:`Ev` records, with the device time
    under each span of the harness's and of the program's."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.events():
        dev = e.device_type != DeviceType.CPU
        spanned = e.name.startswith("cebench.") or is_program_span(e.name)
        tree = _device_us(e) if (not dev and spanned) else 0.0
        out.append(Ev(e.name, dev, float(e.time_range.start),
                      float(e.time_range.end), int(e.thread), tree))
    return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(host: list[Ev], points: list[float]) -> list[str]:
    """For each time in ``points``, the name of the innermost host event
    that spans it (events of one thread nest), or :data:`NO_OP`."""
    evs = sorted(host, key=lambda e: (e.start, -e.end))
    order = sorted(range(len(points)), key=points.__getitem__)
    names = [NO_OP] * len(points)
    stack: list[Ev] = []
    i = 0
    for pi in order:
        t = points[pi]
        while i < len(evs) and evs[i].start <= t:
            while stack and stack[-1].end <= evs[i].start:
                stack.pop()
            stack.append(evs[i])
            i += 1
        while stack and stack[-1].end <= t:
            stack.pop()
        if stack:
            names[pi] = stack[-1].name
    return names


def _gaps(busy, t0: float, t1: float) -> list:
    """The intervals of [t0, t1) outside the sorted disjoint ``busy``."""
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    return gaps


def summarize(evs: list[Ev], top: int = 10) -> Summary | None:
    """Counts and times over the traced batches; None without a batch."""
    batches = [e for e in evs if not e.device and e.name == BATCH]
    if not batches:
        return None
    t0 = min(e.start for e in batches)
    t1 = max(e.end for e in batches)
    main = batches[0].tid
    inside = [e for e in evs if t0 <= e.start < t1]
    host = [e for e in inside if not e.device]
    device = [e for e in inside if e.device and not e.name.startswith(
        "cebench.")]
    launches = sum(e.name.startswith(LAUNCH_PREFIXES) for e in host)
    syncs = sum(e.name in SYNC_CALLS for e in host)
    spans: dict = defaultdict(float)
    for e in host:
        if e.name.startswith("cebench.") and e.name != BATCH:
            spans[e.name] += e.tree_us / 1e6
    kernel_s: dict = defaultdict(float)
    for e in device:
        kernel_s[e.name] += (e.end - e.start) / 1e6
    busy = _union((max(e.start, t0), min(e.end, t1)) for e in device
                  if e.end > t0 and e.start < t1)
    busy_s = sum(e - s for s, e in busy) / 1e6
    gaps = _gaps(busy, t0, t1)
    inner = [e for e in host if e.tid == main and e.name != BATCH]
    names = _innermost(inner, [(s + e) / 2 for s, e in gaps])
    idle: dict = defaultdict(float)
    for (s, e), nm in zip(gaps, names):
        idle[nm] += (e - s) / 1e6
    return Summary(len(batches), (t1 - t0) / 1e6, busy_s, launches, syncs,
                   dict(spans), dict(kernel_s), _top(kernel_s, top),
                   _top(idle, top), program_spans(host, gaps))


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


def program_spans(host: list[Ev], gaps: list) -> dict:
    """Span name → ``{calls, host_s, device_s, launches, syncs, idle_s}``
    for the program's spans among the traced calls' ``host`` events: host
    seconds inside the span, device seconds of the work launched inside
    it, the launch and sync runtime calls (:data:`LAUNCH_PREFIXES`,
    :data:`SYNC_CALLS`) of its thread inside it, and the device's idle
    seconds (``gaps``, µs intervals) inside it. Every figure includes the
    spans nested in it. Empty where the program made no span."""
    spans: dict = defaultdict(list)
    for e in host:
        if is_program_span(e.name):
            spans[e.name].append(e)
    if not spans:
        return {}
    launches: dict = defaultdict(list)
    syncs: dict = defaultdict(list)
    for e in host:
        if e.name.startswith(LAUNCH_PREFIXES):
            launches[e.tid].append(e.start)
        elif e.name in SYNC_CALLS:
            syncs[e.tid].append(e.start)
    for d in (launches, syncs):
        for v in d.values():
            v.sort()
    out = {}
    for name, es in sorted(spans.items()):
        by_tid: dict = defaultdict(list)
        for e in es:
            by_tid[e.tid].append((e.start, e.end))
        ivs = [_union(v) for v in by_tid.values()]
        merged = _union(iv for v in ivs for iv in v)
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


def _top(d: dict, top: int, width: int = 120) -> list:
    """The ``top`` largest entries, names cut to ``width`` characters
    (kernel names carry whole template argument lists)."""
    return [[k[:width], v]
            for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]


def kernel_seconds(summary: Summary, needle: str) -> float:
    """Device seconds of the operations whose names hold ``needle``."""
    return sum(v for k, v in summary.kernel_s.items() if needle in k)
