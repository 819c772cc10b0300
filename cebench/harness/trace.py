"""What a traced run reads from ``torch.profiler``.

The harness wraps each batch of the traced window in a ``record_function``
span (``BATCH``), and calls into a layer in a span of its own (``SPAN_*``).
:func:`collect` flattens the profiler's events once; :func:`summarize`
reduces them to counts and times over the traced batches, which the
per-layer metric readers (``cebench/metrics/``) take their numbers from.
"""
from __future__ import annotations

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


def _device_us(e) -> float:
    if hasattr(e, "device_time_total"):
        return e.device_time_total
    return e.cuda_time_total


def collect(prof) -> list[Ev]:
    """The profiler's events as :class:`Ev` records."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.events():
        dev = e.device_type != DeviceType.CPU
        tree = _device_us(e) if (not dev and e.name.startswith("cebench.")) \
            else 0.0
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
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    inner = [e for e in host if e.tid == main and e.name != BATCH]
    names = _innermost(inner, [(s + e) / 2 for s, e in gaps])
    idle: dict = defaultdict(float)
    for (s, e), nm in zip(gaps, names):
        idle[nm] += (e - s) / 1e6
    return Summary(len(batches), (t1 - t0) / 1e6, busy_s, launches, syncs,
                   dict(spans), dict(kernel_s), _top(kernel_s, top),
                   _top(idle, top))


def _top(d: dict, top: int, width: int = 120) -> list:
    """The ``top`` largest entries, names cut to ``width`` characters
    (kernel names carry whole template argument lists)."""
    return [[k[:width], v]
            for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]


def kernel_seconds(summary: Summary, needle: str) -> float:
    """Device seconds of the operations whose names hold ``needle``."""
    return sum(v for k, v in summary.kernel_s.items() if needle in k)
