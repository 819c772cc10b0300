"""One run of one benchmark cell: set-up, the measured window, the check
against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix, generator,
reference or per-layer metric is a file of its own under ``cebench/``,
found by the name that ``BENCHMARK.json`` or the configuration gives:

* ``configs/<config>.json``: the deployment (sizes, prober settings, the
  reference that checks it and the limits of the comparison);
* ``traffic/<mix>.json``: the mix's parameters, among them the
  ``driver`` that runs its calls (and, for the plan driver, the
  ``generator`` of its pairs);
* ``drivers/<driver>.py``: what one call of the window does to the
  program, and the record of it that the check replays;
* ``reference/<reference>.py``: the plain reference;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``.

A driver module has ``open(state, cfg, pcfg, traffic, pool_q, pool_t,
seed, dev, tag)``, which returns an object with:

* ``prepare(i)``: the client's side of call ``i`` (its inputs gathered
  from the pool), before the clock starts;
* ``call(i)``: call ``i``, returning once its answers are on the host:
  ``(ests (n,), probed_k (n, L), nvisited (n,), record)``, host tensors;
* ``counters()``: the driver's own counters (``{}`` if none);
* ``state``: the program's state as the calls so far left it.

A record is the list of what the call did, in order: ``("ingest",
first_row, n_rows)``, rows of ``data.heldout``; ``("estimate", pairs,
round_keys, slots)``, answers the program probed; ``("reuse", pairs,
slots)``, answers it served from an earlier one. ``pairs`` (pool pair
indices) and ``round_keys`` are each a tensor or a function of no
arguments that makes it again (one that holds neither the driver nor the
program's state); ``slots`` are the positions of the op's answers in the
call's (None: all). The harness times and reports; a driver times
nothing.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import random
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import torch

from cebench.harness import data, program, stats, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
GIB = 2.0 ** 30


class CellError(Exception):
    """The cell cannot run here: no card, too few cards, a missing file."""


# ---- finding things by name -------------------------------------------------

def _json(path: Path) -> dict:
    if not path.is_file():
        raise CellError(f"missing {path}")
    return json.loads(path.read_text())


def load_module(path: Path):
    """A reader, generator or reference module from its file."""
    if not path.is_file():
        raise CellError(f"missing {path}")
    name = "cebench_dyn_" + "_".join(path.relative_to(
        path.parents[1]).with_suffix("").parts).replace(".", "_").replace(
        "-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    driver: object
    reference: object
    end_to_end: list
    per_layer: list          # (metric entry, reader module)


def load_cell(root: Path, workload: str) -> Cell:
    spec = _json(root / "BENCHMARK.json")
    cells = [w for w in spec["workloads"] if w["name"] == workload]
    if len(cells) != 1:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[0]
    bench = root / "cebench"
    config = _json(bench / "configs" / f"{w['config']}.json")
    traffic = _json(bench / "traffic" / f"{w['traffic']}.json")
    if "driver" not in traffic:
        raise CellError(f"traffic {w['traffic']!r} names no driver")

    def mine(metric):
        return "workloads" not in metric or workload in metric["workloads"]
    e2e = [m for m in spec["end_to_end"] if mine(m)]
    layers = [(m, load_module(bench / "metrics" / f"{m['name']}.py"))
              for m in spec["per_layer"] if mine(m)]
    return Cell(workload, int(w["chips"]), config, traffic,
                load_module(bench / "drivers" / f"{traffic['driver']}.py"),
                load_module(bench / "reference" / f"{config['reference']}.py"),
                e2e, layers)


# ---- helpers ------------------------------------------------------------------

def process_age_s() -> float:
    """Seconds since this process started (Linux's /proc clock)."""
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def smi_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        f"nvidia-smi: {r.stderr.strip()}"


def host_counters() -> dict:
    """The machine's CPU jiffies (all, and stolen by the hypervisor) and
    this process's involuntary context switches, for the window's record."""
    with open("/proc/stat") as f:
        cpu = [int(v) for v in f.readline().split()[1:]]
    out = {"jiffies": sum(cpu), "steal": cpu[7] if len(cpu) > 7 else 0}
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("nonvoluntary_ctxt_switches"):
                out["preempted"] = int(line.split()[1])
    return out


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (default: the
    modules loaded in this process), each compared whole."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def prober_config(cfg: dict):
    from repro_torch.core.config import ProberConfig
    return ProberConfig(**cfg["prober"])


class Call(NamedTuple):
    answers: tuple           # (ests, probed_k, nvisited) on the host
    record: list             # what the call did, in order


class Window(NamedTuple):
    latencies: list          # seconds, every call of the window
    seconds: float           # from the first call to the last answer
    calls: list              # Call, every call of the window
    profile: object          # the profiler of the traced calls, or None
    counters: dict | None    # MetricCtx.counters


def timed_call(drv, i: int):
    """``(seconds, Call)``: call ``i`` of the driver, timed from the call
    until its answers are on the host (its ``prepare`` before that)."""
    drv.prepare(i)
    t0 = time.perf_counter()
    ests, probed, nvis, record = drv.call(i)
    return time.perf_counter() - t0, Call((ests, probed, nvis), record)


def counters_now(drv) -> dict:
    """The program's counters, its tally (where it keeps one) and the
    driver's counters now, in one dict."""
    out = program.counters()
    out.update(program.tally() or {})
    for k, v in drv.counters().items():
        if k in out:
            raise CellError(f"the driver's counter {k!r} is the program's")
        out[k] = v
    return out


def _spanned(plain, span: str):
    from torch.profiler import record_function

    def call(*a, **k):
        with record_function(span):
            return plain(*a, **k)
    return call


def traced_calls(drv, first: int, n: int, dev):
    """Calls ``first .. first + n - 1`` under the profiler (of the card
    too where ``dev`` is one), each in a :data:`trace.BATCH` span, with
    each function of :data:`trace.LAYER_SPANS` in a span of its own.
    Returns ``(latencies, calls, profiler, counters)``, the last what
    :func:`counters_now` moved by over the calls."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    patched = []
    for mod_name, attr, span in trace.LAYER_SPANS:
        mod = importlib.import_module(mod_name)
        plain = getattr(mod, attr)
        patched.append((mod, attr, plain))
        setattr(mod, attr, _spanned(plain, span))
    lat, calls = [], []
    before = counters_now(drv)
    try:
        with profile(activities=acts) as prof:
            for i in range(first, first + n):
                with record_function(trace.BATCH):
                    dt, c = timed_call(drv, i)
                lat.append(dt)
                calls.append(c)
    finally:
        for mod, attr, plain in patched:
            setattr(mod, attr, plain)
    return lat, calls, prof, program.diff(before, counters_now(drv))


def traced_counters(moved: dict, calls: list) -> dict | None:
    """``moved``, what the counters moved by over the traced ``calls``,
    where the program's tally in it sums exactly their estimates (one an
    estimate op of their records); else None."""
    n = sum(op[0] == "estimate" for c in calls for op in c.record)
    return moved if moved.get("calls") == n else None


def run_window(drv, seconds, dev, trace_batches: int = 0) -> Window:
    """The closed loop of one client: call after call until ``seconds``
    have passed, each call ending when its answers are on the host. With
    ``trace_batches``, the first that many calls run under the profiler
    (:func:`traced_calls`), and their counters are kept as
    :func:`traced_counters` says."""
    lat, calls, prof, counts = [], [], None, None
    i = 0
    t_start = time.perf_counter()
    if trace_batches:
        lat, calls, prof, moved = traced_calls(drv, 0, trace_batches, dev)
        counts = traced_counters(moved, calls)
        i = trace_batches
    while True:
        dt, c = timed_call(drv, i)
        lat.append(dt)
        calls.append(c)
        i += 1
        if time.perf_counter() - t_start >= seconds:
            break
    return Window(lat, time.perf_counter() - t_start, calls, prof, counts)


# ---- the check ------------------------------------------------------------------

def index_arrays(state) -> dict:
    """The program's build as the reference re-derives it, on the host."""
    ix = state.index
    out = {"w": ix.params.w, "raw": ix.raw, "codes": ix.codes,
           "order": ix.order, "bucket_codes": ix.bucket_codes,
           "bucket_starts": ix.bucket_starts,
           "bucket_sizes": ix.bucket_sizes, "n_buckets": ix.n_buckets}
    if state.pq is not None:
        n = int(state.n_valid)
        out["pq_centroids"] = state.pq.centroids
        out["pq_codes"] = state.pq.codes[:n]
    return {k: v.detach().cpu() for k, v in out.items()}


def ref_arrays(ri) -> dict:
    out = {"w": ri.w, "raw": ri.raw, "codes": ri.codes, "order": ri.order,
           "bucket_codes": ri.bucket_codes, "bucket_starts": ri.bucket_starts,
           "bucket_sizes": ri.bucket_sizes, "n_buckets": ri.n_buckets}
    if ri.pq is not None:
        out["pq_centroids"] = ri.pq.centroids
        out["pq_codes"] = ri.pq.codes
    return out


def count_diff(mine: torch.Tensor, ref: torch.Tensor) -> int:
    """Elements that differ, floats compared bit for bit; a shape that
    differs counts every element of the larger."""
    if mine.shape != ref.shape or mine.dtype != ref.dtype:
        return max(mine.numel(), ref.numel())
    ref = ref.to(mine.device)
    if mine.is_floating_point():
        return int((mine.view(torch.int32) != ref.view(torch.int32)).sum())
    return int((mine != ref).sum())


def est_gap(mine: torch.Tensor, ref: torch.Tensor) -> float:
    """Widest |estimate - reference| / max(|reference|, 1); a non-finite
    estimate reads infinite."""
    m, r = mine.double(), ref.double().to(mine.device)
    if not bool(torch.isfinite(m).all()):
        return math.inf
    if m.numel() == 0:
        return 0.0
    return float(((m - r).abs() / r.abs().clamp_min(1.0)).max())


def field(v):
    """A record's ``pairs`` or ``round_keys``: the tensor, made again
    where the record holds the function that makes it."""
    return torch.as_tensor(v() if callable(v) else v)


def slots_of(op, n: int) -> torch.Tensor:
    """The positions (int64, on the host) of an op's answers in its
    call's ``n``."""
    s = op[-1]
    return torch.arange(n) if s is None else torch.as_tensor(s).long().cpu()


class Source(NamedTuple):
    """The last probed answer of a pool pair, as a reuse is judged by it."""
    est: torch.Tensor        # () float32, the program's answer
    probed_k: torch.Tensor   # (L,) its probe's deepest rings
    n_valid: int             # live rows when it was probed
    w_epoch: int             # ingests that had moved W by then


def check(cell: Cell, seed: int, mine: dict, x_pad, pool_q, pool_t,
          calls: list, first: int, dev, traced: int = 0):
    """The numbers compared. ``calls`` are every call of the run in
    order, the warm ones first and the window's from ``first``. Their
    records are replayed in order on the reference, built from the seed's
    corpus ``x_pad``: an ingest updates it (``reference.update``); an
    estimate op of a sampled call (the seed's draw of the window's calls,
    with its ``traced`` first ones) is compared with the reference's
    answers to the same pairs and round keys; a reuse op with the last
    earlier probed answer of its pair, bit for bit, and it is stale where
    W moved since that probe, or an ingest since put a row within the
    probe's ``probed_k`` of the query's code in some table. Then the
    program's build (``mine``) against the reference's state.

    Returns ``(compared, picked calls, the reference's index, its tally
    of the traced calls' slab candidates)``; ``compared`` has
    ``stale_serves`` where a record holds a reuse op."""
    cfg, ref = cell.config, cell.reference
    pc = cfg["prober"]
    nl = pc["n_tables"]
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    ri = ref.build(x_pad, cfg["n"], pc, data.generator(seed, "build", dev))
    n_calls = len(calls) - first
    picks = sorted(set(random.Random(data.sub_seed(seed, "check")).sample(
        range(n_calls), min(int(cell.traffic["check_batches"]), n_calls)))
        | set(range(min(traced, n_calls))))
    sampled = {first + p for p in picks}
    reuses = any(op[0] == "reuse" for c in calls for op in c.record)
    last: dict = {}              # pool pair -> Source, where reuses
    pool_codes: dict = {}        # W epoch -> the pool's codes under it
    stats_diff = stale = 0
    gap, w_epoch, laid_out = 0.0, 0, True
    tally = dict.fromkeys(SLAB_TALLY, 0)
    n_t = pool_t.shape[1]
    for ci, call in enumerate(calls):
        m_est, m_pk, m_nv = call.answers
        covered = torch.zeros(m_est.shape[0], dtype=torch.int64)
        for op in call.record:
            kind = op[0]
            if kind == "ingest":
                w0 = ri.w
                ri = ref.update(ri, data.heldout(cfg, seed, int(op[1]),
                                                 int(op[2]), dev), pc,
                                layout=False)
                laid_out = False
                w_epoch += int(not torch.equal(ri.w, w0))
                continue
            if kind not in ("estimate", "reuse"):
                raise CellError(f"a record holds an unknown op {kind!r}")
            slots = slots_of(op, m_est.shape[0])
            covered.index_add_(0, slots, torch.ones_like(slots))
            if kind == "estimate" and not (reuses or ci in sampled):
                continue
            pairs = field(op[1])
            if kind == "estimate":
                if ci in sampled:
                    if not laid_out:
                        ri, laid_out = ref.relayout(ri), True
                    qi, ti = pairs // n_t, pairs % n_t
                    r_est, r_pk, r_nv = ref.estimate(
                        ri, ri.x, pool_q[qi], pool_t[qi, ti], field(op[2]),
                        pc, tally=tally if 0 <= ci - first < traced
                        else None)
                    stats_diff += int(((m_pk[slots] != r_pk.cpu()).any(1)
                                       | (m_nv[slots] != r_nv.cpu())).sum())
                    gap = max(gap, est_gap(m_est[slots], r_est.cpu()))
                if reuses:
                    for p, s in zip(pairs.tolist(), slots.tolist()):
                        last[p] = Source(m_est[s], m_pk[s], ri.n_valid,
                                         w_epoch)
                continue
            for p, s in zip(pairs.tolist(), slots.tolist()):
                src = last.get(p)
                if src is None or count_diff(m_est[s], src.est):
                    stats_diff += 1
                if src is None:
                    continue
                if src.w_epoch != w_epoch:
                    stale += 1
                elif src.n_valid < ri.n_valid:
                    if w_epoch not in pool_codes:
                        pool_codes[w_epoch] = ref.query_codes(ri, pool_q, nl)
                    qc = pool_codes[w_epoch][p // n_t]          # (L, K)
                    rows = ri.codes[:, src.n_valid:ri.n_valid]  # (L, R, K)
                    ham = (rows != qc[:, None, :]).sum(-1)
                    pk = src.probed_k.to(ham.device).long()
                    stale += int(bool((ham <= pk[:, None]).any()))
        # an answer that no op names, or two do, is not accounted for
        stats_diff += int((covered != 1).sum())
    if not laid_out:
        ri = ref.relayout(ri)
    theirs = ref_arrays(ri)
    build_diff = sum(count_diff(mine[k], theirs[k]) for k in mine)
    compared = {"build_diff": build_diff, "stats_diff": stats_diff,
                "est_gap": gap}
    if reuses:
        compared["stale_serves"] = stale
    return compared, picks, ri, tally


# what the reference counts of the slab steps of the calls it follows: the
# candidates qualified exactly and by ADC, and the lanes that took a step
# of each route or any step
SLAB_TALLY = ("exact_rows", "adc_rows", "exact_lanes", "adc_lanes", "lanes")


# ---- one run ----------------------------------------------------------------

def make_corpus(cfg: dict, seed: int, dev):
    """``(x, cluster)``: the corpus of the run's seed, the same each time."""
    c = cfg["corpus"]
    return data.make_corpus(data.generator(seed, "corpus", dev), cfg["n"],
                            cfg["d"], c["n_clusters"], c["intrinsic_dim"],
                            c["noise"], c["scale_sigma"])


def make_inputs(cfg: dict, traffic: dict, seed: int, dev):
    x, cluster = make_corpus(cfg, seed, dev)
    max_card = min(int(traffic["max_card"]),
                   max(int(cfg["n"] * traffic["max_card_share"]), 2))
    q, t, cards = data.query_pool(data.generator(seed, "pool", dev), x,
                                  cluster, int(traffic["pool_queries"]),
                                  int(traffic["n_taus"]), max_card)
    return x, q, t, cards


class SetUp(NamedTuple):
    driver: object           # the window's driver
    pool_q: torch.Tensor
    pool_t: torch.Tensor
    cards: torch.Tensor      # exact counts of the pool's pairs in the corpus
    warm: list               # Call, the warm calls
    build_s: float


def set_up(cell: Cell, seed: int, dev) -> SetUp:
    """What a run makes before its window: the inputs, the build, and the
    warm calls, one a shape, of a driver of their own (tag ``warm``); the
    window's driver opens on the state they left. The harness's corpus is
    not the system's (the state holds its own padded copy): it goes
    before the window and is made again from the seed for the check."""
    from repro_torch.core import estimator as E
    cfg, tr = cell.config, cell.traffic
    pcfg = prober_config(cfg)
    x, pool_q, pool_t, cards = make_inputs(cfg, tr, seed, dev)
    sync(dev)
    t0 = time.perf_counter()
    state = E.build(x, pcfg, generator=data.generator(seed, "build", dev),
                    capacity=int(cfg["capacity"]), device=dev)
    sync(dev)
    build_s = time.perf_counter() - t0
    del x

    def open_(st, tag):
        return cell.driver.open(st, cfg, pcfg, tr, pool_q, pool_t, seed, dev,
                                tag)
    drv = open_(state, "warm")
    warm = [timed_call(drv, i)[1] for i in range(int(tr["warm_batches"]))]
    drv = open_(drv.state, "window")
    sync(dev)
    return SetUp(drv, pool_q, pool_t, cards, warm, build_s)


def answer_pairs(call: Call) -> torch.Tensor:
    """The pool pair of each of a call's answers (-1 where no op names
    it), on the host."""
    out = torch.full((call.answers[0].shape[0],), -1, dtype=torch.int64)
    for op in call.record:
        if op[0] != "ingest":
            out[slots_of(op, out.shape[0])] = field(op[1]).cpu().long()
    return out


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace_on: bool, device=None, log=print, estimate=None):
    """One run; returns the result line as a dict. ``device`` None means
    the card, which must be there; ``estimate`` replaces
    ``estimator.estimate_batch_stats``, the entry every driver reaches,
    for the set-up and the window (the fault tests break it
    underneath)."""
    cell = load_cell(root, workload)
    kernels_built = any((root / "build" / "kernels").glob("*.so"))
    if device is None:
        if not torch.cuda.is_available():
            raise CellError("CUDA is not available")
        if torch.cuda.device_count() < cell.chips:
            raise CellError(f"{cell.name} needs {cell.chips} cards, "
                            f"{torch.cuda.device_count()} present")
        device = "cuda"
    dev = torch.device(device)
    cfg, tr = cell.config, cell.traffic
    from repro_torch.core import estimator as E
    plain = E.estimate_batch_stats
    if estimate is not None:
        E.estimate_batch_stats = estimate
    try:
        su = set_up(cell, seed, dev)
        setup_s = process_age_s()
        cuda = dev.type == "cuda"
        setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)

        host0 = host_counters()
        traced = int(tr["trace_batches"]) if trace_on else 0
        win = run_window(su.driver, seconds, dev, traced)
        sync(dev)
        window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        host1 = host_counters()
    finally:
        E.estimate_batch_stats = plain
    lat_ms = [1e3 * v for v in win.latencies]
    log(json.dumps({"record": "window", "calls": len(lat_ms),
                    "seconds": win.seconds,
                    "call_ms_p10_p50_p90": [stats.percentile(lat_ms, p)
                                            for p in (10, 50, 90)],
                    "steal_share": (host1["steal"] - host0["steal"])
                    / max(1, host1["jiffies"] - host0["jiffies"]),
                    "preempted": host1.get("preempted", 0)
                    - host0.get("preempted", 0),
                    "cpus": len(os.sched_getaffinity(0)),
                    "kernels_built_at_start": kernels_built}))
    log(f"window: {len(win.latencies)} calls in {win.seconds:.3f} s "
        f"(set-up {setup_s:.3f} s, build {su.build_s:.3f} s)",
        file=sys.stderr)

    # the check, once the program's state is freed
    t_check = time.perf_counter()
    mine = index_arrays(su.driver.state)
    su = su._replace(driver=None)
    if cuda:
        torch.cuda.empty_cache()
    x_pad = torch.nn.functional.pad(make_corpus(cfg, seed, dev)[0],
                                    (0, 0, 0, int(cfg["capacity"]) - cfg["n"]))
    compared, picks, ri, tally = check(cell, seed, mine, x_pad, su.pool_q,
                                       su.pool_t, su.warm + win.calls,
                                       len(su.warm), dev, traced)
    del x_pad
    check_s = time.perf_counter() - t_check
    limits = cfg["limits"]
    no_limit = [k for k in compared if k not in limits]
    correct = not no_limit and all(compared[k] <= limits[k] for k in compared)
    ops = [op for c in su.warm + win.calls for op in c.record]
    ingested = sum(int(op[2]) for op in ops if op[0] == "ingest")
    log(json.dumps({"record": "check", "checked_calls": picks,
                    "check_s": check_s, "no_limit": no_limit,
                    "compared": compared, "ingested_rows": ingested,
                    "reused": sum(len(slots_of(op, 0)) for op in ops
                                  if op[0] == "reuse"),
                    "capacity": int(ri.codes.shape[1])}))

    # what the user sees, and the record of the estimates' quality
    ests = torch.cat([c.answers[0] for c in win.calls])
    attempted = ests.numel()
    failed = int((~torch.isfinite(ests)).sum())
    if not ingested:
        # the pool's exact counts hold for the corpus as it was built
        all_pairs = torch.cat([answer_pairs(c) for c in win.calls])
        truth = su.cards.cpu().reshape(-1)[all_pairs]
        qe = sorted(stats.q_error(e, t) for e, t in zip(ests.tolist(),
                                                        truth.tolist()))
        log(json.dumps({"record": "q_error", "pairs": len(qe),
                        "mean": sum(qe) / len(qe),
                        "median": stats.percentile(qe, 50),
                        "p95": stats.percentile(qe, 95),
                        "checked_calls": picks, "check_s": check_s}))

    batch = int(tr["batch"])
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": cell.chips if cuda else 1,
                   "memory_peak_bytes": max(setup_peak, window_peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed}
    if not trace_on:
        values = {"queries_per_s": stats.rate(attempted, win.seconds),
                  "batch_p90_ms": 1e3 * stats.percentile(win.latencies, 90),
                  "peak_mem_gib": window_peak / GIB,
                  "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
    else:
        s = trace.summarize(trace.collect(win.profile))
        log(json.dumps({"record": "slab", **tally}))
        ctx = MetricCtx(summary=s, build_s=su.build_s, config=cfg,
                        batch=batch, live_buckets=int(ri.n_buckets.sum()),
                        slab=tally, counters=win.counters)
        metrics = {}
        for m, reader in cell.per_layer:
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
        if s is not None:
            device_info["busy_s"] = s.busy_s
            device_info["window_s"] = s.window_s
            result["breakdown"] = {"device_ops": s.device_ops,
                                   "idle_gaps": s.idle_gaps}
        if cuda:
            log(json.dumps({"record": "card", "smi": smi_line()}))
    result["device"] = device_info
    result["compared"] = {k: {"value": compared[k], "limit": limits.get(k)}
                          for k in compared}
    return result


class MetricCtx(NamedTuple):
    """What a per-layer metric reader reads (``read(ctx)``): the traced
    calls' summary (None when the profiler saw none), the build's seconds,
    the configuration file, the pairs a call, the live bucket rows of all
    tables, the reference's :data:`SLAB_TALLY` of the traced calls, and
    what :func:`counters_now` moved by over the traced calls (None where
    the program keeps no tally, or it did not move by exactly their
    estimates)."""
    summary: object
    build_s: float
    config: dict
    batch: int
    live_buckets: int
    slab: dict
    counters: dict | None = None


def main(argv=None, root: Path | None = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="cebench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = root or Path.cwd()
    try:
        result = run_cell(root, args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except CellError as e:
        print(f"cebench: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"cebench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for k, v in result["compared"].items():
        print(f"compared {k} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
