"""One run of one benchmark cell: set-up, the measured window, the check
against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix, generator,
reference or per-layer metric is a file of its own under ``cebench/``,
found by the name that ``BENCHMARK.json`` or the configuration gives:

* ``configs/<config>.json``: the deployment (sizes, prober settings, the
  reference that checks it and the limits of the comparison);
* ``traffic/<mix>.json``: the mix's parameters, read by
  ``generators/<generator>.py``;
* ``reference/<reference>.py``: the plain reference;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``.
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

from cebench.harness import data, stats, trace

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
    generator: object
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

    def mine(metric):
        return "workloads" not in metric or workload in metric["workloads"]
    e2e = [m for m in spec["end_to_end"] if mine(m)]
    layers = [(m, load_module(bench / "metrics" / f"{m['name']}.py"))
              for m in spec["per_layer"] if mine(m)]
    return Cell(workload, int(w["chips"]), config, traffic,
                load_module(bench / "generators"
                            / f"{traffic['generator']}.py"),
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


class Window(NamedTuple):
    latencies: list          # seconds, every call of the window
    seconds: float           # from the first call to the last answer
    outputs: list            # (ests, probed_k, nvisited) on the host
    profile: object          # the profiler of the traced calls, or None


def _call(estimate, state, pool_q, pool_t, n_t, traffic, i, pcfg):
    pairs = traffic.pairs(i)
    qi, ti = pairs // n_t, pairs % n_t
    qs, taus = pool_q[qi], pool_t[qi, ti]
    rks = traffic.round_keys(i)
    t0 = time.perf_counter()
    ests, probed, nvis = estimate(state, qs, taus, pcfg, rks=rks)
    out = (ests.cpu(), probed.cpu(), nvis.cpu())
    return time.perf_counter() - t0, out


def _spanned(plain, span: str):
    from torch.profiler import record_function

    def call(*a, **k):
        with record_function(span):
            return plain(*a, **k)
    return call


def run_window(estimate, state, pool_q, pool_t, traffic, pcfg, seconds,
               trace_batches: int = 0) -> Window:
    """The closed loop of one client: call after call until ``seconds``
    have passed, each call ending when its answers are on the host. With
    ``trace_batches``, the first that many calls run under the profiler,
    each in a :data:`trace.BATCH` span, with each function of
    :data:`trace.LAYER_SPANS` in a span of its own."""
    n_t = pool_t.shape[1]
    lat, outs, prof = [], [], None
    i = 0
    t_start = time.perf_counter()
    if trace_batches:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if pool_q.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        patched = []
        for mod_name, attr, span in trace.LAYER_SPANS:
            mod = importlib.import_module(mod_name)
            plain = getattr(mod, attr)
            patched.append((mod, attr, plain))
            setattr(mod, attr, _spanned(plain, span))
        try:
            with profile(activities=acts) as prof:
                for i in range(trace_batches):
                    with record_function(trace.BATCH):
                        dt, out = _call(estimate, state, pool_q, pool_t, n_t,
                                        traffic, i, pcfg)
                    lat.append(dt)
                    outs.append(out)
        finally:
            for mod, attr, plain in patched:
                setattr(mod, attr, plain)
        i = trace_batches
    while True:
        dt, out = _call(estimate, state, pool_q, pool_t, n_t, traffic, i,
                        pcfg)
        lat.append(dt)
        outs.append(out)
        i += 1
        if time.perf_counter() - t_start >= seconds:
            break
    return Window(lat, time.perf_counter() - t_start, outs, prof)


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


def check(cell: Cell, seed: int, mine: dict, x_pad, pool_q, pool_t, traffic,
          outputs: list, dev, traced: int = 0):
    """The numbers compared: the program's build (``mine``) against the
    reference's, element for element, and the answers of a sample of the
    window's calls drawn from the seed, with the ``traced`` first calls,
    against the reference's for the same inputs. Returns ``(compared,
    picked calls, the reference's index, its tally of the traced calls'
    slab candidates)``."""
    cfg, ref = cell.config, cell.reference
    n = cfg["n"]
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    ri = ref.build(x_pad, n, cfg["prober"],
                   data.generator(seed, "build", dev))
    theirs = ref_arrays(ri)
    build_diff = sum(count_diff(mine[k], theirs[k]) for k in mine)
    n_calls = len(outputs)
    picks = sorted(set(random.Random(data.sub_seed(seed, "check")).sample(
        range(n_calls), min(int(cell.traffic["check_batches"]), n_calls)))
        | set(range(min(traced, n_calls))))
    stats_diff, gap = 0, 0.0
    tally = dict.fromkeys(SLAB_TALLY, 0)
    n_t = pool_t.shape[1]
    for i in picks:
        pairs = traffic.pairs(i)
        qi, ti = pairs // n_t, pairs % n_t
        r_est, r_pk, r_nv = ref.estimate(ri, x_pad, pool_q[qi],
                                         pool_t[qi, ti],
                                         traffic.round_keys(i), cfg["prober"],
                                         tally=tally if i < traced else None)
        m_est, m_pk, m_nv = outputs[i]
        stats_diff += int(((m_pk != r_pk.cpu()).any(1)
                           | (m_nv != r_nv.cpu())).sum())
        gap = max(gap, est_gap(m_est, r_est.cpu()))
    return ({"build_diff": build_diff, "stats_diff": stats_diff,
             "est_gap": gap}, picks, ri, tally)


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


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace_on: bool, device=None, log=print, estimate=None):
    """One run; returns the result line as a dict. ``device`` None means
    the card, which must be there; ``estimate`` replaces the entry the
    window drives (the fault tests break it underneath)."""
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
    estimate = estimate or E.estimate_batch_stats
    pcfg = prober_config(cfg)

    # set-up: inputs, the build, one warm call a shape. The harness's
    # corpus is not the system's (the state holds its own padded copy): it
    # goes before the window and is made again from the seed for the check
    x, pool_q, pool_t, cards = make_inputs(cfg, tr, seed, dev)
    sync(dev)
    t0 = time.perf_counter()
    state = E.build(x, pcfg, generator=data.generator(seed, "build", dev),
                    capacity=int(cfg["capacity"]), device=dev)
    sync(dev)
    build_s = time.perf_counter() - t0
    del x
    n_pairs = pool_t.numel()
    gen = cell.generator
    warm = gen.make(tr, n_pairs, pcfg.n_tables, seed, dev, tag="warm")
    for i in range(int(tr["warm_batches"])):
        _call(estimate, state, pool_q, pool_t, pool_t.shape[1], warm, i,
              pcfg)
    traffic = gen.make(tr, n_pairs, pcfg.n_tables, seed, dev)
    sync(dev)
    setup_s = process_age_s()
    cuda = dev.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    host0 = host_counters()
    win = run_window(estimate, state, pool_q, pool_t, traffic, pcfg,
                     seconds, int(tr["trace_batches"]) if trace_on else 0)
    sync(dev)
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    host1 = host_counters()
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
        f"(set-up {setup_s:.3f} s, build {build_s:.3f} s)", file=sys.stderr)

    # the check, once the program's state is freed
    t_check = time.perf_counter()
    mine = index_arrays(state)
    del state
    if cuda:
        torch.cuda.empty_cache()
    traced = int(tr["trace_batches"]) if trace_on else 0
    x_pad = torch.nn.functional.pad(make_corpus(cfg, seed, dev)[0],
                                    (0, 0, 0, int(cfg["capacity"]) - cfg["n"]))
    compared, picks, ri, tally = check(cell, seed, mine, x_pad, pool_q,
                                       pool_t, traffic, win.outputs, dev,
                                       traced)
    del x_pad
    check_s = time.perf_counter() - t_check
    limits = cfg["limits"]
    correct = all(compared[k] <= limits[k] for k in compared)
    n_calls = len(win.outputs)

    # what the user sees, and the record of the estimates' quality
    ests = torch.cat([o[0] for o in win.outputs])
    attempted = ests.numel()
    failed = int((~torch.isfinite(ests)).sum())
    all_pairs = torch.cat([traffic.pairs(i).cpu() for i in range(n_calls)])
    truth = cards.cpu().reshape(-1)[all_pairs]
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
        ctx = MetricCtx(summary=s, build_s=build_s, config=cfg, batch=batch,
                        live_buckets=int(ri.n_buckets.sum()), slab=tally)
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
    result["compared"] = {k: {"value": compared[k], "limit": limits[k]}
                          for k in compared}
    return result


class MetricCtx(NamedTuple):
    """What a per-layer metric reader reads (``read(ctx)``): the traced
    calls' summary (None when the profiler saw none), the build's seconds,
    the configuration file, the pairs a call, the live bucket rows of all
    tables, and the reference's :data:`SLAB_TALLY` of the traced calls."""
    summary: object
    build_s: float
    config: dict
    batch: int
    live_buckets: int
    slab: dict


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
