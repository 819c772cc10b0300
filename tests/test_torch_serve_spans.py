"""The serving path's spans and ingest counter on the CPU: a tiny served
run through ``CardinalityCoalescer`` with its estimate cache, whose
ingests grow the index past its capacity. Under a profiler each flush
batch, ingest chunk, update, capacity growth, cache lookup and cache
insert is one span, nested as ``serve/coalescer.py`` says; with no
profiler no span makes a record; the answers, their provenance,
``probed_k`` and ``nvisited`` do not move; ``ingest_stats`` counts the
rows, chunks and growths fed in."""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import estimator as E
from repro_torch.core.config import ProberConfig
from repro_torch.data import vectors
from repro_torch.serve.coalescer import CardinalityCoalescer

N, CAPACITY, D, SEED = 3000, 4096, 16, 2 ** 31 + 13
CFG = ProberConfig(n_tables=2, n_funcs=6, max_visit=1024, ring_budget=256,
                   central_budget=128, chunk=32, ingest_chunk=256)
# the run, in order: ("ingest", rows) or ("flush", pool pairs); 1,324 rows
# in 6 chunks (300 = one chunk now and 44 rows applied before the next
# flush), the last of which grows the capacity 4096 → 8192 (3,000 + 1,324
# live); the last flush repeats the one before with no ingest between, so
# it is all hits and inserts nothing
RUN = (("flush", range(0, 8)), ("ingest", 512), ("flush", range(0, 8)),
       ("ingest", 300), ("flush", range(4, 12)), ("ingest", 512),
       ("flush", range(0, 8)), ("flush", range(0, 8)))
ROWS = sum(v for k, v in RUN if k == "ingest")
FLUSHES = sum(k == "flush" for k, _ in RUN)
# each span's parent span
PARENT = {"coalescer.flush": None,
          "coalescer.ingest": None,
          "cache.lookup": "coalescer.flush",
          "cache.insert": "coalescer.flush",
          "estimator.estimate_batch": "coalescer.flush",
          "estimator.update": "coalescer.ingest",
          "estimator.grow": "estimator.update"}


@pytest.fixture(scope="module")
def inputs():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    g = torch.Generator().manual_seed(SEED)
    x = vectors.make_corpus(g, N + ROWS, D, n_clusters=8)
    qs, taus, _ = vectors.paper_query_workload(g, x[:N], 6, n_taus=2,
                                               max_card=N // 100)
    yield x, qs, taus
    torch.set_num_threads(old)


def _keys(i: int, n: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(SEED + 100 + i)
    return torch.randint(0, 2 ** 32, (n, CFG.n_tables, 6), generator=g,
                         dtype=torch.int64)


def serve(inputs):
    """The run on a fresh index: ``(coalescer, [(ests, provenance,
    probed_k, nvisited) a flush])``."""
    x, qs, taus = inputs
    state = E.build(x[:N], CFG, generator=torch.Generator().manual_seed(
        SEED + 1), capacity=CAPACITY, device="cpu")
    co = CardinalityCoalescer(state, CFG, max_batch=16, cache_size=32,
                              round_keys=_keys)
    n_t = taus.shape[1]
    rows, out = N, []
    for kind, arg in RUN:
        if kind == "ingest":
            co.ingest(x[rows:rows + arg])
            rows += arg
            continue
        reqs = [co.submit(qs[p // n_t], taus[p // n_t, p % n_t])
                for p in arg]
        res = co.flush()
        out.append(([res[r.rid] for r in reqs],
                    [r.provenance for r in reqs],
                    [None if r.probed_k is None else r.probed_k.tolist()
                     for r in reqs],
                    [r.nvisited for r in reqs]))
    return co, out


def _profiled(inputs):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        co, out = serve(inputs)
    evs = [e for e in prof.events() if e.name in PARENT]
    return co, out, evs


@pytest.fixture(scope="module")
def traced(inputs):
    return _profiled(inputs)


def _refuse(*a, **k):
    raise AssertionError("a profiler record without a profiler")


def test_without_a_profiler_no_span_makes_a_record(inputs, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _refuse)
    co, out = serve(inputs)
    assert len(out) == FLUSHES
    assert co.ingest_stats["grows"] == 1


def _misses(out) -> int:
    return sum(any(p != "hit" for p in prov) for _, prov, _, _ in out)


@pytest.mark.parametrize("name,calls", [
    ("coalescer.flush", lambda out: FLUSHES),
    ("coalescer.ingest", lambda out: 6),
    ("estimator.update", lambda out: 6),
    ("estimator.grow", lambda out: 1),
    ("cache.lookup", lambda out: FLUSHES),
    ("cache.insert", _misses),
    ("estimator.estimate_batch", _misses)])
def test_one_span_a_flush_chunk_update_growth_lookup_and_insert(
        traced, name, calls):
    _, out, evs = traced
    assert sum(e.name == name for e in evs) == calls(out)


def test_the_last_flush_is_all_hits_and_inserts_nothing(traced):
    _, out, _ = traced
    assert set(out[-1][1]) == {"hit"}
    assert 0 < _misses(out) < FLUSHES
    assert any(p == "stale-refresh" for _, prov, _, _ in out for p in prov)


def test_spans_nest_as_the_coalescer_calls(traced):
    _, _, evs = traced
    for e in evs:
        outer = [o for o in evs if o is not e and o.thread == e.thread
                 and o.time_range.start <= e.time_range.start
                 and e.time_range.end <= o.time_range.end]
        parent = min(outer, key=lambda o: o.time_range.end
                     - o.time_range.start, default=None)
        assert (parent and parent.name) == PARENT[e.name], e.name


def test_the_profiler_leaves_the_answers_bit_identical(inputs, traced):
    _, on, _ = traced
    _, off = serve(inputs)
    for (e1, p1, k1, v1), (e2, p2, k2, v2) in zip(on, off, strict=True):
        assert np.array_equal(np.float32(e1), np.float32(e2))
        assert (p1, k1, v1) == (p2, k2, v2)


def test_ingest_stats_count_the_rows_chunks_and_growths(traced):
    co, _, _ = traced
    assert co.ingest_stats == {"rows": ROWS, "chunks": 6, "grows": 1}
    assert int(co.state.n_valid) == N + ROWS
    assert co.state.capacity == 2 * CAPACITY
