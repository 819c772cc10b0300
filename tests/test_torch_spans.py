"""The port's spans and tally on the CPU, on two tiny configurations (exact
L2 and PQ-ADC): no span and no tally code runs without a profiler; under
one, the spans nest as ``core/prober.py`` says, the slab steps agree with
``ops.WORK`` and the lane-steps the prober ran with the tally's, the
tally's exact and ADC candidates equal the count of the benchmark's plain
reference (``cebench/reference/prober.py``), and the answers do not move.
Also ``ops.slab_qualify``'s ``WORK`` against its formula on the PQ
route."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from cebench.reference import prober as ref  # noqa: E402
from repro_torch.core import estimator as E, prober  # noqa: E402
from repro_torch.core.config import ProberConfig  # noqa: E402
from repro_torch.data import vectors  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

N, CAPACITY, SEED = 3000, 4096, 2 ** 31 + 11
PROBER = dict(n_tables=2, n_funcs=6, n_regions=4, max_visit=1024,
              ring_budget=256, central_budget=128, s1=0.05, s_max=1.0,
              eps=0.01, delta=0.001, chunk=32, schedule_checks=True,
              use_pq=False, pq_m=8, pq_kc=16, pq_iters=8, pq_int8_lut=False,
              pq_pack4=False, pq_banded=False, pq_exact_rings=2,
              pq_exact_central=True, lane_block=4, lane_tile=16,
              table_max_dist=6, ingest_chunk=256, use_kernels=False)
# name → (d, prober settings over PROBER)
CONFIGS = {"tiny-exact": (16, {}),
           "tiny-pq": (32, {"use_pq": True, "pq_iters": 3})}
PROGRAM = ("estimator.", "prober.", "pq.")
# each program span's parent span
PARENT = {"estimator.estimate_batch": None,
          "pq.build_query_lut": "estimator.estimate_batch",
          "prober.query_lanes": "estimator.estimate_batch",
          "prober.table_setup": "estimator.estimate_batch",
          "prober.ring_cumsums": "prober.table_setup",
          "prober.central_count": "prober.table_setup",
          "prober.slab_loop": "estimator.estimate_batch",
          "prober.slab_block": "prober.slab_loop",
          "prober.slab_step": "prober.slab_block",
          "prober.tally": "estimator.estimate_batch"}


def _build_generator() -> torch.Generator:
    return torch.Generator().manual_seed(SEED + 1)


class Case:
    """A clustered corpus of N points, an index over it, and 16 queries
    with their radii and round keys."""
    def __init__(self, name: str, **over):
        d, settings = CONFIGS[name]
        self.prober = {**PROBER, **settings, **over}
        self.pcfg = ProberConfig(**self.prober)
        g = torch.Generator().manual_seed(SEED)
        self.x = vectors.make_corpus(g, N, d, n_clusters=8)
        qs, taus, _ = vectors.paper_query_workload(g, self.x, 16, n_taus=6,
                                                   max_card=N // 100)
        self.qs, self.taus = qs, taus[:, 3].contiguous()
        self.state = E.build(self.x, self.pcfg, generator=_build_generator(),
                             capacity=CAPACITY, device="cpu")
        self.rks = torch.randint(0, 2 ** 32, (16, self.pcfg.n_tables, 6),
                                 generator=g, dtype=torch.int64)

    def estimate(self):
        return E.estimate_batch_stats(self.state, self.qs, self.taus,
                                      self.pcfg, rks=self.rks)


@pytest.fixture(scope="module")
def cases():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield {name: Case(name) for name in CONFIGS}
    torch.set_num_threads(old)


def _profiled(fn):
    prober.reset_tally()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _refuse(*a, **k):
    raise AssertionError("a profiler record without a profiler")


@pytest.mark.parametrize("name", CONFIGS)
def test_untraced_estimates_make_no_span_and_no_tally(cases, name,
                                                      monkeypatch):
    c = cases[name]
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _refuse)
    prober.reset_tally()
    work0 = ops.WORK["slab_qualify"]["calls"]
    c.estimate()
    E.estimate_batch(c.state, c.qs, c.taus, c.pcfg, rks=c.rks)
    E.estimate(c.state, c.qs[0], c.taus[0], c.pcfg, rks=c.rks[0])
    assert prober.TALLY is None and prober.read_tally()["calls"] == 0
    assert ops.WORK["slab_qualify"]["calls"] > work0


class _Ops(TorchDispatchMode):
    """Records each op's name, and whether it ran inside ``prober._tally``
    (while ``where`` is set)."""
    def __init__(self, where=None):
        super().__init__()
        self.where = where if where is not None else [False]
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append((str(func), self.where[-1]))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", CONFIGS)
def test_the_only_ops_tracing_adds_are_the_tally(cases, name, monkeypatch):
    """The ops of an untraced call are those of a traced one less the
    tally's (a dozen, at the call's end): no span and no tally code issues
    an op with the profiler off, and the spans issue none with it on."""
    c = cases[name]
    with _Ops() as off:
        c.estimate()
    in_tally = [False]
    plain = prober._tally

    def marked(*a):
        in_tally.append(True)
        try:
            return plain(*a)
        finally:
            in_tally.pop()
    monkeypatch.setattr(prober, "_tally", marked)
    prober.reset_tally()
    with profile(activities=[ProfilerActivity.CPU]), _Ops(in_tally) as on:
        c.estimate()
    assert all(not t for _, t in off.ops)
    assert [op for op, t in on.ops if not t] == [op for op, _ in off.ops]
    assert 0 < sum(t for _, t in on.ops) <= 20


def test_spans_make_no_device_annotation():
    """A span is a function-scope record: a user-scope one (the harness's
    ``cebench.*`` spans) also annotates the device with the work it
    launched, which would count as device time."""
    from repro_torch.utils.spans import span
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("prober.slab_step"):
            torch.ones(4).add_(1)
    ev = [e for e in prof.events() if e.name == "prober.slab_step"]
    assert len(ev) == 1 and not ev[0].is_user_annotation
    assert ev[0].cpu_children


@pytest.mark.parametrize("name", CONFIGS)
def test_spans_nest_and_agree_with_the_counters(cases, name, monkeypatch):
    c = cases[name]
    work0 = ops.WORK["slab_qualify"]["calls"]
    lane_steps = [0]
    plain = prober._slab_step

    def counted(s, ctx, small, lanes, *rest, **kw):
        lane_steps[0] += lanes.numel()
        return plain(s, ctx, small, lanes, *rest, **kw)
    monkeypatch.setattr(prober, "_slab_step", counted)
    _, prof = _profiled(c.estimate)
    evs = [e for e in prof.events() if e.name.startswith(PROGRAM)]
    names = {e.name for e in evs}
    want = set(PARENT) - ({"pq.build_query_lut"} if name == "tiny-exact"
                          else set())
    assert names == want
    for e in evs:
        outer = [o for o in evs if o is not e and o.thread == e.thread
                 and o.time_range.start <= e.time_range.start
                 and e.time_range.end <= o.time_range.end]
        parent = min(outer, key=lambda o: o.time_range.end
                     - o.time_range.start, default=None)
        assert (parent and parent.name) == PARENT[e.name], e.name
    calls = {n: sum(e.name == n for e in evs) for n in names}
    assert calls["prober.slab_step"] == \
        ops.WORK["slab_qualify"]["calls"] - work0
    assert calls["prober.slab_step"] == \
        c.pcfg.lane_block * calls["prober.slab_block"]
    t = prober.read_tally()
    assert t["calls"] == calls["prober.tally"] == 1
    assert t["kept_lane_steps"] + t["discarded_lane_steps"] == \
        lane_steps[0] > 0


@pytest.mark.parametrize("name", CONFIGS)
def test_the_tally_equals_the_references_count(cases, name):
    c = cases[name]
    _profiled(c.estimate)
    t = prober.read_tally()
    x_pad = torch.nn.functional.pad(c.x, (0, 0, 0, CAPACITY - N))
    ri = ref.build(x_pad, N, c.prober, _build_generator())
    rt = dict.fromkeys(("exact_rows", "adc_rows", "exact_lanes",
                        "adc_lanes", "lanes"), 0)
    ref.estimate(ri, x_pad, c.qs, c.taus, c.rks, c.prober, tally=rt)
    assert (t["exact"], t["adc"]) == (rt["exact_rows"], rt["adc_rows"])
    assert t["exact"] > 0 and (t["adc"] > 0) == (name == "tiny-pq")


@pytest.mark.parametrize("name", CONFIGS)
def test_one_step_blocks_discard_nothing(cases, name):
    c = cases[name]
    _profiled(c.estimate)
    t4 = prober.read_tally()
    one = Case(name, lane_block=1)
    (e1, k1, n1), _ = _profiled(one.estimate)
    t1 = prober.read_tally()
    assert t4["discarded_lane_steps"] > 0 and t4["discarded"] > 0
    assert t1["discarded_lane_steps"] == 0 and t1["discarded"] == 0
    # the kept work is the schedule's, whatever the block
    assert (t1["exact"], t1["adc"], t1["kept_lane_steps"]) == \
        (t4["exact"], t4["adc"], t4["kept_lane_steps"])
    e4, k4, n4 = c.estimate()
    assert torch.equal(e1, e4) and torch.equal(k1, k4) and \
        torch.equal(n1, n4)


@pytest.mark.parametrize("name", CONFIGS)
def test_the_profiler_leaves_the_answers_bit_identical(cases, name):
    c = cases[name]
    off = c.estimate()
    on, _ = _profiled(c.estimate)
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("lut", ("float", "uint8"))
def test_a_pq_steps_work_is_its_formula(cases, lut, monkeypatch):
    c = cases["tiny-pq"] if lut == "float" else Case("tiny-pq",
                                                     pq_int8_lut=True)
    seen = []
    plain = ops.slab_qualify

    def recorded(k, ci, lanes, tid, rks, prings, *rest):
        before = dict(ops.WORK["slab_qualify"])
        out = plain(k, ci, lanes, tid, rks, prings, *rest)
        after = ops.WORK["slab_qualify"]
        seen.append((prings.shape[0], rest[-2], rest[-1],
                     {key: after[key] - before[key] for key in after}))
        return out
    monkeypatch.setattr(ops, "slab_qualify", recorded)
    c.estimate()
    assert seen
    for na, qual, chunk, got in seen:
        assert qual.luts.dtype == (torch.float32 if lut == "float"
                                   else torch.uint8)
        d = qual.x.shape[1]
        m, kc = qual.luts.shape[1:]
        cb = qual.codes.shape[1] + 4 * (qual.resid is not None)
        want = tuple(map(max, ops.slab_qualify_work(na, d, na * chunk, na),
                         ops.slab_qualify_work(
                             na, d, 0, 0, na * chunk, na, cb,
                             m * kc * qual.luts.element_size(), m)))
        assert got == {"calls": 1, "bytes": want[0], "flops": want[1]}
