"""The program's own spans and counters as the harness reads them
(``trace.Summary.program_spans``, ``harness/program.py``, the counters of
``MetricCtx``, the two counter metrics, ``tools/spans.py``): inclusive
attribution on synthetic event lists, a summary that the program's spans
leave as it was, and traced CPU runs of the tiny cells."""
from __future__ import annotations

import importlib.util
import json

import pytest

from cebench.tests._util import ROOT, TINY, one_thread, tiny_root  # noqa: F401
from cebench.harness import core, program, trace
from cebench.harness.trace import Ev

NEW = ("slab.candidates_per_batch", "prober.discarded_lane_step_share")


def _host(name, s, e, tid=1, tree=0.0):
    return Ev(name, False, float(s), float(e), tid, tree)


def _dev(name, s, e):
    return Ev(name, True, float(s), float(e), 0)


# one traced call, 0-100 µs: an estimate (5-95) holding a slab loop of two
# blocks of two steps; launches, syncs and kernels placed by hand
HARNESS = [_host(trace.BATCH, 0, 100),
           _host(trace.SPAN_RINGS, 6, 10, tree=3.0),
           _host("cudaLaunchKernel", 2, 3),          # the harness's gather
           _host("cudaLaunchKernel", 7, 8),          # the ring cumsums
           _host("cudaLaunchKernel", 22, 23),
           _host("cudaStreamSynchronize", 30, 38),
           _host("cudaLaunchKernel", 45, 46),
           _host("cudaStreamSynchronize", 58, 59),   # the block's nonzero
           _host("cudaLaunchKernel", 62, 63),
           _host("cudaStreamSynchronize", 80, 85),
           _host("cudaLaunchKernel", 50, 51, tid=2),  # another thread
           _host("cudaMemcpy", 96, 98),              # an answer's copy
           _dev("ring_kernel", 8, 20), _dev("slab_qualify_kernel", 24, 30),
           _dev("k", 46, 50), _dev("k", 63, 66), _dev("copy", 96, 97)]
PROGRAM = [_host("estimator.estimate_batch", 5, 95, tree=24.0),
           _host("prober.ring_cumsums", 6, 11, tree=12.0),
           _host("prober.slab_loop", 20, 90, tree=13.0),
           _host("prober.slab_block", 20, 60, tree=10.0),
           _host("prober.slab_block", 60, 90, tree=3.0),
           _host("prober.slab_step", 20, 40, tree=6.0),
           _host("prober.slab_step", 40, 57, tree=4.0),
           _host("prober.slab_step", 60, 75, tree=3.0),
           _host("prober.slab_step", 75, 90)]


def test_program_spans_count_inclusively_on_their_thread():
    s = trace.summarize(HARNESS + PROGRAM)
    sp = s.program_spans
    assert set(sp) == {e.name for e in PROGRAM}
    step, block, loop = (sp[f"prober.{n}"] for n in ("slab_step",
                                                     "slab_block",
                                                     "slab_loop"))
    assert (step["calls"], block["calls"], loop["calls"]) == (4, 2, 1)
    # launches at 22, 45, 62; the other thread's at 50 is not the span's
    assert (step["launches"], block["launches"], loop["launches"]) == \
        (3, 3, 3)
    # syncs at 30 and 80 in steps, the nonzero's at 58 in its block only;
    # the answer's copy at 96 is the harness's
    assert (step["syncs"], block["syncs"], loop["syncs"]) == (2, 3, 3)
    est = sp["estimator.estimate_batch"]
    assert (est["launches"], est["syncs"]) == (4, 3)
    # busy 8-20, 24-30, 46-50, 63-66, 96-97: the loop (20-90) idles
    # 20-24, 30-46, 50-63 and 66-90, its steps all of that but 57-60
    assert loop["idle_s"] == pytest.approx(57e-6)
    assert block["idle_s"] == pytest.approx(57e-6)
    assert step["idle_s"] == pytest.approx(54e-6)
    assert est["idle_s"] == pytest.approx(3e-6 + 57e-6 + 5e-6)
    assert step["host_s"] == pytest.approx(67e-6)
    assert step["device_s"] == pytest.approx(13e-6)
    assert sp["prober.ring_cumsums"]["device_s"] == pytest.approx(12e-6)
    assert sum(v for _, v in s.idle_gaps) == pytest.approx(
        s.window_s - s.busy_s)


def test_program_spans_leave_the_summary_as_it_was():
    before = trace.summarize(HARNESS)
    after = trace.summarize(HARNESS + PROGRAM)
    for field in ("batches", "window_s", "busy_s", "launches", "syncs",
                  "span_device_s", "kernel_s", "device_ops"):
        assert getattr(after, field) == getattr(before, field), field
    assert before.program_spans == {}
    # a gap is named by what the host did at its middle: the gaps inside
    # the slab steps (30-46, 50-63) were the host outside any operator,
    # and are the steps' now; what is left of it lies outside the estimate
    # (0-8, 97-100)
    was, now = (dict(map(tuple, s.idle_gaps)) for s in (before, after))
    assert was[trace.NO_OP] == pytest.approx((8 + 16 + 13 + 3) * 1e-6)
    assert now[trace.NO_OP] == pytest.approx((8 + 3) * 1e-6)
    assert now["prober.slab_step"] == pytest.approx((16 + 13) * 1e-6)


class _Driver:
    """A driver with no counters of its own."""

    def counters(self):
        return {}


# one traced call of one estimate
ONE_CALL = [core.Call((None, None, None), [("estimate", None, None, None)])]


def test_counter_readers_read_nothing_from_a_program_without_a_tally(
        monkeypatch):
    from repro_torch.core import prober
    monkeypatch.delattr(prober, "read_tally")
    assert program.tally() is None
    now = core.counters_now(_Driver())
    assert "calls" not in now
    counters = core.traced_counters(program.diff(now, now), ONE_CALL)
    assert counters is None
    ctx = core.MetricCtx(summary=trace.summarize(HARNESS), build_s=0.0,
                         config={}, batch=16, live_buckets=0, slab={},
                         counters=counters)
    for name in NEW:
        reader = core.load_module(ROOT / "cebench" / "metrics"
                                  / f"{name}.py")
        assert reader.read(ctx) is None


@pytest.mark.parametrize("extra", (0, 1, -1))
@pytest.mark.parametrize("name", NEW)
def test_counter_readers_read_only_a_tally_of_the_traced_calls(
        monkeypatch, name, extra):
    """The harness keeps what the counters moved by over the traced calls
    only where the tally sums exactly their estimates (one here), and a
    reader reads nothing otherwise."""
    counts = dict.fromkeys(("exact", "adc", "discarded",
                            "discarded_lane_steps", "kept_lane_steps",
                            "calls"), 0)
    monkeypatch.setattr(program, "tally", lambda: dict(counts))
    reader = core.load_module(ROOT / "cebench" / "metrics" / f"{name}.py")
    before = core.counters_now(_Driver())
    counts.update(exact=30, adc=10, discarded=5, discarded_lane_steps=2,
                  kept_lane_steps=8, calls=1 + extra)
    moved = program.diff(before, core.counters_now(_Driver()))
    ctx = core.MetricCtx(summary=trace.summarize(HARNESS), build_s=0.0,
                         config={}, batch=16, live_buckets=0, slab={},
                         counters=core.traced_counters(moved, ONE_CALL))
    want = {"slab.candidates_per_batch": 45.0,
            "prober.discarded_lane_step_share": 20.0}[name]
    assert reader.read(ctx) == (want if extra == 0 else None)


@pytest.fixture(scope="module")
def root(tmp_path_factory, one_thread):
    return tiny_root(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("cell", TINY)
def test_a_traced_cpu_run_reports_the_counter_metrics(root, cell):
    lines = []
    r = core.run_cell(root, cell, 2 ** 31 + 29, 0.1, True, device="cpu",
                      log=lambda *a, **k: lines.append(a[0]))
    assert r["correct"] is True
    assert set(NEW) <= set(r["metrics"])
    ref = next(json.loads(x) for x in lines if x.startswith('{"record": '
                                                           '"slab"'))
    traced = json.loads((root / "cebench" / "traffic"
                         / "tiny-b16.json").read_text())["trace_batches"]
    kept = ref["exact_rows"] + ref["adc_rows"]
    # the program's count holds the discarded candidates beside the kept
    # ones, which equal the reference's
    assert r["metrics"]["slab.candidates_per_batch"]["value"] * traced \
        >= kept > 0
    assert 0 < r["metrics"]["prober.discarded_lane_step_share"]["value"] \
        < 50


def test_the_spans_tool_splits_a_traced_call_into_parts(root):
    spec = importlib.util.spec_from_file_location(
        "cebench_tools_spans", ROOT / "cebench" / "tools" / "spans.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = tool.main(["--workload", TINY[1], "--seed", "7", "--device", "cpu",
                     "--calls", "2", "--rounds", "1"], root=root)
    assert len(out["rounds"]) == 1
    for rec in out["rounds"]:
        on, off = rec["on"], rec["off"]
        assert off["spans"] == {} and off["counters"]["kept_lane_steps"] == 0
        steps = on["spans"]["prober.slab_step"]["calls"]
        assert on["counters"]["slab_steps"] == steps > 0
        assert on["counters"]["calls"] == 2 and off["counters"]["calls"] == 0
        for key, total in (("syncs_split", on["syncs"]),
                           ("launches_split", on["launches"]),
                           ("idle_s_split",
                            on["window_s"] - on["busy_s"])):
            assert sum(on[key].values()) == pytest.approx(total)
        assert "pq.build_query_lut" in on["spans"]
    assert set(out["gate_us"]) == {"gated span", "record_function"}
