"""``rings.rows_per_lane``: the bucket rows a lane's rings were built over,
from the program's tally of ring rows (``prober.read_tally``'s
``ring_rows``) over the traced calls' lanes. On synthetic contexts, on a
program whose tally has no such field, and on traced CPU runs of the tiny
cells, whose capacity-padded index is cut to its live extent."""
from __future__ import annotations

import json

import pytest

from cebench.tests._util import ROOT, TINY, one_thread, tiny_root  # noqa: F401
from cebench.harness import core, program, trace

NAME = "rings.rows_per_lane"
FIELDS = ("exact", "adc", "discarded", "discarded_lane_steps",
          "kept_lane_steps")
ONE_CALL = [core.Call((None, None, None), [("estimate", None, None, None)])]


class _Driver:
    def counters(self):
        return {}


def _reader():
    return core.load_module(ROOT / "cebench" / "metrics" / f"{NAME}.py")


def _ctx(counters, batch=128, n_tables=2):
    return core.MetricCtx(summary=trace.summarize([]), build_s=0.0,
                          config={"prober": {"n_tables": n_tables}},
                          batch=batch, live_buckets=0, slab={},
                          counters=counters)


def _moved(monkeypatch, start: dict, end: dict, calls):
    counts = dict(start)
    monkeypatch.setattr(program, "tally", lambda: dict(counts))
    before = core.counters_now(_Driver())
    counts.update(end)
    moved = program.diff(before, core.counters_now(_Driver()))
    return core.traced_counters(moved, calls)


@pytest.mark.parametrize("extent,batch,n_tables",
                         ((8192, 128, 2), (16384, 64, 2), (256, 16, 3)))
def test_reads_ring_rows_over_the_traced_calls_lanes(monkeypatch, extent,
                                                     batch, n_tables):
    calls = ONE_CALL * 6
    start = {**dict.fromkeys(FIELDS, 0), "ring_rows": 12345, "calls": 2}
    end = {"ring_rows": 12345 + 6 * batch * n_tables * extent, "calls": 8}
    ctx = _ctx(_moved(monkeypatch, start, end, calls), batch, n_tables)
    assert _reader().read(ctx) == extent


@pytest.mark.parametrize("case", ("no field", "no tally", "calls differ"))
def test_reads_nothing_without_a_count_of_the_traced_calls(monkeypatch,
                                                           case):
    """A parent whose tally has no ``ring_rows``, a program with no tally,
    and a tally that did not move by exactly the traced estimates."""
    start = {**dict.fromkeys(FIELDS, 0), "calls": 0}
    end = {"calls": 1, "exact": 7}
    if case == "no tally":
        from repro_torch.core import prober
        monkeypatch.delattr(prober, "read_tally")
        now = core.counters_now(_Driver())
        counters = core.traced_counters(program.diff(now, now), ONE_CALL)
    else:
        if case == "calls differ":
            start["ring_rows"], end["ring_rows"] = 0, 2 * 256 * 128 * 2
            end["calls"] = 2
        counters = _moved(monkeypatch, start, end, ONE_CALL)
    assert _reader().read(_ctx(counters)) is None


@pytest.fixture(scope="module")
def root(tmp_path_factory, one_thread):
    return tiny_root(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("cell", TINY)
def test_a_traced_cpu_run_reads_the_live_extent(root, cell):
    r = core.run_cell(root, cell, 2 ** 31 + 57, 0.1, True, device="cpu",
                      log=lambda *a, **k: None)
    assert r["correct"] is True
    rows = r["metrics"][NAME]["value"]
    cfg = json.loads((root / "cebench" / "configs"
                      / f"{cell.split('.')[0]}.json").read_text())
    # a power of two of at least 256 rows, below the index's capacity
    assert 256 <= rows < cfg["capacity"]
    assert rows == int(rows) and int(rows) & (int(rows) - 1) == 0
