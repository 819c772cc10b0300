"""The served SIFT1M cell's driver (``drivers/serve.py``) and its four
readers, on the CPU at a tiny size (``tests/data/tiny-exact-served.json``
and ``tiny-serve-zipf-ingest.json``, the cell's tiny stand-in): a traced
run replays correct with no stale serve across a capacity doubling and
reads every new metric; the warm coalescer and its cache carry over into
the window; the held-out rows are drawn before the clock; a program
without ``ingest_stats`` (the parent's) still runs correct and the ingest
reader reads nothing; and a coalescer that skips the ball-sum freshness
check after an ingest is caught."""
from __future__ import annotations

import json
import sys

import pytest
import torch

from cebench.tests._util import one_thread, tiny_root  # noqa: F401
from cebench.tests.conftest import SERVED_CELL
from cebench.harness import core, data

SEED = 2 ** 31 + 101
NEW = ("serve.hit_share", "serve.syncs_per_flush", "serve.idle_ms_per_flush",
       "ingest.device_ms_per_kpoint")
ZERO = {"build_diff": 0, "stats_diff": 0, "est_gap": 0.0, "stale_serves": 0}


@pytest.fixture(scope="module")
def root(tmp_path_factory, one_thread):
    return tiny_root(tmp_path_factory.mktemp("checkout"))


def _run(root, trace_on, seconds=0.3):
    """``(result line, the check's record)`` of one run of the cell."""
    lines = []
    r = core.run_cell(root, SERVED_CELL, SEED, seconds, trace_on,
                      device="cpu", log=lambda *a, **k: lines.append(a[0]))
    rec = next(json.loads(x) for x in lines
               if x.startswith('{"record": "check"'))
    return r, rec


@pytest.fixture(scope="module")
def traced(root):
    """A traced run, with the caller of every held-out draw noted."""
    callers = []
    plain = data.heldout

    def heldout(*a, **k):
        callers.append(sys._getframe(1).f_code.co_name)
        return plain(*a, **k)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(data, "heldout", heldout)
        r, rec = _run(root, True)
    return r, rec, callers


def _values(r):
    return {k: v["value"] for k, v in r["compared"].items()}


def test_a_traced_run_is_correct_across_a_capacity_doubling(root, traced):
    r, rec, _ = traced
    config = json.loads((root / "cebench" / "configs"
                         / "tiny-exact-served.json").read_text())
    assert r["correct"] is True and r["failed"] == 0
    assert _values(r) == ZERO
    assert rec["capacity"] == 2 * config["capacity"]
    assert rec["ingested_rows"] > config["capacity"] - config["n"]
    assert rec["reused"] > 0


def test_a_traced_run_reads_the_four_new_metrics(traced):
    r, _, _ = traced
    assert set(NEW) <= set(r["metrics"])
    assert all(isinstance(r["metrics"][m]["value"], float) for m in NEW)
    assert 0 < r["metrics"]["serve.hit_share"]["value"] < 100


def test_no_held_out_row_is_drawn_inside_a_call(traced):
    _, _, callers = traced
    assert "prepare" in callers and "check" in callers
    assert set(callers) == {"prepare", "check"}


def test_the_warm_cache_carries_over_into_the_window(root):
    cell = core.load_cell(root, SERVED_CELL)
    su = core.set_up(cell, SEED, torch.device("cpu"))
    co = su.driver.co
    warm = int(cell.traffic["warm_batches"])
    assert co.cache_stats["lookups"] == warm * int(cell.traffic["batch"])
    assert su.driver.flushes == warm
    # a cold cache would answer the window's first flush by probes alone
    first = [core.timed_call(su.driver, i)[1] for i in range(2)]
    assert all(any(op[0] == "reuse" for op in c.record) for c in first)


def _no_ingest_stats(monkeypatch):
    """The coalescer as the parent commit has it, to its readers: no
    ``ingest_stats``."""
    from repro_torch.serve.coalescer import CardinalityCoalescer as Co
    init, chunk = Co.__init__, Co._apply_ingest_chunk

    def __init__(self, *a, **k):
        init(self, *a, **k)
        del self.ingest_stats

    def _apply_ingest_chunk(self, k):
        self.ingest_stats = {"rows": 0, "chunks": 0, "grows": 0}
        try:
            chunk(self, k)
        finally:
            del self.ingest_stats
    monkeypatch.setattr(Co, "__init__", __init__)
    monkeypatch.setattr(Co, "_apply_ingest_chunk", _apply_ingest_chunk)


def test_without_ingest_stats_the_ingest_reader_reads_nothing(root,
                                                              monkeypatch):
    _no_ingest_stats(monkeypatch)
    r, _ = _run(root, True)
    assert r["correct"] is True and _values(r) == ZERO
    assert "ingest.device_ms_per_kpoint" not in r["metrics"]
    assert set(NEW) - {"ingest.device_ms_per_kpoint"} <= set(r["metrics"])


def test_skipping_the_freshness_check_after_an_ingest_is_caught(
        root, monkeypatch):
    from repro_torch.serve.coalescer import CardinalityCoalescer as Co
    chunk = Co._apply_ingest_chunk

    def _apply_ingest_chunk(self, k):
        chunk(self, k)
        self._check_ingest = False
    monkeypatch.setattr(Co, "_apply_ingest_chunk", _apply_ingest_chunk)
    r, _ = _run(root, False)
    assert r["correct"] is False
    assert r["compared"]["stale_serves"]["value"] > 0
