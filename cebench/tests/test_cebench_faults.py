"""The comparison that decides ``correct`` fails a run whose timed path is
broken underneath, or whose record leaves out what the program did, or
that compares a number with no limit, and the control (the program's
matrix products in TF32) comes out not correct; a cell on the card is
marked ``cuda``."""
from __future__ import annotations

import json

import pytest
import torch

from cebench.tests._util import (SERVED, TINY, add_cell,  # noqa: F401
                                 one_thread, served, tiny_root)
from cebench import control
from cebench.harness import core

# the served cell with its ingests left out of the record, and with no
# limit for the stale serves
UNRECORDED = "tiny-serve.tiny-zipf-unrecorded"
NO_LIMIT = "tiny-serve-nolimit.tiny-zipf"


@pytest.fixture(scope="module")
def root(tmp_path_factory, one_thread):
    r = tiny_root(tmp_path_factory.mktemp("checkout"))
    config, traffic = served()
    add_cell(r, config, traffic, "tiny_serve")
    add_cell(r, config, dict(traffic, name="tiny-zipf-unrecorded",
                             omit_ingest_ops=True), "tiny_serve")
    limits = {k: v for k, v in config["limits"].items()
              if k != "stale_serves"}
    add_cell(r, dict(config, name="tiny-serve-nolimit", limits=limits),
             traffic, "tiny_serve")
    return r


def _quiet(*a, **k):
    pass


# each fault wraps the entry as it is when the fault is made: the run puts
# the fault in the entry's place

def _unchanged():
    """Every call answers what the first call answered."""
    from repro_torch.core import estimator as E
    plain = E.estimate_batch_stats
    first = []

    def est(state, qs, taus, cfg, rks=None):
        if not first:
            first.append(plain(state, qs, taus, cfg, rks=rks))
        return first[0]
    return est


def _half():
    """Half the batch estimated, the other half given the mean of it."""
    from repro_torch.core import estimator as E
    plain = E.estimate_batch_stats

    def est(state, qs, taus, cfg, rks=None):
        h = qs.shape[0] // 2
        e, pk, nv = plain(state, qs[:h], taus[:h], cfg, rks=rks[:h])
        rest = qs.shape[0] - h
        return (torch.cat([e, e.mean().expand(rest)]),
                torch.cat([pk, pk.float().mean(0).round().int()
                           .expand(rest, -1)]),
                torch.cat([nv, nv.float().mean().round().int()
                           .expand(rest)]))
    return est


def _altered():
    """One estimate a call off by one point where it is produced."""
    from repro_torch.core import estimator as E
    plain = E.estimate_batch_stats

    def est(state, qs, taus, cfg, rks=None):
        e, pk, nv = plain(state, qs, taus, cfg, rks=rks)
        e = e.clone()
        e[0] += 1.0
        return e, pk, nv
    return est


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["state_unchanged", "half_batch",
                              "answer_altered"])
def test_a_broken_timed_path_is_not_correct(root, fault):
    r = core.run_cell(root, TINY[0], 21, 0.3, False, device="cpu",
                      log=_quiet, estimate=fault())
    assert r["correct"] is False
    assert r["compared"]["stats_diff"]["value"] > 0 or \
        r["compared"]["est_gap"]["value"] > r["compared"]["est_gap"]["limit"]


def _stale_served(monkeypatch):
    """The cache serves an entry that an ingest made stale."""
    from repro_torch.cache import estimate_cache as C
    plain = C.lookup

    def lookup(*a, **k):
        cache, est, hit, stale = plain(*a, **k)
        return cache, est, hit | stale, torch.zeros_like(stale)
    monkeypatch.setattr(C, "lookup", lookup)


def _reuse_altered(monkeypatch):
    """A hit served with another value than the probe it reuses."""
    from repro_torch.cache import estimate_cache as C
    plain = C.lookup

    def lookup(*a, **k):
        cache, est, hit, stale = plain(*a, **k)
        return cache, torch.where(hit, est + 1.0, est), hit, stale
    monkeypatch.setattr(C, "lookup", lookup)


@pytest.mark.parametrize("fault,cell,key", [
    (_stale_served, SERVED, "stale_serves"),
    (_reuse_altered, SERVED, "stats_diff"),
    (None, UNRECORDED, "build_diff"),
    (None, NO_LIMIT, "stale_serves")],
    ids=["stale_serve", "reuse_altered", "ingest_unrecorded", "no_limit"])
def test_a_served_run_that_breaks_its_guarantees_is_not_correct(
        root, monkeypatch, fault, cell, key):
    if fault is not None:
        fault(monkeypatch)
    lines = []
    r = core.run_cell(root, cell, 23, 0.3, False, device="cpu",
                      log=lambda *a, **k: lines.append(a[0]))
    assert r["correct"] is False
    got = r["compared"][key]
    rec = next(json.loads(x) for x in lines
               if x.startswith('{"record": "check"'))
    if cell == NO_LIMIT:
        assert got["limit"] is None and rec["no_limit"] == [key]
    else:
        assert got["value"] > got["limit"] and rec["no_limit"] == []


@pytest.mark.parametrize("cell", TINY)
def test_the_tf32_control_is_not_correct(root, cell):
    res = control.readings(root, cell, [31], 0.1, ["sound", "tf32"],
                           device="cpu")
    (_, sound_ok, _), = res["sound"]
    (_, ctrl_ok, compared), = res["tf32"]
    assert sound_ok is True and ctrl_ok is False
    assert compared["build_diff"]["value"] > 0


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10, 1.0 + 3 * 2 ** -12])
    got = control.round_tf32(x)
    assert got.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0 + 2 ** -10]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", TINY)
def test_a_tiny_cell_on_the_card_is_correct_and_its_control_is_not(root,
                                                                    cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    res = control.readings(root, cell, [41], 0.5, ["sound", "tf32"])
    assert res["sound"][0][1] is True and res["tf32"][0][1] is False
