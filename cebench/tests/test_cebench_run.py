"""Whole runs of the tiny cells on the CPU (the harness's look for a card
skipped): the result line, discovery by name, throwaway cells added by
new files only (one served through the coalescer and its cache while it
ingests), and the exit without a card."""
from __future__ import annotations

import hashlib
import json

import pytest
import torch

from cebench.tests._util import (ROOT, SERVED, TINY, add_cell,  # noqa: F401
                                 one_thread, served, tiny_root)
from cebench.harness import core, data

KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]


@pytest.fixture(scope="module")
def root(tmp_path_factory, one_thread):
    return tiny_root(tmp_path_factory.mktemp("checkout"))


def _quiet(*a, **k):
    pass


@pytest.mark.parametrize("cell", TINY)
def test_a_run_is_correct_and_prints_the_contract_keys(root, cell):
    r = core.run_cell(root, cell, 2 ** 31 + 7, 0.3, False, device="cpu",
                      log=_quiet)
    assert list(r)[:3] == KEYS[:3] and list(r)[-1] == "compared"
    assert set(KEYS) <= set(r)
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] % 16 == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"queries_per_s", "batch_p90_ms",
                                 "peak_mem_gib", "setup_s"}
    assert all(v["value"] >= 0 for v in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    assert {k: v["value"] for k, v in r["compared"].items()} == \
        {"build_diff": 0, "stats_diff": 0, "est_gap": 0.0}
    json.dumps(r)


def test_a_traced_run_reports_the_per_layer_metrics_it_can_read(root):
    r = core.run_cell(root, TINY[0], 11, 0.1, True, device="cpu", log=_quiet)
    assert r["correct"] is True
    # on the CPU the profiler sees no device: only the set-up's seconds and
    # the host's launch-free counts are there to read
    assert "setup.build_s" in r["metrics"]
    assert not {"ring_cumsums_roofline", "query_lanes_roofline",
                "device.idle_share"} & set(r["metrics"])
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def test_a_new_cell_takes_new_files_and_entries_only(root, tmp_path):
    digest = {p: hashlib.sha256(p.read_bytes()).hexdigest()
              for p in (root / "cebench").rglob("*") if p.is_file()}
    bench = root / "cebench"
    cfg = json.loads((bench / "configs" / "tiny-exact.json").read_text())
    cfg.update(name="tiny-wide", d=24)
    (bench / "configs" / "tiny-wide.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "tiny-b16.json").read_text())
    traffic.update(batch=8)
    (bench / "traffic" / "tiny-b8.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "tiny.pairs_per_call.py").write_text(
        "def read(ctx):\n    return float(ctx.batch)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny-wide.tiny-b8",
                              "config": "tiny-wide", "traffic": "tiny-b8",
                              "chips": 1, "why": "throwaway"})
    spec["per_layer"].append({"name": "tiny.pairs_per_call", "unit": "pairs",
                              "better": "higher", "source": "host_clock",
                              "layer": "traffic", "moves": "queries_per_s",
                              "workloads": ["tiny-wide.tiny-b8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    try:
        r = core.run_cell(root, "tiny-wide.tiny-b8", 5, 0.1, True,
                          device="cpu", log=_quiet)
        assert r["correct"] is True
        assert r["metrics"]["tiny.pairs_per_call"]["value"] == 8.0
        assert r["attempted"] % 8 == 0
    finally:
        for p in (bench / "configs" / "tiny-wide.json",
                  bench / "traffic" / "tiny-b8.json",
                  bench / "metrics" / "tiny.pairs_per_call.py"):
            p.unlink()
        spec["workloads"].pop()
        spec["per_layer"].pop()
        (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    for p, h in digest.items():
        assert hashlib.sha256(p.read_bytes()).hexdigest() == h, p


HIT_SHARE = """def read(ctx):
    c = ctx.counters
    if c is None or not c["cache_lookups"]:
        return None
    return 100.0 * c["cache_hits"] / c["cache_lookups"]
"""


def test_a_served_cell_that_ingests_takes_new_files_and_entries_only(root):
    """A driver over the program's coalescer, with its estimate cache,
    zipf reuse and ingests that cross a capacity doubling, comes in by new
    files; its records replay on the reference and read correct, with no
    stale serve; a reader reads the driver's counters."""
    digest = {p: hashlib.sha256(p.read_bytes()).hexdigest()
              for p in (root / "cebench").rglob("*") if p.is_file()}
    spec_text = (root / "BENCHMARK.json").read_text()
    config, traffic = served()
    new = add_cell(root, config, traffic, "tiny_serve")
    reader = root / "cebench" / "metrics" / "tiny.hit_share.py"
    reader.write_text(HIT_SHARE)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "tiny.hit_share", "unit": "%",
                              "better": "higher",
                              "source": "program_counter", "layer": "cache",
                              "moves": "queries_per_s",
                              "workloads": [SERVED]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    lines = []
    try:
        r = core.run_cell(root, SERVED, 2 ** 31 + 17, 0.3, True,
                          device="cpu",
                          log=lambda *a, **k: lines.append(a[0]))
    finally:
        for p in new + [reader]:
            p.unlink()
        (root / "BENCHMARK.json").write_text(spec_text)
    for p, h in digest.items():
        assert hashlib.sha256(p.read_bytes()).hexdigest() == h, p
    assert r["correct"] is True and r["failed"] == 0
    assert {k: v["value"] for k, v in r["compared"].items()} == \
        {"build_diff": 0, "stats_diff": 0, "est_gap": 0.0,
         "stale_serves": 0}
    rec = next(json.loads(x) for x in lines
               if x.startswith('{"record": "check"'))
    assert rec["capacity"] == 2 * config["capacity"]
    assert rec["ingested_rows"] > config["capacity"] - config["n"]
    assert rec["reused"] > 0
    assert 0 <= r["metrics"]["tiny.hit_share"]["value"] <= 100


def test_a_missing_file_is_a_cell_error(root, tmp_path):
    with pytest.raises(core.CellError):
        core.load_cell(root, "no-such.cell")
    with pytest.raises(core.CellError):
        core.load_cell(tmp_path, TINY[0])


def test_a_traffic_file_names_its_driver(root):
    traffic = root / "cebench" / "traffic" / "tiny-b16.json"
    text = traffic.read_text()
    try:
        body = json.loads(text)
        del body["driver"]
        traffic.write_text(json.dumps(body))
        with pytest.raises(core.CellError, match="driver"):
            core.load_cell(root, TINY[0])
        traffic.write_text(json.dumps(dict(body, driver="no-such")))
        with pytest.raises(core.CellError):
            core.load_cell(root, TINY[0])
    finally:
        traffic.write_text(text)
    assert core.load_cell(root, TINY[0]).driver.open


def test_without_a_card_the_command_exits_non_zero_and_prints_nothing(
        capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = core.main(["--workload", "sift1m-exact.plan-b128", "--seed", "1",
                    "--seconds", "1"], root=ROOT)
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err


@pytest.mark.parametrize("cell", TINY)
def test_the_reference_rederives_the_ports_build_and_answers(root, cell):
    """The port's CPU route against the plain reference at a tiny size."""
    from repro_torch.core import estimator as E
    c = core.load_cell(root, cell)
    cfg, tr = c.config, c.traffic
    x, pool_q, pool_t, _ = core.make_inputs(cfg, tr, 3, torch.device("cpu"))
    pcfg = core.prober_config(cfg)
    state = E.build(x, pcfg, generator=data.generator(3, "build", "cpu"),
                    capacity=cfg["capacity"], device="cpu")
    x_pad = torch.nn.functional.pad(x, (0, 0, 0, cfg["capacity"] - cfg["n"]))
    ri = c.reference.build(x_pad, cfg["n"], cfg["prober"],
                           data.generator(3, "build", "cpu"))
    mine, theirs = core.index_arrays(state), core.ref_arrays(ri)
    assert set(mine) == set(theirs)
    assert all(core.count_diff(mine[k], theirs[k]) == 0 for k in mine)
    g = torch.Generator().manual_seed(4)
    qs = pool_q[torch.randint(0, pool_q.shape[0], (16,), generator=g)]
    taus = pool_t.reshape(-1)[torch.randint(0, pool_t.numel(), (16,),
                                            generator=g)]
    rks = torch.randint(0, 2 ** 32, (16, pcfg.n_tables, 6), generator=g)
    got = E.estimate_batch_stats(state, qs, taus, pcfg, rks=rks)
    want = c.reference.estimate(ri, x_pad, qs, taus, rks, cfg["prober"])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[2].sum()) > 0


@pytest.mark.cuda
def test_the_served_cell_replays_correct_on_the_card(tmp_path):
    """The served cell's records replay bit for bit on the card too: the
    program's padded miss batches against the reference's lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    root = tiny_root(tmp_path)
    config, traffic = served()
    add_cell(root, config, traffic, "tiny_serve")
    r = core.run_cell(root, SERVED, 2 ** 31 + 41, 1.0, False, log=_quiet)
    assert r["correct"] is True
    assert r["compared"]["stale_serves"]["value"] == 0
