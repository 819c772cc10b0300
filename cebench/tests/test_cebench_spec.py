"""BENCHMARK.json against the contract's shape: keys, names, units,
bounds, files under its paths, and every cell reporting what it must."""
from __future__ import annotations

import json
import re

from cebench.tests._util import ROOT
from cebench.harness import core

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["cebench"]
    assert SPEC["command"][1].startswith("cebench/")
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_names_units_and_lines():
    for key, fields in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for e in SPEC[key]:
            assert set(e) == fields
            assert NAME.match(e["name"])
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for e in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(e["name"]) and UNIT.match(e["unit"])
        assert e["better"] in ("lower", "higher")
    names = [e["name"] for e in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))


def test_configs_files_and_cells():
    files = {c["name"]: c["file"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert c["file"].startswith("cebench/configs/")
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == set(files)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] == 1 for w in SPEC["workloads"])


def test_bounds_and_what_every_cell_reports():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        assert any(cell in m["workloads"] for m in SPEC["per_layer"])


def test_every_cell_loads_by_name():
    for w in SPEC["workloads"]:
        cell = core.load_cell(ROOT, w["name"])
        assert {m["name"] for m in cell.end_to_end} == \
            {"queries_per_s", "batch_p90_ms", "peak_mem_gib", "setup_s"}
        assert all(hasattr(r, "read") for _, r in cell.per_layer)
        assert hasattr(cell.reference, "estimate")
        assert hasattr(cell.reference, "update")
        assert hasattr(cell.driver, "open")
        gen = cell.traffic.get("generator")
        if gen is not None:
            assert hasattr(core.load_module(
                ROOT / "cebench" / "generators" / f"{gen}.py"), "make")
