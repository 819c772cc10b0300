"""Shared helpers of the cebench CPU tests: a throwaway checkout holding
the benchmark's files plus the tiny test cells (tests/data), and a served
cell that ingests, added to it by new files only."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

DATA = Path(__file__).resolve().parent / "data"
TINY = ("tiny-exact.tiny-b16", "tiny-pq.tiny-b16")
# the coalescer with its cache over an index that ingests past a capacity
# doubling (tests/data/tiny_serve.py, tiny-serve.json, tiny-zipf.json)
SERVED = "tiny-serve.tiny-zipf"


def tiny_root(tmp: Path) -> Path:
    """A checkout in ``tmp`` with the benchmark's files as they are, and the
    tiny cells added by new files and new BENCHMARK.json entries only."""
    shutil.copytree(ROOT / "cebench", tmp / "cebench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell in TINY:
        config, traffic = cell.split(".")
        shutil.copy(DATA / f"{config}.json",
                    tmp / "cebench" / "configs" / f"{config}.json")
        shutil.copy(DATA / f"{traffic}.json",
                    tmp / "cebench" / "traffic" / f"{traffic}.json")
        spec["workloads"].append({"name": cell, "config": config,
                                  "traffic": traffic, "chips": 1,
                                  "why": "a CPU test size"})
    stands_for = {"sift1m-exact.plan-b128": TINY[0],
                  "gist1m-pq.plan-b128": TINY[1]}
    for m in spec["per_layer"]:
        m["workloads"].extend(stands_for[w] for w in list(m["workloads"]))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return tmp


def add_cell(root: Path, config: dict, traffic: dict, driver: str | None,
             name: str | None = None) -> list[Path]:
    """Add a cell to the checkout ``root`` by new files (its configuration,
    its traffic and, where given, the test driver of that name from
    tests/data) and a new ``BENCHMARK.json`` entry; returns the files."""
    bench = root / "cebench"
    new = [bench / "configs" / f"{config['name']}.json",
           bench / "traffic" / f"{traffic['name']}.json"]
    new[0].write_text(json.dumps(config))
    new[1].write_text(json.dumps({k: v for k, v in traffic.items()
                                  if k != "name"}))
    if driver is not None:
        new.append(bench / "drivers" / f"{driver}.py")
        if not new[-1].exists():
            shutil.copy(DATA / f"{driver}.py", new[-1])
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": name or f"{config['name']}."
                              f"{traffic['name']}", "config": config["name"],
                              "traffic": traffic["name"], "chips": 1,
                              "why": "a CPU test size"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return new


def served(**traffic) -> tuple[dict, dict]:
    """The served cell's configuration and traffic, the traffic's
    parameters updated from ``traffic``."""
    config = json.loads((DATA / "tiny-serve.json").read_text())
    mix = {"name": "tiny-zipf",
           **json.loads((DATA / "tiny-zipf.json").read_text())}
    mix.update(traffic)
    return config, mix


@pytest.fixture(scope="module", autouse=False)
def one_thread():
    """Whole runs on one CPU thread, so that a module's runs do not crowd
    the test workers beside them; the worker's setting comes back after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
