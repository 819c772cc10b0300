"""Shared helpers of the cebench CPU tests: a throwaway checkout holding
the benchmark's files plus the tiny test cells (tests/data)."""
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


@pytest.fixture(scope="module", autouse=False)
def one_thread():
    """Whole runs on one CPU thread, so that a module's runs do not crowd
    the test workers beside them; the worker's setting comes back after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
