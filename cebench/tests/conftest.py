"""The tiny checkout of ``_util.tiny_root``, for a ``BENCHMARK.json``
whose per-layer metrics also list the served cell.

``_util.tiny_root`` gives each metric the tiny cells that stand in for
the cells it lists, from a map of the two plan cells alone, and fails on
any other cell. This module puts in its place (before any test module
imports it) the same checkout with one more stand-in: the served cell's,
``tiny-exact-served.tiny-serve-zipf-ingest`` (its configuration and
traffic from ``tests/data``, run by ``drivers/serve.py``).
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from cebench.tests import _util

SERVED_CELL = "tiny-exact-served.tiny-serve-zipf-ingest"
STANDS_FOR = {"sift1m-exact.plan-b128": _util.TINY[0],
              "gist1m-pq.plan-b128": _util.TINY[1],
              "sift1m-exact-served.serve-zipf-ingest": SERVED_CELL}


def tiny_root(tmp: Path) -> Path:
    """A checkout in ``tmp`` with the benchmark's files as they are, and the
    tiny cells added by new files and new BENCHMARK.json entries only."""
    shutil.copytree(_util.ROOT / "cebench", tmp / "cebench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((_util.ROOT / "BENCHMARK.json").read_text())
    for cell in _util.TINY + (SERVED_CELL,):
        config, traffic = cell.split(".")
        shutil.copy(_util.DATA / f"{config}.json",
                    tmp / "cebench" / "configs" / f"{config}.json")
        shutil.copy(_util.DATA / f"{traffic}.json",
                    tmp / "cebench" / "traffic" / f"{traffic}.json")
        spec["workloads"].append({"name": cell, "config": config,
                                  "traffic": traffic, "chips": 1,
                                  "why": "a CPU test size"})
    for m in spec["per_layer"]:
        m["workloads"].extend(STANDS_FOR[w] for w in list(m["workloads"]))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return tmp


_util.tiny_root = tiny_root
