"""The five ``examples/torch_*.py`` on the CPU, each ``main`` at a small
size (the examples' defaults are their JAX twins' sizes, run on the card).
Each asserts what its twin prints: q-errors below 2 on a clustered corpus
(mean below 1.5 for the streamed and the static build), estimates within
10 % + 1 of the exact counts on the distributed path, the planner's three
actions and more cache hits than misses, the loss lower after 30 steps
across an injected failure. ~15 s.
"""
import importlib
import os
import sys

import pytest

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


def _load(name: str):
    """The example as a module importable by name: the distributed one's
    spawned ranks import it again (spawn hands them this ``sys.path``)."""
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    return importlib.import_module(name)


def test_quickstart():
    out = _load("torch_quickstart").main(
        ["--device", "cpu", "--scale", "0.05", "--new-points", "256"])
    assert out["qerrors"] and max(out["qerrors"]) < 2.0
    est, true = out["after_update"]
    assert max(est, 1) / max(true, 1) < 2.0 and max(true, 1) / max(est, 1) < 2.0
    assert out["n_valid"] == 2000 + 256


def test_dynamic_updates():
    out = _load("torch_dynamic_updates").main(
        ["--device", "cpu", "--scale", "0.03", "--chunk", "256"])
    assert out["n_valid"] == out["n"] == 1200
    assert out["qerr_updated"] < 1.5 and out["qerr_static"] < 1.5


def test_distributed_estimate():
    rows = _load("torch_distributed_estimate").main(
        ["--device", "cpu", "--ranks", "4", "--n", "4000"])
    assert len(rows) == 8
    for r in rows:
        assert abs(r["estimate"] - r["true"]) <= 0.1 * r["true"] + 1, r


def test_serve_semantic():
    out = _load("torch_serve_semantic").main(
        ["--device", "cpu", "--docs", "1000", "--repeats", "40",
         "--new-docs", "200"])
    assert out["actions"] == {"narrow": "execute", "medium": "execute",
                              "too-broad": "refuse"}
    assert out["stats"]["hits"] > out["stats"]["misses"]
    assert out["after_update"] == "execute"


def test_train_tiny_lm():
    log = _load("torch_train_tiny_lm").main(
        ["--device", "cpu", "--steps", "30", "--save-every", "10",
         "--fail-at", "17"])
    assert log[-1]["step"] == 30 and len(log) == 37
    assert log[-1]["loss"] < log[0]["loss"]


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_dynamic_updates",
                                  "torch_distributed_estimate",
                                  "torch_serve_semantic",
                                  "torch_train_tiny_lm"])
def test_default_device_is_the_card(name, monkeypatch):
    """Without a card the examples' default ``--device cuda`` raises: no
    CPU fallback."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _load(name).main([])
