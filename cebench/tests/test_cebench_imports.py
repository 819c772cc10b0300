"""Nothing the benchmark runs imports JAX, the JAX package or the JAX
benchmarks; the plain reference imports nothing of the program either."""
from __future__ import annotations

import ast

import pytest

from cebench.tests._util import ROOT
from cebench.harness import core

BENCH = ROOT / "cebench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def top_level_imports(path):
    """Top-level names (before the first dot) of every import in a file;
    relative imports are the benchmark's own."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def modules():
    return sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in
                  p.parts)


def test_the_walk_sees_the_harness_and_reads_names_whole():
    files = {p.relative_to(BENCH).as_posix() for p in modules()}
    assert {"run.py", "harness/core.py", "reference/prober.py",
            "metrics/device.idle_share.py"} <= files
    assert "repro_torch" in top_level_imports(BENCH / "harness" / "core.py")
    assert "repro_torch".split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("path", modules(), ids=lambda p: p.relative_to(
    BENCH).as_posix())
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_only_torch_numpy_and_itself(path):
    names = top_level_imports(path)
    assert "repro_torch" not in names
    assert names <= {"__future__", "math", "typing", "torch", "numpy",
                     "cebench"}
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("cebench"):
            assert node.module == "cebench.reference"


def test_the_run_finds_forbidden_modules_by_whole_name():
    assert core.forbidden_modules(["repro_torch", "repro_torch.core",
                                   "torch", "jaxtyping", "cebench"]) == []
    assert core.forbidden_modules(["repro.core", "jax.numpy", "flax",
                                   "benchmarks.common", "jaxlib"]) == \
        ["benchmarks", "flax", "jax", "jaxlib", "repro"]
