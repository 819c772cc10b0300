"""Builds the CUDA kernels in ``csrc/`` into one shared library at first use.

One ``nvcc`` per source, all started together, then one link, into
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``).
The library has a plain C interface and is loaded with ``ctypes``; every
entry point returns ``cudaGetLastError()``. The library's name carries a
hash of the sources and the headers beside them, so an edited source is
rebuilt and a stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _I64, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                   ctypes.c_float)
# C entry point -> argtypes (pointers and the stream as c_void_p; a
# Python float passed as c_float is rounded to float32 as torch rounds it)
SIGNATURES = {
    "lsh_hash_f32": [_P, _P, _P, _P, _P, _I64, _I, _I, _P],
    "hamming_to_buckets_i32": [_P, _P, _P, _P, _I, _I, _I64, _I, _P],
    "query_lanes_i32": [_P] * 8 + [_I, _I, _I64, _I, _I, _I, _I, _I64, _P],
    "l2dist_f32": [_P, _P, _P, _I64, _I, _I, _I64] + [_I] * 5 + [_P],
    "l2dist_general_f32": [_P, _P, _P, _I64, _I, _I, _P],
    "l2dist_rows_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "adc_rows_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "adc_rows_u8": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "adc_batch_f32": [_P, _P, _P, _I64] + [_I] * 8 + [_P],
    "adc_batch_u8": [_P, _P, _P, _I64] + [_I] * 8 + [_P],
    "slab_qualify": [_P] * 21 + [_I] * 16 + [_P],
    "slab_loop": [_P] * 30 + [_F] * 3 + [_I] * 18 + [_P],
    "central_qualify": [_P] * 18 + [_I] * 15 + [_P],
    "cache_insert": [_P] * 22 + [_I] * 8 + [_P],
    "neighbor_dists_i8": [_P, _P] + [_I] * 10 + [_I64] * 2 + [_I] * 3 + [_P],
}


class Built(NamedTuple):
    """The loaded library plus what its build reported (``seconds`` and
    ``ptxas`` are 0 and empty when an up-to-date library was reused)."""
    lib: ctypes.CDLL
    seconds: float
    ptxas: list[str]
    path: Path


_BUILT: Built | None = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources in {CSRC}")
    return srcs


def _compile(path: Path) -> tuple[float, list[str]]:
    nvcc = _nvcc()
    srcs = _sources()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c",
                                   str(s), "-o", str(o)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        for s, p, log in zip(srcs, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s.name}:\n{log}")
        tmp_so = Path(tmp) / path.name
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp_so),
                               *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(tmp_so, path)    # atomic: a concurrent build never
                                    # loads a half-written library
    ptxas = [ln.strip() for log in logs for ln in log.splitlines()
             if "registers" in ln or "spill" in ln
             or "Compiling entry" in ln]
    return time.perf_counter() - t0, ptxas


def load() -> Built:
    """Build (if needed) and load the kernel library; cached per process."""
    global _BUILT
    if _BUILT is not None:
        return _BUILT
    digest = hashlib.sha256()
    for s in _sources() + sorted(CSRC.glob("*.cuh")):
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / f"libreprokernels_{digest.hexdigest()[:16]}.so"
    seconds, ptxas = 0.0, []
    if not path.exists():
        seconds, ptxas = _compile(path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _BUILT = Built(lib, seconds, ptxas, path)
    return _BUILT
