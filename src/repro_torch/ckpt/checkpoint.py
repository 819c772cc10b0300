"""Fault-tolerant checkpointing (port of ``repro/ckpt/checkpoint.py``).

Layout per step, the reference's:  <dir>/step_<N>/
    manifest.json          step, config hash, leaf index, completion marker
    shard_<host>.npz       flat leaf arrays owned by this host

A state is nested dicts of tensors; a leaf's key is its path ``/``-joined
(keys sorted at every level), as the reference joins its tree paths, so a
checkpoint written by either package restores in the other. Guarantees:
  * atomic publish — everything is written into ``step_<N>.tmp`` and
    renamed; a crash mid-save never corrupts the latest valid checkpoint;
  * restore-latest-valid — directories without a manifest (or without this
    host's shard) are skipped, so a torn save falls back to the previous
    step;
  * async save — ``save_async`` copies every leaf to host memory before it
    returns (the next in-place optimizer step cannot race the writer
    thread) and writes in a worker thread;
  * data-pipeline cursor and optimizer state ride along with params;
  * retention — keep the newest ``keep`` checkpoints.

bfloat16 leaves are written as float32 (numpy has no bfloat16; exact) and
restored to the template's dtype.

A sharded state (DTensor leaves, the mesh trainer's) is saved whole: every
rank takes part in gathering each DTensor, rank 0 alone copies the full
tensors to the host and writes them, and the others wait for it (a
barrier after the write, which rank 0 reaches even if the write fails;
``save_async``'s ``wait`` holds it). ``restore`` gives such a leaf as a
full host tensor, as the reference restores host state;
``ft.elastic.reshard`` (or ``ft.failures.copy_into``) places it on a
mesh.
"""
from __future__ import annotations

import hashlib
import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor


def _items(tree: dict, prefix: str = ""):
    """(key, tensor) pairs, keys sorted at every level (the reference's
    order)."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _items(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _host(t: torch.Tensor) -> np.ndarray:
    """A copy on the host (a CPU tensor is copied too: the caller may
    update it in place while a writer thread holds the copy)."""
    t = t.detach()
    if isinstance(t, DTensor):
        t = t.full_tensor()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


def _flatten(tree: dict) -> dict[str, np.ndarray] | None:
    """Host copies of ``tree``'s leaves by key. A sharded tree is gathered
    leaf by leaf on every rank (the gather is a collective), and only rank
    0, which writes, copies to the host: the others get None."""
    if not _sharded(tree) or dist.get_rank() == 0:
        return {k: _host(v) for k, v in _items(tree)}
    for _, v in _items(tree):
        if isinstance(v, DTensor):
            v.detach().full_tensor()
    return None


def _unflatten_into(tree: dict, flat: dict[str, np.ndarray],
                    prefix: str = "") -> dict:
    """``tree``'s structure with each leaf replaced by ``flat``'s array of
    its key, as a tensor of the leaf's dtype on its device."""
    out = {}
    for k, leaf in tree.items():
        key = f"{prefix}{k}"
        if isinstance(leaf, dict):
            out[k] = _unflatten_into(leaf, flat, key + "/")
            continue
        arr = flat[key]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"{key}: {arr.shape} != {tuple(leaf.shape)}")
        dev = "cpu" if isinstance(leaf, DTensor) else leaf.device
        out[k] = torch.as_tensor(arr).to(device=dev, dtype=leaf.dtype)
    return out


def _sharded(tree: dict) -> bool:
    return any(isinstance(v, DTensor) for _, v in _items(tree))


def config_hash(obj: Any) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3, host: int = 0,
                 n_hosts: int = 1):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.host = host
        self.n_hosts = n_hosts
        self._worker: threading.Thread | None = None
        self._error: BaseException | None = None
        self._barrier = False      # the outstanding save was sharded

    # ------------------------------------------------------------- save ----
    def save(self, step: int, state: dict, extra: dict | None = None) -> Path:
        flat = _flatten(state)          # every rank gathers a sharded state
        if not _sharded(state):
            return self._write(step, flat, extra or {})
        try:
            if flat is not None:
                self._write(step, flat, extra or {})
        finally:                        # rank 0 reaches it if its write fails
            dist.barrier()
        return self.dir / f"step_{step:08d}"

    def save_async(self, step: int, state: dict, extra: dict | None = None):
        self.wait()   # only one outstanding save
        flat = _flatten(state)   # synchronous device -> host snapshot
        self._barrier = _sharded(state)
        if flat is None:
            return
        self._worker = threading.Thread(
            target=self._write_reporting, args=(step, flat, extra or {}),
            daemon=True)
        self._worker.start()

    def wait(self):
        """Join the outstanding save; raise what its thread raised."""
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._barrier:
            self._barrier = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("asynchronous checkpoint save failed") from err

    def _write_reporting(self, step: int, flat: dict, extra: dict):
        try:
            self._write(step, flat, extra)
        except Exception as e:          # handed to wait(), which raises it
            self._error = e

    def _write(self, step: int, flat: dict, extra: dict) -> Path:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / f"shard_{self.host}.npz", **flat)
        manifest = {
            "step": step, "time": time.time(), "extra": extra,
            "leaves": sorted(flat.keys()), "n_hosts": self.n_hosts,
            "hosts_done": [self.host],
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()
        return final

    def _gc(self):
        steps = sorted(self._valid_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ---------------------------------------------------------- restore ----
    def _valid_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            try:
                m = json.loads((p / "manifest.json").read_text())
                if (p / f"shard_{self.host}.npz").exists():
                    out.append(int(m["step"]))
            except (json.JSONDecodeError, KeyError):
                continue
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self._valid_steps()
        return steps[-1] if steps else None

    def restore(self, template: dict, step: int | None = None
                ) -> tuple[dict, dict, int] | None:
        """-> (state, extra, step) or None if no valid checkpoint. The
        state has ``template``'s structure, each leaf a new tensor of the
        template leaf's dtype on its device (a DTensor leaf's: a full
        tensor on the host)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        p = self.dir / f"step_{step:08d}"
        manifest = json.loads((p / "manifest.json").read_text())
        with np.load(p / f"shard_{self.host}.npz") as z:
            flat = {k: z[k] for k in z.files}
        if sorted(flat.keys()) != manifest["leaves"]:
            raise ValueError(f"{p}: leaf index mismatch")
        state = _unflatten_into(template, flat)
        return state, manifest.get("extra", {}), step
