"""Distributed Dynamic Prober on ``torch.distributed`` (port of
``repro/core/distributed.py``).

Cardinality is additive over a partition of the data, so the index is
sharded: every rank of a process group holds one shard (a contiguous row
block at build time, round-robin arrivals after it), the hash functions are
the same on every rank (codes are globally consistent), every rank runs the
full prober on its own shard, and the estimates are summed.

The model is SPMD: every rank makes the same calls, each with its own shard.
The reference's single-controller ``shard_map`` maps onto collectives one
for one: ``psum`` is ``all_reduce(SUM)``, ``pmin``/``pmax`` one
``all_reduce(MIN)`` over ``cat(lo, -hi)`` (exact), ``axis_index``
``get_rank(group)`` and the axis size ``get_world_size(group)``. Only
``all_reduce`` and ``broadcast`` are used: NCCL has both, and gloo has both
for CPU and CUDA tensors (it stages CUDA tensors through the host itself).
``group=None`` means the default (world) group. Every ``all_reduce``
goes through :func:`collectives.all_reduce`, which counts it. The reference's
``repro/compat.py`` has no counterpart here: it dispatches between JAX
versions.

Two stopping modes (``estimate_sharded(mode=...)``):

* ``local``: each rank stops on its own shard, and one ``all_reduce(SUM)``
  folds the (Q,) estimates. Each shard's selectivity is within ε w.p.
  1-δ, so the global absolute error is within ε·N w.p. (1-δ)^P.
* ``sync``: pooled stopping (``estimator.estimate_batch_pooled``): one
  ``all_reduce`` at setup and one per slab step pool the Chernoff
  statistics, so the ε-test sees the GLOBAL selectivity, without a union
  bound. Every stopping decision derives from pooled values, which keeps
  the ranks in lockstep under the prober's compacting schedule.

Dynamic updates: ``build_sharded(capacity=C)`` pads every shard to C/P
rows; :func:`update_sharded` routes each batch round-robin, pads every
shard's part to one power-of-two width, grows every shard together when one
would overflow, and renormalises W from the live projections of all ranks
(Alg. 7's global min/max), so W stays bit-identical on every rank.

:func:`run_ranks` starts P ranks on this host (spawned processes, a
``FileStore`` rendezvous in a temporary directory, no network), joins them
with a timeout, and raises a rank's exception with its traceback.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import collectives, estimator as E, lsh, updates
from repro_torch.core.config import ProberConfig
from repro_torch.kernels import ops


def _group(group):
    return dist.group.WORLD if group is None else group


def shard_counts(n_local: int, group=None, device="cpu") -> np.ndarray:
    """Every rank's ``n_local``, in rank order, as a (P,) int64 array (one
    ``all_reduce`` on ``device``; NCCL needs a CUDA one)."""
    group = _group(group)
    counts = torch.zeros(dist.get_world_size(group), dtype=torch.int64,
                         device=device)
    counts[dist.get_rank(group)] = int(n_local)
    collectives.all_reduce(counts, group=group)
    return counts.cpu().numpy()


def build_sharded(x_global, cfg: ProberConfig,
                  generator: torch.Generator | None = None, group=None,
                  capacity: int | None = None, device="cuda", x_local=None,
                  params: lsh.LSHParams | None = None) -> E.ProberState:
    """Build this rank's shard of an index whose hash functions every rank
    shares. Returns the rank's :class:`~repro_torch.core.estimator.ProberState`
    (its ``index.params`` are the shared functions).

    Pass either ``x_global`` (N, d), the same on every rank, of which the
    rank takes the contiguous block ``[r·N/P, (r+1)·N/P)`` (N divisible by
    P), or ``x_local``, the rank's rows alone. ``capacity`` is GLOBAL and
    split evenly: every shard is padded to ``capacity // P`` rows, so an
    :func:`update_sharded` that fits keeps every shape; without it the
    shards must be of equal size. The hash functions are drawn from
    ``generator`` on group rank 0 and broadcast, and W is normalised on the
    union of the shards' rows (pooled min/max); ``params`` reuses given
    functions, W included. ``generator`` also serves the rank's own draws
    (the PQ fit), so the caller seeds it per rank (the reference folds the
    shard index into its key). Collectives: one ``all_reduce`` of the shard
    sizes, and without ``params`` two ``broadcast``\\ s and W's
    ``all_reduce``."""
    group = _group(group)
    n_shards, rank = dist.get_world_size(group), dist.get_rank(group)
    dev = ops.resolve_device(device)
    if (x_global is None) == (x_local is None):
        raise ValueError("pass exactly one of x_global and x_local")
    if x_global is not None:
        n = x_global.shape[0]
        if n % n_shards:
            raise ValueError(f"{n} rows do not split over {n_shards} shards")
        x_local = x_global[rank * n // n_shards:(rank + 1) * n // n_shards]
    x_local = torch.as_tensor(x_local).to(dev, torch.float32).contiguous()
    sizes = shard_counts(x_local.shape[0], group, dev)
    if capacity is None:
        if (sizes != sizes[0]).any():
            raise ValueError(f"shards of unequal sizes {sizes.tolist()} "
                             "need capacity=")
        cap_shard = int(sizes[0])
    else:
        if capacity % n_shards:
            raise ValueError(f"capacity {capacity} does not split over "
                             f"{n_shards} shards")
        cap_shard = capacity // n_shards
        if cap_shard < sizes.max():
            raise ValueError(f"shard capacity {cap_shard} < {sizes.max()} "
                             "rows")
    if params is None:
        if generator is None:
            raise ValueError("build_sharded needs generator= or params=")
        params = lsh.init_params(generator, x_local.shape[1], cfg, dev)
        src = dist.get_global_rank(group, 0)
        for t in (params.a, params.b):
            dist.broadcast(t, src, group=group)
        raw = lsh.project_raw(params, x_local)
        params = params._replace(w=lsh.normalize_w(raw, cfg.n_regions,
                                                   group=group))
        del raw
    # capacity = the shard's size when none is given: an untrimmed bucket
    # axis, the layout the reference's traced shard build has
    return E.build(x_local, cfg, generator, params=params, capacity=cap_shard,
                   device=dev)


def route_round_robin(x_new, shards: int, offset: int) -> list:
    """Deterministic round-robin routing: global arrival ``j`` goes to shard
    ``(offset + j) % shards``, where ``offset`` is the stream position (the
    points ingested so far), so the placement is a pure function of the
    stream. Works on numpy arrays and tensors alike (strided row views)."""
    return [x_new[((s - offset) % shards)::shards] for s in range(shards)]


def update_sharded(state: E.ProberState, x_new, cfg: ProberConfig,
                   group=None, n_valid=None):
    """Sharded §5 update (Alg. 7/8 on every shard). Every rank passes the
    same batch ``x_new`` (N_new, d) (numpy or tensor); it is routed
    round-robin from the stream position ``sum(n_valid) % P``, every
    shard's part is padded to one power-of-two width, every shard grows to
    ``next_capacity`` first if any would overflow, and this rank ingests its
    part with W pooled over the group. ``n_valid`` is the host-side (P,)
    array of live counts (read with one ``all_reduce`` when not given).
    Returns ``(state, n_valid)`` with the counts updated."""
    group = _group(group)
    n_shards, rank = dist.get_world_size(group), dist.get_rank(group)
    dev = state.x.device
    if n_valid is None:
        nv = shard_counts(int(state.index.n_valid), group, dev)
    else:
        nv = np.asarray(n_valid, np.int64).reshape(n_shards)
    if x_new.ndim == 1:
        x_new = x_new[None]
    parts = route_round_robin(x_new, n_shards, int(nv.sum()) % n_shards)
    counts = np.asarray([len(p) for p in parts], np.int64)
    width = updates.next_pow2(max(int(counts.max()), 1))
    part = torch.as_tensor(parts[rank]).to(dev, torch.float32)
    x_pad = torch.nn.functional.pad(part, (0, 0, 0, width - part.shape[0]))
    cap = state.x.shape[0]
    needed = int((nv + counts).max())
    if needed > cap:
        state = E._grow(state, updates.next_capacity(cap, needed))
    state = E._ingest_core(state, x_pad.contiguous(), int(counts[rank]), cfg,
                           int(nv[rank]), group=group)
    return state, nv + counts


def shard_round_keys(seed: int, nq: int, nl: int, device, group=None,
                     stream: int = 0) -> torch.Tensor:
    """This rank's PRP round keys (Q, L, 6), uint32 values in int64, drawn
    from ``(seed, stream, rank)``: independent across ranks and streams
    (e.g. one stream per flush), reproducible from the seed."""
    rank = dist.get_rank(_group(group))
    rng = np.random.default_rng([seed, stream, rank])
    return torch.from_numpy(rng.integers(0, 2 ** 32, (nq, nl, 6),
                                         dtype=np.int64)).to(device)


def estimate_sharded(state: E.ProberState, qs: torch.Tensor,
                     taus: torch.Tensor, cfg: ProberConfig,
                     rks: torch.Tensor, group=None,
                     mode: str = "local",
                     steps: list | None = None) -> torch.Tensor:
    """Batched estimation over the sharded index: ``qs`` (Q, d) and
    ``taus`` (Q,) the same on every rank, ``rks`` (Q, L, 6) this rank's
    round keys. ``local``: this rank's ``estimate_batch`` and one
    ``all_reduce(SUM)``; ``sync``: pooled stopping. Both return the global
    (Q,) estimates, the same on every rank. ``steps`` gets this rank's
    slab steps (``prober.estimate_batch``'s)."""
    if mode not in ("local", "sync"):
        raise ValueError(f"mode must be 'local' or 'sync', got {mode!r}")
    group = _group(group)
    if mode == "sync":
        return E.estimate_batch_pooled(state, qs, taus, cfg, rks, group,
                                       steps=steps)
    est = E.estimate_batch(state, qs, taus, cfg, rks=rks, steps=steps)
    collectives.all_reduce(est, group=group)
    return est


def _rank_main(rank: int, fn, world: int, store_path: str, backend: str,
               timeout: float, args: tuple):
    # every rank is on this host: gloo talks over the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def _read_trace(path: str) -> str:
    import pickle
    with open(path, "rb") as fh:
        return pickle.load(fh)      # written by torch.multiprocessing


def run_ranks(fn, nprocs: int, args: tuple = (), backend: str = "gloo",
              timeout: float = 600.0) -> None:
    """Run ``fn(rank, *args)`` as ``nprocs`` ranks of one process group on
    this host: spawned processes (CUDA cannot be used in a forked child), a
    ``FileStore`` rendezvous in a temporary directory, ``backend`` for the
    collectives, whose own timeout is ``timeout`` too. ``fn`` must be
    importable by its module path. When a rank raises, the others are
    terminated and a ``RuntimeError`` carries the traceback of every rank
    that failed; when ``timeout`` seconds pass, every rank is killed and
    ``TimeoutError`` raised."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, nprocs, os.path.join(tmp, "store"),
                              backend, timeout, args),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{nprocs} ranks still running after "
                                       f"{timeout:.0f} s; killed")
        except mp.ProcessRaisedException as e:
            # the first rank to fail makes its peers fail in their next
            # collective; report every rank's traceback, the cause included
            raise RuntimeError("".join(
                f"\n-- rank {r}:\n{_read_trace(f)}"
                for r, f in enumerate(ctx.error_files)
                if os.path.exists(f))) from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
