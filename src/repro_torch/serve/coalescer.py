"""Request coalescing for the estimator, with the estimate cache (port of
``CardinalityCoalescer`` in ``repro/serve/engine.py``).

Concurrent ``(q, tau)`` requests queue up and are flushed through one
``estimate_batch`` step, padded to a power of two. With ``cache_size > 0``
each flush first looks every request up in the estimate cache
(:mod:`repro_torch.cache`): hits are served from it, only the misses are
probed (padded to a power of two), and the fresh estimates are written
back with their epoch snapshots. A hit is served only while no ingest has
touched a bucket the original probe visited. On the card one
``query_lanes`` launch over the padded batch gives the cache keys (the
codes) and the Hamming distances that both ball sums read (the lookup's
freshness check and the insert's snapshots), and one ``cache_insert``
launch writes the misses back.

While a ``torch.profiler`` runs, each batch a flush drains is a
``coalescer.flush`` span and each ingest chunk a ``coalescer.ingest``
span (``utils/spans.span``), around the cache's ``cache.lookup`` /
``cache.insert`` and the estimator's ``estimator.estimate_batch`` /
``estimator.update`` (⊃ ``estimator.grow``) spans. ``ingest_stats``
counts the rows and chunks ingested and the capacity growths, always, on
the host.

With a process ``group`` the coalescer serves off a SHARDED index (this
rank's shard from ``distributed.build_sharded``): every rank makes the same
``submit`` / ``ingest`` / ``flush`` calls (SPMD), a flush runs
``distributed.estimate_sharded`` with the chosen stopping ``mode``
(``"local"`` or ``"sync"``), and every ingest chunk goes through
``distributed.update_sharded`` (round-robin, W pooled), with the per-shard
live counts kept on the host. Before each flush batch and each ingest chunk
one ``all_reduce`` checks that every rank is at the same step with the same
data, and raises otherwise: diverged ranks are never served. The estimate
cache serves local (unsharded) coalescers only: it keys on one process's
index.

Round keys: flush ``i`` of a batch of ``n`` probed lanes takes
``round_keys(i, n)`` (n, L, 6); by default they are drawn from
``generator`` (seeded per rank when sharded: each rank draws its own).
The parity tests pass the reference's key tree
(``fold_in(key, i)``), which lines up because the padding is the
reference's: ``max_batch`` rounded up to a power of two, a flush padded to
``next_pow2(n)`` and a cached flush's misses to ``next_pow2(misses)``, with
zero rows at tau 0.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.cache import estimate_cache as C
from repro_torch.cache.epochs import U32, ball_sums_from_ham
from repro_torch.core import collectives, distributed as D, estimator as E
from repro_torch.core import lsh, updates
from repro_torch.core.config import ProberConfig
from repro_torch.utils.spans import span

RoundKeys = Callable[[int, int], torch.Tensor]


@dataclasses.dataclass
class CardRequest:
    """One pending cardinality-estimation request."""
    rid: int
    q: np.ndarray                 # (d,) query embedding
    tau: float
    est: Optional[float] = None   # filled by flush()
    provenance: Optional[str] = None   # "probe" | "hit" | "stale-refresh"
    probed_k: Optional[np.ndarray] = None   # (L,) deepest ring per table
                                  # when this request was probed (None on
                                  # hits and without a cache)
    nvisited: Optional[int] = None     # samples the probe drew


class CardResult(float):
    """A flush() value: the estimate as a float, carrying its provenance
    (a fresh probe, a cache hit, or a probe that refreshed a stale
    entry)."""
    provenance: str

    def __new__(cls, est: float, provenance: str = "probe"):
        self = super().__new__(cls, est)
        self.provenance = provenance
        return self


class CardinalityCoalescer:
    """Coalesces concurrent cardinality requests into one estimate step.

    ``submit`` enqueues (and flushes once ``max_batch`` requests wait);
    ``flush`` applies pending ingests, runs the pending batches and returns
    every answered ``{rid: CardResult}``. ``ingest`` buffers new corpus
    points and applies them in chunks of ``cfg.ingest_chunk``, eagerly and
    before every flush. ``cache_size`` and ``reuse_tol`` switch on the
    estimate cache; ``cache_stats`` counts hits, misses, stale entries,
    evictions and lookups, ``ingest_stats`` the rows and chunks ingested
    and the capacity growths they caused. Serves the state's device.
    ``group`` (e.g. ``torch.distributed.group.WORLD``) serves a sharded
    state with the stopping ``mode``; None serves a local one."""

    def __init__(self, state: E.ProberState, cfg: ProberConfig,
                 generator: torch.Generator | None = None,
                 max_batch: int = 256, cache_size: int = 0,
                 reuse_tol: float = 0.0,
                 round_keys: RoundKeys | None = None,
                 group=None, mode: str = "local"):
        if mode not in ("local", "sync"):
            raise ValueError(f"mode must be 'local' or 'sync', got {mode!r}")
        if cache_size > 0 and group is not None:
            raise ValueError("the estimate cache serves the local "
                             "(unsharded) path only")
        self._group, self.mode = group, mode
        if round_keys is None:
            if generator is None:
                raise ValueError("pass generator= or round_keys=")

            def round_keys(i: int, n: int) -> torch.Tensor:
                return E.draw_round_keys(generator, n, cfg.n_tables,
                                         self._state.x.device)
        self._round_keys = round_keys
        self.cfg = cfg
        self.reuse_tol = float(reuse_tol)
        self._cache = C.init_cache(cache_size, cfg.n_tables, cfg.n_funcs,
                                   state.x.device) if cache_size > 0 else None
        self.cache_stats = {"hits": 0, "misses": 0, "stale": 0, "evicts": 0,
                            "lookups": 0}
        self.ingest_stats = {"rows": 0, "chunks": 0, "grows": 0}
        # False until the first ingest (or state swap): lookups skip the
        # ball sums while the corpus is provably unchanged
        self._check_ingest = False
        self.state = state              # the setter also reads n_valid
        self._check_ingest = False      # the swap's bump is moot while the
                                        # cache is still empty
        self.max_batch = updates.next_pow2(max_batch)
        self.pending: list[CardRequest] = []
        self._next_rid = 0
        self._n_flushes = self._n_ingests = 0
        self._answered: dict[int, CardResult] = {}
        self._ingest_buf: Optional[np.ndarray] = None

    @property
    def state(self) -> E.ProberState:
        return self._state

    @state.setter
    def state(self, st: E.ProberState):
        # a state swapped in from outside may hold data whose ingests this
        # coalescer never saw: retire the whole cache generation
        if self._cache is not None:
            if st.epochs is None:
                st = E.attach_epochs(st)
            st = st._replace(epochs=st.epochs._replace(
                params_epoch=(st.epochs.params_epoch + 1) & U32))
            self._check_ingest = True
        self._state = st
        nv = int(st.index.n_valid)
        # a sharded state: every shard's live count, in rank order
        self._n_valid = nv if self._group is None else \
            D.shard_counts(nv, self._group, st.x.device)

    def submit(self, q, tau) -> CardRequest:
        """Queue ``(q, tau)``; ``q`` (d,) is an array or a tensor on any
        device (held on the host until its flush)."""
        if isinstance(q, torch.Tensor):
            q = q.detach().cpu()
        req = CardRequest(rid=self._next_rid, q=np.asarray(q),
                          tau=float(tau))
        self._next_rid += 1
        self.pending.append(req)
        if len(self.pending) >= self.max_batch:
            self._answered.update(self._drain())
        return req

    # ------------------------------------------------- dynamic ingest -----
    def ingest(self, x_new) -> int:
        """Queue new corpus points (paper §5); ``x_new`` (n, d) or (d,) is
        an array or a tensor on any device (held on the host until it is
        applied). Full chunks of ``cfg.ingest_chunk`` are applied at once,
        the rest before the next flush. Returns the number still
        buffered."""
        if isinstance(x_new, torch.Tensor):
            x_new = x_new.detach().cpu()
        x = np.asarray(x_new, np.float32)
        if x.ndim == 1:
            x = x[None]
        self._ingest_buf = x if self._ingest_buf is None else \
            np.concatenate([self._ingest_buf, x], axis=0)
        chunk = self.cfg.ingest_chunk
        while self._ingest_buf is not None and len(self._ingest_buf) >= chunk:
            self._apply_ingest_chunk(chunk)
        return 0 if self._ingest_buf is None else len(self._ingest_buf)

    def apply_ingest(self):
        """Drain the ingest buffer (the last partial chunk too)."""
        chunk = self.cfg.ingest_chunk
        while self._ingest_buf is not None and len(self._ingest_buf) > 0:
            self._apply_ingest_chunk(min(chunk, len(self._ingest_buf)))

    def _apply_ingest_chunk(self, k: int):
        self._check_ingest = True       # lookups must check the ball sums
        buf = self._ingest_buf
        part, rest = buf[:k], buf[k:]
        self._ingest_buf = rest if len(rest) else None
        cap = self._state.x.shape[0]
        with span("coalescer.ingest"):
            if self._group is not None:
                self._check_same(1, self._n_ingests, len(part), part)
                self._n_ingests += 1
                self._state, self._n_valid = D.update_sharded(
                    self._state, part, self.cfg, group=self._group,
                    n_valid=self._n_valid)
            else:
                self._state = E.update(self._state, torch.from_numpy(part),
                                       self.cfg, n_valid=self._n_valid)
                self._n_valid += len(part)
        self.ingest_stats["rows"] += len(part)
        self.ingest_stats["chunks"] += 1
        self.ingest_stats["grows"] += int(self._state.x.shape[0] != cap)

    def flush(self) -> dict[int, CardResult]:
        """Apply pending ingests, then estimate everything pending in
        batches of ``max_batch``; returns every answered request not yet
        returned (auto-flushed ones too) as ``{rid: CardResult}``."""
        out = self._answered
        self._answered = {}
        out.update(self._drain())
        return out

    def _drain(self) -> dict[int, CardResult]:
        self.apply_ingest()          # estimates see every prior ingest()
        out: dict[int, CardResult] = {}
        while self.pending:
            batch, self.pending = self.pending[:self.max_batch], \
                self.pending[self.max_batch:]
            with span("coalescer.flush"):
                n = len(batch)
                p = updates.next_pow2(n)
                d = batch[0].q.shape[-1]
                qs = np.zeros((p, d), np.float32)
                taus = np.zeros((p,), np.float32)
                for i, r in enumerate(batch):
                    qs[i], taus[i] = r.q, r.tau
                flush_index = self._n_flushes
                self._n_flushes += 1
                if self._cache is not None:
                    ests, prov, pks, nvs = self._flush_cached(qs, taus, n,
                                                              flush_index)
                    for i, r in enumerate(batch):
                        r.probed_k, r.nvisited = pks[i], nvs[i]
                else:
                    dev = self._state.x.device
                    tqs = torch.from_numpy(qs).to(dev)
                    ttaus = torch.from_numpy(taus).to(dev)
                    rks = self._round_keys(flush_index, p)
                    if self._group is None:
                        ests = E.estimate_batch(self._state, tqs, ttaus,
                                                self.cfg, rks=rks)
                    else:
                        self._check_same(0, flush_index, n, qs, taus)
                        ests = D.estimate_sharded(self._state, tqs, ttaus,
                                                  self.cfg, rks,
                                                  group=self._group,
                                                  mode=self.mode)
                    ests = ests.cpu().numpy()
                    prov = ["probe"] * n
                for i, r in enumerate(batch):
                    r.est = float(ests[i])
                    r.provenance = prov[i]
                    out[r.rid] = CardResult(r.est, prov[i])
        return out

    def _check_same(self, step: int, index: int, rows: int,
                    *arrays: np.ndarray):
        """Raise unless every rank is at the same SPMD step with the same
        data: one ``all_reduce(MIN)`` over ``[v, -v]``, v = (step: 0 a
        flush batch, 1 an ingest chunk; its index; its rows; the CRC-32
        of ``arrays``), all exact in float64. Every check reduces this one
        shape, so a rank at a flush and a rank at an ingest fail the check
        instead of hanging."""
        crc = 0
        for a in arrays:
            crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
        v = torch.tensor([step, index, rows, crc],
                         dtype=torch.float64, device=self._state.x.device)
        both = torch.cat([v, -v])
        collectives.all_reduce(both, dist.ReduceOp.MIN, group=self._group)
        lo, hi = both[:4].tolist(), (-both[4:]).tolist()
        if lo != hi:
            what = ("flushed different batches", "ingested different chunks")
            raise RuntimeError(
                f"ranks {what[step] if lo[0] == hi[0] else 'diverged'} "
                "(step, index, rows, CRC-32 range over "
                f"{list(zip(lo, hi))})")

    def _flush_cached(self, qs: np.ndarray, taus: np.ndarray, n: int,
                      flush_index: int):
        """One flush through the cache: look every request up, probe only
        the misses, write them back, merge. Returns ``(ests (n,),
        provenance (n,), probed_k (n,), nvisited (n,))``, the last two None
        for hits."""
        st = self._state
        dev = st.x.device
        strict = self.reuse_tol <= 0.0
        tqs = torch.from_numpy(qs).to(dev)
        ix = st.index
        qcodes, ham = lsh.query_lanes(ix.params, tqs, ix.bucket_codes,
                                      ix.n_buckets)
        qhash = C.query_hash(tqs)
        tkeys = C.tau_band(torch.from_numpy(taus).to(dev), self.reuse_tol)
        live = torch.arange(qs.shape[0], device=dev) < n
        self._cache, c_est, hit, stale = C.lookup(
            self._cache, st.epochs, ham, ix.bucket_sizes, qcodes, qhash,
            tkeys, live, match_qhash=strict,
            check_ingest=self._check_ingest)
        hit = hit[:n].cpu().numpy()
        stale = stale[:n].cpu().numpy()
        ests = c_est[:n].cpu().numpy().copy()
        miss = np.nonzero(~hit)[0]
        self.cache_stats["lookups"] += n
        self.cache_stats["hits"] += int(hit.sum())
        self.cache_stats["misses"] += len(miss)
        self.cache_stats["stale"] += int(stale.sum())
        prov = ["hit" if hit[i] else
                ("stale-refresh" if stale[i] else "probe")
                for i in range(n)]
        pks: list = [None] * n
        nvs: list = [None] * n
        if len(miss):
            pm = updates.next_pow2(len(miss))
            qs_m = np.zeros((pm, qs.shape[1]), np.float32)
            taus_m = np.zeros((pm,), np.float32)
            qs_m[:len(miss)], taus_m[:len(miss)] = qs[miss], taus[miss]
            ests_m, probed_k, nvis = E.estimate_batch_stats(
                st, torch.from_numpy(qs_m).to(dev),
                torch.from_numpy(taus_m).to(dev), self.cfg,
                rks=self._round_keys(flush_index, pm))
            active = torch.arange(pm, device=dev) < len(miss)
            # the write-back's keys and ball snapshots read the rows the
            # lookup computed; rows past len(miss) pad and stay inactive
            mrows = torch.from_numpy(np.pad(miss, (0, pm - len(miss)))).to(
                dev)
            balls = ball_sums_from_ham(ham, ix.bucket_sizes, probed_k,
                                       rows=mrows)
            self._cache, n_evict = C.insert(
                self._cache, st.epochs, balls, qcodes[mrows], qhash[mrows],
                tkeys[mrows], ests_m, nvis, probed_k, active,
                match_qhash=strict)
            self.cache_stats["evicts"] += int(n_evict)
            ests[miss] = ests_m.cpu().numpy()[:len(miss)]
            pk_np, nv_np = probed_k.cpu().numpy(), nvis.cpu().numpy()
            for j, i in enumerate(miss):
                pks[i], nvs[i] = pk_np[j], int(nv_np[j])
        return ests, prov, pks, nvs
