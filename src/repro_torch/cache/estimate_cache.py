"""Fixed-capacity estimate cache with CLOCK eviction (port of
``repro/cache/estimate_cache.py``).

The cache is a NamedTuple of fixed-shape tensors: a key table (the query's
(L, K) bucket codes, an exact-query fingerprint and a quantised tau band),
per-entry epoch snapshots (:mod:`repro_torch.cache.epochs`), a value table
(estimate and sample count) and CLOCK metadata (a ``ref`` bit per entry and
one hand).

Keys: at ``reuse_tol == 0`` a hit needs the identical query (two 32-bit
fingerprints of the float bits and all codes) and the identical tau bits,
so it is bit-identical to the original probe's estimate. At ``reuse_tol >
0`` a hit needs the same code in every table and a tau in the same
multiplicative band ``floor(ln tau / ln(1 + reuse_tol))``.

Lookup is one compare over (batch, S) in torch. Insertion is sequential
over the flush's lanes (later lanes see earlier lanes' writes: duplicate
keys overwrite in place, the hand moves), which is one launch of
``ops.cache_insert`` on the card. Unlike the reference, insert updates the
cache's tensors in place; its owner (the coalescer) keeps no other view.

While a ``torch.profiler`` runs, a lookup is a ``cache.lookup`` span and
an insert a ``cache.insert`` span (``utils/spans.span``).

uint32 fields (``qhash``, ``snap_params``) are held in int64; the hash
arithmetic masks with ``& 0xFFFFFFFF`` after every multiply and sum and
before every shift, so it wraps as uint32 does.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.cache.epochs import U32, EpochState, ball_sums_from_ham
from repro_torch.kernels import ops
from repro_torch.utils.spans import span

_MULT = 2654435761


class EstimateCache(NamedTuple):
    # --- key table ---
    qcodes: torch.Tensor       # (S, L, K) int32 per-table bucket codes
    qhash: torch.Tensor        # (S, 2) int64 (uint32) query fingerprint
    tau_key: torch.Tensor      # (S,) int32 tau band / exact tau bits
    # --- epoch snapshots ---
    snap_ball: torch.Tensor    # (S, L) int32 probed-ball populations
    snap_params: torch.Tensor  # (S,) int64 (uint32)
    probed_k: torch.Tensor     # (S, L) int32 deepest ring the probe folded
    # --- value table ---
    est: torch.Tensor          # (S,) float32
    nvisited: torch.Tensor     # (S,) int32
    # --- CLOCK ---
    valid: torch.Tensor        # (S,) bool
    ref: torch.Tensor          # (S,) bool second-chance bit
    hand: torch.Tensor         # () int32

    @property
    def size(self) -> int:
        return self.est.shape[0]


def init_cache(size: int, n_tables: int, n_funcs: int,
               device="cuda") -> EstimateCache:
    s = int(size)
    if s <= 0:
        raise ValueError(f"cache size must be positive, got {size}")

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return EstimateCache(
        qcodes=z((s, n_tables, n_funcs), torch.int32),
        qhash=z((s, 2), torch.int64), tau_key=z((s,), torch.int32),
        snap_ball=z((s, n_tables), torch.int32),
        snap_params=z((s,), torch.int64),
        probed_k=z((s, n_tables), torch.int32),
        est=z((s,), torch.float32), nvisited=z((s,), torch.int32),
        valid=z((s,), torch.bool), ref=z((s,), torch.bool),
        hand=z((), torch.int32))


def tau_band(taus: torch.Tensor, reuse_tol: float) -> torch.Tensor:
    """The cache's tau key: the float32 bits at ``reuse_tol <= 0``, else
    the multiplicative log-band of width ``1 + reuse_tol`` (float32 log
    times a float32 inverse, then floor). A tau whose band value lies
    within an ulp of an integer may band differently from the reference's
    log; the tests keep such radii out."""
    taus = torch.as_tensor(taus, dtype=torch.float32)
    if reuse_tol <= 0.0:
        return taus.contiguous().view(torch.int32).clone()
    inv = torch.tensor(1.0 / math.log1p(reuse_tol), dtype=torch.float32,
                       device=taus.device)
    return torch.floor(torch.log(taus.clamp_min(1e-30)) * inv).to(
        torch.int32)


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """``a * b mod 2^32`` for uint32 values in int64, in two 16-bit halves
    of ``a`` so that no product leaves int64."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & U32


def query_hash(qs: torch.Tensor) -> torch.Tensor:
    """Two independent 32-bit fingerprints of the raw query bytes, (..., d)
    → (..., 2) int64 holding uint32 values, bit-equal to the reference's
    uint32 arithmetic."""
    bits = qs.to(torch.float32).contiguous().view(torch.int32)
    b = bits.to(torch.int64) & U32
    i = torch.arange(b.shape[-1], dtype=torch.int64, device=b.device)
    h1 = _mul32(b, 2 * i + 1).sum(-1) & U32
    m2 = (_MULT + 2 * i + 1) & U32
    h2 = _mul32((b ^ (b >> 16)) & U32, m2).sum(-1) & U32

    def mix(x):
        x = _mul32(x ^ (x >> 15), 0x85EBCA6B)
        return x ^ (x >> 13)

    return torch.stack([mix(h1), mix(h2)], dim=-1)


def _key_match(cache: EstimateCache, qcodes: torch.Tensor,
               qhash: torch.Tensor, tau_keys: torch.Tensor,
               match_qhash: bool) -> torch.Tensor:
    """(n, S) bool: valid entries whose key equals request ``i``'s key."""
    m = cache.valid[None] & (cache.tau_key[None] == tau_keys[:, None])
    m = m & (cache.qcodes[None] == qcodes[:, None]).flatten(2).all(-1)
    if match_qhash:
        m = m & (cache.qhash[None] == qhash[:, None]).all(-1)
    return m


def lookup(cache: EstimateCache, ep: EpochState, ham: torch.Tensor | None,
           bucket_sizes: torch.Tensor, qcodes: torch.Tensor,
           qhash: torch.Tensor, tau_keys: torch.Tensor, live: torch.Tensor,
           match_qhash: bool = True, check_ingest: bool = True):
    """Batched lookup of (n, L, K) codes, (n, 2) fingerprints and (n,) tau
    keys → ``(cache', est (n,), hit (n,), stale (n,))``.

    A key matches the first valid entry with the same key. ``hit``: a key
    matched and the entry is still fresh, its params epoch current and,
    with ``check_ingest``, its probed-ball populations, recomputed from
    ``ham`` (n, L, B) (the Hamming distances of the requests' codes under
    the current layout) and ``bucket_sizes``, unchanged. ``stale``: a key
    matched but the check failed. ``check_ingest=False`` skips the ball
    sums (``ham`` may then be None); callers pass it only while no ingest
    has happened since the cache was made. ``live`` masks padding rows.
    Hits set their entry's ``ref`` bit (a scatter-max)."""
    with span("cache.lookup"):
        m = _key_match(cache, qcodes, qhash, tau_keys, match_qhash)
        slot = torch.argmax(m.to(torch.int32), dim=1)  # first match, else 0
        key_hit = m.any(1)
        fresh = cache.snap_params[slot] == ep.params_epoch
        if check_ingest:
            ball = ball_sums_from_ham(ham, bucket_sizes, cache.probed_k[slot])
            fresh = fresh & (ball == cache.snap_ball[slot]).all(-1)
        hit = key_hit & fresh & live
        stale = key_hit & ~fresh & live
        ref = cache.ref.to(torch.int32).scatter_reduce(
            0, slot, hit.to(torch.int32), "amax").to(torch.bool)
        return cache._replace(ref=ref), cache.est[slot], hit, stale


def insert(cache: EstimateCache, ep: EpochState, balls: torch.Tensor,
           qcodes: torch.Tensor, qhash: torch.Tensor, tau_keys: torch.Tensor,
           ests: torch.Tensor, nvisited: torch.Tensor,
           probed_k: torch.Tensor, active: torch.Tensor,
           match_qhash: bool = True):
    """Write a probed batch back, in place: each active lane overwrites the
    first entry with its key (stale refresh, duplicate in the flush) or
    claims a CLOCK victim. ``balls`` (n, L) are the lanes' probed-ball
    populations under the layout the probe ran on
    (:func:`ball_sums_from_ham`); ``match_qhash`` must mirror the lookup's.
    Returns ``(cache, n_evicted)``, ``n_evicted`` a 0-d int32 tensor
    counting live entries displaced by new keys."""
    with span("cache.insert"):
        n_evicted = ops.cache_insert(
            cache, qcodes.to(torch.int32).contiguous(), qhash.contiguous(),
            tau_keys.to(torch.int32).contiguous(),
            balls.to(torch.int32).contiguous(),
            ep.params_epoch, ests.to(torch.float32).contiguous(),
            nvisited.to(torch.int32).contiguous(),
            probed_k.to(torch.int32).contiguous(),
            active.to(torch.bool).contiguous(), match_qhash)
    return cache, n_evicted
