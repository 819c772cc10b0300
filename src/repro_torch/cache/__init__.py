"""Workload-aware estimate cache (port of ``repro/cache``).

Repeated and near-duplicate ``(q, tau)`` requests are served from a
fixed-capacity cache instead of a probe, kept exact under ingest by the
probed-ball populations of :mod:`repro_torch.cache.epochs`.

* :mod:`repro_torch.cache.epochs` — the invalidation signal.
* :mod:`repro_torch.cache.estimate_cache` — the store: key table, value
  table, CLOCK eviction (the insert is the ``cache_insert`` kernel).

Served through :class:`repro_torch.serve.coalescer.CardinalityCoalescer`
and :class:`repro_torch.serve.semantic.SemanticPlanner`.
"""
from repro_torch.cache.epochs import (EpochState, ball_sums,
                                      ball_sums_from_ham, ingest_bump,
                                      init_epochs)
from repro_torch.cache.estimate_cache import (EstimateCache, init_cache,
                                              insert, lookup, query_hash,
                                              tau_band)

__all__ = [
    "EpochState", "init_epochs", "ingest_bump", "ball_sums",
    "EstimateCache", "init_cache", "lookup", "insert", "query_hash",
    "tau_band",
]
