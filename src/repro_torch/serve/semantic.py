"""Semantic-operator planner, the paper's motivating application (§1):
estimate how many LLM calls a semantic operator (``SEM_JOIN docs ON
similarity(q) <= tau``, one LLM call per match) will make before running
it, and turn the estimate into a plan (port of ``repro/serve/semantic.py``).

Concurrent operators share one prober: :meth:`SemanticPlanner.plan_batch`
coalesces every outstanding ``(q, tau)`` into one estimate step through
:class:`~repro_torch.serve.coalescer.CardinalityCoalescer`, with the
estimate cache when ``cache_size > 0``.

With a process ``group`` the planner serves off a SHARDED index: every
rank of the group builds its shard with ``distributed.build_sharded``,
makes the same calls (SPMD), and gets the same plans; estimates run with
the distributed stopping ``mode`` through the sharded coalescer, single
ones too.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import distributed as D, estimator as E
from repro_torch.core.config import ProberConfig
from repro_torch.serve.coalescer import CardinalityCoalescer, RoundKeys


@dataclasses.dataclass
class OperatorPlan:
    est_matches: float
    llm_calls: int            # calls the plan will schedule
    batch_slots: int          # engine slots to provision
    n_batches: int
    action: str               # "execute" | "fallback_exact" | "refuse"
    reason: str = ""


class SemanticPlanner:
    def __init__(self, corpus_embeddings, cfg: ProberConfig,
                 generator: torch.Generator | None = None,
                 max_calls: int = 512, slot_budget: int = 8,
                 max_batch: int = 256, capacity: int | None = None,
                 cache_size: int = 0, reuse_tol: float = 0.0,
                 device="cuda", round_keys: RoundKeys | None = None,
                 state: E.ProberState | None = None, group=None,
                 mode: str = "local"):
        """Builds a capacity-padded index over ``corpus_embeddings`` on
        ``device`` (with ingest epochs when ``cache_size > 0``), unless a
        built ``state`` is given (e.g. one bridged from the reference).
        ``cache_size`` / ``reuse_tol`` switch on the estimate cache:
        ``reuse_tol = 0`` reuses exact repeats only, ``> 0`` also LSH
        near-duplicates whose tau shares a ``(1 + reuse_tol)`` band.
        Round keys are drawn from ``generator`` unless ``round_keys``
        gives them (see the coalescer).

        ``group`` (e.g. ``torch.distributed.group.WORLD``) shards the index
        over its ranks: ``corpus_embeddings`` is the whole corpus, the same
        on every rank, of which each rank builds its row block
        (``distributed.build_sharded``: the hash functions drawn from
        ``generator`` on rank 0; ``capacity`` is global); ``mode`` is the
        stopping mode (``"local"`` or ``"sync"``). Flush ``i`` of ``n``
        lanes then takes ``distributed.shard_round_keys(seed, n, L,
        stream=i)`` on each rank, ``seed`` the generator's initial seed,
        unless ``round_keys`` is given. The estimate cache serves the local
        path only: the coalescer raises for ``cache_size > 0`` with a
        group."""
        self.cfg = cfg
        self.max_calls = max_calls
        self.slot_budget = slot_budget
        self._gen = generator
        self._group = group
        if state is None and group is not None:
            state = D.build_sharded(torch.as_tensor(corpus_embeddings), cfg,
                                    generator, group=group,
                                    capacity=capacity, device=device)
        elif state is None:
            state = E.build(torch.as_tensor(corpus_embeddings), cfg,
                            generator, capacity=capacity,
                            track_epochs=cache_size > 0, device=device)
        elif cache_size > 0 and state.epochs is None:
            state = E.attach_epochs(state)
        self.state = state
        if group is not None and round_keys is None:
            if generator is None:
                raise ValueError("a sharded planner needs generator= or "
                                 "round_keys=")
            seed, dev = generator.initial_seed(), state.x.device

            def round_keys(i: int, n: int) -> torch.Tensor:
                return D.shard_round_keys(seed, n, cfg.n_tables, dev, group,
                                          stream=i)
        self._coalescer = CardinalityCoalescer(
            state, cfg, generator, max_batch=max_batch,
            cache_size=cache_size, reuse_tol=reuse_tol,
            round_keys=round_keys, group=group, mode=mode)
        self._cached = cache_size > 0

    @property
    def cache_stats(self) -> dict:
        """The coalescer's cumulative cache counters."""
        return dict(self._coalescer.cache_stats)

    def update_corpus(self, new_embeddings):
        """Dynamic data updates (paper §5) without a rebuild, through the
        coalescer's chunked ingest, applied before the next estimate."""
        self._coalescer.ingest(new_embeddings)
        self._coalescer.apply_ingest()
        self.state = self._coalescer.state

    def estimate(self, q, tau) -> float:
        # sharded and cached serving both go through the coalescer (the
        # cache lives there; sharded estimates are its collective flushes)
        if self._group is not None or self._cached:
            return self.estimate_batch([q], [tau])[0]
        dev = self.state.x.device
        return float(E.estimate(self.state, torch.as_tensor(q).to(dev), tau,
                                self.cfg, generator=self._gen))

    def estimate_batch(self, qs, taus) -> list[float]:
        """Coalesce concurrent requests into one estimate step."""
        reqs = [self._coalescer.submit(q, t) for q, t in zip(qs, taus)]
        self._coalescer.flush()
        return [r.est for r in reqs]

    def _plan_from_estimate(self, est: float) -> OperatorPlan:
        calls = int(math.ceil(est))
        if calls > self.max_calls:
            return OperatorPlan(est, 0, 0, 0, "refuse",
                                f"estimated {calls} LLM calls > budget "
                                f"{self.max_calls}")
        if calls == 0:
            return OperatorPlan(est, 0, 0, 0, "execute", "no matches")
        slots = min(self.slot_budget, max(1, calls))
        n_batches = int(math.ceil(calls / slots))
        return OperatorPlan(est, calls, slots, n_batches, "execute")

    def plan(self, q, tau) -> OperatorPlan:
        return self._plan_from_estimate(self.estimate(q, tau))

    def plan_batch(self, qs, taus) -> list[OperatorPlan]:
        """Plan N concurrent operators off one coalesced estimate step."""
        return [self._plan_from_estimate(e)
                for e in self.estimate_batch(qs, taus)]
