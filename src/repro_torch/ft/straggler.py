"""Straggler detection & mitigation (the port's copy of
``repro/ft/straggler.py``).

Detection: per-rank step-time EWMA; a rank is a straggler when its EWMA
exceeds ``threshold`` × the fleet median. Mitigation on a real cluster maps
to the same path as elastic scaling (shrink the slow rank's data shard /
evict it); here the policy object is exercised directly in tests and by
the training driver's logging.
"""
from __future__ import annotations

import statistics
from collections import defaultdict


class StragglerDetector:
    def __init__(self, alpha: float = 0.3, threshold: float = 1.8,
                 min_samples: int = 3):
        self.alpha = alpha
        self.threshold = threshold
        self.min_samples = min_samples
        self.ewma: dict[int, float] = {}
        self.count: dict[int, int] = defaultdict(int)

    def record(self, rank: int, step_time: float):
        prev = self.ewma.get(rank)
        self.ewma[rank] = step_time if prev is None else \
            self.alpha * step_time + (1 - self.alpha) * prev
        self.count[rank] += 1

    def stragglers(self) -> list[int]:
        ready = {r: t for r, t in self.ewma.items()
                 if self.count[r] >= self.min_samples}
        if len(ready) < 2:
            return []
        med = statistics.median(ready.values())
        return [r for r, t in ready.items() if t > self.threshold * med]

    def mitigation(self, rank: int) -> str:
        """Policy: first rebalance (smaller shard), then evict via elastic."""
        e = self.ewma.get(rank, 0.0)
        ready = [t for r, t in self.ewma.items() if r != rank]
        med = statistics.median(ready) if ready else e
        return "evict" if med and e > 3.0 * med else "rebalance"
