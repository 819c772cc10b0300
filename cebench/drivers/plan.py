"""A closed loop of estimate calls on one static index: each call is a
batch of (query, τ) pairs of the pool with its own PRP round keys, both
from the traffic file's ``generator`` (``generators/<generator>.py``),
sent through ``estimator.estimate_batch_stats``. What a query optimiser
sends when it costs a plan's vector predicates in one call.

A call's record is one estimate op over every answer, naming its pairs
and round keys by the generator's call index (no copy to the host inside
the window).
"""
from __future__ import annotations

from functools import partial
from pathlib import Path

from cebench.harness import core

GENERATORS = Path(__file__).resolve().parents[1] / "generators"


class Plan:
    def __init__(self, state, pcfg, params: dict, pool_q, pool_t, seed: int,
                 dev, tag: str):
        gen = core.load_module(GENERATORS / f"{params['generator']}.py")
        self.state, self.pcfg = state, pcfg
        self.pool_q, self.pool_t = pool_q, pool_t
        self.traffic = gen.make(params, pool_t.numel(), pcfg.n_tables, seed,
                                dev, tag=tag)
        self._next = None

    def prepare(self, i: int) -> None:
        n_t = self.pool_t.shape[1]
        pairs = self.traffic.pairs(i)
        qi, ti = pairs // n_t, pairs % n_t
        self._next = (self.pool_q[qi], self.pool_t[qi, ti],
                      self.traffic.round_keys(i))

    def call(self, i: int):
        from repro_torch.core import estimator as E
        (qs, taus, rks), self._next = self._next, None
        ests, probed, nvis = E.estimate_batch_stats(self.state, qs, taus,
                                                    self.pcfg, rks=rks)
        record = [("estimate", partial(self.traffic.pairs, i),
                   partial(self.traffic.round_keys, i), None)]
        return ests.cpu(), probed.cpu(), nvis.cpu(), record

    def counters(self) -> dict:
        return {}


def open(state, cfg, pcfg, params, pool_q, pool_t, seed, dev, tag):
    return Plan(state, pcfg, params, pool_q, pool_t, seed, dev, tag)
