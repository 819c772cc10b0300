"""Requests drawn zipf from the pool's pairs and served through the
program's ``CardinalityCoalescer`` with its estimate cache, while an
insert stream of held-out rows (``data.heldout``) lands every few calls:
a query optimiser costing similarity predicates against a live
collection. A call is one flush. Its record is what
``tests/data/tiny_serve.py`` records (an ingest op a chunk of
``ingest_chunk`` rows, a reuse op for the hits, an estimate op for the
probed misses with their round keys by flush); three things differ from
that test driver:

* The warm driver's coalescer, with its cache, flush count, round-key
  stream and place in the held-out stream, is taken over by the driver
  opened next on the state it left, which is how ``core.set_up`` opens
  the window's: a deployed estimator's cache is warm when its traffic is
  measured. The warm driver also runs one estimate of each miss-batch
  size the flushes can pad to, before its first call.
* ``prepare(i)`` draws the requests and, on an ingest call, the held-out
  rows (on the run's device, where the check draws them too: a CPU
  generator draws other rows) and moves them to the host; ``call(i)``
  only submits, ingests and flushes.
* ``counters()`` gives ``cache_*`` from the coalescer's ``cache_stats``
  and ``ingest_*`` from its ``ingest_stats``, where the program keeps
  them.

Traffic keys: ``batch`` (requests a call, at most ``max_batch``),
``max_batch``, ``cache_size``, ``reuse_tol``, ``zipf_s`` (over a seeded
order of the pool's pairs, the same for every call), ``ingest_every``
(flushes, counted on across the warm calls into the window's: the insert
stream is the deployment's), ``ingest_rows``.
"""
from __future__ import annotations

import weakref
from functools import partial

import torch

from cebench.harness import data
from repro_torch.core import estimator as E
from repro_torch.core.updates import next_pow2
from repro_torch.serve.coalescer import CardinalityCoalescer

# the driver opened last, held weakly: the next driver opened on the state
# it left takes its coalescer over (``open`` is given that state and not
# the driver that left it)
_last = None


def keys(seed: int, tag: str, n_tables: int, dev, flush: int, n: int):
    """The PRP round keys (n, L, 6) of flush ``flush``'s ``n`` lanes."""
    g = data.generator(seed, f"{tag}.keys{flush}", dev)
    return torch.randint(0, 2 ** 32, (n, n_tables, 6), generator=g,
                         dtype=torch.int64, device=dev)


def first_keys(make, n: int):
    return make()[:n]


class Serve:
    def __init__(self, state, cfg, pcfg, params, pool_q, pool_t, seed, dev,
                 tag):
        global _last
        if int(params["batch"]) > int(params["max_batch"]):
            raise ValueError("a call is one flush: batch <= max_batch")
        self.cfg, self.params, self.seed, self.dev, self.tag = \
            cfg, params, seed, dev, tag
        self.chunk = pcfg.ingest_chunk
        self.n_t = pool_t.shape[1]
        self.pool_q = pool_q.cpu().numpy()
        self.pool_t = pool_t.cpu()
        n_pairs = pool_t.numel()
        self.order = torch.randperm(
            n_pairs, generator=data.generator(seed, "zipf", "cpu"))
        self.weights = torch.arange(1, n_pairs + 1, dtype=torch.float64) \
            ** -float(params["zipf_s"])
        self._next = None
        warm = _last() if _last is not None else None
        if warm is not None and warm.state is state:
            self.co, self.keys = warm.co, warm.keys
            self.flushes, self.rows = warm.flushes, warm.rows
        else:
            self.keys = partial(keys, seed, tag, pcfg.n_tables, dev)
            self.co = CardinalityCoalescer(
                state, pcfg, max_batch=int(params["max_batch"]),
                cache_size=int(params["cache_size"]),
                reuse_tol=float(params["reuse_tol"]), round_keys=self.keys)
            self.flushes = 0
            self.rows = int(state.n_valid) - int(cfg["n"])
            g = data.generator(seed, f"{tag}.shapes", dev)
            for p in range(next_pow2(int(params["batch"])).bit_length()):
                qi = torch.randint(0, pool_q.shape[0], (2 ** p,),
                                   generator=g, device=dev)
                E.estimate_batch_stats(state, pool_q[qi], pool_t[qi, 0],
                                       pcfg, rks=keys(seed, f"{tag}.shapes",
                                                      pcfg.n_tables, dev, p,
                                                      2 ** p))
        _last = weakref.ref(self)

    @property
    def state(self):
        return self.co.state

    def prepare(self, i: int) -> None:
        g = data.generator(self.seed, f"{self.tag}.req{i}", "cpu")
        idx = torch.multinomial(self.weights, int(self.params["batch"]),
                                replacement=True, generator=g)
        pairs = self.order[idx]
        qi, ti = pairs // self.n_t, pairs % self.n_t
        reqs = [(self.pool_q[q], float(self.pool_t[q, t]))
                for q, t in zip(qi.tolist(), ti.tolist())]
        rows = None
        if self.flushes % int(self.params["ingest_every"]) == 0:
            rows = data.heldout(self.cfg, self.seed, self.rows,
                                int(self.params["ingest_rows"]),
                                self.dev).cpu().numpy()
        self._next = pairs, reqs, rows

    def call(self, i: int):
        (pairs, reqs, rows), self._next = self._next, None
        record = []
        if rows is not None:
            n = rows.shape[0]
            self.co.ingest(rows)
            record += [("ingest", self.rows + s, min(self.chunk, n - s))
                       for s in range(0, n, self.chunk)]
            self.rows += n
        subs = [self.co.submit(q, t) for q, t in reqs]
        res = self.co.flush()
        flush, self.flushes = self.flushes, self.flushes + 1
        ests = torch.tensor([res[r.rid] for r in subs], dtype=torch.float32)
        hit = torch.tensor([r.provenance == "hit" for r in subs])
        probed = torch.nonzero(~hit).squeeze(1)
        pk = torch.full((len(subs), self.co.cfg.n_tables), -1,
                        dtype=torch.int32)
        nv = torch.full((len(subs),), -1, dtype=torch.int32)
        for s in probed.tolist():
            pk[s] = torch.as_tensor(subs[s].probed_k)
            nv[s] = int(subs[s].nvisited)
        if hit.any():
            served = torch.nonzero(hit).squeeze(1)
            record.append(("reuse", pairs[served], served))
        if len(probed):
            pm = next_pow2(len(probed))
            record.append(("estimate", pairs[probed],
                           partial(first_keys, partial(self.keys, flush, pm),
                                   len(probed)), probed))
        return ests, pk, nv, record

    def counters(self) -> dict:
        out = {f"cache_{k}": v for k, v in self.co.cache_stats.items()}
        out.update({f"ingest_{k}": v for k, v in
                    getattr(self.co, "ingest_stats", {}).items()})
        return out


def open(state, cfg, pcfg, params, pool_q, pool_t, seed, dev, tag):
    return Serve(state, cfg, pcfg, params, pool_q, pool_t, seed, dev, tag)
