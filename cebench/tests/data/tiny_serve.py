"""A test driver: requests drawn zipf from the pool's pairs, served through
the program's ``CardinalityCoalescer`` with its estimate cache, and an
ingest of held-out rows (``data.heldout``) every few calls. A call is one
flush.

Traffic keys: ``batch`` (requests a call, at most ``max_batch``),
``max_batch``, ``cache_size``, ``reuse_tol``, ``zipf_s``, ``ingest_every``
(calls), ``ingest_rows``; ``omit_ingest_ops`` leaves the ingests out of
the record (a fault for the tests).
"""
from __future__ import annotations

from functools import partial

import torch

from cebench.harness import data


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
        from repro_torch.serve.coalescer import CardinalityCoalescer
        self.cfg, self.params, self.seed, self.dev, self.tag = \
            cfg, params, seed, dev, tag
        self.chunk = pcfg.ingest_chunk
        self.n_t = pool_t.shape[1]
        self.pool_q, self.pool_t = pool_q.cpu(), pool_t.cpu()
        n_pairs = pool_t.numel()
        g = data.generator(seed, f"{tag}.zipf", "cpu")
        self.order = torch.randperm(n_pairs, generator=g)
        self.weights = torch.arange(1, n_pairs + 1, dtype=torch.float64) \
            ** -float(params["zipf_s"])
        self.rows = int(state.n_valid) - int(cfg["n"])
        self.keys = partial(keys, seed, tag, pcfg.n_tables, dev)
        if int(params["batch"]) > int(params["max_batch"]):
            raise ValueError("a call is one flush: batch <= max_batch")
        self.co = CardinalityCoalescer(
            state, pcfg, max_batch=int(params["max_batch"]),
            cache_size=int(params["cache_size"]),
            reuse_tol=float(params["reuse_tol"]), round_keys=self.keys)
        self.flushes = 0
        self._pairs = None

    @property
    def state(self):
        return self.co.state

    def prepare(self, i: int) -> None:
        g = data.generator(self.seed, f"{self.tag}.req{i}", "cpu")
        idx = torch.multinomial(self.weights, int(self.params["batch"]),
                                replacement=True, generator=g)
        self._pairs = self.order[idx]

    def call(self, i: int):
        pairs, self._pairs = self._pairs, None
        record = []
        if i % int(self.params["ingest_every"]) == 0:
            n = int(self.params["ingest_rows"])
            self.co.ingest(data.heldout(self.cfg, self.seed, self.rows, n,
                                        self.dev))
            if not self.params.get("omit_ingest_ops"):
                record += [("ingest", self.rows + s, min(self.chunk, n - s))
                           for s in range(0, n, self.chunk)]
            self.rows += n
        qi, ti = pairs // self.n_t, pairs % self.n_t
        reqs = [self.co.submit(self.pool_q[q], float(self.pool_t[q, t]))
                for q, t in zip(qi.tolist(), ti.tolist())]
        res = self.co.flush()
        flush, self.flushes = self.flushes, self.flushes + 1
        ests = torch.tensor([res[r.rid] for r in reqs], dtype=torch.float32)
        hit = torch.tensor([r.provenance == "hit" for r in reqs])
        probed = torch.nonzero(~hit).squeeze(1)
        pk = torch.full((len(reqs), self.co.cfg.n_tables), -1,
                        dtype=torch.int32)
        nv = torch.full((len(reqs),), -1, dtype=torch.int32)
        for s in probed.tolist():
            pk[s] = torch.as_tensor(reqs[s].probed_k)
            nv[s] = int(reqs[s].nvisited)
        if hit.any():
            served = torch.nonzero(hit).squeeze(1)
            record.append(("reuse", pairs[served], served))
        if len(probed):
            pm = 1
            while pm < len(probed):
                pm *= 2
            record.append(("estimate", pairs[probed],
                           partial(first_keys, partial(self.keys, flush, pm),
                                   len(probed)), probed))
        return ests, pk, nv, record

    def counters(self) -> dict:
        return {f"cache_{k}": v for k, v in self.co.cache_stats.items()}


def open(state, cfg, pcfg, params, pool_q, pool_t, seed, dev, tag):
    return Serve(state, cfg, pcfg, params, pool_q, pool_t, seed, dev, tag)
