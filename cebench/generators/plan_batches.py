"""Batches of (query, τ) pairs from a fixed pool, each with fresh PRP round
keys: what a query optimiser sends when it costs a plan's vector predicates
in one call.

Parameters (the traffic file): ``batch``, the pairs a call; the pool is
every (query, τ) pair of the run's query pool. Batches are consecutive
slices of a random permutation of the pool, drawn anew for every pass over
it, so that every seed sends the same pairs in another order. Round keys
are uint32 values held in int64, (batch, L, 6), one set a call.
"""
from __future__ import annotations

import torch

from cebench.harness.data import generator

KEY_CHUNK = 64                # batches whose round keys are drawn at once


class PlanBatches:
    def __init__(self, params: dict, n_pairs: int, n_tables: int, seed: int,
                 device, tag: str = "window"):
        self.batch_size = int(params["batch"])
        self.n_pairs = n_pairs
        self.n_tables = n_tables
        self.seed = seed
        self.device = device
        self.tag = tag
        self._perms: dict[int, torch.Tensor] = {}
        self._keys: dict[int, torch.Tensor] = {}

    def _perm(self, epoch: int) -> torch.Tensor:
        if epoch not in self._perms:
            g = generator(self.seed, f"{self.tag}.perm{epoch}", self.device)
            self._perms[epoch] = torch.randperm(self.n_pairs, generator=g,
                                                device=self.device)
        return self._perms[epoch]

    def pairs(self, i: int) -> torch.Tensor:
        """Pool indices (batch,) of call ``i``."""
        b = self.batch_size
        pos = torch.arange(i * b, (i + 1) * b)
        epochs = pos // self.n_pairs
        return torch.cat([self._perm(int(e))[pos[epochs == e] % self.n_pairs]
                          for e in torch.unique(epochs)])

    def round_keys(self, i: int) -> torch.Tensor:
        """PRP round keys (batch, L, 6) of call ``i``."""
        c = i // KEY_CHUNK
        if c not in self._keys:
            g = generator(self.seed, f"{self.tag}.keys{c}", self.device)
            self._keys[c] = torch.randint(
                0, 2 ** 32, (KEY_CHUNK, self.batch_size, self.n_tables, 6),
                generator=g, dtype=torch.int64, device=self.device)
        return self._keys[c][i % KEY_CHUNK]


def make(params: dict, n_pairs: int, n_tables: int, seed: int, device,
         tag: str = "window") -> PlanBatches:
    return PlanBatches(params, n_pairs, n_tables, seed, device, tag)
