"""The benchmark's inputs, made on the device from the seed, in plain torch.

Frozen copies of the program's ``data/vectors.py`` generators
(``make_corpus`` and ``paper_query_workload``), kept here so that the
yardstick does not move when the program changes. Two departures, both so
that every seed gives the same amount of work in another arrangement:

* the clusters' sizes are equal (points are dealt to clusters by a random
  permutation), their scales are the quantiles of the same log-normal
  law in a random order, and their centres lie at one distance from the
  origin in random directions, where the original drew all three; the
  query pool takes the same number of queries from every cluster;
* ground truth is exact squared L2 in float64 (``|x|^2 + |q|^2 - 2 x·q``
  over blocks), where the original ran the program's ``l2dist`` kernel.
"""
from __future__ import annotations

import hashlib
import math

import numpy as np
import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of run seed ``seed``."""
    h = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def surrogate(g: torch.Generator, dim: int, n_clusters: int,
              intrinsic_dim: int, scale_sigma: float):
    """``(basis, centers, scales)`` of the clustered surrogate: the first
    draws of ``g``, before any point is drawn."""
    dev = g.device
    basis = torch.randn((intrinsic_dim, dim), generator=g, device=dev) \
        / math.sqrt(intrinsic_dim)
    centers = torch.randn((n_clusters, intrinsic_dim), generator=g,
                          device=dev)
    centers *= 2.0 * math.sqrt(intrinsic_dim) / centers.norm(dim=1,
                                                            keepdim=True)
    quant = (torch.arange(n_clusters, device=dev, dtype=torch.float64)
             + 0.5) / n_clusters
    scales = torch.exp(torch.special.ndtri(quant) * scale_sigma).float()
    scales = scales[torch.randperm(n_clusters, generator=g, device=dev)]
    return basis, centers, scales


def _points(g: torch.Generator, n: int, basis, centers, scales,
            noise: float) -> torch.Tensor:
    """``(x (n, dim), cluster (n,))``: ``n`` points dealt evenly to the
    clusters in a random order, each its centre plus its cluster's spread
    on the subspace, plus isotropic noise."""
    dev = g.device
    n_clusters, intrinsic_dim = centers.shape
    assign = torch.randperm(n, generator=g, device=dev) % n_clusters
    z = centers[assign] + torch.randn((n, intrinsic_dim), generator=g,
                                      device=dev) * scales[assign, None]
    x = z @ basis + torch.randn((n, basis.shape[1]), generator=g,
                                device=dev) * noise
    return x.float().contiguous(), assign


def make_corpus(g: torch.Generator, n: int, dim: int, n_clusters: int,
                intrinsic_dim: int, noise: float, scale_sigma: float
                ) -> torch.Tensor:
    """``(x (n, dim) float32, cluster (n,) int64)`` on ``g``'s device:
    clusters on a random ``intrinsic_dim``-dimensional subspace, plus
    isotropic noise."""
    return _points(g, n, *surrogate(g, dim, n_clusters, intrinsic_dim,
                                    scale_sigma), noise)


HELDOUT_BLOCK = 1024          # rows of the held-out stream drawn at once


def heldout(cfg: dict, seed: int, first: int, n: int, device) -> torch.Tensor:
    """Rows ``[first, first + n)`` (float32) of the run's held-out stream:
    points of the corpus's surrogate (its clusters, drawn again from the
    corpus's sub-seed) that the corpus does not hold. The stream is drawn
    in blocks of :data:`HELDOUT_BLOCK` rows, each from a sub-seed of its
    own, so a row is the same however the range is cut."""
    c = cfg["corpus"]
    shape = surrogate(generator(seed, "corpus", device), int(cfg["d"]),
                      c["n_clusters"], c["intrinsic_dim"], c["scale_sigma"])
    lo, hi = first // HELDOUT_BLOCK, -(-(first + n) // HELDOUT_BLOCK)
    rows = torch.cat([_points(generator(seed, f"heldout{b}", device),
                              HELDOUT_BLOCK, *shape, c["noise"])[0]
                      for b in range(lo, max(hi, lo + 1))])
    start = first - lo * HELDOUT_BLOCK
    return rows[start:start + n].contiguous()


def tau_targets(n: int, n_taus: int, max_card: int) -> torch.Tensor:
    """The paper's geometric grid of target cardinalities in [1, max_card]
    (§6.1), as the program's generator builds it."""
    return torch.as_tensor(np.unique(
        np.geomspace(1, max_card, n_taus).astype(np.int64)))


def stratified_rows(g: torch.Generator, cluster: torch.Tensor,
                    n_rows: int) -> torch.Tensor:
    """``n_rows`` distinct rows, as many from every cluster as the count
    allows (the first clusters of a random order take one more where it
    does not divide), in a random order."""
    n = cluster.shape[0]
    n_cl = int(cluster.max()) + 1
    dev = g.device
    perm = torch.randperm(n, generator=g, device=dev)
    cl = cluster.to(dev)[perm]
    grouped = perm[torch.argsort(cl, stable=True)]
    counts = torch.bincount(cl, minlength=n_cl)
    starts = torch.cumsum(counts, 0) - counts
    take = torch.full((n_cl,), n_rows // n_cl, device=dev)
    extra = torch.randperm(n_cl, generator=g, device=dev)[:n_rows % n_cl]
    take[extra] += 1
    take = torch.minimum(take, counts)
    rows = torch.cat([grouped[starts[c]:starts[c] + take[c]]
                      for c in range(n_cl)])
    return rows[torch.randperm(rows.shape[0], generator=g, device=dev)]


def query_pool(g: torch.Generator, x: torch.Tensor, cluster: torch.Tensor,
               n_queries: int, n_taus: int, max_card: int,
               q_block: int = 128, x_block: int = 1 << 18):
    """Paper §6.1: ``n_queries`` corpus rows as queries, drawn evenly from
    the clusters; for each, τ at the midpoint between the distance of its
    ``t``-th neighbour and the next one, for every target t. Returns
    ``(queries (Q, d), taus (Q, T) float32, cards (Q, T) int64)``, the
    exact counts of points within each τ."""
    n = x.shape[0]
    dev = x.device
    qidx = stratified_rows(g, cluster, n_queries)
    queries = x[qidx.to(dev)].contiguous()
    targets = tau_targets(n, n_taus, max_card).to(dev)
    kmax = int(targets.max()) + 1
    x2 = torch.cat([(x[r:r + x_block].double() ** 2).sum(-1)
                    for r in range(0, n, x_block)])
    taus, cards = [], []
    for s in range(0, n_queries, q_block):
        q = queries[s:s + q_block].double()
        q2 = (q ** 2).sum(-1)
        d2 = torch.empty((q.shape[0], n), dtype=torch.float64, device=dev)
        for r in range(0, n, x_block):
            xb = x[r:r + x_block].double()
            d2[:, r:r + x_block] = (x2[None, r:r + x_block] + q2[:, None]
                                    - 2.0 * (q @ xb.T)).clamp_min(0.0)
        near = torch.topk(d2, min(kmax, n), dim=1, largest=False).values
        at = near[:, targets - 1].sqrt()
        nxt = near[:, targets.clamp_max(n - 1)].sqrt()
        tau = torch.where(targets < n, 0.5 * (at + nxt), at + 1e-3).float()
        t2 = tau.double() ** 2
        cards.append(torch.stack([(d2 <= t2[:, t, None]).sum(1)
                                  for t in range(tau.shape[1])], 1))
        taus.append(tau)
        del d2, near
    return queries, torch.cat(taus), torch.cat(cards)
