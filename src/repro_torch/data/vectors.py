"""Synthetic vector corpora shaped like the paper's five datasets, and the
paper's query protocol, on the device (port of ``repro/data/vectors.py``;
draws come from a ``torch.Generator`` and are not bit-equal to the
reference's).

SIFT, GloVe, FastText, GIST and YouTube are replaced by matched-shape
surrogates: the ambient dimension is the real corpus's, N is scaled. The
corpus is a clustered low-intrinsic-dimensional manifold embedded in
the ambient dimension (real image and text embeddings have intrinsic
dimension ~8–20), which gives broad distance distributions. The query
workload follows paper §6.1: query points sampled from the data, a
geometric grid of target cardinalities in [1, min(20000, 1% N)], and τ at
the midpoint between the target's distance and the next one.
"""
from __future__ import annotations

import dataclasses
import math
import zlib

import numpy as np
import torch

from repro_torch.kernels import ops

# name -> (n_objects, dim) at benchmark scale (the real corpora's dims,
# CPU-scaled N): the reference's table
CORPORA: dict[str, tuple[int, int]] = {
    "sift":     (40000, 128),
    "glove":    (40000, 300),
    "fasttext": (40000, 300),
    "gist":     (20000, 960),
    "youtube":  (10000, 1770),
}


@dataclasses.dataclass(frozen=True)
class VectorDataset:
    name: str
    x: torch.Tensor         # (N, d) float32
    queries: torch.Tensor   # (Q, d) float32
    taus: torch.Tensor      # (Q, T) float32 threshold grid per query
    cards: torch.Tensor     # (Q, T) exact cardinality per (query, tau)


def make_corpus(generator: torch.Generator, n: int, dim: int, *,
                n_clusters: int = 32, intrinsic_dim: int = 12,
                noise: float = 0.05) -> torch.Tensor:
    """(n, dim) float32 on ``generator``'s device."""
    g, dev = generator, generator.device
    basis = torch.randn((intrinsic_dim, dim), generator=g, device=dev) \
        / math.sqrt(intrinsic_dim)
    centers = torch.randn((n_clusters, intrinsic_dim), generator=g,
                          device=dev) * 2.0
    # heavy-tailed per-cluster scales (the paper's datasets are non-uniform)
    scales = torch.exp(torch.randn((n_clusters,), generator=g, device=dev)
                       * 0.8)
    assign = torch.randint(0, n_clusters, (n,), generator=g, device=dev)
    z = centers[assign] + torch.randn((n, intrinsic_dim), generator=g,
                                      device=dev) * scales[assign, None]
    x = z @ basis + torch.randn((n, dim), generator=g, device=dev) * noise
    return x.float().contiguous()


def paper_query_workload(generator: torch.Generator, x: torch.Tensor,
                         n_queries: int, n_taus: int = 12,
                         max_card: int | None = None):
    """Paper §6.1: returns (queries (Q, d), taus (Q, T), cards (Q, T)) with
    exact cardinalities from the ``l2dist`` kernel."""
    n = x.shape[0]
    if max_card is None:
        max_card = min(20000, max(n // 100, 2))
    qidx = torch.randperm(n, generator=generator,
                          device=generator.device)[:n_queries].to(x.device)
    queries = x[qidx].contiguous()
    targets = torch.as_tensor(
        np.unique(np.geomspace(1, max_card, n_taus).astype(np.int64)),
        device=x.device)
    d2 = ops.l2dist(x.contiguous(), queries).T                # (Q, N)
    d2s = torch.sort(d2, dim=1).values
    at = torch.sqrt(d2s[:, targets - 1])
    nxt = torch.sqrt(d2s[:, targets.clamp_max(n - 1)])
    taus = torch.where(targets < n, 0.5 * (at + nxt), at + 1e-3)
    del d2s
    cards = torch.stack([(d2 <= (taus[:, t] ** 2)[:, None]).sum(1)
                         for t in range(taus.shape[1])], dim=1)
    return queries, taus, cards


def skewed_shards(rng: np.random.Generator, shards: int):
    """The skewed partition on which pooled ("sync") stopping beats local
    stopping (the reference's ``test_8dev_sync_beats_local_on_skewed_shards``
    split): shard 0, the first block of rows, is the query cluster; every
    other shard is a shell just outside τ plus a few true matches just
    inside it. Returns numpy ``(x (1000·shards, 16), queries (6, 16), taus
    (6,))``, float32, to be split into contiguous blocks."""
    d, n_shard, tau, n_sp = 16, 1000, 3.0, 10

    def shell(n, r_lo, r_hi):
        v = rng.normal(size=(n, d))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        return (v * rng.uniform(r_lo, r_hi, size=(n, 1))).astype(np.float32)

    parts = [shell(n_shard, 0.0, tau * 1.05)]
    for _ in range(1, shards):
        parts.append(np.concatenate(
            [shell(n_shard - n_sp, tau * 1.05, tau * 1.35),
             shell(n_sp, tau * 0.80, tau * 0.98)]))
    qs = (np.zeros((6, d), np.float32)
          + 0.01 * rng.standard_normal((6, d)).astype(np.float32))
    return np.concatenate(parts), qs, np.full((6,), tau, np.float32)


def load(name: str, generator: torch.Generator | None = None,
         n_queries: int = 32, scale: float = 1.0,
         device="cuda") -> VectorDataset:
    """A named surrogate corpus of ``CORPORA[name]`` at ``scale`` × its N,
    with the paper-protocol query workload, made on ``device`` (default
    ``"cuda"``; raises when CUDA is absent and the CPU was not asked for).
    ``generator`` must live on that device. Without one, the draws are
    seeded from ``zlib.crc32(name)``: a departure from the reference, which
    seeds from ``hash(name)``, a value that changes from process to process
    under ``PYTHONHASHSEED``."""
    dev = ops.resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(
            zlib.crc32(name.encode()) % 2 ** 31)
    elif generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, data on {dev}")
    n, dim = CORPORA[name]
    x = make_corpus(generator, int(n * scale), dim)
    queries, taus, cards = paper_query_workload(generator, x, n_queries)
    return VectorDataset(name=name, x=x, queries=queries, taus=taus,
                         cards=cards)
