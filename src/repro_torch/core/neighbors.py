"""Precomputed bucket-neighbor lookup table (paper §4.7, Alg. 6 and Alg. 9);
port of ``repro/core/neighbors.py``.

The online prober computes Hamming rings on the fly (``lsh.query_lanes``).
This module is the paper's literal offline table, for faithfulness and for
the dynamic-update algorithm:

  ``table[i, j] = hamming(C[i], C[j])`` if ``0 < d <= M`` else 0 (not stored)

stored densely as int8 (M <= 127). ``ring(i, k)`` masks ``table[i] == k``,
equal to the online ``hamming_to_buckets(...) == k`` masks over the live
rows. On the card :func:`build` and :func:`update` run the
``neighbor_dists`` kernel; :func:`update` writes only the row and column
strips of the new codes, which is Alg. 9's point.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops


class NeighborTable(NamedTuple):
    dists: torch.Tensor    # (B, B) int8 — 0 where not stored (d==0 or d>M)
    n: torch.Tensor        # () int32 — number of valid codes
    max_dist: int          # M


def _count(n: int, device) -> torch.Tensor:
    # a fill on the device, not a blocking copy from the host
    return torch.full((), n, dtype=torch.int32, device=device)


def build(codes: torch.Tensor, n_valid, max_dist: int) -> NeighborTable:
    """Alg. 6: all-pairs Hamming over the unique bucket codes ``C``.

    ``codes``: (B, K) padded; rows >= ``n_valid`` are ignored (their
    distances are not stored)."""
    codes = codes.to(torch.int32).contiguous()
    nv = int(n_valid)
    dists = ops.neighbor_dists(codes, nv, max_dist)
    return NeighborTable(dists=dists, n=_count(nv, codes.device),
                         max_dist=max_dist)


def ring(table: NeighborTable, i, k) -> torch.Tensor:
    """Bucket mask (B,) of the k-step neighbors N_k of bucket ``i`` (k >= 1)."""
    dev = table.dists.device
    if isinstance(i, torch.Tensor):
        i = i.to(dev).long()
    if isinstance(k, torch.Tensor):
        k = k.to(dev, torch.int8)
    return table.dists[i] == k


def grow(table: NeighborTable, new_capacity: int) -> NeighborTable:
    """Re-pad the table to a larger code capacity. Padding entries are 0
    (not stored) and lie beyond ``n``, so every ``ring`` is unchanged."""
    cap = table.dists.shape[0]
    if new_capacity < cap:
        raise ValueError(f"new capacity {new_capacity} < {cap}")
    pad = new_capacity - cap
    return table._replace(dists=torch.nn.functional.pad(
        table.dists, (0, pad, 0, pad)))


def update(table: NeighborTable, codes_all: torch.Tensor, n_old,
           n_new_total) -> NeighborTable:
    """Alg. 9: extend the table with the new codes C1 =
    ``codes_all[n_old:n_new_total]``.

    Only pairs that touch a new code are computed: the row strip
    [n_old, n_new_total) × [0, B') and its column strip; the old block is
    kept as it is. ``codes_all`` (B', K) holds the original codes first,
    and B' may exceed the table's capacity (the table is zero-padded to it)
    or equal it, where padding rows past ``n_new_total`` may carry any
    value (they are masked). At equal capacity the table's ``dists`` are
    updated in place (the reference returns a new array): the old table
    shares them afterwards."""
    b = codes_all.shape[0]
    nb = table.dists.shape[0]
    if b < nb:
        raise ValueError(f"codes_all has {b} rows, the table {nb}")
    n_old, n_new = int(n_old), int(n_new_total)
    if b == nb:
        merged = table.dists
    else:
        merged = torch.zeros((b, b), dtype=torch.int8,
                             device=table.dists.device)
        merged[:nb, :nb] = table.dists
    live = max(n_old, n_new)
    ops.neighbor_dists(codes_all.to(torch.int32).contiguous(), live,
                       table.max_dist, r0=min(n_old, live), r1=live,
                       out=merged)
    return NeighborTable(dists=merged, n=_count(n_new, merged.device),
                         max_dist=table.max_dist)
