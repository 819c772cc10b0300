"""Plain PyTorch versions of the port's kernels.

The wrappers in :mod:`ops` call these for tensors on the CPU; on the card
``chip_smoke.py`` and the ``cuda``-marked tests hold each kernel against
them. Distances are the difference form Σ(x−q)², the form of the
reference's default qualification path (``repro/core/prober.py``).
"""
from __future__ import annotations

import torch


def lsh_hash(x, a, b, w):
    """``floor((x @ a + b*w) / w)`` → (N, F) int32."""
    proj = x.float() @ a + b[None, :] * w[None, :]
    return torch.floor(proj / w[None, :]).to(torch.int32)


def hamming_to_buckets(bucket_codes, qcodes, n_buckets):
    """bucket_codes (L, B, K), qcodes (Q, L, K), n_buckets (L,) → (Q, L, B)
    int32 Hamming distances; rows ``b >= n_buckets[l]`` get ``K + 1``."""
    k = bucket_codes.shape[-1]
    nb = bucket_codes.shape[1]
    dist = (bucket_codes[None] != qcodes[:, :, None, :]).sum(
        -1, dtype=torch.int32)
    valid = torch.arange(nb, device=dist.device)[None, :] < n_buckets[:, None]
    return torch.where(valid[None], dist, k + 1).to(torch.int32)


def l2dist(x, q):
    """x (N, d), q (Q, d) → (N, Q) squared distances, one query at a time so
    that no (N, Q, d) intermediate is materialised."""
    cols = [((x - q[j][None, :]) ** 2).sum(-1) for j in range(q.shape[0])]
    if not cols:
        return x.new_zeros((x.shape[0], 0))
    return torch.stack(cols, dim=1)


def l2dist_rows(x, ids, qs):
    """x (C, d), ids (R, c), qs (R, d) → (R, c): squared distance of row
    ``x[ids[r, i]]`` to query ``qs[r]``."""
    diff = x[ids.long()] - qs[:, None, :]
    return (diff * diff).sum(-1)
