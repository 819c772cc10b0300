"""Per-bucket ingest epochs: the estimate cache's invalidation signal
(port of ``repro/cache/epochs.py``).

A cached estimate may be served only while no ingest since its probe has
landed a point in a bucket the probe visited. Those are exactly the buckets
within Hamming distance ``probed_k`` of the query's code, and the
capacity-padded layout already keeps the exact per-bucket epoch: its
population. Points are only added, codes of live points are bit-stable
while W is, and a bucket's distance to a fixed code never changes, so the
population of a query's probed ball is monotone and moves iff an ingest
landed in it. What needs explicit state is the generation of the hash
functions: ``EpochState.params_epoch`` counts the ingests whose Alg. 7
renormalisation moved W.

Both counters are uint32 values held in 0-d int64 tensors on the state's
device and wrapped with ``& 0xFFFFFFFF`` after every add, the convention
of the PRP round keys.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import lsh

U32 = 0xFFFFFFFF
# elements of the (rows, L, B) Hamming block one ball-sum chunk reads
_BALL_CHUNK = 1 << 24


class EpochState(NamedTuple):
    """Ingest bookkeeping carried in the ``ProberState`` (uint32 in int64)."""
    params_epoch: torch.Tensor   # () hash-function generation (W moved)
    n_ingested: torch.Tensor     # () points ingested (diagnostics)


def init_epochs(device) -> EpochState:
    z = torch.zeros((), dtype=torch.int64, device=device)
    return EpochState(params_epoch=z, n_ingested=z.clone())


def ingest_bump(ep: EpochState, n_new, w_changed) -> EpochState:
    """Fold one ingest batch of ``n_new`` points into the counters;
    ``w_changed`` (a bool tensor) retires the cache generation."""
    w_changed = torch.as_tensor(w_changed, device=ep.params_epoch.device)
    return EpochState(
        params_epoch=(ep.params_epoch + w_changed.to(torch.int64)) & U32,
        n_ingested=(ep.n_ingested + n_new) & U32)


def ball_sums_from_ham(ham: torch.Tensor, bucket_sizes: torch.Tensor,
                       probed_k: torch.Tensor,
                       rows: torch.Tensor | None = None) -> torch.Tensor:
    """Probed-ball populations from Hamming distances already computed.

    ``ham`` (Q, L, B) int32 distances of each (query, table) code to every
    bucket row (padding rows read K + 1, beyond any ``probed_k``),
    ``bucket_sizes`` (L, B), ``probed_k`` (R, L) → (R, L) int32, the live
    points in buckets within ``probed_k`` of the code. With ``rows`` (R,)
    int64, row ``r`` of the result reads ``ham[rows[r]]``; otherwise R = Q.
    Summed in int32 over chunks of rows, so the only temporary is one
    bounded slice.
    """
    n = ham.shape[0] if rows is None else rows.shape[0]
    nl, nb = bucket_sizes.shape
    out = torch.empty((n, nl), dtype=torch.int32, device=ham.device)
    step = max(1, _BALL_CHUNK // max(1, nl * nb))
    for i in range(0, n, step):
        h = ham[i:i + step] if rows is None else ham[rows[i:i + step]]
        inside = h <= probed_k[i:i + step, :, None]
        out[i:i + step] = torch.where(inside, bucket_sizes[None], 0).sum(
            -1, dtype=torch.int32)
    return out


def ball_sums(bucket_codes: torch.Tensor, bucket_sizes: torch.Tensor,
              n_buckets: torch.Tensor, qcodes: torch.Tensor,
              probed_k: torch.Tensor) -> torch.Tensor:
    """The reference's signature: ``bucket_codes`` (L, B, K),
    ``bucket_sizes`` (L, B), ``n_buckets`` (L,), ``qcodes`` (..., L, K),
    ``probed_k`` (..., L) → (..., L) int32, through
    :func:`lsh.hamming_to_buckets` and :func:`ball_sums_from_ham`."""
    batch = qcodes.shape[:-2]
    nl, k = qcodes.shape[-2:]
    ham = lsh.hamming_to_buckets(bucket_codes, n_buckets,
                                 qcodes.reshape(-1, nl, k))
    out = ball_sums_from_ham(ham, bucket_sizes, probed_k.reshape(-1, nl))
    return out.reshape(*batch, nl)
