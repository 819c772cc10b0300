"""Carries a reference state across frameworks as numpy arrays.

Keys are the reference's field names: ``params.a``, ``params.b``,
``params.w``, ``raw``, ``codes``, ``order``, ``bucket_codes``,
``bucket_starts``, ``bucket_sizes``, ``n_buckets``, ``n_valid`` and ``x``;
a PQ state adds ``pq.centroids``, ``pq.codes`` (uint8), ``pq.counts``,
``pq.resid``, ``pq.n_valid`` and, with 4-bit codes, ``pq.packed``. Dtypes
are kept exactly (int32 stays int32, uint8 stays uint8). This is how the
reference's "weights" — its LSH functions, built index and codebooks —
reach the port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import lsh, pq as pqmod
from repro_torch.core.estimator import ProberState

_INDEX_FIELDS = ("raw", "codes", "order", "bucket_codes", "bucket_starts",
                 "bucket_sizes", "n_buckets", "n_valid")
KEYS = ("params.a", "params.b", "params.w", *_INDEX_FIELDS, "x")
_PQ_FIELDS = ("centroids", "codes", "counts", "resid", "n_valid")
PQ_KEYS = tuple(f"pq.{k}" for k in _PQ_FIELDS)    # plus optional pq.packed


def state_from_numpy(d: dict[str, np.ndarray], device) -> ProberState:
    missing = [k for k in KEYS if k not in d]
    if missing:
        raise KeyError(f"missing state fields: {missing}")

    def t(k):
        return torch.tensor(np.asarray(d[k]), device=device)

    params = lsh.LSHParams(t("params.a"), t("params.b"), t("params.w"))
    index = lsh.LSHIndex(params, *(t(k) for k in _INDEX_FIELDS))
    pq = None
    if any(k.startswith("pq.") for k in d):
        missing = [k for k in PQ_KEYS if k not in d]
        if missing:
            raise KeyError(f"missing PQ fields: {missing}")
        pq = pqmod.PQIndex(*(t(k) for k in PQ_KEYS),
                           packed=t("pq.packed") if "pq.packed" in d else None)
    return ProberState(index=index, x=t("x"), pq=pq)


def state_to_numpy(state: ProberState) -> dict[str, np.ndarray]:
    ix = state.index
    out = {"params.a": ix.params.a, "params.b": ix.params.b,
           "params.w": ix.params.w, "x": state.x}
    out.update({k: getattr(ix, k) for k in _INDEX_FIELDS})
    if state.pq is not None:
        out.update({f"pq.{k}": getattr(state.pq, k) for k in _PQ_FIELDS})
        if state.pq.packed is not None:
            out["pq.packed"] = state.pq.packed
    return {k: v.detach().cpu().numpy() for k, v in out.items()}
