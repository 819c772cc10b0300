"""Carries a reference state across frameworks as numpy arrays.

Keys are the reference's field names: ``params.a``, ``params.b``,
``params.w``, ``raw``, ``codes``, ``order``, ``bucket_codes``,
``bucket_starts``, ``bucket_sizes``, ``n_buckets``, ``n_valid`` and ``x``.
Dtypes are kept exactly (int32 stays int32, float32 stays float32). This is
how the reference's "weights" — its LSH functions and built index — reach
the port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import lsh
from repro_torch.core.estimator import ProberState

_INDEX_FIELDS = ("raw", "codes", "order", "bucket_codes", "bucket_starts",
                 "bucket_sizes", "n_buckets", "n_valid")
KEYS = ("params.a", "params.b", "params.w", *_INDEX_FIELDS, "x")


def state_from_numpy(d: dict[str, np.ndarray], device) -> ProberState:
    missing = [k for k in KEYS if k not in d]
    if missing:
        raise KeyError(f"missing state fields: {missing}")

    def t(k):
        return torch.tensor(np.asarray(d[k]), device=device)

    params = lsh.LSHParams(t("params.a"), t("params.b"), t("params.w"))
    index = lsh.LSHIndex(params, *(t(k) for k in _INDEX_FIELDS))
    return ProberState(index=index, x=t("x"))


def state_to_numpy(state: ProberState) -> dict[str, np.ndarray]:
    ix = state.index
    out = {"params.a": ix.params.a, "params.b": ix.params.b,
           "params.w": ix.params.w, "x": state.x}
    out.update({k: getattr(ix, k) for k in _INDEX_FIELDS})
    return {k: v.detach().cpu().numpy() for k, v in out.items()}
