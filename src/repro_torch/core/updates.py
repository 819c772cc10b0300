"""Dynamic data updates (paper §5, Alg. 7) over the capacity-padded layout
(port of ``repro/core/updates.py``, LSH part).

New points are written into spare capacity rows; ``W`` is renormalised from
the min/max of ALL live raw projections (the retained ``raw`` makes this
exact) and the sorted-CSR layout is rebuilt. An in-capacity update returns
tensors of the same shapes as its input; only a capacity doubling changes
them. The update is functional: the input state's tensors are not written.
"""
from __future__ import annotations

import torch

from repro_torch.core import lsh
from repro_torch.core.config import ProberConfig


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def next_capacity(cap: int, needed: int) -> int:
    """Amortized doubling: smallest power-of-two multiple of ``cap`` (at
    least 256) covering ``needed``."""
    cap = max(cap, 256)
    while cap < needed:
        cap *= 2
    return cap


def _write_rows(dst: torch.Tensor, src: torch.Tensor, start: int,
                n_new: int) -> torch.Tensor:
    """A copy of ``dst`` with ``src[:n_new]`` in rows ``start:start+n_new``.
    Rows of ``src`` past ``n_new`` (the power-of-two batch padding) are not
    written."""
    if start + n_new > dst.shape[0]:
        raise ValueError(f"rows {start}+{n_new} exceed capacity {dst.shape[0]}")
    out = dst.clone()
    out[start:start + n_new] = src[:n_new]
    return out


def _lsh_ingest(index: lsh.LSHIndex, x_new: torch.Tensor, n_new: int,
                cfg: ProberConfig, n_valid: int) -> lsh.LSHIndex:
    """Alg. 7 at fixed shapes: every output shape equals the input capacity.
    ``n_valid`` is the index's live count, known on the host."""
    params = index.params
    raw_new = lsh.project_raw(params, x_new)
    raw_all = _write_rows(index.raw, raw_new, n_valid, n_new)
    nv2 = n_valid + n_new
    params = params._replace(w=lsh.normalize_w(raw_all, cfg.n_regions, nv2))
    codes = lsh._table_codes(raw_all, params, cfg, nv2)
    order, bcodes, starts, sizes, nb = lsh._build_tables(codes, nv2)
    return lsh.LSHIndex(params=params, raw=raw_all, codes=codes, order=order,
                        bucket_codes=bcodes, bucket_starts=starts,
                        bucket_sizes=sizes, n_buckets=nb,
                        n_valid=torch.tensor(nv2, dtype=torch.int32,
                                             device=raw_all.device))


def _pad_batch(x_new: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Pad a batch to the next power of two rows (float32); returns the
    padded batch and the live count."""
    nn = x_new.shape[0]
    x_pad = torch.nn.functional.pad(x_new.float(),
                                    (0, 0, 0, next_pow2(nn) - nn))
    return x_pad, nn
