"""Dynamic data updates (paper §5, Alg. 7/8) over the capacity-padded
layout (port of ``repro/core/updates.py``, LSH and PQ parts).

* LSH (Alg. 7): new points are written into spare capacity rows; ``W`` is
  renormalised from the min/max of ALL live raw projections (the retained
  ``raw`` makes this exact) and the sorted-CSR layout is rebuilt.
* PQ (Alg. 8): new points take the nearest of the OLD centroids, centroids
  move to their running means, every live residual is refreshed against
  the moved centroids, and the packed 4-bit mirror is kept in step.

An in-capacity update returns tensors of the same shapes as its input; only
a capacity doubling changes them. The update is functional: the input
state's tensors are not written.
"""
from __future__ import annotations

import torch

from repro_torch.cache import epochs as cache_epochs
from repro_torch.core import lsh, pq as pqmod
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
                cfg: ProberConfig, n_valid: int, group=None) -> lsh.LSHIndex:
    """Alg. 7 at fixed shapes: every output shape equals the input capacity.
    ``n_valid`` is the index's live count, known on the host. With a
    process ``group`` (a sharded index) W is renormalised from the live
    projections of every rank (``lsh.normalize_w``)."""
    params = index.params
    raw_new = lsh.project_raw(params, x_new)
    raw_all = _write_rows(index.raw, raw_new, n_valid, n_new)
    nv2 = n_valid + n_new
    params = params._replace(w=lsh.normalize_w(raw_all, cfg.n_regions, nv2,
                                               group=group))
    codes = lsh._table_codes(raw_all, params, cfg, nv2)
    order, bcodes, starts, sizes, nb, nb_max = lsh._build_tables(codes, nv2)
    return lsh.LSHIndex(params=params, raw=raw_all, codes=codes, order=order,
                        bucket_codes=bcodes, bucket_starts=starts,
                        bucket_sizes=sizes, n_buckets=nb,
                        n_valid=torch.tensor(nv2, dtype=torch.int32,
                                             device=raw_all.device),
                        n_buckets_max=nb_max)


def _epoch_ingest(ep: cache_epochs.EpochState, index: lsh.LSHIndex,
                  old_w: torch.Tensor, n_new: int) -> cache_epochs.EpochState:
    """Fold one ingest into the cache's epoch counters: ``n_new`` points,
    and a new params generation iff Alg. 7 moved any width. The compare
    stays on the device; it is exact because ``normalize_w`` reproduces W
    bit for bit when no projection extreme moves."""
    w_changed = (index.params.w != old_w).any()
    return cache_epochs.ingest_bump(ep, n_new, w_changed)


def _pad_batch(x_new: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Pad a batch to the next power of two rows (float32); returns the
    padded batch and the live count."""
    nn = x_new.shape[0]
    x_pad = torch.nn.functional.pad(x_new.float(),
                                    (0, 0, 0, next_pow2(nn) - nn))
    return x_pad, nn


def _pq_ingest(pq: pqmod.PQIndex, x_all: torch.Tensor, x_new: torch.Tensor,
               n_new: int, n_valid: int) -> pqmod.PQIndex:
    """Alg. 8 at fixed shapes. ``x_all`` is the capacity-padded corpus with
    the new rows already written at ``[n_valid, n_valid + n_new)``;
    ``x_new`` is the power-of-two padded batch, of which the first
    ``n_new`` rows are live."""
    m, kc = pq.m, pq.kc
    cap = pq.codes.shape[0]
    xs_new = pqmod.split_subspaces(x_new, m)                 # (Nn, M, ds)
    nn_pad, _, ds = xs_new.shape
    new_codes = pqmod.assign(pq.centroids, xs_new)           # old centroids
    wf = (torch.arange(nn_pad, device=x_new.device) < n_new).float() \
        .repeat_interleave(m)
    seg = pqmod._segments(new_codes, kc)
    sums = pqmod.segment_sum(xs_new.reshape(-1, ds) * wf[:, None], seg,
                             m * kc).reshape(m, kc, ds)
    cnts = pqmod.segment_sum(wf, seg, m * kc).reshape(m, kc)
    tot = pq.counts + cnts
    centroids = torch.where(
        tot[..., None] > 0,
        (pq.centroids * pq.counts[..., None] + sums)
        / tot[..., None].clamp_min(1.0),
        pq.centroids)
    codes8 = new_codes.to(torch.uint8)
    codes = _write_rows(pq.codes, codes8, n_valid, n_new)
    packed = None if pq.packed is None else \
        _write_rows(pq.packed, pqmod.pack_codes(codes8), n_valid, n_new)
    nv2 = n_valid + n_new
    resid = pqmod.reconstruction_residual(
        centroids, codes, pqmod.split_subspaces(x_all, m))
    resid[nv2:] = 0.0
    return pqmod.PQIndex(centroids=centroids, codes=codes, counts=tot,
                         resid=resid,
                         n_valid=torch.tensor(nv2, dtype=torch.int32,
                                              device=codes.device),
                         packed=packed)


def update_pq(pq: pqmod.PQIndex, x_new: torch.Tensor,
              x_all: torch.Tensor) -> pqmod.PQIndex:
    """Alg. 8 on its own: ``x_all`` is the whole corpus (old points first,
    then ``x_new``), possibly capacity-padded; the PQ arrays grow to match
    it. Residuals of ALL live points are recomputed."""
    nn = x_new.shape[0]
    nv = int(pq.n_valid)
    cap = x_all.shape[0]
    if nv + nn > cap:
        raise ValueError(f"{nv} + {nn} points exceed x_all's {cap} rows")
    x_all = x_all.to(pq.codes.device, torch.float32)
    if cap < pq.codes.shape[0]:        # exact corpus against padded arrays
        x_all = torch.nn.functional.pad(
            x_all, (0, 0, 0, pq.codes.shape[0] - cap))
    elif pq.codes.shape[0] < cap:
        pq = pqmod.grow(pq, cap)
    x_pad, n_new = _pad_batch(x_new.to(pq.codes.device))
    return _pq_ingest(pq, x_all, x_pad, n_new, nv)
