"""E2LSH index with a sorted-CSR bucket layout (port of ``repro/core/lsh.py``).

Paper §2.2 / §4.2: ``h_{a,b}(o) = floor((a·o + b) / W)`` with ``a`` drawn from
N(0, I) and ``b ~ U[0, W)``. ``K`` functions form one table's composite
code; ``L`` independent tables form the index. Per table, a dense layout:

  * ``order``          (L, C)       point ids sorted by bucket code
  * ``bucket_codes``   (L, B, K)    unique codes, row ``j`` = code of bucket j
  * ``bucket_starts``  (L, B)       CSR offset of bucket j into ``order``
  * ``bucket_sizes``   (L, B)       number of points in bucket j
  * ``n_buckets``      (L,)         number of valid bucket rows
  * ``n_valid``        ()           number of live points (<= capacity C)
  * ``n_buckets_max``  host int     ``max(n_buckets)``, or None (unknown)

Rows ``j >= n_buckets[l]`` are padding. A capacity-padded index keeps the
bucket axis at B = C, and its dead point rows carry ``CODE_SENTINEL`` codes,
which sort into one trailing sentinel bucket at row ``n_buckets`` that no
probe touches. A plain build trims the bucket axis to ``max(n_buckets)``
rounded up to a multiple of 256. Every build, growth and ingest reads
``max(n_buckets)`` to the host once, so that a probe reads only the first
:attr:`LSHIndex.live_extent` rows of the bucket axis and takes no sync to
know how many. ``LSHIndex.raw`` keeps the pure projection
``a·x`` so Alg. 7 (``normalize_w``) reproduces ``W`` bit for bit across
ingests that extend no extreme.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core import collectives
from repro_torch.core.config import ProberConfig
from repro_torch.kernels import ops

CODE_SENTINEL = 2 ** 31 - 1      # int32 max


class LSHParams(NamedTuple):
    """The hash functions: a (d, L*K), b (L*K,) as a fraction of w, and the
    per-function bucket widths w (L*K,), all float32."""
    a: torch.Tensor
    b: torch.Tensor
    w: torch.Tensor


class LSHIndex(NamedTuple):
    params: LSHParams
    raw: torch.Tensor            # (C, L*K) float32 — pure a·x
    codes: torch.Tensor          # (L, C, K) int32 (dead rows: CODE_SENTINEL)
    order: torch.Tensor          # (L, C) int32
    bucket_codes: torch.Tensor   # (L, B, K) int32
    bucket_starts: torch.Tensor  # (L, B) int32
    bucket_sizes: torch.Tensor   # (L, B) int32
    n_buckets: torch.Tensor      # (L,) int32
    n_valid: torch.Tensor        # () int32
    n_buckets_max: int | None = None   # max(n_buckets) on the host

    @property
    def capacity(self) -> int:
        return self.raw.shape[0]

    @property
    def live_extent(self) -> int:
        """Bucket rows a probe reads: ``max(n_buckets)`` rounded up to a
        power of two, at least 256 and at most B; B where
        ``n_buckets_max`` is unknown. Every row past it is padding."""
        nb = self.bucket_codes.shape[1]
        if self.n_buckets_max is None:
            return nb
        pow2 = 1 << max(self.n_buckets_max - 1, 0).bit_length()
        return min(nb, max(256, pow2))

    @property
    def n_tables(self) -> int:
        return self.codes.shape[0]

    @property
    def n_funcs(self) -> int:
        return self.codes.shape[2]


def init_params(generator: torch.Generator, dim: int, cfg: ProberConfig,
                device: torch.device) -> LSHParams:
    """Sample the L·K hash functions on ``generator``'s device. ``w`` starts
    at 1 and is normalised against the data by :func:`normalize_w`."""
    lk = cfg.n_tables * cfg.n_funcs
    gdev = generator.device
    a = torch.randn((dim, lk), generator=generator, device=gdev)
    b = torch.rand((lk,), generator=generator, device=gdev)
    w = torch.ones((lk,), device=gdev)
    return LSHParams(a.to(device), b.to(device), w.to(device))


def project_raw(params: LSHParams, x: torch.Tensor) -> torch.Tensor:
    """Pure projections ``a·x`` (..., L*K), independent of ``w``."""
    return x.float() @ params.a


def project(params: LSHParams, x: torch.Tensor) -> torch.Tensor:
    """Offset projections ``a·x + b·w``."""
    return project_raw(params, x) + params.b * params.w


def normalize_w(raw: torch.Tensor, n_regions: int,
                n_valid: torch.Tensor | int | None = None,
                group=None) -> torch.Tensor:
    """Paper Alg. 7 ``normalizeW``: per-function width from the min/max of
    the live raw projections, so each function yields ~``n_regions``
    values. Rows ``>= n_valid`` (capacity padding) are masked out.

    With a ``torch.distributed`` process ``group`` (one rank per shard),
    the extremes are pooled over its ranks first: one ``all_reduce(MIN)``
    of ``cat(lo, -hi)``, which is exact, so W is bit-identical on every
    rank and equals the W of the union of the ranks' live rows."""
    if n_valid is None:
        lo, hi = raw.amin(0), raw.amax(0)
    else:
        valid = (torch.arange(raw.shape[0], device=raw.device)
                 < n_valid)[:, None]
        lo = torch.where(valid, raw, torch.inf).amin(0)
        hi = torch.where(valid, raw, -torch.inf).amax(0)
    if group is not None:
        ext = torch.cat([lo, -hi])
        collectives.all_reduce(ext, dist.ReduceOp.MIN, group=group)
        lo, hi = ext[:lo.shape[0]], -ext[lo.shape[0]:]
    return torch.clamp_min((hi - lo) / float(n_regions), 1e-6)


def quantize(raw: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``floor(raw / W)`` — the E2LSH bucket id per function."""
    return torch.floor(raw / w).to(torch.int32)


def hash_point(params: LSHParams, x: torch.Tensor,
               n_tables: int) -> torch.Tensor:
    """Hash one point (d,) or a batch (Q, d) → (..., L, K) int32 codes,
    through the fused ``lsh_hash`` kernel."""
    x2 = x.reshape(-1, x.shape[-1]).float().contiguous()
    codes = ops.lsh_hash(x2, params.a.contiguous(), params.b.contiguous(),
                         params.w.contiguous())
    return codes.reshape(*x.shape[:-1], n_tables, -1)


_PACK_BITS = 6                  # per-column field of the packed sort key
_PACK_COLS = 30 // _PACK_BITS   # columns per 32-bit key word
_DEAD_KEY = 0xFFFFFFFF          # key word of a dead row: after every live one


def _live_mask(n: int, n_valid, device) -> torch.Tensor | None:
    if n_valid is None:
        return None
    return torch.arange(n, device=device) < n_valid


def _pack_fits(codes: torch.Tensor,
               valid: torch.Tensor | None = None) -> torch.Tensor:
    """Scalar predicate over every table at once: each column's live code
    range fits the packed 6-bit sort field."""
    if valid is None:
        lo, hi = codes.amin(-2), codes.amax(-2)
    else:
        v = valid[:, None]
        lo = torch.where(v, codes, 2 ** 31 - 1).amin(-2)
        hi = torch.where(v, codes, -2 ** 31).amax(-2)
    # float difference: an int32 one could wrap for sentinel-sized ranges
    rng = hi.float() - lo.float()
    return (rng < (1 << _PACK_BITS)).all() & (rng >= 0).all()


def _stable_lsd(perm: torch.Tensor, keys: list[torch.Tensor]) -> torch.Tensor:
    """Stable least-significant-key-first passes: the permutation of one
    stable lexicographic sort on ``keys`` (first key most significant)."""
    for key in reversed(keys):
        idx = torch.sort(key[perm], stable=True).indices
        perm = perm[idx]
    return perm


def lexsort_rows(codes: torch.Tensor, valid: torch.Tensor | None = None,
                 fits: bool | None = None) -> torch.Tensor:
    """Permutation (int64) sorting the rows of ``codes`` (N, K)
    lexicographically, stable — equal to ``lax.sort(num_keys=..,
    is_stable=True)`` in the reference.

    Fast path: when every live column spans < 64 values, columns are
    rank-compressed into 6-bit fields, 5 to a key word, and sorted in
    ``ceil(K/5)`` stable passes over int64 copies of the words (one word
    each — packing two 32-bit words into one int64 would put the dead-row
    key into the sign bit and sort dead rows first). Dead rows
    (``~valid``) get all-ones words and sort after every live row, where
    their sentinel codes would land. Otherwise K stable column passes.
    ``fits`` is decided on the host.
    """
    n, k = codes.shape
    perm = torch.arange(n, device=codes.device)
    nkeys = -(-k // _PACK_COLS)
    if fits is None:
        fits = bool(_pack_fits(codes, valid).item())
    if nkeys > 4 or not fits:
        return _stable_lsd(perm, [codes[:, c] for c in range(k)])
    if valid is None:
        lo = codes.amin(0)
    else:
        lo = torch.where(valid[:, None], codes, 2 ** 31 - 1).amin(0)
    shifted = (codes.long() - lo.long()[None, :]).clamp(
        0, (1 << _PACK_BITS) - 1)
    keys = []
    for g in range(nkeys):
        acc = torch.zeros(n, dtype=torch.int64, device=codes.device)
        for c in range(g * _PACK_COLS, min((g + 1) * _PACK_COLS, k)):
            acc = (acc << _PACK_BITS) | shifted[:, c]
        if valid is not None:
            acc = torch.where(valid, acc, _DEAD_KEY)
        keys.append(acc)
    return _stable_lsd(perm, keys)


def _build_table(codes_t: torch.Tensor, n_valid=None,
                 fits: bool | None = None) -> tuple[torch.Tensor, ...]:
    """One table's sorted-CSR layout from (C, K) codes: (order, bucket_codes,
    bucket_starts, bucket_sizes, n_buckets). Rows ``>= n_valid`` become
    ``CODE_SENTINEL`` and collapse into the sentinel bucket after the live
    ones; ``n_buckets`` counts live buckets only."""
    n = codes_t.shape[0]
    dev = codes_t.device
    valid = _live_mask(n, n_valid, dev)
    if valid is not None:
        codes_t = torch.where(valid[:, None], codes_t, CODE_SENTINEL)
    perm = lexsort_rows(codes_t, valid=valid, fits=fits)
    sorted_codes = codes_t[perm]
    prev = torch.cat([sorted_codes[:1] - 1, sorted_codes[:-1]], dim=0)
    boundary = (sorted_codes != prev).any(-1)
    bucket_of_row = torch.cumsum(boundary, 0) - 1           # int64
    if valid is None:
        n_buckets = bucket_of_row[-1] + 1
    else:
        nv = torch.as_tensor(n_valid, device=dev)
        last = bucket_of_row[torch.clamp_min(nv - 1, 0)]
        n_buckets = torch.where(nv > 0, last + 1, 0)
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    starts = torch.full((n,), n, dtype=torch.int32, device=dev).scatter_reduce_(
        0, bucket_of_row, rows, "amin", include_self=True)
    sizes = torch.zeros(n, dtype=torch.int32, device=dev).scatter_add_(
        0, bucket_of_row, torch.ones_like(rows))
    # rows of one bucket share one code, so duplicate indices write equal rows
    bucket_codes = torch.full_like(sorted_codes, CODE_SENTINEL).index_copy_(
        0, bucket_of_row, sorted_codes)
    return (perm.to(torch.int32), bucket_codes, starts, sizes,
            n_buckets.to(torch.int32))


def _build_tables(codes: torch.Tensor, n_valid=None) -> tuple:
    """:func:`_build_table` for every table of (L, C, K) codes, stacked, and
    last ``max(n_buckets)`` as a host int; the packed-sort predicate is
    decided once over all tables."""
    valid = _live_mask(codes.shape[1], n_valid, codes.device)
    fits = bool(_pack_fits(codes, valid).item())
    parts = [_build_table(codes[t], n_valid, fits)
             for t in range(codes.shape[0])]
    order, bcodes, starts, sizes, nb = (torch.stack(p) for p in zip(*parts))
    return order, bcodes, starts, sizes, nb, int(nb.max())


def _table_codes(raw: torch.Tensor, params: LSHParams, cfg: ProberConfig,
                 n_valid=None) -> torch.Tensor:
    """(C, L*K) raw projections → (L, C, K) codes, dead rows sentinel."""
    n = raw.shape[0]
    codes = quantize(raw + params.b * params.w, params.w)
    codes = codes.reshape(n, cfg.n_tables, cfg.n_funcs).transpose(0, 1)
    if n_valid is not None:
        live = _live_mask(n, n_valid, raw.device)[None, :, None]
        codes = torch.where(live, codes, CODE_SENTINEL)
    return codes.contiguous()


def build_index(x: torch.Tensor, cfg: ProberConfig,
                generator: torch.Generator | None = None,
                params: LSHParams | None = None,
                n_valid: int | None = None) -> LSHIndex:
    """Build the L-table index over ``x`` (C, d).

    With ``params`` the hash functions are reused as given; otherwise they
    are drawn from ``generator`` and ``W`` is normalised on ``x``. With
    ``n_valid``, rows ``>= n_valid`` are capacity padding: masked out of
    the normalisation, coded ``CODE_SENTINEL``, and the bucket axis stays
    untrimmed (B = C); probes read its :attr:`LSHIndex.live_extent` rows.
    """
    dev = x.device
    if params is None:
        if generator is None:
            raise ValueError("build_index needs params= or generator=")
        params = init_params(generator, x.shape[-1], cfg, dev)
        raw = project_raw(params, x)
        params = params._replace(w=normalize_w(raw, cfg.n_regions, n_valid))
    else:
        raw = project_raw(params, x)
    n = x.shape[0]
    codes = _table_codes(raw, params, cfg, n_valid)
    order, bcodes, starts, sizes, nb, nb_max = _build_tables(codes, n_valid)
    cap = _static_bucket_cap(nb_max, n) if n_valid is None else n
    nv = n if n_valid is None else n_valid
    return LSHIndex(params=params, raw=raw, codes=codes, order=order,
                    bucket_codes=bcodes[:, :cap].contiguous(),
                    bucket_starts=starts[:, :cap].contiguous(),
                    bucket_sizes=sizes[:, :cap].contiguous(), n_buckets=nb,
                    n_valid=torch.tensor(nv, dtype=torch.int32, device=dev),
                    n_buckets_max=nb_max)


def _static_bucket_cap(n_buckets_max: int, n: int) -> int:
    """Bucket-axis length of a plain build: ``max(n_buckets)`` rounded up to
    a multiple of 256, at most ``n``."""
    return min(n, max(256, -(-n_buckets_max // 256) * 256))


def grow_capacity(index: LSHIndex, new_capacity: int) -> LSHIndex:
    """Re-pad an index to a larger capacity: live rows keep their raw
    projections and codes, new rows join the sentinel bucket, and the
    bucket axis widens to the new capacity."""
    cap = index.raw.shape[0]
    if new_capacity < cap:
        raise ValueError(f"capacity {new_capacity} < current {cap}")
    pad = new_capacity - cap
    raw = torch.nn.functional.pad(index.raw, (0, 0, 0, pad))
    codes = torch.nn.functional.pad(index.codes, (0, 0, 0, pad),
                                    value=CODE_SENTINEL)
    nv = int(index.n_valid.item())
    order, bcodes, starts, sizes, nb, nb_max = _build_tables(codes, nv)
    return LSHIndex(params=index.params, raw=raw, codes=codes, order=order,
                    bucket_codes=bcodes, bucket_starts=starts,
                    bucket_sizes=sizes, n_buckets=nb, n_valid=index.n_valid,
                    n_buckets_max=nb_max)


def hamming_to_buckets(bucket_codes: torch.Tensor, n_buckets: torch.Tensor,
                       qcodes: torch.Tensor) -> torch.Tensor:
    """Hamming distance (paper Def. 6) from each (query, table) code to every
    bucket code of that table: bucket_codes (L, B, K), n_buckets (L,),
    qcodes (Q, L, K) → (Q, L, B) int32. Padding rows get ``K+1`` (never
    probed), so rings N_k are ``dist == k`` masks."""
    return ops.hamming_to_buckets(bucket_codes.contiguous(),
                                  qcodes.to(torch.int32).contiguous(),
                                  n_buckets.to(torch.int32).contiguous())


def query_lanes(params: LSHParams, qs: torch.Tensor, bucket_codes: torch.Tensor,
                n_buckets: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`hash_point` of a batch (Q, d) and :func:`hamming_to_buckets`
    of its codes, through one fused ``query_lanes`` kernel: → ``(qcodes
    (Q, L, K), ham (Q, L, B))`` int32."""
    return ops.query_lanes(qs.float().contiguous(), params.a.contiguous(),
                           params.b.contiguous(), params.w.contiguous(),
                           bucket_codes.contiguous(),
                           n_buckets.to(torch.int32).contiguous())
