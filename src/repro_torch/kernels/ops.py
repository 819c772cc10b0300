"""Device-dispatching wrappers over the CUDA kernels in ``csrc/``.

A tensor on the CPU goes to the plain version in :mod:`ref`; a tensor on a
CUDA device goes to the hand-written kernel, or the call raises. There is no
fallback. :func:`slab_loop` alone runs on the card only: its plain
counterpart is the prober's host loop of :func:`slab_qualify` steps. Each
wrapper checks device, dtype, shape and contiguity, allocates its output
with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch reported an error, and adds one to its
count in :data:`LAUNCHES` — there and nowhere else.

Each wrapper also adds the work of its call to :data:`WORK`, on either
route (the CPU tests see the same counts as the card): the bytes the
function must move (each input read once, each output written once) and
the operations it does, by the ``*_work`` formulas below, the ones
``chip_smoke.py`` bounds each kernel's time by. Where the work depends on
the data (the live buckets, the candidates a slab draws), the formulas take
the data's counts, and the wrappers pass the most the call's shapes allow:
reading the counts would stall the stream. The kernels launch through
pointers, so no dispatch mode sees them: the dry runs read their work here.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import ref

# launches per wrapper; "l2dist" counts both of its kernels (a tiled call
# is one launch, whatever its panels), and "l2dist_general" the general
# one alone, which only its witness wrapper launches; "slab_loop" counts
# the slab kernel's loop form, "slab_qualify" its one-step form
LAUNCHES: dict[str, int] = {"lsh_hash": 0, "hamming_to_buckets": 0,
                            "query_lanes": 0, "l2dist": 0,
                            "l2dist_general": 0, "l2dist_rows": 0,
                            "adc_rows": 0, "adc_rows_q8": 0, "adc_batch": 0,
                            "adc_batch_q8": 0, "slab_qualify": 0,
                            "slab_loop": 0, "central_qualify": 0,
                            "cache_insert": 0, "neighbor_dists": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# per wrapper, its calls on either route and their summed work: "bytes"
# moved and "flops", the operations (integer compares for the Hamming
# distances and neighbor_dists); "slab_loop"'s is a bound, every lane
# drawing to its visit budget, since its steps are known only on the card
WORK: dict[str, dict[str, int]] = {name: {"calls": 0, "bytes": 0, "flops": 0}
                                   for name in LAUNCHES}


def reset_work() -> None:
    for w in WORK.values():
        w["calls"] = w["bytes"] = w["flops"] = 0


def _work(name: str, nbytes: int, flops: int) -> None:
    WORK[name]["calls"] += 1
    WORK[name]["bytes"] += int(nbytes)
    WORK[name]["flops"] += int(flops)


# ---- the work of a call: (bytes, operations) --------------------------------

def lsh_hash_work(n: int, d: int, f: int) -> tuple[int, int]:
    """x (N, d), a (d, F), b and w (F,) in; codes (N, F) out; a
    multiply-add a coordinate and function."""
    return 4 * (n * d + d * f + 2 * f + n * f), 2 * n * d * f


def hamming_to_buckets_work(nq: int, nl: int, nb: int, k: int,
                            live: int | None = None) -> tuple[int, int]:
    """The ``live`` bucket rows' codes (every row: L·B), the query codes
    and n_buckets in; (Q, L, B) distances out; a compare and an add a
    function of each live pair."""
    live = nl * nb if live is None else live
    return (4 * (live * k + nq * nl * k + nl + nq * nl * nb),
            2 * nq * live * k)


def query_lanes_work(nq: int, d: int, nl: int, nb: int, k: int,
                     live: int | None = None) -> tuple[int, int]:
    """:func:`lsh_hash_work` of the queries and
    :func:`hamming_to_buckets_work` against their codes, the codes
    written once."""
    f = nl * k
    live = nl * nb if live is None else live
    return (4 * (nq * d + d * f + 2 * f + live * k + nl + nq * nl * k
                 + nq * nl * nb),
            2 * nq * d * f + 2 * nq * live * k)


def l2dist_work(n: int, nq: int, d: int) -> tuple[int, int]:
    """x (N, d) and q (Q, d) in, (N, Q) out; a multiply-add a
    coordinate of each pair."""
    return 4 * (n * d + nq * d + n * nq), 2 * n * nq * d


def l2dist_rows_work(r: int, c: int, d: int,
                     rows: int | None = None) -> tuple[int, int]:
    """ids (R, c), the ``rows`` distinct drawn rows (every draw: R·c),
    the queries (R, d) in; (R, c) out."""
    rows = r * c if rows is None else rows
    return 4 * (r * c + rows * d + r * d + r * c), 2 * r * c * d


def adc_batch_work(nq: int, n: int, cb: int, m: int, lut_bytes: int,
                   out_bytes: int) -> tuple[int, int]:
    """codes (N, cb bytes), the Q LUTs (``lut_bytes`` in all) in; (Q, N)
    sums of ``out_bytes`` out; a lookup-add a subspace of each pair."""
    return n * cb + lut_bytes + nq * n * out_bytes, nq * n * m


def adc_rows_work(r: int, c: int, cb: int, m: int, lut_bytes: int,
                  luts: int | None = None) -> tuple[int, int]:
    """ids (R, c), the gathered code rows, the ``luts`` distinct LUTs the
    lanes read (of ``lut_bytes`` each; at most one a lane), lane_q and the
    (R, c) sums out."""
    luts = r if luts is None else luts
    return r * c * (4 + cb + 4) + r * 4 + luts * lut_bytes, r * c * m


def slab_qualify_work(na: int, d: int, exact_rows: int, exact_lanes: int,
                      adc_rows: int = 0, adc_lanes: int = 0, cb: int = 0,
                      lut_bytes: int = 0, m: int = 0) -> tuple[int, int]:
    """A slab step of ``na`` lanes: a candidate qualified exactly reads
    its row, one by ADC its code row (``cb`` bytes, the residual
    included), and each its starts and order entries and one 32-byte
    sector of the cumsum around the draw; a lane reads its query row or
    LUT, and its state, constants and outputs (104 bytes). Operations: a
    subtract and a multiply-add a coordinate, or a lookup-add a
    subspace."""
    nbytes = (exact_rows * (4 * d + 40) + adc_rows * (cb + 40)
              + exact_lanes * 4 * d + adc_lanes * lut_bytes + na * 104)
    return nbytes, exact_rows * 3 * d + adc_rows * m


def central_qualify_work(nql: int, k: int, d: int, exact: bool,
                         lut_bytes: int, m: int, row_bytes: int,
                         seen: int, distinct: int | None = None
                         ) -> tuple[int, int]:
    """Alg. 3 for ``nql`` lanes: per lane its code and table, the matched
    bucket's code, start and size, its query row (or LUT and threshold),
    τ² and the outputs; per slot of a distinct (table, bucket) its order
    entry and row (``row_bytes``); ``seen`` candidates qualified in all
    (``distinct`` of them in distinct buckets: all by default)."""
    distinct = seen if distinct is None else distinct
    per_lane = (4 * k + 8 + 4 * k + 8 + (4 * d if exact else lut_bytes + 4)
                + 4 + 12)
    return (nql * per_lane + distinct * (4 + row_bytes),
            seen * (3 * d if exact else m))


def cache_insert_work(s: int, n: int, nl: int, k: int, match_qhash: bool,
                      active: int | None = None,
                      tau_hits: int | None = None,
                      code_hits: int | None = None,
                      changed: int | None = None,
                      cleared: int | None = None) -> tuple[int, int]:
    """The CLOCK insert of ``n`` lanes (``active`` of them) into S
    entries: valid and tau_key of every entry; the codes of the
    ``tau_hits`` entries whose tau key is an active lane's, the
    fingerprints of the ``code_hits`` whose codes match too (with
    ``match_qhash``); ref up to each victim (``cleared`` bits and the
    ``changed`` entries); the active lanes; each written entry and
    cleared bit. The defaults are the most the shapes allow."""
    active = n if active is None else active
    tau_hits = s if tau_hits is None else tau_hits
    code_hits = s if code_hits is None else code_hits
    changed = min(n, s) if changed is None else changed
    cleared = s if cleared is None else cleared
    entry = 4 * nl * k + 8 * nl + 38
    lane = 4 * nl * k + 8 * nl + 28
    nbytes = (5 * s + 4 * nl * k * tau_hits
              + (16 * code_hits if match_qhash else 0)
              + cleared + changed
              + active * lane + n + 8
              + changed * entry + cleared + 8)
    return nbytes, 0


def neighbor_dists_work(b: int, k: int, n_valid: int, r0: int = 0,
                        r1: int | None = None) -> tuple[int, int]:
    """The whole (B, B) table: every entry written once, every code read
    once, the live pairs' compares; a strip of rows [r0, r1): its entries
    in the row and column strips, the live codes, the new rows' compares
    against the live ones."""
    r1 = b if r1 is None else r1
    if r0 == 0 and r1 == b:
        return b * b + 4 * b * k, n_valid * n_valid * k
    r = r1 - r0
    return r * (2 * b - r) + 4 * n_valid * k, r * n_valid * k


# a block's shared memory on the H100: 227 KB
_SMEM_LIMIT = 232448


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA must exist if asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev


def _on_cpu(*ts: torch.Tensor) -> bool:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch(name: str, fn, *args) -> None:
    from repro_torch.kernels import build
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(build.load().lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def lsh_hash(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """x (N, d), a (d, F), b (F,), w (F,) float32 → codes (N, F) int32,
    ``floor((x @ a + b*w) / w)``."""
    _work("lsh_hash", *lsh_hash_work(x.shape[0], x.shape[-1], a.shape[-1]))
    if _on_cpu(x, a, b, w):
        return ref.lsh_hash(x, a, b, w)
    for t, nm, nd in ((x, "x", 2), (a, "a", 2), (b, "b", 1), (w, "w", 1)):
        _check(t, nm, torch.float32, nd)
    n, d = x.shape
    f = a.shape[1]
    if a.shape[0] != d or b.shape[0] != f or w.shape[0] != f:
        raise ValueError(f"shapes x{tuple(x.shape)} a{tuple(a.shape)} "
                         f"b{tuple(b.shape)} w{tuple(w.shape)}")
    if not 0 < f <= 1024:
        raise ValueError(f"lsh_hash takes 1..1024 functions, got {f}")
    if (d * f + 64 * 64) * 4 > 227 * 1024:
        raise ValueError(f"a ({d}, {f}) does not fit shared memory")
    out = torch.empty((n, f), dtype=torch.int32, device=x.device)
    if n:
        _launch("lsh_hash", "lsh_hash_f32", x.data_ptr(), a.data_ptr(),
                b.data_ptr(), w.data_ptr(), out.data_ptr(), n, d, f)
    return out


def hamming_to_buckets(bucket_codes: torch.Tensor, qcodes: torch.Tensor,
                       n_buckets: torch.Tensor) -> torch.Tensor:
    """bucket_codes (L, B, K), qcodes (Q, L, K), n_buckets (L,) int32 →
    (Q, L, B) int32 Hamming distances; rows ``b >= n_buckets[l]`` get K+1."""
    _work("hamming_to_buckets", *hamming_to_buckets_work(
        qcodes.shape[0], *bucket_codes.shape))
    if _on_cpu(bucket_codes, qcodes, n_buckets):
        return ref.hamming_to_buckets(bucket_codes, qcodes, n_buckets)
    _check(bucket_codes, "bucket_codes", torch.int32, 3)
    _check(qcodes, "qcodes", torch.int32, 3)
    _check(n_buckets, "n_buckets", torch.int32, 1)
    nl, nb, k = bucket_codes.shape
    nq = qcodes.shape[0]
    if qcodes.shape[1:] != (nl, k) or n_buckets.shape[0] != nl:
        raise ValueError(f"shapes bucket_codes{tuple(bucket_codes.shape)} "
                         f"qcodes{tuple(qcodes.shape)} "
                         f"n_buckets{tuple(n_buckets.shape)}")
    if not 0 < k <= 32:
        raise ValueError(f"hamming_to_buckets takes 1..32 functions, got {k}")
    if nq * k * 4 > 200 * 1024:
        raise ValueError(f"{nq} query codes of {k} do not fit shared memory")
    out = torch.empty((nq, nl, nb), dtype=torch.int32,
                      device=bucket_codes.device)
    if nq and nl and nb:
        _launch("hamming_to_buckets", "hamming_to_buckets_i32",
                bucket_codes.data_ptr(), qcodes.data_ptr(),
                n_buckets.data_ptr(), out.data_ptr(), nq, nl, nb, k)
    return out


# query_lanes' blocks share one hash over a cluster of 4 (CLUSTER in
# csrc/hamming.cu); a block stages at most ~32 KB of query rows at a time
_LANES_CLUSTER, _LANES_STAGE = 4, 32 * 1024


def query_lanes_smem(nq: int, k: int, d: int, qch: int, pad: int) -> int:
    """Shared memory of one ``query_lanes`` block (``lanes_smem`` in
    ``csrc/hamming.cu``): the (Q, K) codes, table l's (d, K) columns of
    ``a`` and ``qch`` staged query rows of d + ``pad`` floats."""
    return _align16(4 * nq * k) + _align16(4 * d * k) + 4 * qch * (d + pad)


def query_lanes(qs: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                w: torch.Tensor, bucket_codes: torch.Tensor,
                n_buckets: torch.Tensor,
                workers: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """qs (Q, d), a (d, L·K), b (L·K,), w (L·K,) float32; bucket_codes
    (L, B, K), n_buckets (L,) int32 → ``(qcodes (Q, L, K), ham (Q, L, B))``
    int32 in one launch: the codes of :func:`lsh_hash` (bit-equal to it)
    and the distances of :func:`hamming_to_buckets` against them.
    The grid has one block per 256-row bucket tile; ``workers`` (per table,
    rounded up to the cluster of 4; 0: 16 per SM over the L tables) is how
    many of them scan the live tiles and hash. The results are the same
    for every value."""
    _work("query_lanes", *query_lanes_work(*qs.shape, *bucket_codes.shape))
    if _on_cpu(qs, a, b, w, bucket_codes, n_buckets):
        return ref.query_lanes(qs, a, b, w, bucket_codes, n_buckets)
    for t, nm, nd in ((qs, "qs", 2), (a, "a", 2), (b, "b", 1), (w, "w", 1)):
        _check(t, nm, torch.float32, nd)
    _check(bucket_codes, "bucket_codes", torch.int32, 3)
    _check(n_buckets, "n_buckets", torch.int32, 1)
    nq, d = qs.shape
    nl, nb, k = bucket_codes.shape
    f = nl * k
    if (a.shape != (d, f) or b.shape != (f,) or w.shape != (f,)
            or n_buckets.shape != (nl,)):
        raise ValueError(f"shapes qs{tuple(qs.shape)} a{tuple(a.shape)} "
                         f"b{tuple(b.shape)} w{tuple(w.shape)} bucket_codes"
                         f"{tuple(bucket_codes.shape)} n_buckets"
                         f"{tuple(n_buckets.shape)}")
    if not 0 < k <= 32 or nl > 65535 or workers < 0:
        raise ValueError(f"query_lanes takes 1..32 functions, at most "
                         f"65535 tables and workers >= 0, got K={k}, L={nl}, "
                         f"workers={workers}")
    vec = int(d % 4 == 0 and qs.data_ptr() % 16 == 0)
    pad = 4 if vec else 1
    per = -(-nq // _LANES_CLUSTER)
    room = (_SMEM_LIMIT - query_lanes_smem(nq, k, d, 0, pad)) // (4 * (d + pad))
    qch = min(per, room, max(1, _LANES_STAGE // (4 * (d + pad))))
    qcodes = torch.empty((nq, nl, k), dtype=torch.int32, device=qs.device)
    ham = torch.empty((nq, nl, nb), dtype=torch.int32, device=qs.device)
    if nq and nl:
        if qch < 1:
            raise ValueError(f"{nq} query codes of {k} and a ({d}, {k}) "
                             "table of a do not fit shared memory")
        _launch("query_lanes", "query_lanes_i32", qs.data_ptr(),
                a.data_ptr(), b.data_ptr(), w.data_ptr(),
                bucket_codes.data_ptr(), n_buckets.data_ptr(),
                qcodes.data_ptr(), ham.data_ptr(), nq, nl, nb, k, d, qch, vec,
                workers)
    return qcodes, ham


def hamming(bucket_codes: torch.Tensor, qcode: torch.Tensor) -> torch.Tensor:
    """The reference kernel's own form: (B, K), (K,) → (B,) mismatch
    counts. It is the Q = L = 1 case of :func:`hamming_to_buckets` with
    every row valid."""
    nb = torch.tensor([bucket_codes.shape[0]], dtype=torch.int32,
                      device=bucket_codes.device)
    return hamming_to_buckets(bucket_codes[None].contiguous(),
                              qcode[None, None].contiguous(), nb)[0, 0]


# l2dist's tiled kernel (``l2dist_f32`` in csrc/l2dist.cu): tiles of 128
# rows and 64 queries, x staged in chunks of 64 floats of k (rows padded to
# 68 floats) through a ring of 2 stages; the query tile of a panel of k,
# at most 9 chunks, stays resident
_L2_ROWS, _L2_QT, _L2_KC, _L2_STAGES = 128, 64, 64, 2
_L2_RING = _L2_STAGES * _L2_ROWS * (_L2_KC + 4)
_L2_MAX_CHUNKS = (_SMEM_LIMIT // 4 - _L2_RING) // (_L2_KC * _L2_QT)


class L2Plan(NamedTuple):
    """How ``l2dist_f32`` covers an (N, Q) output; the fields are its
    arguments, in order."""
    row_tiles: int      # 128-row tiles of x
    q_tiles: int        # 64-query tiles of q, each resident in one block
    panels: int         # panels of k, each a query tile of its own
    chunks: int         # chunks of 64 floats of k a panel (the last fewer)
    width: int          # bytes a copy of x and q: 16, 8 or 4
    smem: int           # dynamic shared memory of one block, bytes


def l2dist_smem(chunks: int) -> int:
    """Shared memory of one tiled ``l2dist`` block (``tiled_smem`` in
    ``csrc/l2dist.cu``): a panel's query tile of ``chunks`` chunks of 64
    floats of k, transposed, and the ring of staged row chunks."""
    return 4 * (chunks * _L2_KC * _L2_QT + _L2_RING)


def l2dist_plan(n: int, nq: int, d: int, x_ptr: int,
                q_ptr: int) -> L2Plan | None:
    """The tiled kernel's plan for x (N, d) and q (Q, d) at these
    addresses, or None where d is 0 or Q needs more than 65,535 query
    tiles. d is cut into the fewest panels of at most 9 chunks, of equal
    chunks; x and q are copied in the widest pieces (16, 8 or 4 bytes)
    that the row width and both addresses allow (the kernel refuses an
    address that is not 4-byte aligned). Ragged N and Q are masked by the
    kernel."""
    q_tiles = -(-nq // _L2_QT)
    if q_tiles > 65535 or d < 1:
        return None
    kch = -(-d // _L2_KC)
    panels = -(-kch // _L2_MAX_CHUNKS)
    chunks = -(-kch // panels)
    width = next((w for w in (16, 8) if (4 * d) % w == 0
                  and x_ptr % w == 0 and q_ptr % w == 0), 4)
    return L2Plan(-(-n // _L2_ROWS), q_tiles, -(-kch // chunks), chunks,
                  width, l2dist_smem(chunks))


def _l2dist_args(x: torch.Tensor, q: torch.Tensor) -> tuple[int, int, int]:
    _check(x, "x", torch.float32, 2)
    _check(q, "q", torch.float32, 2)
    if q.shape[1] != x.shape[1]:
        raise ValueError(f"shapes x{tuple(x.shape)} q{tuple(q.shape)}")
    return x.shape[0], q.shape[0], x.shape[1]


def l2dist(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """x (N, d), q (Q, d) float32 → (N, Q) squared distances Σ(x−q)²,
    through the tiled kernel at every shape :func:`l2dist_plan` covers; a
    shape it does not cover raises."""
    _work("l2dist", *l2dist_work(x.shape[0], q.shape[0], x.shape[-1]))
    if _on_cpu(x, q):
        return ref.l2dist(x, q)
    n, nq, d = _l2dist_args(x, q)
    out = torch.empty((n, nq), dtype=torch.float32, device=x.device)
    if n and nq:
        plan = l2dist_plan(n, nq, d, x.data_ptr(), q.data_ptr())
        if plan is None:
            raise ValueError(f"l2dist: no tiled plan for x{tuple(x.shape)} "
                             f"q{tuple(q.shape)}")
        _launch("l2dist", "l2dist_f32", x.data_ptr(), q.data_ptr(),
                out.data_ptr(), n, nq, d, *plan)
    return out


def l2dist_general(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """:func:`l2dist` through the general kernel (the first port) at any
    shape: no path runs it; it is the bit-equality witness the card's
    checks hold the tiled kernel against. Counted in ``"l2dist"`` and in
    ``"l2dist_general"``."""
    for name in ("l2dist", "l2dist_general"):
        _work(name, *l2dist_work(x.shape[0], q.shape[0], x.shape[-1]))
    if _on_cpu(x, q):
        return ref.l2dist(x, q)
    n, nq, d = _l2dist_args(x, q)
    out = torch.empty((n, nq), dtype=torch.float32, device=x.device)
    if n and nq:
        _launch("l2dist", "l2dist_general_f32", x.data_ptr(), q.data_ptr(),
                out.data_ptr(), n, nq, d)
        LAUNCHES["l2dist_general"] += 1
    return out


def l2dist_rows(x: torch.Tensor, ids: torch.Tensor,
                qs: torch.Tensor) -> torch.Tensor:
    """x (C, d) float32, ids (R, c) int32, qs (R, d) float32 → (R, c)
    squared distances of the gathered rows ``x[ids[r]]`` to ``qs[r]``, in
    the order of ``ids``; the gather is fused, so the rows never pass
    through device memory. Every id must lie in [0, C). The kernel runs
    chunks of draws across all R rows at once, so ids in ascending order
    within each row read the rows several pairs draw from L2."""
    _work("l2dist_rows", *l2dist_rows_work(*ids.shape, x.shape[-1]))
    if _on_cpu(x, ids, qs):
        return ref.l2dist_rows(x, ids, qs)
    _check(x, "x", torch.float32, 2)
    _check(ids, "ids", torch.int32, 2)
    _check(qs, "qs", torch.float32, 2)
    nr, c = ids.shape
    d = x.shape[1]
    if qs.shape != (nr, d):
        raise ValueError(f"shapes x{tuple(x.shape)} ids{tuple(ids.shape)} "
                         f"qs{tuple(qs.shape)}")
    if 4 * d > _SMEM_LIMIT:
        raise ValueError(f"l2dist_rows: a query of {d} floats does not fit "
                         "shared memory")
    out = torch.empty((nr, c), dtype=torch.float32, device=x.device)
    vec = int(d % 4 == 0 and x.data_ptr() % 16 == 0
              and qs.data_ptr() % 16 == 0)
    if nr and c:
        _launch("l2dist_rows", "l2dist_rows_f32", x.data_ptr(),
                ids.data_ptr(), qs.data_ptr(), out.data_ptr(), nr, c, d, vec)
    return out


# ---- ADC (Alg. 5) --------------------------------------------------------

# code row bytes the kernels hold in registers; with Kc <= 256 this bounds
# one LUT by 64 x 256 x 4 bytes = 64 KB, which fits a block's shared memory
_MAX_CODE_BYTES = 64


def _adc_layout(codes: torch.Tensor, luts: torch.Tensor,
                lut_dtype: torch.dtype) -> tuple[int, int, int, int, int]:
    """Checks of the ADC kernels' inputs; returns (m, kc, code bytes,
    packed, alignment of the code rows)."""
    _check(codes, "codes", torch.uint8, 2)
    _check(luts, "luts", lut_dtype, 3)
    _, m, kc = luts.shape
    cb = codes.shape[1]
    packed = cb != m
    if packed and (2 * cb != m or kc > 16):
        raise ValueError(f"codes of width {cb} fit neither M={m} byte codes "
                         f"nor M/2 packed 4-bit codes (Kc={kc} <= 16)")
    if not 0 < kc <= 256 or not 0 < cb <= _MAX_CODE_BYTES:
        raise ValueError(f"ADC kernels take Kc in 1..256 and code rows of "
                         f"1..{_MAX_CODE_BYTES} bytes, got Kc={kc}, {cb}")
    ptr = codes.data_ptr()
    align = 16 if cb % 16 == 0 and ptr % 16 == 0 else \
        4 if cb % 4 == 0 and ptr % 4 == 0 else 1
    return m, kc, cb, int(packed), align


def _adc_rows_work(name: str, codes, ids, luts) -> None:
    r, c = ids.shape
    _work(name, *adc_rows_work(r, c, codes.shape[-1], luts.shape[1],
                               luts[0].numel() * luts.element_size(),
                               min(r, luts.shape[0])))


def _adc_batch_work(name: str, codes, luts) -> None:
    _work(name, *adc_batch_work(luts.shape[0], *codes.shape, luts.shape[1],
                                luts.numel() * luts.element_size(), 4))


def _adc_rows(name: str, fn: str, lut_dtype, out_dtype, codes, ids, luts,
              lane_q):
    m, kc, cb, packed, align = _adc_layout(codes, luts, lut_dtype)
    _check(ids, "ids", torch.int32, 2)
    _check(lane_q, "lane_q", torch.int32, 1)
    nr, c = ids.shape
    if lane_q.shape[0] != nr:
        raise ValueError(f"lane_q{tuple(lane_q.shape)} for ids"
                         f"{tuple(ids.shape)}")
    out = torch.empty((nr, c), dtype=out_dtype, device=codes.device)
    if nr and c:
        _launch(name, fn, codes.data_ptr(), ids.data_ptr(), luts.data_ptr(),
                lane_q.data_ptr(), out.data_ptr(), nr, c, cb, m, kc, packed,
                align)
    return out


def adc_rows(codes: torch.Tensor, ids: torch.Tensor, luts: torch.Tensor,
             lane_q: torch.Tensor) -> torch.Tensor:
    """codes (C, M) uint8, or (C, M/2) packed 4-bit codes; ids (R, c)
    int32; luts (Q, M, Kc) float32; lane_q (R,) int32 → (R, c) float32:
    row r, candidate i is Σ_m luts[lane_q[r], m, codes[ids[r, i], m]]. The
    gather is fused. Every id must lie in [0, C), every lane_q in [0, Q)
    and every code below Kc."""
    _adc_rows_work("adc_rows", codes, ids, luts)
    if _on_cpu(codes, ids, luts, lane_q):
        return ref.adc_rows(codes, ids, luts, lane_q)
    return _adc_rows("adc_rows", "adc_rows_f32", torch.float32,
                     torch.float32, codes, ids, luts, lane_q)


def adc_rows_q8(codes: torch.Tensor, ids: torch.Tensor, qluts: torch.Tensor,
                lane_q: torch.Tensor) -> torch.Tensor:
    """:func:`adc_rows` of uint8 LUTs (Q, M, Kc) → (R, c) int32 sums."""
    _adc_rows_work("adc_rows_q8", codes, ids, qluts)
    if _on_cpu(codes, ids, qluts, lane_q):
        return ref.adc_rows_q8(codes, ids, qluts, lane_q)
    return _adc_rows("adc_rows_q8", "adc_rows_u8", torch.uint8, torch.int32,
                     codes, ids, qluts, lane_q)


# adc_batch's blocks: 512 threads
_BATCH_WARPS = 16


def _align16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def adc_batch_smem(q8: bool, m: int, kc: int, cb: int, lg: int,
                   lrb: int) -> int:
    """Shared memory of one ``adc_batch`` block (``batch_smem`` in
    ``csrc/adc.cu``): the query tile's LUTs, G = 2^lg words per (m, c);
    two code tiles of 2^lrb rows, each row padded to 16 bytes; the
    (queries × rows) output tile."""
    g, rb, cbs = 1 << lg, 1 << lrb, _align16(cb)
    out = rb * (g + 1) * 16 if q8 else g * (rb + 32 // g) * 4
    return _align16(m * kc * 4 * g) + 2 * _align16(rb * cbs) + out


def adc_batch_plan(nq: int, m: int, kc: int, cb: int,
                   q8: bool) -> tuple[int, int]:
    """``adc_batch``'s tiles ``(lg, lrb)``: the widest query tile that fits
    (G = 2^lg LUT words per (m, c), G <= 16 and no wider than the Q queries
    need; a word holds one float query or four uint8 ones), then the longest
    row tile, 2^lrb <= 512 rows and at least the 16 · 32/G rows the block's
    lanes hold at once."""
    qpw = 4 if q8 else 1
    top = 0
    while top < 4 and qpw << top < nq:
        top += 1
    for lg in range(top, -1, -1):
        for lrb in range(9, -1, -1):
            if 1 << lrb < _BATCH_WARPS * (32 >> lg):
                break
            if adc_batch_smem(q8, m, kc, cb, lg, lrb) <= _SMEM_LIMIT:
                return lg, lrb
    raise ValueError(f"no adc_batch tile fits shared memory at M={m}, "
                     f"Kc={kc}, {cb}-byte codes")


def _adc_batch(name: str, fn: str, lut_dtype, out_dtype, codes, luts):
    m, kc, cb, packed, align = _adc_layout(codes, luts, lut_dtype)
    n, nq = codes.shape[0], luts.shape[0]
    out = torch.empty((nq, n), dtype=out_dtype, device=codes.device)
    if n and nq:
        lg, lrb = adc_batch_plan(nq, m, kc, cb, lut_dtype == torch.uint8)
        _launch(name, fn, codes.data_ptr(), luts.data_ptr(), out.data_ptr(),
                n, nq, cb, m, kc, packed, lg, lrb, align)
    return out


def adc_batch(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """codes (N, M) uint8, or (N, M/2) packed 4-bit codes; luts (Q, M, Kc)
    float32 → (Q, N) float32 ADC distances, one pass over the codes for
    all Q queries. Every code must lie below Kc."""
    _adc_batch_work("adc_batch", codes, luts)
    if _on_cpu(codes, luts):
        return ref.adc_batch(codes, luts)
    return _adc_batch("adc_batch", "adc_batch_f32", torch.float32,
                      torch.float32, codes, luts)


def adc_batch_q8(codes: torch.Tensor, qluts: torch.Tensor) -> torch.Tensor:
    """:func:`adc_batch` of uint8 LUTs (Q, M, Kc) → (Q, N) int32 sums."""
    _adc_batch_work("adc_batch_q8", codes, qluts)
    if _on_cpu(codes, qluts):
        return ref.adc_batch_q8(codes, qluts)
    return _adc_batch("adc_batch_q8", "adc_batch_u8", torch.uint8,
                      torch.int32, codes, qluts)


def _byte_codes(codes: torch.Tensor) -> torch.Tensor:
    """The reference forms take codes of any integer type below 256."""
    if codes.dtype != torch.uint8:
        if codes.numel() and (int(codes.min()) < 0 or int(codes.max()) > 255):
            raise ValueError("codes must lie in [0, 256)")
        codes = codes.to(torch.uint8)
    return codes.contiguous()


def adc(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """The reference kernel's own form: codes (N, M) integers below 256,
    lut (M, Kc) float32 → (N,). The Q = 1 call of :func:`adc_batch`."""
    return adc_batch(_byte_codes(codes), lut[None].contiguous())[0]


def adc_q8(codes: torch.Tensor, qlut: torch.Tensor) -> torch.Tensor:
    """codes (N, M), qlut (M, Kc) uint8 → (N,) int32: the Q = 1 call of
    :func:`adc_batch_q8`."""
    return adc_batch_q8(_byte_codes(codes), qlut[None].contiguous())[0]


# ---- the prober's slab step (Alg. 2 body) --------------------------------

class Qual(NamedTuple):
    """What candidates qualify by, per lane (lane i of Q·L holds query
    ``lane_q[i]``). Without ``codes`` every candidate qualifies exactly,
    1[d² <= τ²]; with PQ codes rings above ``exact_rings`` qualify by ADC
    through the lane's LUT: a hard threshold, the banded weight when
    ``resid`` is given, or int32 sums of a uint8 LUT against ``thresh``."""
    x: torch.Tensor                      # (C, d) float32 corpus rows
    qs: torch.Tensor                     # (QL, d) float32 each lane's query
    tau_sq: torch.Tensor                 # (QL,) float32 each lane's τ²
    codes: torch.Tensor | None = None    # (C, M) uint8, or (C, M/2) packed
    luts: torch.Tensor | None = None     # (Q, M, Kc) float32 or uint8
    lane_q: torch.Tensor | None = None   # (QL,) int32 each lane's LUT
    resid: torch.Tensor | None = None    # (C,) float32: banded float ADC
    thresh: torch.Tensor | None = None   # (QL,) int32: uint8 thresholds
    exact_rings: int = 0                 # rings k <= this qualify exactly


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _qual_adc(qual: Qual, nql: int,
              n_points: int) -> tuple[int, int, int, int, int, int, int]:
    """Checks of a :class:`Qual`'s ADC inputs for ``nql`` lanes over
    ``n_points`` points; returns the kernels' (mode, m, kc, code bytes,
    packed, alignment, LUT bytes), mode 0 (no codes: exact only), 1
    (float32 LUTs) or 2 (uint8 LUTs with thresholds)."""
    if qual.codes is None:
        return 0, 0, 0, 0, 0, 0, 0
    q8 = qual.thresh is not None
    m, kc, cb, packed, align = _adc_layout(
        qual.codes, qual.luts, torch.uint8 if q8 else torch.float32)
    _check(qual.lane_q, "lane_q", torch.int32, 1)
    if qual.lane_q.shape[0] != nql or qual.codes.shape[0] < n_points:
        raise ValueError(f"lane_q{tuple(qual.lane_q.shape)} and codes"
                         f"{tuple(qual.codes.shape)} for {nql} lanes "
                         f"and {n_points} points")
    if q8:
        _check(qual.thresh, "thresh", torch.int32, 1)
        if qual.thresh.shape[0] != nql or qual.resid is not None:
            raise ValueError("uint8 LUTs take (QL,) thresholds and no "
                             "residuals")
    elif qual.resid is not None:
        _check(qual.resid, "resid", torch.float32, 1)
        if qual.resid.shape[0] != qual.codes.shape[0]:
            raise ValueError(f"resid{tuple(qual.resid.shape)} for codes"
                             f"{tuple(qual.codes.shape)}")
    mode = 2 if q8 else 1
    lut_bytes = m * kc * qual.luts.element_size()
    return mode, m, kc, cb, packed, align, lut_bytes


def _slab_work(na: int, rows: int, qual: Qual) -> tuple[int, int]:
    """:func:`slab_qualify_work` of ``na`` lanes drawing ``rows``
    candidates, all exact or, with PQ codes, all by ADC, whichever costs
    more."""
    d = qual.x.shape[-1]
    w = slab_qualify_work(na, d, rows, na)
    if qual.codes is not None:
        # rings above exact_rings qualify by ADC: each at the larger cost
        w = tuple(map(max, w, slab_qualify_work(
            na, d, 0, 0, rows, na,
            qual.codes.shape[1] + 4 * (qual.resid is not None),
            math.prod(qual.luts.shape[1:]) * qual.luts.element_size(),
            qual.luts.shape[1])))
    return w


def _slab_plan(chunk: int, d: int, lut_bytes: int) -> tuple[int, int]:
    """The slab kernel's blocks a lane and dynamic shared memory: a lane's
    chunk is split over up to 4 blocks (one cluster) of <= 128 slots each
    where it can be; a block's dynamic shared memory holds the lane's query
    row or LUT, then an id and a weight per slot."""
    splits = min(4, -(-chunk // 128))
    slots = -(-chunk // splits)
    smem = _align16(8 * slots) + _align16(max(4 * d, lut_bytes))
    if smem > 200 * 1024:
        raise ValueError(f"d={d}, a {lut_bytes}-byte LUT and {slots} slots "
                         "per block do not fit shared memory")
    return splits, smem


def slab_qualify(k: torch.Tensor, ci: torch.Tensor, lanes: torch.Tensor,
                 tid: torch.Tensor, rks: torch.Tensor, prings: torch.Tensor,
                 caps: torch.Tensor, nbits: torch.Tensor, cums: torch.Tensor,
                 starts: torch.Tensor, order: torch.Tensor, qual: Qual,
                 chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One progressive-sampling slab for A active lanes, candidate walk and
    qualification fused: ``(wq_add (A,) float32, w_add (A,) int32)``.

    Lane ``a`` (lane id ``lanes[a]``, table ``tid[a]``, both int64) in ring
    ``kc = min(k[a], K)`` draws slots ``ci[a]·chunk + s`` of its PRP (round
    keys ``rks`` (A, 6) int64; ring tables ``prings``/``caps``/``nbits``
    (A, K) int32), resolves each draw through row ``cums[lanes[a], kc]`` of
    the (QL, K+1, B) ring cumsums and the CSR arrays ``starts`` (L, B) and
    ``order`` (L, C), qualifies the candidates as ``qual`` routes ring
    ``kc``, and sums their weights and count. Every lane and table id must
    lie in range.
    """
    na = prings.shape[0]
    _work("slab_qualify", *_slab_work(na, na * chunk, qual))
    opt = [t for t in qual[3:8] if t is not None]
    if _on_cpu(k, ci, lanes, tid, rks, prings, caps, nbits, cums, starts,
               order, qual.x, qual.qs, qual.tau_sq, *opt):
        return ref.slab_qualify(k, ci, lanes, tid, rks, prings, caps, nbits,
                                cums, starts, order, qual, chunk)
    for t, nm in ((k, "k"), (ci, "ci")):
        _check(t, nm, torch.int32, 1)
    for t, nm in ((lanes, "lanes"), (tid, "tid")):
        _check(t, nm, torch.int64, 1)
    _check(rks, "rks", torch.int64, 2)
    for t, nm in ((prings, "prings"), (caps, "caps"), (nbits, "nbits")):
        _check(t, nm, torch.int32, 2)
    _check(cums, "cums", torch.int32, 3)
    _check(starts, "starts", torch.int32, 2)
    _check(order, "order", torch.int32, 2)
    _check(qual.x, "x", torch.float32, 2)
    _check(qual.qs, "qs", torch.float32, 2)
    _check(qual.tau_sq, "tau_sq", torch.float32, 1)
    na, n_rings = prings.shape
    nql, _, nb = cums.shape
    nl, n_points = order.shape
    d = qual.x.shape[1]
    if (k.shape[0] != na or ci.shape[0] != na or lanes.shape[0] != na
            or tid.shape[0] != na or rks.shape != (na, 6)
            or caps.shape != prings.shape or nbits.shape != prings.shape
            or cums.shape[1] != n_rings + 1 or starts.shape != (nl, nb)
            or qual.x.shape[0] < n_points or qual.qs.shape != (nql, d)
            or qual.tau_sq.shape != (nql,)):
        shapes = {nm: tuple(t.shape) for nm, t in (
            ("k", k), ("ci", ci), ("lanes", lanes), ("tid", tid),
            ("rks", rks), ("prings", prings), ("caps", caps),
            ("nbits", nbits), ("cums", cums), ("starts", starts),
            ("order", order), ("x", qual.x), ("qs", qual.qs),
            ("tau_sq", qual.tau_sq))}
        raise ValueError(f"slab_qualify shapes do not agree: {shapes}")
    if n_rings < 1 or chunk < 1:
        raise ValueError(f"slab_qualify needs K >= 1 rings and chunk >= 1, "
                         f"got K={n_rings}, chunk={chunk}")
    mode, m, kc, cb, packed, align, lut_bytes = _qual_adc(qual, nql,
                                                          n_points)
    splits, smem = _slab_plan(chunk, d, lut_bytes)
    vec = int(d % 4 == 0 and qual.x.data_ptr() % 16 == 0)
    wq_add = torch.empty(na, dtype=torch.float32, device=k.device)
    w_add = torch.empty(na, dtype=torch.int32, device=k.device)
    if na:
        _launch("slab_qualify", "slab_qualify", k.data_ptr(), ci.data_ptr(),
                lanes.data_ptr(), tid.data_ptr(), rks.data_ptr(),
                prings.data_ptr(), caps.data_ptr(), nbits.data_ptr(),
                cums.data_ptr(), starts.data_ptr(), order.data_ptr(),
                qual.x.data_ptr(), qual.qs.data_ptr(), qual.tau_sq.data_ptr(),
                _ptr(qual.codes), _ptr(qual.luts), _ptr(qual.lane_q),
                _ptr(qual.resid), _ptr(qual.thresh), wq_add.data_ptr(),
                w_add.data_ptr(), na, n_rings, nb, n_points, d, chunk,
                qual.exact_rings, mode, cb, m, kc, packed, align, vec, splits,
                smem)
    return wq_add, w_add


# the slab loop's per-lane state, in the kernel's order, with its dtypes
LOOP_STATE = (("k", torch.int32), ("ci", torch.int32), ("w", torch.int32),
              ("wq", torch.float32), ("target", torch.float32),
              ("est", torch.float32), ("nvisited", torch.int32),
              ("ptf", torch.bool), ("done", torch.bool))


def slab_loop(state: dict, lanes: torch.Tensor, tid: torch.Tensor,
              rks: torch.Tensor, prings: torch.Tensor, caps: torch.Tensor,
              nbits: torch.Tensor, totals_f: torch.Tensor,
              w_caps: torch.Tensor, first_targets: torch.Tensor,
              cums: torch.Tensor, starts: torch.Tensor, order: torch.Tensor,
              qual: Qual, chunk: int, a_const: float, eps: float,
              visit_budget: int, schedule_checks: bool) -> torch.Tensor:
    """Alg. 2's slab loop for every lane in one launch, local stopping:
    each lane runs :func:`slab_qualify`'s step, then the stopping rule of
    ``prober._slab_step`` (without a process group), until it is done.
    Returns ``counts`` (QL, 3) int32: each lane's candidates qualified
    exactly, by ADC, and its slab steps.

    ``state`` maps the names of :data:`LOOP_STATE` to (QL,) tensors of
    their dtypes, read and written in place; the lanes' rows of the other
    arguments are ``slab_qualify``'s (``lanes`` and ``tid`` int64 for
    every lane, ``rks`` (QL, 6) int64, ``prings``/``caps``/``nbits`` (QL,
    K) int32), beside the ring tables ``totals_f``, ``w_caps`` and
    ``first_targets`` (QL, K) float32. ``a_const``, ``eps`` and the
    ``schedule_checks`` flag are the config's, ``visit_budget`` the lanes'
    budget. The card only: on the CPU the prober runs the host loop, whose
    step is :func:`slab_qualify`'s plain version."""
    for nm, dtype in LOOP_STATE:
        _check(state[nm], nm, dtype, 1)
    for t, nm in ((lanes, "lanes"), (tid, "tid")):
        _check(t, nm, torch.int64, 1)
    _check(rks, "rks", torch.int64, 2)
    for t, nm in ((prings, "prings"), (caps, "caps"), (nbits, "nbits")):
        _check(t, nm, torch.int32, 2)
    for t, nm in ((totals_f, "totals_f"), (w_caps, "w_caps"),
                  (first_targets, "first_targets")):
        _check(t, nm, torch.float32, 2)
    _check(cums, "cums", torch.int32, 3)
    _check(starts, "starts", torch.int32, 2)
    _check(order, "order", torch.int32, 2)
    _check(qual.x, "x", torch.float32, 2)
    _check(qual.qs, "qs", torch.float32, 2)
    _check(qual.tau_sq, "tau_sq", torch.float32, 1)
    nql, n_rings = prings.shape
    nb = cums.shape[-1]
    nl, n_points = order.shape
    d = qual.x.shape[1]
    tables = (prings, caps, nbits, totals_f, w_caps, first_targets)
    if (any(state[nm].shape != (nql,) for nm, _ in LOOP_STATE)
            or lanes.shape != (nql,) or tid.shape != (nql,)
            or rks.shape != (nql, 6)
            or any(t.shape != (nql, n_rings) for t in tables)
            or cums.shape != (nql, n_rings + 1, nb)
            or starts.shape != (nl, nb) or qual.x.shape[0] < n_points
            or qual.qs.shape != (nql, d) or qual.tau_sq.shape != (nql,)):
        shapes = {nm: tuple(t.shape) for nm, t in (
            *((nm, state[nm]) for nm, _ in LOOP_STATE), ("lanes", lanes),
            ("tid", tid), ("rks", rks), ("prings", prings), ("caps", caps),
            ("nbits", nbits), ("totals_f", totals_f), ("w_caps", w_caps),
            ("first_targets", first_targets), ("cums", cums),
            ("starts", starts), ("order", order), ("x", qual.x),
            ("qs", qual.qs), ("tau_sq", qual.tau_sq))}
        raise ValueError(f"slab_loop shapes do not agree: {shapes}")
    if n_rings < 1 or chunk < 1 or not 0 < visit_budget < 2 ** 31:
        raise ValueError(f"slab_loop needs K >= 1 rings, chunk >= 1 and a "
                         f"visit budget in [1, 2^31), got K={n_rings}, "
                         f"chunk={chunk}, budget={visit_budget}")
    opt = [t for t in qual[3:8] if t is not None]
    if _on_cpu(*(state[nm] for nm, _ in LOOP_STATE), lanes, tid, rks,
               *tables, cums, starts, order, qual.x, qual.qs, qual.tau_sq,
               *opt):
        raise ValueError("slab_loop runs on the card only; on the CPU the "
                         "prober steps the lanes itself")
    mode, m, kc, cb, packed, align, lut_bytes = _qual_adc(qual, nql,
                                                          n_points)
    splits, smem = _slab_plan(chunk, d, lut_bytes)
    vec = int(d % 4 == 0 and qual.x.data_ptr() % 16 == 0)
    # a lane draws fewer than visit_budget + chunk candidates: it stops at
    # the step that takes its samples to the budget
    _work("slab_loop", *_slab_work(nql, nql * (visit_budget + chunk - 1),
                                   qual))
    counts = torch.empty((nql, 3), dtype=torch.int32, device=lanes.device)
    if nql:
        _launch("slab_loop", "slab_loop",
                *(state[nm].data_ptr() for nm, _ in LOOP_STATE),
                lanes.data_ptr(), tid.data_ptr(), rks.data_ptr(),
                *(t.data_ptr() for t in tables), cums.data_ptr(),
                starts.data_ptr(), order.data_ptr(), qual.x.data_ptr(),
                qual.qs.data_ptr(), qual.tau_sq.data_ptr(), _ptr(qual.codes),
                _ptr(qual.luts), _ptr(qual.lane_q), _ptr(qual.resid),
                _ptr(qual.thresh), counts.data_ptr(), a_const, 2.0 * a_const,
                eps, nql, n_rings, nb, n_points, d, chunk, qual.exact_rings,
                mode, cb, m, kc, packed, align, vec, splits, smem,
                visit_budget, int(schedule_checks))
    return counts


# ---- the central bucket (Alg. 3) -----------------------------------------

# central_qualify splits a lane over a cluster of up to 8 blocks of <= 256
# slots each
_CENTRAL_SLOTS, _CENTRAL_SPLITS = 256, 8


def central_qualify(qcodes: torch.Tensor, tid: torch.Tensor,
                    bucket_codes: torch.Tensor, n_buckets: torch.Tensor,
                    bucket_starts: torch.Tensor, bucket_sizes: torch.Tensor,
                    order: torch.Tensor, qual: Qual, exact: bool,
                    budget: int) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Alg. 3's central count of every lane in one launch: ``(qualified
    (QL,) float32, seen (QL,) int32, total (QL,) int32)``.

    Lane ``i`` (table ``tid[i]``, int64; code ``qcodes.reshape(-1, K)[i]``,
    int32) finds the bucket among the first ``n_buckets[tid[i]]`` rows of
    ``bucket_codes`` (L, B, K) whose code equals its own (those rows are
    sorted lexicographically and unique, as the index builds them), and
    qualifies its first ``seen = min(size, budget)`` points, the CSR slice
    ``order[tid[i], start + s]``: exactly when ``exact``, else by ADC as
    ``qual`` routes far rings. ``qualified`` sums their weights, ``total``
    is the bucket's size; a lane whose code matches no bucket gets 0 for
    all three.
    """
    nql, d = qual.qs.shape
    pq = not exact and qual.codes is not None
    _work("central_qualify", *central_qualify_work(
        nql, bucket_codes.shape[-1], d, not pq,
        qual.luts[0].numel() * qual.luts.element_size() if pq else 0,
        qual.luts.shape[1] if pq else 0,
        qual.codes.shape[1] + 4 * (qual.resid is not None) if pq
        else 4 * d, nql * budget))
    opt = [t for t in qual[3:8] if t is not None]
    if _on_cpu(qcodes, tid, bucket_codes, n_buckets, bucket_starts,
               bucket_sizes, order, qual.x, qual.qs, qual.tau_sq, *opt):
        return ref.central_qualify(qcodes, tid, bucket_codes, n_buckets,
                                   bucket_starts, bucket_sizes, order, qual,
                                   exact, budget)
    _check(bucket_codes, "bucket_codes", torch.int32, 3)
    nl, nb, k = bucket_codes.shape
    if qcodes.dtype != torch.int32 or not qcodes.is_contiguous() or \
            qcodes.dim() < 2 or qcodes.shape[-1] != k:
        raise ValueError(f"qcodes: expected contiguous int32 (..., {k}), got "
                         f"{qcodes.dtype} {tuple(qcodes.shape)}")
    _check(tid, "tid", torch.int64, 1)
    _check(n_buckets, "n_buckets", torch.int32, 1)
    for t, nm in ((bucket_starts, "bucket_starts"),
                  (bucket_sizes, "bucket_sizes"), (order, "order")):
        _check(t, nm, torch.int32, 2)
    _check(qual.x, "x", torch.float32, 2)
    _check(qual.qs, "qs", torch.float32, 2)
    _check(qual.tau_sq, "tau_sq", torch.float32, 1)
    nql, d = qual.qs.shape
    n_points = order.shape[1]
    if (qcodes.numel() != nql * k or tid.shape[0] != nql
            or n_buckets.shape != (nl,) or bucket_starts.shape != (nl, nb)
            or bucket_sizes.shape != (nl, nb) or order.shape[0] != nl
            or qual.x.shape[1] != d or qual.x.shape[0] < n_points
            or qual.tau_sq.shape != (nql,)):
        shapes = {nm: tuple(t.shape) for nm, t in (
            ("qcodes", qcodes), ("tid", tid),
            ("bucket_codes", bucket_codes), ("n_buckets", n_buckets),
            ("bucket_starts", bucket_starts), ("bucket_sizes", bucket_sizes),
            ("order", order), ("x", qual.x), ("qs", qual.qs),
            ("tau_sq", qual.tau_sq))}
        raise ValueError(f"central_qualify shapes do not agree: {shapes}")
    if not 0 < k <= 32 or budget < 1:
        raise ValueError(f"central_qualify takes 1..32 functions and a "
                         f"budget >= 1, got K={k}, budget={budget}")
    if not exact and qual.codes is None:
        raise ValueError("an ADC central count needs PQ codes")
    mode, m, kc, cb, packed, align, lut_bytes = (0,) * 7 if exact else \
        _qual_adc(qual, nql, n_points)
    splits = min(_CENTRAL_SPLITS, -(-budget // _CENTRAL_SLOTS))
    slots = -(-budget // splits)
    smem = _align16(8 * slots) + _align16(lut_bytes if mode else 4 * d)
    if smem > 200 * 1024:
        raise ValueError(f"d={d}, a {lut_bytes}-byte LUT and {slots} slots "
                         "per block do not fit shared memory")
    vec = int(d % 4 == 0 and qual.x.data_ptr() % 16 == 0)
    dev = qual.qs.device
    qualified = torch.empty(nql, dtype=torch.float32, device=dev)
    seen = torch.empty(nql, dtype=torch.int32, device=dev)
    total = torch.empty(nql, dtype=torch.int32, device=dev)
    if nql:
        _launch("central_qualify", "central_qualify", qcodes.data_ptr(),
                tid.data_ptr(), bucket_codes.data_ptr(), n_buckets.data_ptr(),
                bucket_starts.data_ptr(), bucket_sizes.data_ptr(),
                order.data_ptr(), qual.x.data_ptr(), qual.qs.data_ptr(),
                qual.tau_sq.data_ptr(), _ptr(qual.codes), _ptr(qual.luts),
                _ptr(qual.lane_q), _ptr(qual.resid), _ptr(qual.thresh),
                qualified.data_ptr(), seen.data_ptr(), total.data_ptr(), nql,
                nb, n_points, k, d, budget, mode, cb, m, kc, packed, align,
                vec, splits, smem)
    return qualified, seen, total


# ---- the estimate cache's CLOCK insert -------------------------------------

# the cache's fields as cache_insert takes them: name, dtype and the shape
# after the entry axis S ("l" and "k" stand for L and K)
_CACHE_FIELDS = (("qcodes", torch.int32, ("l", "k")),
                 ("qhash", torch.int64, (2,)), ("tau_key", torch.int32, ()),
                 ("snap_ball", torch.int32, ("l",)),
                 ("snap_params", torch.int64, ()),
                 ("probed_k", torch.int32, ("l",)),
                 ("est", torch.float32, ()), ("nvisited", torch.int32, ()),
                 ("valid", torch.bool, ()), ("ref", torch.bool, ()))


class CachePlan(NamedTuple):
    """How ``cache_insert`` (``csrc/cache.cu``) runs a call; the fields
    are its last arguments, in order."""
    threads: int        # the chain block: a power of two, 32..1024
    smem: int           # the chain block's dynamic shared memory, bytes
    cand_shared: int    # 1: the key ids' candidate slots in shared memory


# lanes the chain stages at a time (LANE_CHUNK in csrc/cache.cu)
_CACHE_LANE_CHUNK = 1024


def cache_insert_plan(s: int, n: int) -> CachePlan:
    """The chain block for S entries and n lanes: about 8 chunks of 8
    entries a thread (a power of two of threads, 32..1024), and shared
    memory for the entries' 16-bit key ids and keyed bits, the claim,
    valid and first ref bitmaps and the staged lanes
    (``cache_insert_chain_kernel``'s layout), plus a candidate slot for
    each of the n key ids where that fits in the 227 KB a block may use
    (in the scratch otherwise)."""
    if not 0 < s <= 1 << 16 or not 0 < n <= 1 << 16:
        raise ValueError(f"cache_insert takes 1..65536 entries and 1..65536 "
                         f"lanes, got S={s}, n={n}")
    chunks, words = -(-s // 8), -(-s // 32)
    threads = min(1024, max(32, 1 << (-(-chunks // 8) - 1).bit_length()))
    smem = 17 * chunks + 4 * (3 * words + _CACHE_LANE_CHUNK)
    shared = smem + 4 * n <= _SMEM_LIMIT
    return CachePlan(threads, smem + 4 * n * shared, int(shared))


def cache_insert_scratch(s: int, n: int) -> int:
    """int32 words of scratch a call takes: the lanes' and entries' key
    ids (n rounded up to 4, S to 8: the entries' are read 16 bytes at a
    time), each lane's slot, each slot's last writer, each key id's
    candidate slot."""
    return -(-n // 4) * 4 + -(-s // 8) * 8 + 2 * n + s


def cache_insert(cache, qcodes: torch.Tensor, qhash: torch.Tensor,
                 tau_keys: torch.Tensor, balls: torch.Tensor,
                 params_epoch: torch.Tensor, ests: torch.Tensor,
                 nvisited: torch.Tensor, probed_k: torch.Tensor,
                 active: torch.Tensor, match_qhash: bool) -> torch.Tensor:
    """The CLOCK insert of n probed lanes into ``cache`` (an
    ``EstimateCache``: (S, L, K) codes, (S, 2) int64 fingerprints, ...,
    a 0-d int32 hand), in lane order and in place: ``qcodes`` (n, L, K)
    int32, ``qhash`` (n, 2) int64, ``tau_keys`` (n,) int32, ``balls`` and
    ``probed_k`` (n, L) int32, ``params_epoch`` 0-d int64, ``ests`` (n,)
    float32, ``nvisited`` (n,) int32, ``active`` (n,) bool. Returns the
    evictions of live entries, a 0-d int32 tensor. On the card one call
    of ``csrc/cache.cu`` (key ids, the chain in one block, the fields'
    writes; :func:`ref.cache_insert` is its plain version)."""
    lanes = (qcodes, qhash, tau_keys, balls, params_epoch, ests, nvisited,
             probed_k, active)
    _work("cache_insert", *cache_insert_work(
        cache.qcodes.shape[0], qcodes.shape[0], *cache.qcodes.shape[1:],
        match_qhash))
    if _on_cpu(*cache, *lanes):
        return ref.cache_insert(cache, *lanes, match_qhash)
    s, nl, k = cache.qcodes.shape
    n = qcodes.shape[0]
    dims = {"l": nl, "k": k}
    for name, dtype, tail in _CACHE_FIELDS:
        shape = (s,) + tuple(dims.get(d, d) for d in tail)
        _check(getattr(cache, name), name, dtype, len(shape))
        if tuple(getattr(cache, name).shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got "
                             f"{tuple(getattr(cache, name).shape)}")
    _check(cache.hand, "hand", torch.int32, 0)
    _check(params_epoch, "params_epoch", torch.int64, 0)
    for t, nm, dtype, shape in (
            (qcodes, "qcodes", torch.int32, (n, nl, k)),
            (qhash, "qhash", torch.int64, (n, 2)),
            (tau_keys, "tau_keys", torch.int32, (n,)),
            (balls, "balls", torch.int32, (n, nl)),
            (ests, "ests", torch.float32, (n,)),
            (nvisited, "nvisited", torch.int32, (n,)),
            (probed_k, "probed_k", torch.int32, (n, nl)),
            (active, "active", torch.bool, (n,))):
        _check(t, nm, dtype, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"{nm}: expected {shape}, got {tuple(t.shape)}")
    plan = cache_insert_plan(s, max(n, 1))
    if not n:
        return torch.zeros((), dtype=torch.int32, device=qcodes.device)
    n_evicted = torch.empty((), dtype=torch.int32, device=qcodes.device)
    scratch = torch.empty(cache_insert_scratch(s, n), dtype=torch.int32,
                          device=qcodes.device)
    _launch("cache_insert", "cache_insert",
            *(getattr(cache, f).data_ptr() for f, _, _ in _CACHE_FIELDS),
            cache.hand.data_ptr(), qcodes.data_ptr(), qhash.data_ptr(),
            tau_keys.data_ptr(), balls.data_ptr(), params_epoch.data_ptr(),
            ests.data_ptr(), nvisited.data_ptr(), probed_k.data_ptr(),
            active.data_ptr(), n_evicted.data_ptr(), scratch.data_ptr(), s,
            n, nl, nl * k, int(match_qhash), *plan)
    return n_evicted


# ---- the bucket-neighbor table (Alg. 6 / 9) -------------------------------

class NeighborPlan(NamedTuple):
    """How ``neighbor_dists_i8`` (``csrc/neighbors.cu``) covers a call;
    the fields are its arguments, in order."""
    square: int         # 1: the whole table (upper triangle + zero fill)
    tiles: int          # tile blocks (64 x 64 pairs each)
    side: int           # square: live tiles a side; strip: column tiles
    live: int           # square: the live square's side in rows
    fill_a: int         # fill units of rows [0, live) x columns [live, B)
    fill_b: int         # fill units of rows [live, B)
    fill_blocks: int    # blocks of NEIGHBOR_FILL_UNITS units
    smem: int           # dynamic shared memory of a block, bytes


NEIGHBOR_TILE = 64
NEIGHBOR_FILL_UNITS = 256 * 16


def neighbor_dists_plan(b: int, k: int, n_valid: int, r0: int, r1: int,
                        aligned: bool) -> NeighborPlan:
    """The kernel's blocks for the entries with i or j in [r0, r1) of a
    (b, b) table. The whole table (r0 = 0, r1 = b) is the upper triangle
    of 64 x 64 tiles over the live square (n_valid rounded up to a tile,
    at most b), each stored at (I, J) and transposed at (J, I), plus zero
    fill of the rest in units of 16-byte pieces (bytes unless
    ``aligned``). A strip is every tile of its rows against every column
    tile, each stored in the row strip and transposed in the column
    strip."""
    t = NEIGHBOR_TILE
    smem = 2 * k * (t + 4) * 4 + 2 * t * (t + 16)
    if r0 == 0 and r1 == b:
        side = -(-n_valid // t)
        live = min(b, side * t)
        wide = 16 if aligned else 1
        fill_a = live * ((b - live) // wide)
        fill_b = (b - live) * b // wide
        if fill_a >= 1 << 32:
            raise ValueError(f"neighbor_dists: a table of {b} rows needs "
                             f"16-byte aligned rows")
        return NeighborPlan(1, side * (side + 1) // 2, side, live, fill_a,
                            fill_b, -(-(fill_a + fill_b)
                                      // NEIGHBOR_FILL_UNITS), smem)
    side = -(-b // t)
    return NeighborPlan(0, -(-(r1 - r0) // t) * side, side, 0, 0, 0, 0, smem)


def neighbor_dists(codes: torch.Tensor, n_valid: int, max_dist: int,
                   r0: int = 0, r1: int | None = None,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """codes (B, K) int32 → the (B, B) int8 table ``out[i, j] =
    popcount(codes[i] != codes[j])`` where i, j < ``n_valid`` and
    0 < d <= ``max_dist``, else 0. Only the entries with i or j in the row
    range [r0, r1) (default: every row) are written; the rest of ``out``
    is left as it is. ``out=None`` gives a new table, zero outside the
    strips. One launch on the card (:func:`neighbor_dists_plan`)."""
    cpu = _on_cpu(codes) if out is None else _on_cpu(codes, out)
    if not cpu:
        _check(codes, "codes", torch.int32, 2)
    if codes.dim() != 2:
        raise ValueError(f"codes: expected (B, K), got {tuple(codes.shape)}")
    b, k = codes.shape
    r1 = b if r1 is None else int(r1)
    r0, n_valid = int(r0), int(n_valid)
    if not 0 <= r0 <= r1 <= b or not 0 <= n_valid <= b:
        raise ValueError(f"row range [{r0}, {r1}) and n_valid {n_valid} "
                         f"must lie in [0, {b}]")
    if not 0 <= max_dist <= 127:
        raise ValueError(f"max_dist {max_dist} must fit int8 (0..127)")
    if out is None:
        full = r0 == 0 and r1 == b
        out = (torch.empty if full else torch.zeros)(
            (b, b), dtype=torch.int8, device=codes.device)
    elif out.dtype != torch.int8 or tuple(out.shape) != (b, b) \
            or not out.is_contiguous():
        raise ValueError(f"out: expected contiguous int8 ({b}, {b}), got "
                         f"{out.dtype} {tuple(out.shape)}")
    if r1 > r0:
        _work("neighbor_dists", *neighbor_dists_work(b, k, n_valid, r0, r1))
    if cpu:
        return ref.neighbor_dists(codes, n_valid, max_dist, r0, r1, out)
    if not 0 < k <= 32:
        raise ValueError(f"neighbor_dists takes 1..32 functions, got K={k}")
    if r1 > r0:
        aligned = b % 16 == 0 and out.data_ptr() % 16 == 0
        plan = neighbor_dists_plan(b, k, n_valid, r0, r1, aligned)
        _launch("neighbor_dists", "neighbor_dists_i8", codes.data_ptr(),
                out.data_ptr(), b, k, n_valid, max_dist, r0, r1, *plan,
                int(aligned))
    return out
