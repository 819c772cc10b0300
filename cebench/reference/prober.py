"""Plain reference of the Dynamic Prober (paper §4-5, Alg. 1-3, 7; with PQ,
Alg. 4-5, 8), written from the paper and the configuration, in plain torch.

It imports nothing of the program and takes nothing the program made. Given
the corpus, the seed of the build's generator, the batch's queries, radii
and PRP round keys, it works out:

* the build: the L·K hash functions (drawn from the generator in the order
  the program documents: ``a``, then ``b``), Alg. 7's widths W, the codes,
  and each table's sorted-CSR layout (a stable lexicographic sort of the
  codes); with PQ, Lloyd's k-means per subspace and the codes;
* per batch: the queries' codes and Hamming distances to every live bucket,
  the central count (Alg. 3), and the progressive sampling of rings 1..K
  under the Chernoff stopping rule (Alg. 1/2), with the same PRP draws;
  with PQ, the LUTs and the ADC qualification of the far rings;
* per ingest (:func:`update`): Alg. 7 over the live rows, the capacity
  doubled where they no longer fit; with PQ, Alg. 8.

Float32 operations follow the program's order (``arith``), so that equal
inputs give equal outputs bit for bit, and the comparison can be exact.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from cebench.reference import arith

SENTINEL = 2 ** 31 - 1
MASK32 = 0xFFFFFFFF
KMEANS_CHUNK = 1 << 25          # elements of one (rows, M, Kc) distance block


class RefPQ(NamedTuple):
    centroids: torch.Tensor     # (M, Kc, ds) float32
    codes: torch.Tensor         # (n, M) uint8
    counts: torch.Tensor        # (M, Kc) float32 points a centroid, Alg. 8


class RefIndex(NamedTuple):
    a: torch.Tensor             # (d, L·K)
    b: torch.Tensor             # (L·K,)
    w: torch.Tensor             # (L·K,)
    raw: torch.Tensor           # (C, L·K) projections a·x
    codes: torch.Tensor         # (L, C, K) int32, dead rows SENTINEL
    order: torch.Tensor         # (L, C) int32
    bucket_codes: torch.Tensor  # (L, C, K) int32
    bucket_starts: torch.Tensor  # (L, C) int32
    bucket_sizes: torch.Tensor  # (L, C) int32
    n_buckets: torch.Tensor     # (L,) int32
    pq: Optional[RefPQ] = None
    x: Optional[torch.Tensor] = None   # (C, d) the corpus, rows >= n zero
    n_valid: int = 0                   # live rows


# ---- the build ------------------------------------------------------------

def _codes(raw: torch.Tensor, b: torch.Tensor, w: torch.Tensor,
           nl: int) -> torch.Tensor:
    """(R, L·K) projections a·x → (L, R, K) codes floor((a·x + b·w) / w)."""
    c = torch.floor((raw + b * w) / w).to(torch.int32)
    return c.reshape(raw.shape[0], nl, -1).transpose(0, 1)


def _csr(codes_t: torch.Tensor, n: int):
    """One table's sorted-CSR layout of (C, K) codes whose rows >= n are
    dead: a stable lexicographic sort (least significant column first),
    then one bucket per run of equal codes, padded to C buckets."""
    c, k = codes_t.shape
    dev = codes_t.device
    perm = torch.arange(c, device=dev)
    for j in reversed(range(k)):
        perm = perm[torch.sort(codes_t[perm, j], stable=True).indices]
    srt = codes_t[perm]
    new = torch.ones(c, dtype=torch.bool, device=dev)
    new[1:] = (srt[1:] != srt[:-1]).any(-1)
    first = torch.nonzero(new).squeeze(1)               # sorted positions
    nb_all = first.shape[0]
    sizes = torch.diff(first, append=torch.tensor([c], device=dev))
    live = int((srt[first, 0] != SENTINEL).sum()) if n < c else nb_all
    bcodes = torch.full((c, k), SENTINEL, dtype=torch.int32, device=dev)
    bcodes[:nb_all] = srt[first]
    starts = torch.full((c,), c, dtype=torch.int32, device=dev)
    starts[:nb_all] = first.int()
    bsizes = torch.zeros(c, dtype=torch.int32, device=dev)
    bsizes[:nb_all] = sizes.int()
    return perm.int(), bcodes, starts, bsizes, live


def kmeans_assign(centroids: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of every subspace, by |x|^2 - 2 x·c + |c|^2 in
    float32 over blocks of rows: (n, M, ds) → (n, M) int64."""
    n, m, _ = xs.shape
    kc = centroids.shape[1]
    c2 = (centroids ** 2).sum(-1)
    out = torch.empty((n, m), dtype=torch.int64, device=xs.device)
    step = max(1, KMEANS_CHUNK // (m * kc))
    for s in range(0, n, step):
        blk = xs[s:s + step]
        x2 = (blk ** 2).sum(-1, keepdim=True)
        xc = torch.einsum("nms,mks->nmk", blk, centroids)
        out[s:s + step] = torch.argmin(x2 - 2.0 * xc + c2[None], dim=-1)
    return out


def _segment_sums(data: torch.Tensor, seg: torch.Tensor, n_seg: int):
    """Sums of ``data`` rows by segment id, over the rows of each segment
    in their order (a stable sort by segment, then one reduction a run)."""
    order = torch.argsort(seg, stable=True)
    lengths = torch.bincount(seg, minlength=n_seg)
    return torch.segment_reduce(data[order], "sum", lengths=lengths, axis=0)


def kmeans(xs: torch.Tensor, init_rows: torch.Tensor, iters: int) -> RefPQ:
    """Lloyd's k-means of every subspace at once from the rows
    ``init_rows`` (Kc,): ``iters`` rounds of assignment and means (an
    empty cluster keeps its centroid), then the codes."""
    n, m, ds = xs.shape
    kc = init_rows.shape[0]
    cent = xs[init_rows.long()].transpose(0, 1).contiguous()
    flat = xs.reshape(n * m, ds)
    ones = torch.ones(n * m, dtype=torch.float32, device=xs.device)
    offs = (torch.arange(m, device=xs.device) * kc)[None]
    for _ in range(iters):
        seg = (kmeans_assign(cent, xs) + offs).reshape(-1)
        sums = _segment_sums(flat, seg, m * kc).reshape(m, kc, ds)
        cnts = _segment_sums(ones, seg, m * kc).reshape(m, kc, 1)
        cent = torch.where(cnts > 0, sums / cnts.clamp_min(1.0), cent)
    codes = kmeans_assign(cent, xs)
    cnt = _segment_sums(ones, (codes + offs).reshape(-1), m * kc)
    return RefPQ(cent, codes.to(torch.uint8), cnt.reshape(m, kc))


def build(x_pad: torch.Tensor, n: int, cfg: dict,
          generator: torch.Generator) -> RefIndex:
    """The index over the first ``n`` rows of the capacity-padded corpus
    ``x_pad`` (C, d), with the hash functions and the k-means rows drawn
    from ``generator``."""
    if cfg["use_pq"] and (cfg["pq_int8_lut"] or cfg["pq_pack4"]
                          or cfg["pq_banded"]):
        raise NotImplementedError("this reference qualifies by float LUTs "
                                  "and byte codes only")
    d = x_pad.shape[1]
    nl, k = cfg["n_tables"], cfg["n_funcs"]
    g = generator
    a = torch.randn((d, nl * k), generator=g, device=g.device).to(x_pad.device)
    b = torch.rand((nl * k,), generator=g, device=g.device).to(x_pad.device)
    raw = x_pad @ a
    live = raw[:n]
    w = torch.clamp_min((live.amax(0) - live.amin(0))
                        / float(cfg["n_regions"]), 1e-6)
    codes = _codes(raw, b, w, nl).contiguous()
    codes[:, n:] = SENTINEL
    pq = None
    if cfg["use_pq"]:
        m, kc = cfg["pq_m"], cfg["pq_kc"]
        if n >= kc:
            init = torch.randperm(n, generator=g, device=g.device)[:kc]
        else:
            init = torch.randint(0, n, (kc,), generator=g, device=g.device)
        xs = x_pad[:n].reshape(n, m, d // m)
        pq = kmeans(xs, init.to(x_pad.device), cfg["pq_iters"])
    return relayout(RefIndex(a=a, b=b, w=w, raw=raw, codes=codes,
                             order=None, bucket_codes=None,
                             bucket_starts=None, bucket_sizes=None,
                             n_buckets=None, pq=pq, x=x_pad, n_valid=n))


def relayout(ri: RefIndex) -> RefIndex:
    """Every table's sorted-CSR layout from the codes of the live rows."""
    parts = [_csr(ri.codes[t], ri.n_valid) for t in range(ri.codes.shape[0])]
    return ri._replace(order=torch.stack([p[0] for p in parts]),
                       bucket_codes=torch.stack([p[1] for p in parts]),
                       bucket_starts=torch.stack([p[2] for p in parts]),
                       bucket_sizes=torch.stack([p[3] for p in parts]),
                       n_buckets=torch.tensor([p[4] for p in parts],
                                              dtype=torch.int32,
                                              device=ri.codes.device))


def _pow2_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` padded with zero rows to a power of two: an ingest's rows are
    projected and encoded as one such block, as the program does, so that
    the matrix products round alike."""
    p = 1
    while p < x.shape[0]:
        p *= 2
    return torch.nn.functional.pad(x, (0, 0, 0, p - x.shape[0]))




def _ingest_pq(pq: RefPQ, blk: torch.Tensor, n_new: int) -> RefPQ:
    """Alg. 8: the new rows (the first ``n_new`` of the zero-padded block
    ``blk``) take the nearest of the existing centroids, and each
    centroid moves to the running mean of its points."""
    m, kc, ds = pq.centroids.shape
    xs = blk.reshape(blk.shape[0], m, ds)
    new = kmeans_assign(pq.centroids, xs)
    live = (torch.arange(blk.shape[0], device=blk.device) < n_new).float()
    wf = live.repeat_interleave(m)
    seg = (new + (torch.arange(m, device=blk.device) * kc)[None]).reshape(-1)
    sums = _segment_sums(xs.reshape(-1, ds) * wf[:, None], seg,
                         m * kc).reshape(m, kc, ds)
    tot = pq.counts + _segment_sums(wf, seg, m * kc).reshape(m, kc)
    cent = torch.where(tot[..., None] > 0,
                       (pq.centroids * pq.counts[..., None] + sums)
                       / tot[..., None].clamp_min(1.0), pq.centroids)
    return RefPQ(cent, torch.cat([pq.codes, new[:n_new].to(torch.uint8)]),
                 tot)


def update(ri: RefIndex, x_new: torch.Tensor, cfg: dict,
           layout: bool = True) -> RefIndex:
    """Paper §5, Alg. 7: the rows ``x_new`` join the live ones (the
    capacity doubles first where they do not fit); W is derived again from
    the range of every live row's projections; if it moved, every live row
    is hashed again, else only the new ones; the tables are laid out again
    (``layout=False`` leaves that to a later :func:`relayout`, and the
    layout fields are then stale). With PQ, Alg. 8. The corpus and the
    projections are written in place where the rows fit."""
    n, k = ri.n_valid, x_new.shape[0]
    x, raw, codes = ri.x, ri.raw, ri.codes
    cap = x.shape[0]
    if n + k > cap:
        while cap < n + k:
            cap *= 2
        grow = cap - x.shape[0]
        x = torch.nn.functional.pad(x, (0, 0, 0, grow))
        raw = torch.nn.functional.pad(raw, (0, 0, 0, grow))
        codes = torch.nn.functional.pad(codes, (0, 0, 0, grow),
                                        value=SENTINEL)
    blk = _pow2_rows(x_new.to(x.device, torch.float32))
    x[n:n + k] = blk[:k]
    raw[n:n + k] = (blk @ ri.a)[:k]
    live = raw[:n + k]
    w = torch.clamp_min((live.amax(0) - live.amin(0))
                        / float(cfg["n_regions"]), 1e-6)
    nl = codes.shape[0]
    if torch.equal(w, ri.w):
        codes[:, n:n + k] = _codes(raw[n:n + k], ri.b, w, nl)
    else:
        codes[:, :n + k] = _codes(live, ri.b, w, nl)
    out = ri._replace(w=w, raw=raw, codes=codes, x=x, n_valid=n + k,
                      pq=None if ri.pq is None else
                      _ingest_pq(ri.pq, blk, k))
    return relayout(out) if layout else out


# ---- one batch ------------------------------------------------------------

def query_codes(ri: RefIndex, qs: torch.Tensor, nl: int) -> torch.Tensor:
    """(Q, d) → (Q, L, K): floor((a·q + b·w) / w), a·q summed in order."""
    s = arith.dot_sequential(qs, ri.a)
    v = s + ri.b * ri.w
    return torch.floor(v / ri.w).to(torch.int32).reshape(qs.shape[0], nl, -1)


def hamming(ri: RefIndex, qcodes: torch.Tensor, nb: int,
            block: int = 8) -> torch.Tensor:
    """Hamming distances of every lane's code to the first ``nb`` buckets of
    its table (rows past n_buckets: K + 1) → (Q, L, nb) int32."""
    nq, nl, k = qcodes.shape
    bc = ri.bucket_codes[:, :nb]
    live = torch.arange(nb, device=bc.device)[None] < ri.n_buckets[:, None]
    out = torch.empty((nq, nl, nb), dtype=torch.int32, device=bc.device)
    for s in range(0, nq, block):
        dist = (bc[None] != qcodes[s:s + block, :, None, :]).sum(
            -1, dtype=torch.int32)
        out[s:s + block] = torch.where(live[None], dist, k + 1)
    return out


def prp(idx: torch.Tensor, rk: torch.Tensor, mask: torch.Tensor,
        nbits: torch.Tensor) -> torch.Tensor:
    """The keyed multiply/xorshift permutation of Z_{2^n} (Alg. 2's sample
    order) in uint32 arithmetic, emulated in int64: ``idx`` (A, c), ``rk``
    (A, 6), ``mask`` = 2^n - 1 and ``nbits`` (A,)."""
    x = idx.long() & MASK32
    mask = mask.long()[:, None]
    nbits = nbits.long()[:, None]
    for i in range(3):
        x = (x * (rk[:, 2 * i, None] | 1)) & mask
        x = x ^ (x >> (nbits // 2 + (i % 2) + 1))
        x = (x + rk[:, 2 * i + 1, None]) & mask
    return x


def search_right(cum: torch.Tensor, rows: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """For each value ``v`` (A, c), the first position of row ``rows[a]`` of
    ``cum`` (R, B), non-decreasing, whose entry exceeds it (B if none)."""
    nb = cum.shape[1]
    lo = torch.zeros_like(v, dtype=torch.int64)
    hi = torch.full_like(lo, nb)
    base = (rows.long() * nb)[:, None]
    flat = cum.reshape(-1)
    for _ in range(max(1, nb.bit_length())):
        mid = (lo + hi) // 2
        le = flat[base + mid.clamp_max(nb - 1)] <= v
        open_ = lo < hi
        lo = torch.where(open_ & le, mid + 1, lo)
        hi = torch.where(open_ & ~le, mid, hi)
    return lo


class _Qual(NamedTuple):
    x: torch.Tensor                     # (C, d)
    qs: torch.Tensor                    # (Q, d)
    tau_sq: torch.Tensor                # (Q,)
    lane_q: torch.Tensor                # (QL,)
    codes: Optional[torch.Tensor]       # (n, M) uint8 with PQ
    luts: Optional[torch.Tensor]        # (Q, M, Kc)
    exact_rings: int


def _weights(qual: _Qual, lanes: torch.Tensor, ids: torch.Tensor,
             ok: torch.Tensor, exact: torch.Tensor) -> torch.Tensor:
    """1[distance <= tau^2] of candidates ``ids`` (A, c) of ``lanes`` (A,):
    the exact squared distance where ``exact`` (A,), else the ADC one.
    Candidates outside ``ok`` weigh 0."""
    q = qual.lane_q[lanes]
    tsq = qual.tau_sq[q][:, None]
    wt = torch.zeros(ids.shape, dtype=torch.float32, device=ids.device)
    ex = exact[:, None] & ok
    if ex.any():
        ai, ci = torch.nonzero(ex, as_tuple=True)
        d2 = arith.sq_dist_warp(qual.x[ids[ai, ci].long()], qual.qs[q[ai]])
        wt[ai, ci] = (d2 <= tsq[ai, 0]).float()
    ad = ~exact[:, None] & ok
    if ad.any():
        ai, ci = torch.nonzero(ad, as_tuple=True)
        codes = qual.codes[ids[ai, ci].long()]           # (R, M)
        s = arith.adc_in_order(qual.luts[q[ai]], codes[:, None, :])[:, 0]
        wt[ai, ci] = (s <= tsq[ai, 0]).float()
    return wt


def _bit_length(v: torch.Tensor) -> torch.Tensor:
    """Bits of non-negative int32 values, by shifts (a float log2 is not
    exact at every power of two on every device)."""
    out = torch.zeros_like(v, dtype=torch.int32)
    for b in range(31):
        out += ((v.long() >> b) > 0).int()
    return out


# Chernoff bounds of §4.5 on p = w'/w with a = ln(1/delta): a numerator
# is a float32 tensor first (a Python float over a tensor would multiply by
# the reciprocal, which rounds differently)

def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _mu_upper(p, w, a):
    w = torch.clamp_min(w, 1e-9)
    t = _f32(a, w) / (2.0 * w)
    s = torch.sqrt(p + t) + torch.sqrt(t)
    return s * s


def _mu_lower(p, w, a):
    w = torch.clamp_min(w, 1e-9)
    t = _f32(a, w) / (2.0 * w)
    inner = torch.sqrt(p + _f32(2.0 * a, w) / (9.0 * w)) - torch.sqrt(t)
    return torch.clamp_min(inner * inner - _f32(a, w) / (18.0 * w), 0.0)


def _at(t: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """``t[a, col[a]]`` for every row a."""
    return t.gather(1, col[:, None])[:, 0]


def luts(ri: RefIndex, qs: torch.Tensor) -> torch.Tensor:
    """Alg. 4: T[q, m, c] = ||q_m - centroid[m, c]||^2 → (Q, M, Kc)."""
    cent = ri.pq.centroids
    m = cent.shape[0]
    sub = qs.reshape(qs.shape[0], m, -1)
    return ((sub[:, :, None, :] - cent) ** 2).sum(-1)


def estimate(ri: RefIndex, x_pad: torch.Tensor, qs: torch.Tensor,
             taus: torch.Tensor, rks: torch.Tensor, cfg: dict,
             tally: Optional[dict] = None):
    """Alg. 1-3 for Q queries: ``(ests (Q,) float32, probed_k (Q, L) int32,
    nvisited (Q,) int32)``, with round keys ``rks`` (Q, L, 6). A ``tally``
    gets, added to its counts, the ring steps' candidates qualified
    exactly (``exact_rows``) and by ADC (``adc_rows``), and the lanes that
    took a step of each route (``exact_lanes``, ``adc_lanes``) or any
    step (``lanes``)."""
    dev = x_pad.device
    nl, kf = cfg["n_tables"], cfg["n_funcs"]
    chunk = cfg["chunk"]
    a_const = math.log(1.0 / cfg["delta"])
    eps = cfg["eps"]
    nq = qs.shape[0]
    nql = nq * nl
    qs = qs.to(dev, torch.float32).contiguous()
    taus = taus.to(dev, torch.float32)
    tau_sq = taus * taus
    lane = torch.arange(nql, device=dev)
    lane_q, tid = lane // nl, lane % nl
    pq = cfg["use_pq"]
    qual = _Qual(x_pad, qs, tau_sq, lane_q,
                 ri.pq.codes if pq else None,
                 luts(ri, qs) if pq else None,
                 cfg["pq_exact_rings"] if pq else kf)

    # rings: Hamming distances to the live buckets and per-ring cumsums
    qc = query_codes(ri, qs, nl)
    nb = int(ri.n_buckets.max())
    ham = hamming(ri, qc, nb).reshape(nql, nb)
    sizes = ri.bucket_sizes[tid, :nb]                   # (QL, nb)
    cums = torch.stack([torch.cumsum(torch.where(ham == r, sizes, 0), -1,
                                     dtype=torch.int32)
                        for r in range(1, kf + 1)], 1)  # (QL, K, nb)

    # Alg. 3: the central bucket, the live one at distance 0 (codes are
    # unique within a table, so there is at most one)
    match = ham == 0
    del ham
    found = match.any(1)
    row = match.int().argmax(1)
    total0 = torch.where(found, sizes.gather(1, row[:, None])[:, 0], 0)
    budget = cfg["central_budget"]
    seen = total0.clamp_max(budget)
    slot = torch.arange(budget, device=dev)
    valid = slot[None] < seen[:, None]
    start = ri.bucket_starts[tid, row]
    pos = torch.where(valid, start[:, None] + slot[None], 0)
    ids = ri.order[tid[:, None], pos.long()]
    central_exact = torch.full((nql,), (not pq) or cfg["pq_exact_central"],
                               dtype=torch.bool, device=dev)
    qualified = (_weights(qual, lane, ids, valid, central_exact)
                 * valid).sum(-1)
    scale = torch.where(seen > 0, total0 / seen.clamp_min(1), 0.0)
    est = qualified * scale
    nvis = seen.clone()

    # ring constants: |N_k|, sample caps, PRP domains, schedule anchors
    totals = cums[:, :, -1]                             # (QL, K)
    totals_f = totals.float()
    caps = totals.clamp_max(cfg["ring_budget"])
    nbits = torch.where(caps <= 1, 0, _bit_length((caps - 1).clamp_min(1)))
    prings = torch.ones_like(nbits) << nbits
    w_caps = torch.minimum(torch.ceil(cfg["s_max"] * totals_f), caps.float())
    first = torch.ceil(cfg["s1"] * totals_f).clamp_min(1.0)
    budget_v = cfg["max_visit"]

    k = torch.ones(nql, dtype=torch.int32, device=dev)
    ci = torch.zeros(nql, dtype=torch.int32, device=dev)
    w = torch.zeros(nql, dtype=torch.int32, device=dev)
    wq = torch.zeros(nql, dtype=torch.float32, device=dev)
    target = first[:, 0].clone()
    ptf = torch.zeros(nql, dtype=torch.bool, device=dev)
    done = (nvis >= budget_v) | (kf < 1)
    rks = rks.to(dev, torch.int64).reshape(nql, 6)
    slots = torch.arange(chunk, device=dev)
    lane_exact = torch.zeros(nql, dtype=torch.bool, device=dev)
    lane_adc = torch.zeros(nql, dtype=torch.bool, device=dev)
    g = _at
    while not bool(done.all()):
        act = torch.nonzero(~done).squeeze(1)
        kk = k[act]
        r = (kk.clamp_max(kf) - 1).long()
        p_ring = g(prings[act], r)
        idx = ci[act].long()[:, None] * chunk + slots[None]
        draw = prp(idx, rks[act], p_ring - 1, g(nbits[act], r))
        ok = (idx < p_ring[:, None]) & (draw < g(caps[act], r)[:, None])
        crow = act * kf + r
        j = search_right(cums.reshape(nql * kf, nb), crow, draw)
        j = j.clamp_max(nb - 1)
        cflat = cums.reshape(-1)
        prev = torch.where(j > 0, cflat[(crow * nb)[:, None] + (j - 1)
                                        .clamp_min(0)], 0)
        t_act = tid[act]
        pos = ri.bucket_starts[t_act[:, None], j] + (draw - prev)
        pos = torch.where(ok, pos, 0).clamp(0, ri.order.shape[1] - 1)
        cand = ri.order[t_act[:, None], pos]
        exact = (kk.clamp_max(kf) <= qual.exact_rings)
        wt = _weights(qual, act, cand, ok, exact)
        if tally is not None:
            n_ok = ok.sum(-1)
            tally["exact_rows"] += int(n_ok[exact].sum())
            tally["adc_rows"] += int(n_ok[~exact].sum())
            lane_exact[act[exact]] = True
            lane_adc[act[~exact]] = True
        wq_a = wq[act] + (wt * ok).sum(-1)
        w_a = w[act] + ok.sum(-1, dtype=torch.int32)
        exhausted = (ci[act] + 1) * chunk >= p_ring
        wf = w_a.float()
        ring_est = g(totals_f[act], r) * wq_a / wf.clamp_min(1.0)
        p_hat = wq_a / wf.clamp_min(1.0)
        w_cap = g(w_caps[act], r)
        at_sched = (wf >= target[act]) | (wf >= w_cap)
        if not cfg["schedule_checks"]:
            at_sched = torch.ones_like(at_sched)
        mu_u = _mu_upper(p_hat, wf, a_const)
        cond1 = ((mu_u - p_hat) <= eps) & \
            ((p_hat - _mu_lower(p_hat, wf, a_const)) <= eps)
        cond2 = mu_u < eps
        budget_hit = (nvis[act] + wf.int()) >= budget_v
        ring_done = (at_sched & (cond1 | cond2)) | (wf >= w_cap) | \
            exhausted | budget_hit
        ptf_a = ptf[act] | (at_sched & cond2)
        tgt = torch.where(at_sched, target[act] * 2.0, target[act])
        nk = torch.where(ring_done, kk + 1, kk)
        nrow = (nk - 1).clamp_max(kf - 1).long()
        k[act] = nk
        ci[act] = torch.where(ring_done, 0, ci[act] + 1)
        w[act] = torch.where(ring_done, 0, w_a)
        wq[act] = torch.where(ring_done, 0.0, wq_a)
        target[act] = torch.where(ring_done, g(first[act], nrow), tgt)
        est[act] = torch.where(ring_done, est[act] + ring_est, est[act])
        nvis[act] = torch.where(ring_done, nvis[act] + wf.int(), nvis[act])
        ptf[act] = ptf_a
        done[act] = (nk > kf) | ptf_a | budget_hit
    if tally is not None:
        tally["exact_lanes"] += int(lane_exact.sum())
        tally["adc_lanes"] += int(lane_adc.sum())
        tally["lanes"] += int((lane_exact | lane_adc).sum())
    ests = est.reshape(nq, nl).mean(1)
    probed = (k - 1).clamp(0, kf).reshape(nq, nl)
    return ests, probed, nvis.reshape(nq, nl).sum(1, dtype=torch.int32)

