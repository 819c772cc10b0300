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


def query_lanes(qs, a, b, w, bucket_codes, n_buckets):
    """The query hash and its Hamming distances: :func:`lsh_hash` of ``qs``
    (Q, d) reshaped to (Q, L, K) codes, then :func:`hamming_to_buckets`
    against ``bucket_codes`` (L, B, K) → ``(qcodes, ham)``."""
    nl, _, k = bucket_codes.shape
    qcodes = lsh_hash(qs, a, b, w).reshape(qs.shape[0], nl, k)
    return qcodes, hamming_to_buckets(bucket_codes, qcodes, n_buckets)


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


# ---- ADC (Alg. 5): Σ_m lut[m, code_m], float32 or uint8 → int32 LUTs ----
#
# ``codes`` is uint8, (N, M) byte codes or (N, M/2) packed 4-bit codes (two
# per byte, code 2j in the low nibble of byte j); which of the two is told
# by the code width against the LUT's M. Sums run over m = 0..M-1 in order,
# the order of the kernels, so float results agree bit for bit with them.


def _unpacked(codes, m):
    """uint8 code rows (..., M) or packed (..., M/2) → (..., M) int64."""
    if codes.shape[-1] == m:
        return codes.long()
    lo, hi = (codes & 0xF).long(), (codes >> 4).long()
    return torch.stack([lo, hi], dim=-1).reshape(*codes.shape[:-1], m)


def _gather_codes(codes, ids, m):
    """The reference's ``prober._gather_codes``: code rows of ``ids``,
    through the packed matrix when that is what ``codes`` holds."""
    return _unpacked(codes[ids.long()], m)


def _acc_dtype(luts):
    return torch.int32 if luts.dtype == torch.uint8 else torch.float32


def adc_batch(codes, luts):
    """codes (N, M or M/2) uint8, luts (Q, M, Kc) → (Q, N): float32 sums of
    a float32 LUT stack, int32 sums of a uint8 one."""
    nq, m, _ = luts.shape
    c = _unpacked(codes, m)
    acc = torch.zeros((nq, c.shape[0]), dtype=_acc_dtype(luts),
                      device=codes.device)
    for j in range(m):
        acc += luts[:, j][:, c[:, j]].to(acc.dtype)
    return acc


adc_batch_q8 = adc_batch


def adc_rows(codes, ids, luts, lane_q):
    """codes (C, M or M/2) uint8, ids (R, c), luts (Q, M, Kc), lane_q (R,)
    → (R, c): the ADC sums of rows ``codes[ids[r]]`` under LUT
    ``luts[lane_q[r]]``."""
    m = luts.shape[1]
    c = _gather_codes(codes, ids, m)                          # (R, c, M)
    lr = luts[lane_q.long()]                                  # (R, M, Kc)
    acc = torch.zeros(ids.shape, dtype=_acc_dtype(luts), device=codes.device)
    for j in range(m):
        acc += lr[:, j].gather(1, c[:, :, j]).to(acc.dtype)
    return acc


adc_rows_q8 = adc_rows


# ---- the prober's slab step (Alg. 2 body): candidates and qualification --

_U32 = 0xFFFFFFFF


def prp_eval(idx, rks, mask, n_bits):
    """Keyed multiply/xorshift PRP on Z_{2^n}, ``mask = 2^n - 1``.

    ``idx`` (..., c), ``rks`` (..., 6), ``mask`` and ``n_bits`` (...). The
    reference computes in uint32; torch has no uint32 right shift on the
    CPU, so this computes in int64, where every intermediate is exact
    (idx < 2^14, multiplier < 2^32) and masking with ``mask < 2^32`` keeps
    exactly the low bits uint32 wrap-around would keep.
    """
    x = idx.long() & _U32
    mask = mask.long()[..., None]
    n_bits = n_bits.long()[..., None]
    for i in range(3):
        x = (x * (rks[..., 2 * i, None] | 1)) & mask
        x = x ^ (x >> (n_bits // 2 + (i % 2) + 1))
        x = (x + rks[..., 2 * i + 1, None]) & mask
    return x.to(torch.int32)


def _row(t, row):
    return t.gather(1, row[:, None]).squeeze(1)


def band_weight(adc_sq, r, tau_sq):
    """Banded ADC weight: the fraction of the residual band [max(0, adc −
    r), adc + r] that lies below τ (r = ||p − q(p)||)."""
    adc = torch.sqrt(adc_sq.clamp_min(0.0))
    lo = (adc - r).clamp_min(0.0)
    hi = adc + r
    tau = torch.sqrt(tau_sq)
    w = torch.where(hi > lo, (tau - lo) / (hi - lo).clamp_min(1e-12),
                    (adc <= tau).float())
    return w.clamp(0.0, 1.0)


def qualify(qual, ids, lanes, exact: bool, rows=None):
    """Qualification weights (R, c) in [0, 1] of candidates ``ids`` (R, c)
    int32 for lanes ``lanes`` (R,) under ``qual`` (an :class:`ops.Qual`):
    exact 1[d² <= τ²], or ADC through the lane's LUT (hard, banded, or
    int32 sums of a uint8 LUT against the lane's threshold). ``rows`` is
    the module whose ``l2dist_rows`` / ``adc_rows`` / ``adc_rows_q8``
    compute the sums: these plain versions by default, ``ops`` for the
    kernels."""
    l2, adc, adc8 = (l2dist_rows, adc_rows, adc_rows_q8) if rows is None \
        else (rows.l2dist_rows, rows.adc_rows, rows.adc_rows_q8)
    if exact:
        d2 = l2(qual.x, ids, qual.qs[lanes].contiguous())
        return (d2 <= qual.tau_sq[lanes, None]).float()
    lane_q = qual.lane_q[lanes].contiguous()
    if qual.thresh is not None:
        s = adc8(qual.codes, ids, qual.luts, lane_q)
        return (s <= qual.thresh[lanes, None]).float()
    adc_sq = adc(qual.codes, ids, qual.luts, lane_q)
    tau_sq = qual.tau_sq[lanes, None]
    if qual.resid is None:
        return (adc_sq <= tau_sq).float()
    return band_weight(adc_sq, qual.resid[ids.long()], tau_sq)


def slab_candidates(k, ci, lanes, tid, rks, prings, caps, nbits, cums,
                    starts, order, chunk: int):
    """One slab's candidates for each active lane: ids (A, chunk) int32
    and the mask ``ok`` (A, chunk). Lane ``a`` walks slots ``ci[a]·chunk +
    s`` of the PRP over ring ``min(k[a], K)``'s domain and resolves each
    draw through row ``cums[lanes[a], ring]`` of the ring size cumsums and
    its table ``tid[a]``'s CSR arrays ``starts`` (L, B) and ``order`` (L,
    C). Lanes that finished (k = K+1) are clamped to ring K, as the
    reference's clamped gathers are."""
    n_rings = prings.shape[1]
    nb = cums.shape[-1]
    n_points = order.shape[-1]
    slot = torch.arange(chunk, dtype=torch.int32, device=k.device)
    kc = k.clamp_max(n_rings).long()
    row = kc - 1
    p_ring = _row(prings, row)
    idx = ci[:, None] * chunk + slot
    p_slab = prp_eval(idx, rks, p_ring - 1, _row(nbits, row))
    cum = cums[lanes, kc]                               # (A, B)
    ok = (idx < p_ring[:, None]) & (p_slab < _row(caps, row)[:, None])
    j = torch.searchsorted(cum, p_slab, right=True).clamp_max(nb - 1)
    prev = torch.where(j > 0, cum.gather(1, (j - 1).clamp_min(0)), 0)
    pos = starts[tid[:, None], j] + (p_slab - prev)
    pos = torch.where(ok, pos, 0).clamp(0, n_points - 1)
    return order[tid[:, None], pos.long()], ok


def slab_qualify(k, ci, lanes, tid, rks, prings, caps, nbits, cums, starts,
                 order, qual, chunk: int, rows=None):
    """One slab step's qualification sums for each active lane: ``wq_add``
    (A,) float32, the sum of the qualified candidates' weights, and
    ``w_add`` (A,) int32, the number of candidates drawn. Ring ``min(k,
    K)`` qualifies exactly when there are no PQ codes or it is a near ring
    (<= ``qual.exact_rings``), else by ADC; both are computed and one is
    selected per lane. ``rows`` is passed on to :func:`qualify`."""
    sl, ok = slab_candidates(k, ci, lanes, tid, rks, prings, caps, nbits,
                             cums, starts, order, chunk)
    if qual.codes is None:
        wt = qualify(qual, sl, lanes, True, rows)
    else:
        wt = qualify(qual, sl, lanes, False, rows)
        if qual.exact_rings > 0:
            near = (k.clamp_max(prings.shape[1]) <= qual.exact_rings)[:, None]
            wt = torch.where(near, qualify(qual, sl, lanes, True, rows), wt)
    return (wt * ok).sum(-1), ok.sum(-1, dtype=torch.int32)


def central_qualify(qcodes, tid, bucket_codes, n_buckets, bucket_starts,
                    bucket_sizes, order, qual, exact: bool, budget: int):
    """Alg. 3's central count of every lane: ``(qualified (QL,) float32,
    seen (QL,) int32, total (QL,) int32)``. Lane ``i`` (table ``tid[i]``,
    code ``qcodes.reshape(-1, K)[i]``) finds its bucket by brute force,
    the row of ``bucket_codes[tid[i]]`` below ``n_buckets`` equal to its
    code, and qualifies the bucket's first ``seen = min(size, budget)``
    points ``order[tid[i], start + s]`` through :func:`qualify` (exactly,
    or by ADC as ``qual`` routes it); ``total`` is the bucket's size. A
    lane whose code matches no bucket gets 0 for all three. The ids are
    the ones the ring-0 cumsum walk gives, laid out the same way, so the
    sums agree with it bit for bit."""
    ids, valid, seen, total = central_ids(qcodes, tid, bucket_codes,
                                          n_buckets, bucket_starts,
                                          bucket_sizes, order, budget)
    lanes = torch.arange(ids.shape[0], device=ids.device)
    qualified = (qualify(qual, ids, lanes, exact) * valid).sum(-1)
    return qualified, seen, total


def central_ids(qcodes, tid, bucket_codes, n_buckets, bucket_starts,
                bucket_sizes, order, budget: int):
    """The candidates :func:`central_qualify` qualifies: ``(ids (QL,
    budget) int32, valid (QL, budget) bool, seen (QL,) int32, total (QL,)
    int32)``."""
    nb, k = bucket_codes.shape[1:]
    qc = qcodes.reshape(-1, k)
    tid = tid.long()
    dev = qc.device
    match = torch.arange(nb, device=dev)[None, :] < n_buckets[tid][:, None]
    for j in range(k):
        match &= bucket_codes[:, :, j][tid] == qc[:, j, None]
    row = match.to(torch.int32).argmax(1)
    total = torch.where(match.any(1), bucket_sizes[tid, row], 0)
    seen = total.clamp_max(budget)
    slots = torch.arange(budget, dtype=torch.int32, device=dev)
    valid = slots < seen[:, None]
    pos = torch.where(valid, bucket_starts[tid, row][:, None] + slots, 0)
    ids = order[tid[:, None], pos.clamp(0, order.shape[1] - 1).long()]
    return ids, valid, seen, total


def gather_ring_from_cum(view, tid, cum, budget: int):
    """Gather up to ``budget`` point ids per lane from a ring's size cumsum
    (the reference's ``prober.gather_ring_from_cum``): the central count's
    composition before :func:`central_qualify`, over ring 0's cumsum row.

    ``view`` holds the index's ``bucket_starts`` (L, B) and ``order`` (L,
    C), ``tid`` (R,) is each lane's table, ``cum`` (R, B) its ring cumsum.
    Returns (ids (R, budget) int32, valid (R, budget) bool, total (R,)
    int32), ``total`` being the full ring population |N_k|.
    """
    nr, nb = cum.shape
    total = cum[:, -1]
    slots = torch.arange(budget, dtype=torch.int32, device=cum.device)
    j = torch.searchsorted(cum, slots.expand(nr, budget).contiguous(),
                           right=True).clamp_max(nb - 1)
    prev = torch.where(j > 0, cum.gather(1, (j - 1).clamp_min(0)), 0)
    pos = view.bucket_starts[tid[:, None], j] + (slots - prev)
    valid = slots < total[:, None]
    pos = torch.where(valid, pos, 0).clamp(0, view.order.shape[1] - 1)
    return view.order[tid[:, None], pos.long()], valid, total


# ---- the estimate cache's CLOCK insert ------------------------------------

def cache_insert(cache, qcodes, qhash, tau_keys, balls, params_epoch, ests,
                 nvisited, probed_k, active, match_qhash: bool):
    """The reference's insert loop (``repro/cache/estimate_cache.py``
    ``insert``), lane by lane in torch, with no host read: the plain
    version of ``cache_insert`` (``csrc/cache.cu``). Updates the fields of
    ``cache`` (an ``EstimateCache``) in place, ``hand`` too, and returns
    the evictions of live entries as a 0-d int32 tensor.

    For each active lane: the first valid entry whose key (``tau_key``,
    all (L, K) codes and, with ``match_qhash``, both fingerprint words)
    equals the lane's is overwritten; without one, the CLOCK hand sweeps
    from ``hand + 1`` to the first entry that is not both valid and
    referenced, clearing ``ref`` on every entry it passed (on all of them
    when none qualifies, taking the first), and that victim is written.
    A written entry is valid with ``ref`` clear; the hand moves only on an
    eviction."""
    c = cache
    s = c.est.shape[0]
    dev = c.est.device
    pos = torch.arange(s, device=dev)
    n_ev = torch.zeros((), dtype=torch.int32, device=dev)
    for i in range(qcodes.shape[0]):
        m = c.valid & (c.tau_key == tau_keys[i]) & \
            (c.qcodes == qcodes[i][None]).flatten(1).all(-1)
        if match_qhash:
            m = m & (c.qhash == qhash[i][None]).all(-1)
        use_existing = m.any()
        order = (c.hand.long() + 1 + pos) % s
        claimable = ~(c.ref[order] & c.valid[order])
        found = claimable.any()
        vpos = torch.argmax(claimable.to(torch.int32))
        victim = order[vpos.reshape(1)]
        passed = (pos < vpos) | ~found
        slot = torch.where(use_existing, torch.argmax(m.to(torch.int32)),
                           victim)              # (1,): no host read
        do = active[i]
        do_evict = do & ~use_existing
        n_ev += (do_evict & c.valid[victim][0]).to(torch.int32)
        c.ref[order] = c.ref[order] & ~(passed & do_evict)
        for field, v in ((c.qcodes, qcodes[i]), (c.qhash, qhash[i]),
                         (c.tau_key, tau_keys[i]), (c.snap_ball, balls[i]),
                         (c.snap_params, params_epoch),
                         (c.probed_k, probed_k[i]), (c.est, ests[i]),
                         (c.nvisited, nvisited[i])):
            field[slot] = torch.where(do, v, field[slot])
        c.valid[slot] = c.valid[slot] | do
        c.ref[slot] = c.ref[slot] & ~do
        c.hand.copy_(torch.where(do_evict, victim[0].to(torch.int32),
                                 c.hand))
    return n_ev


def neighbor_dists(codes, n_valid, max_dist, r0, r1, out):
    """The bucket-neighbor table's entries with i or j in [r0, r1), written
    into ``out`` (B, B) int8: ``popcount(codes[i] != codes[j])`` where
    i, j < ``n_valid`` and 0 < d <= ``max_dist``, else 0. The row strip is
    one (r1 − r0, B, K) compare; the column strip is its transpose (the
    table is symmetric)."""
    b = codes.shape[0]
    d = (codes[r0:r1, None, :] != codes[None, :, :]).sum(
        -1, dtype=torch.int32)
    valid = torch.arange(b, device=codes.device) < n_valid
    keep = valid[r0:r1, None] & valid[None, :] & (d > 0) & (d <= max_dist)
    strip = torch.where(keep, d, 0).to(torch.int8)
    out[r0:r1] = strip
    out[:, r0:r1] = strip.T
    return out
