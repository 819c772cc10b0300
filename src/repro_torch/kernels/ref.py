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
