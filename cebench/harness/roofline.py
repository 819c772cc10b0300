"""Peaks of the card and the work of the measured layers, frozen here.

Peaks: NVIDIA's H100 SXM data sheet (dense, no sparsity), at the full
700 W power limit; a run records the card's own limit beside its shares.
The work formulas are copies of the program's ``kernels/ops.py``
``query_lanes_work`` and ``slab_qualify_work`` as they stood when the
benchmark was defined, plus the ring cumsums' bytes. Each counts the bytes
that a call's inputs need, each input read once and each output written
once, and the operations it must do. Where a layer works over the index's
bucket rows, only the live rows count: the rows past ``n_buckets`` pad the
capacity and hold nothing that an answer needs.
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12          # HBM3
FP32_FLOP_S = 67e12            # float32 outside the tensor cores


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: bytes at peak bandwidth or
    operations at the float32 peak, the larger."""
    return max(nbytes / HBM_BYTES_S, flops / FP32_FLOP_S)


def share_pct(nbytes: float, flops: float, seconds: float) -> float | None:
    """A layer's share of its roofline in %: its bound over its device
    time; nothing where no device time was read."""
    if seconds <= 0:
        return None
    return 100.0 * bound_s(nbytes, flops) / seconds


def query_lanes_work(nq: int, d: int, nl: int, k: int,
                     live: int) -> tuple[int, int]:
    """The queries (Q, d), the hash functions a (d, L·K), b and w, the
    ``live`` bucket rows' codes (of all L tables) and n_buckets in; codes
    (Q, L, K) and each query's Hamming distance to every live row out.
    Operations: a multiply-add a coordinate and function, and a compare
    and an add a function of each live (query, bucket) pair."""
    f = nl * k
    return (4 * (nq * d + d * f + 2 * f + live * k + nl + nq * nl * k
                 + nq * live),
            2 * nq * d * f + 2 * nq * live * k)


def slab_qualify_work(na: int, d: int, exact_rows: int, exact_lanes: int,
                      adc_rows: int = 0, adc_lanes: int = 0, cb: int = 0,
                      lut_bytes: int = 0, m: int = 0) -> tuple[int, int]:
    """Slab steps over ``na`` lanes: a candidate qualified exactly reads its
    row (4d bytes), one by ADC its code row (``cb`` bytes), and each its
    starts and order entries and one 32-byte sector of the ring cumsum
    around its draw (40 bytes); a lane reads its query row or LUT, and its
    state, constants and outputs (104 bytes). Operations: a subtract and a
    multiply-add a coordinate, or a lookup-add a subspace."""
    nbytes = (exact_rows * (4 * d + 40) + adc_rows * (cb + 40)
              + exact_lanes * 4 * d + adc_lanes * lut_bytes + na * 104)
    return nbytes, exact_rows * 3 * d + adc_rows * m


def ring_cumsums_bytes(nq: int, live: int, n_rings: int) -> int:
    """The masked size cumsums of rings 0..K of every lane over the
    ``live`` bucket rows of all tables: each query's Hamming distance to
    each live row and the live rows' sizes read once, K+1 int32 cumsum
    entries a (query, live row) written once."""
    return 4 * (nq * live + live + nq * (n_rings + 1) * live)
