"""The harness's own arithmetic: rates and percentiles, spreads, the
frozen work formulas, the trace reduction, and the reference's kernel-order
float32 sums, each on hand-made cases."""
from __future__ import annotations

import statistics

import numpy as np
import pytest
import torch

from cebench.tests import _util  # noqa: F401  (paths)
from cebench.harness import roofline, stats, trace
from cebench.reference import arith, prober as ref


def test_rate_is_the_work_over_all_the_window():
    assert stats.rate(128 * 100, 40.0) == 320.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


@pytest.mark.parametrize("values,p,want", [
    (list(range(1, 101)), 90, 90), (list(range(1, 11)), 90, 9),
    ([5.0, 1.0, 3.0], 50, 3.0), ([2.0], 90, 2.0),
    (list(range(1, 102)), 90, 91)])
def test_percentile_is_the_nearest_rank(values, p, want):
    assert stats.percentile(values, p) == want


def test_spread_is_the_quartile_gap_over_the_median():
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == (q3 - q1) / med
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0


def test_q_error_clamps_at_one():
    assert stats.q_error(0.0, 0) == 1.0
    assert stats.q_error(50.0, 100) == 2.0 == stats.q_error(200.0, 100)


def test_work_formulas_against_hand_sums():
    # 2 queries, d 4, 1 table of 3 functions, 5 live bucket rows
    nbytes, ops = roofline.query_lanes_work(2, 4, 1, 3, 5)
    want = 4 * (2 * 4 + 4 * 3 + 2 * 3 + 5 * 3 + 1 + 2 * 3 + 2 * 5)
    assert (nbytes, ops) == (want, 2 * 2 * 4 * 3 + 2 * 2 * 5 * 3)
    nbytes, ops = roofline.slab_qualify_work(3, 4, 10, 3)
    assert nbytes == 10 * (16 + 40) + 3 * 16 + 3 * 104
    assert ops == 10 * 3 * 4
    # the ADC route: 7 candidates of 2 lanes by codes of 5 bytes over LUTs
    # of 80 bytes, beside 10 exact ones of 3 lanes, 4 lanes in all
    nbytes, ops = roofline.slab_qualify_work(4, 4, 10, 3, 7, 2, cb=5,
                                             lut_bytes=80, m=5)
    assert nbytes == 10 * (16 + 40) + 7 * (5 + 40) + 3 * 16 + 2 * 80 \
        + 4 * 104
    assert ops == 10 * 3 * 4 + 7 * 5
    # 2 queries, 5 live rows over the tables, rings 0..3
    assert roofline.ring_cumsums_bytes(2, 5, 3) == \
        4 * (2 * 5 + 5 + 2 * 4 * 5)


def test_roofline_share_takes_the_larger_bound():
    one_ms_bytes = roofline.HBM_BYTES_S * 1e-3
    assert roofline.share_pct(one_ms_bytes, 0, 2e-3) == pytest.approx(50.0)
    flops = roofline.FP32_FLOP_S * 1e-3
    assert roofline.share_pct(one_ms_bytes / 10, flops, 4e-3) == \
        pytest.approx(25.0)
    assert roofline.share_pct(1.0, 0.0, 0.0) is None


def _ev(name, dev, s, e, tree=0.0, tid=1):
    return trace.Ev(name, dev, float(s), float(e), tid, tree)


def test_trace_summary_on_a_hand_made_timeline():
    evs = [_ev(trace.BATCH, False, 0, 100), _ev(trace.BATCH, False, 100, 200),
           _ev(trace.SPAN_RINGS, False, 5, 40, tree=30.0),
           _ev("aten::cumsum", False, 6, 30),
           _ev("cudaLaunchKernel", False, 7, 8),
           _ev("cudaLaunchKernelExC", False, 9, 10),
           _ev("cudaStreamSynchronize", False, 50, 60),
           _ev("cudaMemcpyAsync", False, 61, 62),
           _ev("aten::nonzero", False, 120, 190),
           _ev("k_cumsum", True, 10, 40), _ev("k_slab", True, 30, 50),
           _ev("k_slab", True, 150, 160),
           _ev(trace.SPAN_RINGS, True, 10, 40),      # a device annotation
           _ev("k_outside", True, 300, 310)]
    s = trace.summarize(evs)
    assert (s.batches, s.launches, s.syncs) == (2, 2, 1)
    assert s.window_s == pytest.approx(200e-6)
    assert s.busy_s == pytest.approx(50e-6)          # [10, 50] and [150, 160]
    assert s.span_device_s == {trace.SPAN_RINGS: pytest.approx(30e-6)}
    assert trace.kernel_seconds(s, "k_slab") == pytest.approx(30e-6)
    gaps = dict(s.idle_gaps)
    # [0, 10] mid 5 inside the ring span, [50, 150] mid 100 at the batch
    # boundary (no operator), [160, 200] mid 180 in nonzero
    assert gaps[trace.SPAN_RINGS] == pytest.approx(10e-6)
    assert gaps[trace.NO_OP] == pytest.approx(100e-6)
    assert gaps["aten::nonzero"] == pytest.approx(40e-6)
    assert s.device_ops[0][0] in ("k_cumsum", "k_slab")
    assert trace.summarize([_ev("x", True, 0, 1)]) is None


def test_fma_chain_matches_a_float64_fma_by_hand():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 37)).astype(np.float32)
    a = rng.standard_normal((37, 3)).astype(np.float32)
    got = arith.dot_sequential(torch.from_numpy(x), torch.from_numpy(a))
    for i in range(5):
        for c in range(3):
            s = np.float32(0)
            for j in range(37):
                s = np.float32(np.float64(x[i, j]) * np.float64(a[j, c])
                               + np.float64(s))
            assert got[i, c].item() == s


def test_warp_distance_sums_in_the_kernels_order():
    rng = np.random.default_rng(4)
    for d in (16, 128, 960):
        r = rng.standard_normal((3, d)).astype(np.float32)
        q = rng.standard_normal((3, d)).astype(np.float32)
        got = arith.sq_dist_warp(torch.from_numpy(r), torch.from_numpy(q))
        for i in range(3):
            acc = np.zeros(32, np.float32)
            e = (r[i] - q[i]).reshape(-1, 4)
            for j in range(e.shape[0]):
                ln = j % 32
                for c in range(4):
                    acc[ln] = np.float32(np.float64(e[j, c]) ** 2
                                         + np.float64(acc[ln]))
            for o in (16, 8, 4, 2, 1):
                acc = (acc + acc[np.arange(32) ^ o]).astype(np.float32)
            assert got[i].item() == acc[0]
            exact = float(((r[i].astype(np.float64) - q[i]) ** 2).sum())
            assert got[i].item() == pytest.approx(exact, rel=1e-5)


def test_adc_adds_the_subspaces_in_order():
    g = torch.Generator().manual_seed(5)
    lut = torch.rand((2, 4, 6), generator=g)
    codes = torch.randint(0, 6, (2, 3, 4), generator=g)
    got = arith.adc_in_order(lut, codes)
    for q in range(2):
        for c in range(3):
            s = torch.zeros((), dtype=torch.float32)
            for m in range(4):
                s = s + lut[q, m, codes[q, c, m]]
            assert got[q, c].item() == s.item()


def test_search_right_is_searchsorted_right():
    g = torch.Generator().manual_seed(6)
    cum = torch.cumsum(torch.randint(0, 3, (5, 40), generator=g), 1).int()
    rows = torch.tensor([0, 3, 4, 1])
    v = torch.randint(0, 60, (4, 9), generator=g)
    want = torch.searchsorted(cum[rows], v.int(), right=True)
    assert torch.equal(ref.search_right(cum, rows, v), want)


def test_prp_is_a_permutation_of_its_domain():
    g = torch.Generator().manual_seed(7)
    rk = torch.randint(0, 2 ** 32, (3, 6), generator=g)
    for n in (0, 1, 5, 11):
        idx = torch.arange(1 << n)[None].expand(3, -1)
        p = ref.prp(idx, rk, torch.full((3,), (1 << n) - 1),
                    torch.full((3,), n))
        for row in p:
            assert sorted(row.tolist()) == list(range(1 << n))


def test_bit_length_is_exact_at_every_power_of_two():
    v = torch.tensor([0, 1, 2, 3, 7, 8, 9, 2 ** 20 - 1, 2 ** 20, 2 ** 30])
    assert ref._bit_length(v).tolist() == [int(x).bit_length()
                                           for x in v.tolist()]
