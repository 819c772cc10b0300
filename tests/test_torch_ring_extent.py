"""Ring construction over the index's live bucket rows only.

A capacity-padded index keeps its bucket axis at the capacity C, but rows
past ``n_buckets`` are padding: at Hamming distance K+1 from every query,
in no ring. The prober reads the first ``LSHIndex.live_extent`` rows
(``max(n_buckets)`` rounded up to a power of two, known on the host), and
every estimate, ``probed_k`` and ``nvisited`` stays bit-equal to the
full-axis path (``n_buckets_max=None``) on every route; the extent follows
builds, ingests and capacity growth.

The ``cuda``-marked test skips without a card. On the card: the slab loop
over a capacity-padded 2^16 index is bit-equal to the full-axis path and
makes no more host syncs."""
import pytest
import torch

from repro_torch.core import estimator as E, lsh, prober, updates
from repro_torch.core.config import ProberConfig
from repro_torch.data import vectors
from repro_torch.kernels import ops

N0, N, N_ALL, DIM, CAP = 300, 3000, 8000, 32, 4096
# K = 10 functions: 300 points make ~230 buckets a table (extent 256),
# 3,000 ~900 (1,024) and 8,000 ~1,600 (2,048, past the capacity)
CFG = ProberConfig(n_tables=2, n_funcs=10, ring_budget=256,
                   central_budget=256, max_visit=1024, chunk=64, eps=0.06,
                   pq_m=8, pq_kc=16, pq_iters=4)
ROUTES = {
    "exact": dict(),
    "float": dict(use_pq=True),
    "banded": dict(use_pq=True, pq_banded=True),
    "q8": dict(use_pq=True, pq_int8_lut=True),
    "q8-packed": dict(use_pq=True, pq_int8_lut=True, pq_pack4=True),
}


@pytest.fixture(scope="module")
def data():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    g = torch.Generator().manual_seed(0)
    x = vectors.make_corpus(g, N_ALL, DIM)
    qs, taus, _ = vectors.paper_query_workload(g, x[:N], 16, n_taus=4)
    yield x, qs.repeat_interleave(2, 0), taus[:, 1:3].reshape(-1)
    torch.set_num_threads(old)


def _build(x, cfg, n, capacity=CAP, device="cpu"):
    return E.build(x[:n], cfg, generator=torch.Generator().manual_seed(1),
                   capacity=capacity, device=device)


def _full(state):
    """``state`` with its live extent unknown: the full bucket axis."""
    return state._replace(index=state.index._replace(n_buckets_max=None))


def _rks(nq, device="cpu"):
    return E.draw_round_keys(torch.Generator().manual_seed(2), nq,
                             CFG.n_tables, device)


def _assert_same(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _extent_of(index) -> int:
    m = int(index.n_buckets.max())
    return min(index.bucket_codes.shape[1],
               max(256, updates.next_pow2(m)))


@pytest.mark.parametrize("route", list(ROUTES))
def test_cut_estimates_equal_the_full_axis(data, route):
    x, qs, taus = data
    cfg = CFG.replace(**ROUTES[route])
    state = _build(x, cfg, N)
    ix = state.index
    assert ix.n_buckets_max == int(ix.n_buckets.max())
    assert ix.live_extent == _extent_of(ix) < CAP
    view = prober.table_views(ix)
    assert view.bucket_codes.shape[1] == view.bucket_starts.shape[1] == \
        view.bucket_sizes.shape[1] == ix.live_extent
    rks = _rks(qs.shape[0])
    got = E.estimate_batch_stats(state, qs, taus, cfg, rks=rks)
    want = E.estimate_batch_stats(_full(state), qs, taus, cfg, rks=rks)
    _assert_same(got, want)
    assert float(got[0].sum()) > 0


@pytest.mark.parametrize("n", (N0, N))
def test_cut_ring_cumsums_are_the_full_ones_first_columns(data, n):
    x, qs, _ = data
    ix = _build(x, CFG, n).index
    e = ix.live_extent
    hams, cums = [], []
    for index in (ix, ix._replace(n_buckets_max=None)):
        view = prober.table_views(index)
        _, ham = lsh.query_lanes(index.params, qs, view.bucket_codes,
                                 view.n_buckets)
        hams.append(ham)
        cums.append(prober.ring_cumsums(view, ham, CFG.n_funcs))
    (ham_cut, ham_full), (cut, full) = hams, cums
    assert ham_full.shape[-1] == CAP > e == ham_cut.shape[-1]
    assert torch.equal(ham_cut, ham_full[..., :e])
    assert (ham_full[..., e:] == CFG.n_funcs + 1).all()
    assert torch.equal(cut, full[..., :e])
    assert torch.equal(cut[..., -1], full[..., -1])


def _after(x, cfg, case):
    """The state before and after ``case``: an ingest within capacity that
    takes ``max(n_buckets)`` past the extent's power of two, one past the
    capacity (growth, then the ingest), or a growth alone."""
    if case == "update":
        before = _build(x, cfg, N0)
        return before, E.update(before, x[N0:N], cfg)
    before = _build(x, cfg, N)
    if case == "grow":
        return before, E.update(before, x[N:], cfg)
    return before, E._grow(before, 2 * CAP)


@pytest.mark.parametrize("case", ("update", "grow", "grow-only"))
@pytest.mark.parametrize("route", ("exact", "q8"))
def test_extent_follows_ingest_and_growth(data, case, route):
    x, qs, taus = data
    cfg = CFG.replace(**ROUTES[route])
    before, after = _after(x, cfg, case)
    ix = after.index
    assert after.capacity == (CAP if case == "update" else 2 * CAP)
    assert ix.n_buckets_max == int(ix.n_buckets.max())
    assert ix.live_extent == _extent_of(ix) < after.capacity
    if case == "grow-only":
        assert ix.live_extent == before.index.live_extent
    else:
        assert ix.live_extent > before.index.live_extent
    rks = _rks(qs.shape[0])
    _assert_same(E.estimate_batch_stats(after, qs, taus, cfg, rks=rks),
                 E.estimate_batch_stats(_full(after), qs, taus, cfg,
                                        rks=rks))


@pytest.mark.parametrize("capacity", (None, CAP))
def test_a_plain_build_reads_its_whole_bucket_axis(data, capacity):
    """A plain build's bucket axis is already ``max(n_buckets)`` rounded
    up to 256, which the extent never undercuts: its view is the index's
    own arrays. A capacity-padded one is cut, by copies."""
    x, _, _ = data
    ix = _build(x, CFG, N, capacity=capacity).index
    view = prober.table_views(ix)
    plain = capacity is None
    assert (ix.live_extent == ix.bucket_codes.shape[1]) == plain
    for name in ("bucket_codes", "bucket_starts", "bucket_sizes"):
        assert (getattr(view, name) is getattr(ix, name)) == plain
        assert getattr(view, name).is_contiguous()


@pytest.mark.parametrize("calls", (1, 2))
def test_the_tally_counts_the_ring_rows_of_traced_calls(data, calls):
    from torch.profiler import ProfilerActivity, profile
    x, qs, taus = data
    state = _build(x, CFG, N)
    rks = _rks(qs.shape[0])
    prober.reset_tally()
    E.estimate_batch(state, qs, taus, CFG, rks=rks)      # untraced
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(calls):
            E.estimate_batch(state, qs, taus, CFG, rks=rks)
    t = prober.read_tally()
    prober.reset_tally()
    lanes = qs.shape[0] * CFG.n_tables
    assert t["calls"] == calls
    assert t["ring_rows"] == calls * lanes * state.index.live_extent
    assert prober.read_tally()["ring_rows"] == 0


# ---- on the card -----------------------------------------------------------

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


def _to(obj, dev):
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to(v, dev) for v in obj))
    return obj


def _syncs(fn) -> int:
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.name in SYNCS for e in prof.events())


@pytest.mark.cuda
@pytest.mark.parametrize("route", ("exact", "float", "q8"))
def test_cuda_slab_loop_over_the_cut_axis_equals_the_full_axis(route):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the slab loop is a CUDA kernel")
    cfg = CFG.replace(**ROUTES[route])
    g = torch.Generator().manual_seed(0)
    x = vectors.make_corpus(g, 40000, DIM)
    qs, taus, _ = vectors.paper_query_workload(g, x, 64, n_taus=4)
    cut = _to(_build(x, cfg, 40000, capacity=2 ** 16), "cuda")
    full = _full(cut)
    assert cut.index.live_extent < 2 ** 16
    q, t = qs.cuda(), taus[:, 1].contiguous().cuda()
    rks = _rks(q.shape[0], "cuda")
    runs = {}
    for name, state in (("full", full), ("cut", cut)):
        E.estimate_batch_stats(state, q, t, cfg, rks=rks)      # warm
        torch.cuda.synchronize()
        ops.reset_launches()
        runs[name] = E.estimate_batch_stats(state, q, t, cfg, rks=rks)
        assert ops.LAUNCHES["slab_loop"] == 1
        assert ops.LAUNCHES["slab_qualify"] == 0
    _assert_same(runs["cut"], runs["full"])
    syncs = {name: _syncs(lambda: E.estimate_batch(state, q, t, cfg,
                                                   rks=rks))
             for name, state in (("full", full), ("cut", cut))}
    prober.reset_tally()
    assert syncs["cut"] <= syncs["full"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        E.estimate_batch(cut, q, t, cfg, rks=rks)
    finally:
        torch.cuda.set_sync_debug_mode(0)
