"""The port's estimate cache against the reference's (``repro.cache``), on
the CPU with numpy inputs from a seed: the query fingerprint and tau band,
the probed-ball populations, lookup and the CLOCK insert field by field
over a sequence of flushes, the bridge, and the ingest epochs through
``update``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_state_numpy
from repro.cache import epochs as JEp, estimate_cache as JC
from repro.core import config as jconfig, estimator as JE, lsh as jlsh
from repro_torch import bridge
from repro_torch.cache import epochs as Ep, estimate_cache as C
from repro_torch.core import config, estimator as E, lsh

KW = dict(n_tables=2, n_funcs=6, ring_budget=512, central_budget=512,
          chunk=128)
U32 = 0xFFFFFFFF


@pytest.fixture(scope="module")
def data():
    return np.random.default_rng(11).standard_normal((3000, 16)).astype(
        np.float32)


def _cfgs():
    return jconfig.ProberConfig(**KW), config.ProberConfig(**KW)


def _bridged(data, n=1024, capacity=2048):
    jcfg, _ = _cfgs()
    jst = JE.build(jnp.asarray(data[:n]), jcfg, jax.random.PRNGKey(0),
                   capacity=capacity, track_epochs=True)
    return jst, bridge.state_from_numpy(jax_state_numpy(jst), "cpu")


def _jcache_numpy(cache) -> dict:
    return {k: np.asarray(v) for k, v in cache._asdict().items()}


def _assert_cache_equal(tcache, jcache):
    got, want = bridge.cache_to_numpy(tcache), _jcache_numpy(jcache)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---- fingerprint and tau band ---------------------------------------------

@pytest.mark.parametrize("shape,seed", [((7, 16), 0), ((3, 128), 1),
                                        ((2, 5, 9), 2), ((1,), 3)])
def test_query_hash_bit_equal(shape, seed):
    rng = np.random.default_rng(seed)
    qs = (rng.standard_normal(shape) * 10 ** rng.uniform(
        -3, 3, shape)).astype(np.float32)
    flat = qs.reshape(-1)
    flat[0] = -0.0
    if flat.size > 3:
        flat[1] = np.float32(1e-40)                  # a denormal
        flat[2] = -np.float32(3e-45)                 # the smallest ones
        flat[3] = np.float32(3.4e38)
    want = np.asarray(JC.query_hash(jnp.asarray(qs)))
    got = C.query_hash(torch.from_numpy(qs))
    assert got.dtype == torch.int64 and tuple(got.shape) == shape[:-1] + (2,)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_query_hash_tells_apart_zero_signs_and_one_bit():
    q = np.zeros((3, 8), np.float32)
    q[1, 4] = -0.0
    q[2, 4] = np.nextafter(np.float32(0), np.float32(1))
    h = C.query_hash(torch.from_numpy(q)).numpy()
    assert len({tuple(r) for r in h}) == 3


@pytest.mark.parametrize("reuse_tol", [0.0, 0.3])
def test_tau_band_equal_away_from_band_edges(reuse_tol):
    """Precondition at ``reuse_tol > 0``: no radius whose band value
    ``ln tau / ln(1 + reuse_tol)`` (float64) lies within 1e-5 of an
    integer, where two float32 logs may band differently."""
    taus = np.random.default_rng(4).uniform(0.05, 50.0, 400).astype(
        np.float32)
    taus[:3] = [1.0, 1e-35, 0.0]
    if reuse_tol > 0:
        v = np.log(np.maximum(taus.astype(np.float64), 1e-30)) \
            / np.log1p(reuse_tol)
        taus = taus[np.abs(v - np.round(v)) > 1e-5]
    want = np.asarray(JC.tau_band(jnp.asarray(taus), reuse_tol))
    got = C.tau_band(torch.from_numpy(taus), reuse_tol)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ---- epochs ---------------------------------------------------------------

def test_ball_sums_bit_equal_on_a_bridged_padded_state(data):
    jst, st = _bridged(data)
    ix = jst.index
    rng = np.random.default_rng(3)
    qs = data[2000:2012] + 0.01
    qcodes = np.array(jlsh.hash_point(ix.params, jnp.asarray(qs), 2))
    pk = rng.integers(0, KW["n_funcs"] + 1, (12, 2)).astype(np.int32)
    want = np.asarray(JEp.ball_sums(ix.bucket_codes, ix.bucket_sizes,
                                    ix.n_buckets, jnp.asarray(qcodes),
                                    jnp.asarray(pk)))
    tix = st.index
    got = Ep.ball_sums(tix.bucket_codes, tix.bucket_sizes, tix.n_buckets,
                       torch.from_numpy(qcodes), torch.from_numpy(pk))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # (3, 4) leading axes, and the row-gathering form over computed distances
    got = Ep.ball_sums(tix.bucket_codes, tix.bucket_sizes, tix.n_buckets,
                       torch.from_numpy(qcodes).reshape(3, 4, 2, -1),
                       torch.from_numpy(pk).reshape(3, 4, 2))
    np.testing.assert_array_equal(got.reshape(12, 2).numpy(), want)
    ham = lsh.hamming_to_buckets(tix.bucket_codes, tix.n_buckets,
                                 torch.from_numpy(qcodes))
    rows = torch.tensor([5, 0, 11, 5])
    got = Ep.ball_sums_from_ham(ham, tix.bucket_sizes,
                                torch.from_numpy(pk[rows.numpy()]), rows=rows)
    np.testing.assert_array_equal(got.numpy(), want[rows.numpy()])
    # every ring folded: the whole live population of each table
    full = Ep.ball_sums_from_ham(ham, tix.bucket_sizes,
                                 torch.full((12, 2), KW["n_funcs"]))
    assert (full == 1024).all()


@pytest.mark.parametrize("start,n_new,w_changed", [
    (0, 5, False), (7, 3, True), (U32, 2, True), (U32 - 1, 1, False)])
def test_ingest_bump_wraps_like_uint32(start, n_new, w_changed):
    want = JEp.ingest_bump(
        JEp.EpochState(jnp.uint32(start), jnp.uint32(start)),
        jnp.int32(n_new), jnp.bool_(w_changed))
    ep = Ep.EpochState(torch.tensor(start), torch.tensor(start))
    got = Ep.ingest_bump(ep, n_new, torch.tensor(w_changed))
    assert int(got.params_epoch) == int(want.params_epoch)
    assert int(got.n_ingested) == int(want.n_ingested)
    assert got.params_epoch.dtype == torch.int64


def test_epochs_through_update_match_reference(data):
    """``params_epoch`` and ``n_ingested`` after an in-capacity ingest that
    moves no extreme (midpoints of live points), a growth, and an ingest
    that moves W (far points)."""
    jcfg, cfg = _cfgs()
    jst, st = _bridged(data, n=1024, capacity=2048)
    mids = 0.5 * (data[:300] + data[300:600])
    far = data[2500:2600] * 4.0
    steps = [("in capacity, inside the extremes", mids[:200]),
             ("past capacity", data[1024:2200]),
             ("moving W", far)]
    epochs = []
    for tag, x_new in steps:
        jst = JE.update(jst, jnp.asarray(x_new), jcfg)
        st = E.update(st, torch.from_numpy(np.ascontiguousarray(x_new)), cfg)
        assert int(st.epochs.params_epoch) == int(jst.epochs.params_epoch), tag
        assert int(st.epochs.n_ingested) == int(jst.epochs.n_ingested), tag
        epochs.append(int(st.epochs.params_epoch))
    assert st.capacity == jst.capacity == 4096
    assert int(st.epochs.n_ingested) == 200 + 1176 + 100
    assert epochs[0] == 0, "an ingest inside the extremes moved W"
    assert epochs[2] == epochs[1] + 1, "the far points did not move W"


def test_growth_keeps_epochs_and_untracked_states_stay_without():
    _, cfg = _cfgs()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(300, 8, generator=g)
    st = E.build(x[:200], cfg, g, capacity=256, device="cpu")
    assert st.epochs is None
    assert E.update(st, x[200:], cfg).epochs is None
    st = E.attach_epochs(st)
    st = E.update(st, x[200:], cfg)
    assert st.capacity == 512 and int(st.epochs.n_ingested) == 100


def test_bridge_carries_epochs_and_cache_fields(data):
    jst, st = _bridged(data, n=600, capacity=1024)
    d = bridge.state_to_numpy(st)
    for k in bridge.EPOCH_KEYS:
        assert d[k].dtype == np.uint32 and d[k].shape == ()
    back = bridge.state_from_numpy(d, "cpu")
    assert back.epochs.params_epoch.dtype == torch.int64
    jc = JC.init_cache(5, 2, 6)
    jc = jc._replace(qhash=jnp.full((5, 2), 0xFFFFFFF0, jnp.uint32),
                     snap_params=jnp.asarray(
                         (np.arange(5) + U32 - 2) & U32, jnp.uint32))
    tc = bridge.cache_from_numpy(_jcache_numpy(jc), "cpu")
    assert tc.qhash.dtype == torch.int64 and int(tc.qhash.max()) == 0xFFFFFFF0
    _assert_cache_equal(tc, jc)
    _assert_cache_equal(C.init_cache(5, 2, 6, "cpu"), JC.init_cache(5, 2, 6))


# ---- lookup and the CLOCK insert -------------------------------------------

class _Pair:
    """The reference cache and the port's, driven with the same requests;
    every step compares every field."""

    def __init__(self, jst, st, size, match_qhash):
        self.jst, self.st = jst, st
        self.jc = JC.init_cache(size, 2, KW["n_funcs"])
        self.tc = C.init_cache(size, 2, KW["n_funcs"], "cpu")
        self.match_qhash = match_qhash
        self.rng = np.random.default_rng(size)

    def keys(self, qs, taus, reuse_tol):
        codes = np.array(jlsh.hash_point(self.jst.index.params,
                                         jnp.asarray(qs), 2))
        qh = np.array(JC.query_hash(jnp.asarray(qs)))
        tk = np.array(JC.tau_band(jnp.asarray(taus), reuse_tol))
        return codes, qh, tk

    def lookup(self, qs, taus, reuse_tol=0.0, live=None, check=True):
        codes, qh, tk = self.keys(qs, taus, reuse_tol)
        live = np.ones(len(qs), bool) if live is None else live
        ix = self.jst.index
        self.jc, jest, jhit, jstale = JC.lookup(
            self.jc, self.jst.epochs, ix.bucket_codes, ix.bucket_sizes,
            ix.n_buckets, jnp.asarray(codes), jnp.asarray(qh),
            jnp.asarray(tk), jnp.asarray(live), match_qhash=self.match_qhash,
            check_ingest=check)
        tix = self.st.index
        tcodes = torch.from_numpy(codes)
        ham = lsh.hamming_to_buckets(tix.bucket_codes, tix.n_buckets, tcodes)
        self.tc, est, hit, stale = C.lookup(
            self.tc, self.st.epochs, ham if check else None,
            tix.bucket_sizes, tcodes, torch.from_numpy(qh.astype(np.int64)),
            torch.from_numpy(tk), torch.from_numpy(live),
            match_qhash=self.match_qhash, check_ingest=check)
        np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
        np.testing.assert_array_equal(stale.numpy(), np.asarray(jstale))
        np.testing.assert_array_equal(est.numpy(), np.asarray(jest))
        _assert_cache_equal(self.tc, self.jc)
        return hit.numpy(), stale.numpy()

    def insert(self, qs, taus, reuse_tol=0.0, active=None):
        n = len(qs)
        codes, qh, tk = self.keys(qs, taus, reuse_tol)
        active = np.ones(n, bool) if active is None else active
        ests = self.rng.uniform(0, 100, n).astype(np.float32)
        nvis = self.rng.integers(0, 5000, n).astype(np.int32)
        pk = self.rng.integers(0, KW["n_funcs"] + 1, (n, 2)).astype(np.int32)
        ix = self.jst.index
        self.jc, jev = JC.insert(
            self.jc, self.jst.epochs, ix.bucket_codes, ix.bucket_sizes,
            ix.n_buckets, jnp.asarray(codes), jnp.asarray(qh),
            jnp.asarray(tk), jnp.asarray(ests), jnp.asarray(nvis),
            jnp.asarray(pk), jnp.asarray(active),
            match_qhash=self.match_qhash)
        tix = self.st.index
        tcodes = torch.from_numpy(codes)
        ham = lsh.hamming_to_buckets(tix.bucket_codes, tix.n_buckets, tcodes)
        balls = Ep.ball_sums_from_ham(ham, tix.bucket_sizes,
                                      torch.from_numpy(pk))
        self.tc, ev = C.insert(
            self.tc, self.st.epochs, balls, tcodes,
            torch.from_numpy(qh.astype(np.int64)), torch.from_numpy(tk),
            torch.from_numpy(ests), torch.from_numpy(nvis),
            torch.from_numpy(pk), torch.from_numpy(active),
            match_qhash=self.match_qhash)
        assert ev.dtype == torch.int32 and int(ev) == int(jev)
        _assert_cache_equal(self.tc, self.jc)
        return int(ev)


@pytest.mark.parametrize("match_qhash", [True, False])
def test_lookup_and_insert_match_reference_field_by_field(data, match_qhash):
    jcfg, cfg = _cfgs()
    jst, st = _bridged(data, n=1024, capacity=2048)
    pair = _Pair(jst, st, 8, match_qhash)
    pool = data[2000:2030] + 0.01
    t = np.float32(4.0)
    # duplicates within one flush (lanes 0/3, 1/5), an inactive lane
    idx = [0, 1, 2, 0, 3, 1, 4]
    active = np.array([1, 1, 1, 1, 1, 1, 0], bool)
    assert pair.insert(pool[idx], np.full(7, t), active=active) == 0
    assert pair.tc.valid.sum() == 4
    hit, _ = pair.lookup(pool[[0, 2, 9, 3]], np.full(4, t), check=False)
    assert hit.tolist() == [True, True, False, True]
    # fill the cache and evict: the hand sweeps past referenced entries
    assert pair.insert(pool[5:12], np.full(7, t)) > 0
    # every entry referenced: the next insert sweeps all S, then evicts
    keys = pool[[i for i in range(30)
                 if pair.lookup(pool[[i]], [t])[0][0]]]
    assert len(keys) == 8 and pair.tc.ref.all()
    hand = int(pair.tc.hand)
    assert pair.insert(pool[20:21], [t]) == 1
    assert int(pair.tc.hand) == (hand + 1) % 8
    assert int(pair.tc.ref.sum()) == 0
    # a key with another tau and, without the fingerprint, a near-duplicate
    q2 = pool[20].copy()
    q2[0] = np.nextafter(q2[0], np.float32(np.inf))
    assert np.array_equal(pair.keys(q2[None], [t], 0.0)[0],
                          pair.keys(pool[20:21], [t], 0.0)[0])
    pair.insert(np.stack([pool[20], q2]), np.array([t, 5.0], np.float32))
    hit, _ = pair.lookup(q2[None], [t])
    assert hit[0] == (not match_qhash)
    # an ingest into probed balls: stale entries, refreshed in place
    pair.insert(pool[21:29], np.full(8, t))
    x_new = data[2021:2029:3] + 0.05
    pair.jst = JE.update(pair.jst, jnp.asarray(x_new), jcfg)
    pair.st = E.update(pair.st, torch.from_numpy(x_new), cfg)
    np.testing.assert_array_equal(pair.st.index.params.w.numpy(),
                                  np.asarray(pair.jst.index.params.w))
    look = pool[21:29]
    live = np.array([1] * 7 + [0], bool)
    hit, stale = pair.lookup(look, np.full(8, t), live=live)
    assert stale.any() and not hit[7] and not stale[7]
    valid_before = int(pair.tc.valid.sum())
    pair.insert(look[stale], np.full(int(stale.sum()), t))
    hit, stale = pair.lookup(look[stale], np.full(int(stale.sum()), t))
    assert hit.all() and int(pair.tc.valid.sum()) == valid_before


def test_lookup_and_insert_match_reference_banded(data):
    """reuse_tol 0.3: keys are codes and tau bands; a near-duplicate query
    with a tau in the same band hits."""
    jst, st = _bridged(data, n=1024, capacity=2048)
    pair = _Pair(jst, st, 4, match_qhash=False)
    pool = data[2100:2110] + 0.01
    taus = np.array([3.0, 4.0, 5.5, 8.0, 3.0, 4.0], np.float32)
    pair.insert(pool[[0, 1, 2, 3, 4, 5]], taus, reuse_tol=0.3)
    near = pool[[4, 5, 6]] + 1e-6
    assert np.array_equal(pair.keys(near, taus[:3], 0.3)[0],
                          pair.keys(pool[[4, 5, 6]], taus[:3], 0.3)[0])
    hit, _ = pair.lookup(near,
                         np.array([3.1, 4.2, 5.0], np.float32),
                         reuse_tol=0.3)
    assert hit[:2].all()


def test_cache_wrapper_raises_on_mixed_devices():
    c = C.init_cache(4, 2, 3, "cpu")
    n = 2
    lanes = [torch.zeros((n, 2, 3), dtype=torch.int32),
             torch.zeros((n, 2), dtype=torch.int64),
             torch.zeros(n, dtype=torch.int32),
             torch.zeros((n, 2), dtype=torch.int32),
             torch.zeros((), dtype=torch.int64), torch.zeros(n),
             torch.zeros(n, dtype=torch.int32),
             torch.zeros((n, 2), dtype=torch.int32),
             torch.ones(n, dtype=torch.bool)]
    from repro_torch.kernels import ops
    with pytest.raises(ValueError, match="no kernel"):
        ops.cache_insert(C.EstimateCache(*(t.to("meta") for t in c)),
                         *(t.to("meta") for t in lanes), True)
    with pytest.raises(ValueError, match="different devices"):
        ops.cache_insert(c, *(t.to("meta") for t in lanes), True)
    assert int(ops.cache_insert(c, *lanes, True)) == 0
    assert int(c.valid.sum()) == 1       # two lanes of one key: one entry
