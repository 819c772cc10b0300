"""The port's serving path: ``CardinalityCoalescer`` with the estimate
cache and ``SemanticPlanner``, on the CPU.

The first tests are the reference's coalescer tests (``test_cache.py``) run
on the port: exact repeats hit bit-identically, near-duplicates miss at
tol 0, ``reuse_tol`` bands tau, an ingest invalidates, no stale serve on a
mixed stream across a capacity doubling (checked by an exact shadow
tracker), entries survive growth, CLOCK prefers cold entries, and the
cache does not perturb the probes it wraps. The reference's test that an
all-hit flush compiles nothing has no torch counterpart. Then parity with
the reference's coalescer and planner on a bridged state with the
reference's round keys, and, on the card, the ``cache_insert`` kernel
against its plain version (the machine with the card has no jax, so this
module imports it only where it is used).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from _torch_parity import jax_state_numpy, reference_round_keys
from repro_torch import bridge
from repro_torch.cache import estimate_cache as C
from repro_torch.core import config, estimator as E, lsh
from repro_torch.kernels import ops, ref
from repro_torch.serve.coalescer import CardinalityCoalescer
from repro_torch.serve.semantic import SemanticPlanner

KW = dict(n_tables=2, n_funcs=6, ring_budget=512, central_budget=512,
          chunk=128)
CFG = config.ProberConfig(**KW)


@pytest.fixture(scope="module")
def data():
    return np.random.default_rng(0).standard_normal((2048, 16)).astype(
        np.float32)


def _coalescer(data, cfg=CFG, n=1024, capacity=4096, cache_size=64,
               reuse_tol=0.0, max_batch=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    st_ = E.build(torch.from_numpy(data[:n]), cfg, g, capacity=capacity,
                  track_epochs=True, device="cpu")
    return CardinalityCoalescer(st_, cfg, g, max_batch=max_batch,
                                cache_size=cache_size, reuse_tol=reuse_tol)


def _codes(state, q):
    return lsh.hash_point(state.index.params, torch.as_tensor(q),
                          CFG.n_tables).numpy()


def test_exact_repeat_hits_bit_identical(data):
    co = _coalescer(data)
    qs = [data[i] + 0.01 for i in range(5)]
    taus = [3.0, 4.0, 5.0, 3.5, 4.5]
    first = [co.submit(qs[i], taus[i]) for i in range(5)]
    out0 = co.flush()
    assert all(r.provenance == "probe" for r in first)
    assert all(out0[r.rid].provenance == "probe" for r in first)
    assert all(r.probed_k.shape == (2,) and r.nvisited >= 0 for r in first)
    again = [co.submit(qs[i], taus[i]) for i in range(5)]
    out1 = co.flush()
    for a, b in zip(first, again):
        assert b.provenance == "hit" and out1[b.rid].provenance == "hit"
        assert a.est == b.est                      # bit-identical
        assert b.probed_k is None and b.nvisited is None
    assert co.cache_stats["hits"] == 5 and co.cache_stats["misses"] == 5
    r = co.submit(qs[0], taus[0] + 1e-3)           # another tau
    co.flush()
    assert r.provenance == "probe"


def test_near_duplicate_query_misses_at_tol_zero(data):
    co = _coalescer(data)
    q = data[3] + 0.01
    co.submit(q, 4.0)
    co.flush()
    q2 = q.copy()
    q2[0] = np.nextafter(q2[0], np.float32(np.inf))   # same codes, new bits
    r = co.submit(q2, 4.0)
    co.flush()
    assert r.provenance == "probe"


def test_reuse_tol_bands_tau_and_lsh_keys(data):
    co = _coalescer(data, reuse_tol=0.3)
    q = data[7] + 0.01
    co.submit(q, 5.0)
    co.flush()
    r_band = co.submit(q, 5.5)                     # same (1 + 0.3) band
    co.flush()
    assert r_band.provenance == "hit"
    r_far = co.submit(q, 8.0)
    co.flush()
    assert r_far.provenance == "probe"
    q2 = q + 1e-6
    same = np.array_equal(_codes(co.state, q), _codes(co.state, q2))
    r_near = co.submit(q2, 5.0)
    co.flush()
    assert r_near.provenance == ("hit" if same else "probe")


def test_ingest_into_probed_bucket_invalidates(data):
    co = _coalescer(data, cfg=CFG.replace(ingest_chunk=64))
    q = data[0] + 50.0                             # isolated: est ~ 0
    r0 = co.submit(q, 3.0)
    co.flush()
    assert r0.est < 1.0
    cluster = q[None, :] + 0.05 * np.random.default_rng(1).standard_normal(
        (128, 16)).astype(np.float32)
    co.ingest(cluster)
    r1 = co.submit(q, 3.0)
    co.flush()
    assert r1.provenance in ("stale-refresh", "probe")
    assert r1.est > 50.0, r1.est


class _ShadowTracker:
    """Exact mirror of what may be served from the cache: for every cached
    key, whether an ingest since its probe landed within its probed rings
    (W compared bitwise; the new points' distance to the entry's codes
    against its ``probed_k``). A hit of a dirty key is a stale serve."""

    def __init__(self):
        self.entries: dict = {}

    def record_probe(self, state, req):
        assert req.probed_k is not None
        self.entries[(req.q.tobytes(), req.tau)] = {
            "qcodes": _codes(state, req.q),
            "w": state.index.params.w.numpy().copy(),
            "probed_k": np.asarray(req.probed_k), "dirty": False,
            "est": req.est}

    def note_ingest(self, state_after, x_new):
        new_codes = _codes(state_after, x_new)                 # (Nn, L, K)
        w_now = state_after.index.params.w.numpy()
        for e in self.entries.values():
            if not np.array_equal(e["w"], w_now):
                e["dirty"] = True
                continue
            d = (new_codes != e["qcodes"][None]).sum(-1)        # (Nn, L)
            if (d.min(0) <= e["probed_k"]).any():
                e["dirty"] = True

    def check_serve(self, req):
        e = self.entries.get((req.q.tobytes(), req.tau))
        if req.provenance == "hit":
            assert e is not None, "hit without a recorded probe"
            assert not e["dirty"], "stale serve: an ingest touched its rings"
            assert req.est == e["est"], "hit diverged from the probe"


def test_zero_stale_serves_mixed_stream(data):
    """Over a mixed ingest and query stream that crosses capacity
    doublings, every hit is of an entry whose probed rings no ingest has
    touched, and hits happen."""
    rng = np.random.default_rng(0)
    co = _coalescer(data, cfg=CFG.replace(ingest_chunk=64), n=1024,
                    capacity=1024, cache_size=128, max_batch=16)
    shadow = _ShadowTracker()
    qpool = [data[i] + 0.01 for i in range(12)]
    taupool = [3.0, 4.0, 5.0]
    n_hits = 0
    for step in range(30):
        if step % 5 == 4:
            x_new = data[rng.integers(0, 2048, 48)] + \
                0.1 * rng.standard_normal((48, 16)).astype(np.float32)
            co.ingest(x_new)
            co.apply_ingest()
            shadow.note_ingest(co.state, x_new)
        reqs = [co.submit(qpool[rng.integers(len(qpool))],
                          taupool[rng.integers(len(taupool))])
                for _ in range(4)]
        co.flush()
        for r in reqs:
            shadow.check_serve(r)
            if r.provenance == "hit":
                n_hits += 1
            else:
                shadow.record_probe(co.state, r)
    assert int(co.state.n_valid) > 1024 and co.state.capacity > 1024
    assert n_hits > 0, "no hits at all: the property test is vacuous"
    assert co.cache_stats["hits"] == n_hits


def test_entries_survive_growth_without_ingest_overlap(data):
    """A capacity doubling does not invalidate: a budget-truncated probe,
    then an ingest of midpoints of live points (inside every projection
    range, so W stays bit for bit) outside the entry's probed rings that
    forces a doubling; the entry keeps serving bit-identical hits."""
    cfg = CFG.replace(ingest_chunk=64, max_visit=256)
    co = _coalescer(data, cfg=cfg, n=1024, capacity=1024, max_batch=8)
    q = data[0] + 0.01
    r0 = co.submit(q, 3.0)
    co.flush()
    assert r0.probed_k is not None and r0.probed_k.max() < CFG.n_funcs
    epoch0 = int(co.state.epochs.params_epoch)
    mids = 0.5 * (data[:512] + data[512:1024])
    qc, mc = _codes(co.state, q), _codes(co.state, mids)
    outside = ((mc != qc[None]).sum(-1) > r0.probed_k[None, :]).all(-1)
    mids = mids[outside]
    assert len(mids) >= 64, "not enough out-of-ball midpoints"
    co.ingest(mids)
    co.apply_ingest()
    assert co.state.capacity > 1024
    assert int(co.state.epochs.params_epoch) == epoch0
    r1 = co.submit(q, 3.0)
    co.flush()
    assert r1.provenance == "hit" and r1.est == r0.est


def test_clock_eviction_prefers_cold_entries(data):
    co = _coalescer(data, cache_size=4, max_batch=4)
    qs = [data[i] + 0.01 for i in range(7)]
    for i in range(4):
        co.submit(qs[i], 4.0)
        co.flush()
    hot = co.submit(qs[0], 4.0)                    # touch entry 0
    co.flush()
    assert hot.provenance == "hit"
    for i in range(4, 7):                          # 3 insertions, 3 evicts
        co.submit(qs[i], 4.0)
        co.flush()
    assert co.cache_stats["evicts"] == 3
    still_hot = co.submit(qs[0], 4.0)
    co.flush()
    assert still_hot.provenance == "hit"


def test_cached_results_match_uncached_distribution(data):
    """With no repeats the cached coalescer gives the same estimates as an
    uncached one on the same round keys."""
    g = torch.Generator().manual_seed(3)
    st_ = E.build(torch.from_numpy(data[:1024]), CFG, g, capacity=2048,
                  track_epochs=True, device="cpu")

    def keys(i, n):
        return E.draw_round_keys(torch.Generator().manual_seed(100 + i), n,
                                 CFG.n_tables, "cpu")

    a = CardinalityCoalescer(st_, CFG, max_batch=8, cache_size=64,
                             round_keys=keys)
    b = CardinalityCoalescer(st_, CFG, max_batch=8, round_keys=keys)
    qs = [data[i] + 0.01 for i in range(6)]
    ra = [a.submit(q, 4.0) for q in qs]
    rb = [b.submit(q, 4.0) for q in qs]
    a.flush()
    b.flush()
    assert [x.est for x in ra] == [y.est for y in rb]


def _repeat_hit(data, idx, tau):
    co = _coalescer(data, cache_size=32, max_batch=4)
    q = data[idx] + 0.01
    r0 = co.submit(q, float(tau))
    co.flush()
    r1 = co.submit(q, float(tau))
    co.flush()
    assert r0.provenance == "probe" and r1.provenance == "hit"
    assert r0.est == r1.est


@settings(max_examples=15, deadline=None)
@given(st.integers(min_value=0, max_value=2047),
       st.floats(min_value=0.5, max_value=8.0, allow_nan=False, width=32))
def test_property_repeat_hit_equals_first_serve(idx, tau):
    _repeat_hit(np.random.default_rng(0).standard_normal((2048, 16)).astype(
        np.float32), idx, tau)


@pytest.mark.parametrize("seed", range(6))
def test_repeat_hit_equals_first_serve_seeded(data, seed):
    """The property above on seeded draws (it runs where hypothesis is
    missing)."""
    rng = np.random.default_rng(seed)
    _repeat_hit(data, int(rng.integers(0, 2048)),
                np.float32(rng.uniform(0.5, 8.0)))


def test_auto_flush_and_uncached_provenance(data):
    """``submit`` flushes once ``max_batch`` requests wait (rounded up to a
    power of two); ``flush`` returns those answers too."""
    g = torch.Generator().manual_seed(0)
    st_ = E.build(torch.from_numpy(data[:1024]), CFG, g, device="cpu")
    co = CardinalityCoalescer(st_, CFG, g, max_batch=3)
    assert co.max_batch == 4
    reqs = [co.submit(data[i] + 0.01, 4.0) for i in range(5)]
    assert all(r.est is not None for r in reqs[:4]) and reqs[4].est is None
    out = co.flush()
    assert sorted(out) == [r.rid for r in reqs]
    assert all(v.provenance == "probe" and isinstance(v, float)
               for v in out.values())
    assert co.cache_stats["lookups"] == 0


# ---- parity with the reference ---------------------------------------------

def _jax():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.core import config as jconfig, estimator as JE
    from repro.serve.engine import CardinalityCoalescer
    from repro.serve.semantic import SemanticPlanner as JPlanner
    return SimpleNamespace(jax=jax, jnp=jnp, config=jconfig, E=JE,
                           Coalescer=CardinalityCoalescer, Planner=JPlanner)


def _pair(data, cache_size, reuse_tol, max_batch, n=1024, capacity=1024,
          seed=0):
    J = _jax()
    jcfg = J.config.ProberConfig(**KW, ingest_chunk=64)
    cfg = CFG.replace(ingest_chunk=64)
    key = J.jax.random.PRNGKey(seed)
    jst = J.E.build(J.jnp.asarray(data[:n]), jcfg, key, capacity=capacity,
                    track_epochs=True)
    tst = bridge.state_from_numpy(jax_state_numpy(jst), "cpu")
    jco = J.Coalescer(jst, jcfg, key, max_batch=max_batch,
                      cache_size=cache_size, reuse_tol=reuse_tol)
    co = CardinalityCoalescer(tst, cfg, max_batch=max_batch,
                              cache_size=cache_size, reuse_tol=reuse_tol,
                              round_keys=_reference_keys(key, cfg))
    return jco, co


def _reference_keys(key, cfg):
    from jax.random import fold_in

    def keys(i, n):
        return torch.from_numpy(reference_round_keys(fold_in(key, i), n,
                                                     cfg.n_tables))
    return keys


def _assert_same_serves(reqs, jreqs):
    for r, j in zip(reqs, jreqs):
        assert r.provenance == j.provenance
        assert (r.probed_k is None) == (j.probed_k is None)
        if r.probed_k is not None:
            np.testing.assert_array_equal(r.probed_k, j.probed_k)
            assert r.nvisited == j.nvisited
        np.testing.assert_allclose(r.est, j.est, rtol=1e-6)


@pytest.mark.parametrize("reuse_tol", [0.0, 0.25])
def test_coalescer_matches_reference(data, reuse_tol):
    """The same seeded stream (repeats, an ingest in capacity and one past
    it) through both coalescers: equal provenance, rings, sample counts and
    cache counters, estimates within rtol 1e-6, and every cache field equal
    (estimates within rtol 1e-6). W is held equal before hits compare."""
    jco, co = _pair(data, 24, reuse_tol, max_batch=8)
    rng = np.random.default_rng(7)
    qpool = [data[i] + 0.01 for i in range(1500, 1520)]
    taupool = np.array([3.1, 4.1, 5.2], np.float32)
    for step in range(14):
        if step in (4, 9):
            x_new = data[rng.integers(0, 2048, 40)] + 0.05
            for c in (jco, co):
                c.ingest(x_new)
            np.testing.assert_array_equal(
                co.state.index.params.w.numpy(),
                np.asarray(jco.state.index.params.w))
        picks = [(int(rng.integers(20)), int(rng.integers(3)))
                 for _ in range(int(rng.integers(3, 11)))]
        reqs = [co.submit(qpool[i], taupool[t]) for i, t in picks]
        jreqs = [jco.submit(qpool[i], taupool[t]) for i, t in picks]
        co.flush()
        jco.flush()
        _assert_same_serves(reqs, jreqs)
        assert co.cache_stats == jco.cache_stats
    assert co.state.capacity == jco.state.capacity == 2048
    assert co.cache_stats["hits"] > 0 and co.cache_stats["evicts"] > 0
    got = bridge.cache_to_numpy(co._cache)
    for k, v in jco._cache._asdict().items():
        if k == "est":
            np.testing.assert_allclose(got[k], np.asarray(v), rtol=1e-6)
        else:
            np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    for k in ("params_epoch", "n_ingested"):
        assert int(getattr(co.state.epochs, k)) == \
            int(getattr(jco.state.epochs, k))


def test_uncached_coalescer_matches_reference(data):
    jco, co = _pair(data, 0, 0.0, max_batch=4)
    qs = [data[i] + 0.01 for i in range(1600, 1606)]
    reqs = [co.submit(q, 4.0) for q in qs]
    jreqs = [jco.submit(q, 4.0) for q in qs]
    out, jout = co.flush(), jco.flush()
    _assert_same_serves(reqs, jreqs)
    assert sorted(out) == sorted(jout)


def test_planner_plan_batch_matches_reference(data):
    """``plan_batch`` and ``update_corpus`` on a bridged state with the
    reference's round keys: the same actions, calls and slots."""
    J = _jax()
    key = J.jax.random.PRNGKey(2)
    jp = J.Planner(J.jnp.asarray(data[:1024]), J.config.ProberConfig(**KW),
                   key, max_calls=60, max_batch=16, capacity=2048,
                   cache_size=32)
    tst = bridge.state_from_numpy(jax_state_numpy(jp.state), "cpu")
    tp = SemanticPlanner(None, CFG, max_calls=60, max_batch=16,
                         cache_size=32, device="cpu", state=tst,
                         round_keys=_reference_keys(key, CFG))
    qs = [data[i] + 0.01 for i in range(1700, 1712)]
    taus = [2.5, 3.5, 4.5, 5.5] * 3
    for rnd in range(3):
        if rnd == 2:
            x_new = data[1900:2000] + 0.02
            jp.update_corpus(x_new)
            tp.update_corpus(x_new)
        got, want = tp.plan_batch(qs, taus), jp.plan_batch(qs, taus)
        for a, b in zip(got, want):
            assert (a.action, a.llm_calls, a.batch_slots, a.n_batches) == \
                (b.action, b.llm_calls, b.batch_slots, b.n_batches)
            np.testing.assert_allclose(a.est_matches, b.est_matches,
                                       rtol=1e-6)
        assert tp.cache_stats == jp.cache_stats
    assert {p.action for p in got} >= {"execute", "refuse"}
    assert tp.cache_stats["hits"] > 0


def test_planner_builds_and_plans_on_its_own(data):
    g = torch.Generator().manual_seed(4)
    tp = SemanticPlanner(data[:1024], CFG, g, max_calls=40, capacity=2048,
                         device="cpu")
    plan = tp.plan(data[5] + 0.01, 4.0)
    assert plan.action in ("execute", "refuse")
    assert plan.llm_calls == (0 if plan.action == "refuse"
                              else int(np.ceil(plan.est_matches)))
    tp.update_corpus(data[1024:1100])
    assert int(tp.state.n_valid) == 1100 and tp.state.epochs is None
    assert tp.cache_stats["lookups"] == 0


@pytest.mark.parametrize("dev", ["cpu", pytest.param("cuda",
                                                     marks=pytest.mark.cuda)])
def test_planner_update_corpus_takes_a_tensor_on_its_device(data, dev):
    """``update_corpus`` takes new embeddings as a tensor on the planner's
    own device, as ``submit`` takes queries: the same state as an update
    from a host array."""
    if dev == "cuda":
        _card()
    new = torch.from_numpy(np.ascontiguousarray(data[1024:1100]))
    states = []
    for x in (new.to(dev), new.numpy()):
        tp = SemanticPlanner(data[:1024], CFG,
                             torch.Generator(device=dev).manual_seed(4),
                             max_calls=40, capacity=2048, device=dev)
        tp.update_corpus(x)
        states.append(tp.state)
    assert int(states[0].n_valid) == int(states[1].n_valid) == 1100
    assert torch.equal(states[0].x, states[1].x)
    for a, b in zip(states[0].index, states[1].index):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


# ---- on the card: the cache_insert kernel against its plain version ------

def _insert_inputs(g, s, n, nl, k, dev, full=False):
    """A random cache of ``s`` entries (all valid and referenced when
    ``full``) and ``n`` lanes: keys of entries, new keys and repeats of
    earlier lanes' keys, some lanes inactive."""
    def ri(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=dtype)
    flags = (torch.ones(s, dtype=torch.bool, device=dev) if full
             else ri(0, 2, (s,)).bool() for _ in range(2))
    cache = C.EstimateCache(
        qcodes=ri(-2, 3, (s, nl, k)),
        qhash=ri(0, 1 << 32, (s, 2), torch.int64),
        tau_key=ri(0, 3, (s,)), snap_ball=ri(0, 1000, (s, nl)),
        snap_params=ri(0, 3, (s,), torch.int64),
        probed_k=ri(0, k + 1, (s, nl)),
        est=torch.rand(s, generator=g, device=dev),
        nvisited=ri(0, 5000, (s,)), valid=next(flags), ref=next(flags),
        hand=ri(0, s, ()))
    # half the lanes take an entry's key, the rest a new one; a quarter
    # then repeat an earlier lane's key
    src = ri(0, s, (n,), torch.int64)
    new = ri(0, 2, (n,)).bool()
    qc = torch.where(new[:, None, None], ri(-2, 3, (n, nl, k)),
                     cache.qcodes[src])
    qh = torch.where(new[:, None], ri(0, 1 << 32, (n, 2), torch.int64),
                     cache.qhash[src])
    tk = torch.where(new, ri(0, 3, (n,)), cache.tau_key[src])
    rep = ri(0, 4, (n,)) == 0
    prev = (torch.rand(n, generator=g, device=dev)
            * torch.arange(n, device=dev)).long()
    prev = torch.where(rep, prev, torch.arange(n, device=dev))
    lanes = (qc[prev].contiguous(), qh[prev].contiguous(),
             tk[prev].contiguous(), ri(0, 1000, (n, nl)),
             torch.tensor(1, device=dev),
             torch.rand(n, generator=g, device=dev), ri(0, 5000, (n,)),
             ri(0, k + 1, (n, nl)), ri(0, 8, (n,)) > 0)
    return cache, lanes


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


def _kernel_against_plain(cache, lanes, match_qhash):
    """The kernel on ``cache`` in place against the plain version on a CPU
    copy: every field and the eviction count equal, one launch."""
    want_cache = C.EstimateCache(*(t.cpu() for t in cache))
    want = ref.cache_insert(want_cache, *(t.cpu() for t in lanes),
                            match_qhash)
    ops.reset_launches()
    got = ops.cache_insert(cache, *lanes, match_qhash)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["cache_insert"] == 1
    assert int(got) == int(want)
    for name, a, b in zip(C.EstimateCache._fields, cache, want_cache):
        assert torch.equal(a.cpu(), b), name
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("s,n,full", [(1024, 64, False), (1024, 256, True),
                                      (65536, 64, False), (65536, 256, True),
                                      (4, 256, False), (1, 3, True),
                                      (1000, 7, False), (1, 256, False),
                                      (1000, 256, True), (16, 65536, False)])
@pytest.mark.parametrize("match_qhash", [True, False])
def test_cuda_cache_insert_matches_plain(s, n, full, match_qhash):
    """Random caches (many duplicate keys, more without the fingerprint),
    lanes that repeat earlier lanes' keys, lanes far outnumbering the
    entries (S = 1, 4, 16), S not a power of two, the full sweep of a
    cache whose ref bits are all set, and the lane limit (65,536)."""
    g = _card()
    cache, lanes = _insert_inputs(g, s, n, 2, 10, "cuda", full)
    _kernel_against_plain(cache, lanes, match_qhash)


@pytest.mark.cuda
@pytest.mark.parametrize("n_keys", [1, 4])
@pytest.mark.parametrize("match_qhash", [True, False])
def test_cuda_cache_insert_dense_duplicate_keys(n_keys, match_qhash):
    """Every entry valid and holding one of ``n_keys`` keys, and the lanes
    those keys plus new ones: the lowest position of a key wins, until a
    new key evicts it."""
    g = _card()
    s, n = 1024, 256
    cache, lanes = _insert_inputs(g, s, n, 2, 10, "cuda")
    pick = torch.randint(0, n_keys, (s,), generator=g, device="cuda")
    lane_pick = torch.randint(0, n_keys + 2, (n,), generator=g,
                              device="cuda")
    src = torch.randint(0, s, (n_keys + 2,), generator=g, device="cuda")
    keys = (cache.qcodes[src].clone(), cache.qhash[src].clone(),
            cache.tau_key[src].clone())
    keys[0][n_keys:] += 7                      # two keys no entry holds
    cache = cache._replace(qcodes=keys[0][pick].contiguous(),
                           qhash=keys[1][pick].contiguous(),
                           tau_key=keys[2][pick].contiguous(),
                           valid=torch.ones_like(cache.valid))
    lanes = (keys[0][lane_pick].contiguous(),
             keys[1][lane_pick].contiguous(),
             keys[2][lane_pick].contiguous()) + lanes[3:]
    _kernel_against_plain(cache, lanes, match_qhash)


def _small_cache(s, keys, valid, ref_bits, hand, dev):
    """A cache of ``s`` entries whose entry p holds key ``keys[p]`` (codes
    and tau all equal to it, the fingerprint (key, 0)) and est p."""
    kk = torch.tensor(keys, dtype=torch.int32)
    nl, k = 2, 3
    return C.EstimateCache(*(t.to(dev) for t in (
        kk[:, None, None].expand(s, nl, k).contiguous(),
        torch.stack([kk.long(), torch.zeros(s, dtype=torch.int64)], 1),
        kk.clone(), torch.zeros((s, nl), dtype=torch.int32),
        torch.zeros(s, dtype=torch.int64),
        torch.zeros((s, nl), dtype=torch.int32),
        torch.arange(s, dtype=torch.float32),
        torch.zeros(s, dtype=torch.int32),
        torch.tensor(valid, dtype=torch.bool),
        torch.tensor(ref_bits, dtype=torch.bool),
        torch.tensor(hand, dtype=torch.int32))))


def _small_lanes(keys, active, dev):
    """Lanes whose lane i holds key ``keys[i]`` (as :func:`_small_cache`)
    and est 100 + i."""
    kk = torch.tensor(keys, dtype=torch.int32)
    n, nl, k = len(keys), 2, 3
    return tuple(t.to(dev) for t in (
        kk[:, None, None].expand(n, nl, k).contiguous(),
        torch.stack([kk.long(), torch.zeros(n, dtype=torch.int64)], 1),
        kk.clone(), torch.ones((n, nl), dtype=torch.int32),
        torch.tensor(1, dtype=torch.int64),
        100 + torch.arange(n, dtype=torch.float32),
        torch.ones(n, dtype=torch.int32),
        torch.ones((n, nl), dtype=torch.int32),
        torch.tensor(active, dtype=torch.bool)))


def _insert_hazard(dev, cache, lanes, match_qhash):
    if dev == "cuda":
        return int(_kernel_against_plain(cache, lanes, match_qhash))
    return int(ops.cache_insert(cache, *lanes, match_qhash))


@pytest.mark.parametrize("dev", ["cpu", pytest.param("cuda",
                                                     marks=pytest.mark.cuda)])
@pytest.mark.parametrize("duplicate", [True, False])
def test_cache_insert_evicted_entry_no_longer_matches(dev, duplicate):
    """Lane 0 (a new key) evicts entry 5, which held lane 1's key: lane 1
    must not match it. With the key also at entry 7, lane 1 takes 7;
    without, it sweeps on from the hand (now 5) to the first entry whose
    ref bit lane 0's sweep cleared (3)."""
    if dev == "cuda":
        _card()
    keys = [10, 11, 12, 13, 14, 15, 16, 15 if duplicate else 17]
    cache = _small_cache(8, keys, [1] * 8, [1, 1, 1, 1, 1, 0, 1, 1], 2, dev)
    lanes = _small_lanes([99, 15], [True, True], dev)
    evicted = _insert_hazard(dev, cache, lanes, True)
    est = cache.est.cpu().tolist()
    assert est[5] == 100
    if duplicate:
        assert evicted == 1 and int(cache.hand) == 5 and est[7] == 101
        assert cache.ref.cpu().tolist() == [1, 1, 1, 0, 0, 0, 1, 0]
    else:
        assert evicted == 2 and int(cache.hand) == 3 and est[3] == 101
        assert cache.ref.cpu().tolist() == [0] * 8
    assert bool(cache.valid.all())


@pytest.mark.parametrize("dev", ["cpu", pytest.param("cuda",
                                                     marks=pytest.mark.cuda)])
@pytest.mark.parametrize("present", [True, False])
def test_cache_insert_every_lane_one_key(dev, present):
    """256 lanes (a third inactive) all holding one key: held by the
    valid entries 20 and 40 (and the invalid entry 10), every active lane
    lands on 20; held by none, the first active lane evicts at the hand
    and every later one lands on its slot."""
    if dev == "cuda":
        _card()
    s, n = 64, 256
    keys = [1000 + p for p in range(s)]
    valid = [1] * s
    if present:
        keys[10] = keys[20] = keys[40] = 7
        valid[10] = 0
    cache = _small_cache(s, keys, valid, [1] * s, 5, dev)
    active = [i % 3 != 0 for i in range(n)]
    lanes = _small_lanes([7] * n, active, dev)
    evicted = _insert_hazard(dev, cache, lanes, False)
    est = cache.est.cpu().tolist()
    slot = 20 if present else 6
    assert est[slot] == 100 + max(i for i in range(n) if active[i])
    assert evicted == (0 if present else 1)
    assert int(cache.hand) == (5 if present else 6)
    if present:
        assert est[40] == 40 and not bool(cache.valid[10])
    assert not bool(cache.ref[slot])


@pytest.mark.parametrize("s,n", [(1, 1), (1000, 7), (1024, 64),
                                 (65536, 256), (65536, 65536), (1, 65536)])
def test_cache_insert_plan_fits_shared_memory(s, n):
    """The chain block: a power of two of threads, 32..1024, with at most
    8 chunks of 8 entries a thread below 1024, and its staged state within
    the 227 KB a block may use at every S and lane count the wrapper
    takes, the candidate slots with it where they fit (not with 65,536
    lanes); the scratch holds everything else."""
    plan = ops.cache_insert_plan(s, n)
    t = plan.threads
    assert t & (t - 1) == 0 and 32 <= t <= 1024
    assert t == 1024 or 8 * t >= -(-s // 8)
    assert t == 32 or 4 * t < -(-s // 8)
    assert 16 * -(-s // 8) < plan.smem <= ops._SMEM_LIMIT
    base = plan.smem - 4 * n * plan.cand_shared
    assert (base + 4 * n <= ops._SMEM_LIMIT) == bool(plan.cand_shared)
    assert plan.cand_shared == (n < 65536)
    assert ops.cache_insert_scratch(s, n) >= 3 * n + 2 * s


@pytest.mark.parametrize("s,n", [(0, 1), (65537, 1), (1, 0), (1, 65537)])
def test_cache_insert_plan_refuses_out_of_range(s, n):
    with pytest.raises(ValueError, match="65536"):
        ops.cache_insert_plan(s, n)


@pytest.mark.cuda
def test_cuda_cache_insert_raises_on_what_the_kernel_does_not_take():
    g = _card()
    cache, lanes = _insert_inputs(g, 16, 4, 2, 10, "cuda")
    with pytest.raises(TypeError, match="qhash"):
        ops.cache_insert(cache, lanes[0], lanes[1].int(), *lanes[2:], True)
    with pytest.raises(ValueError, match="balls"):
        ops.cache_insert(cache, *lanes[:3], lanes[3][:, :1].contiguous(),
                         *lanes[4:], True)
    big = C.init_cache((1 << 16) + 1, 2, 10, "cuda")
    with pytest.raises(ValueError, match="65536 entries"):
        ops.cache_insert(big, *lanes, True)


@pytest.mark.parametrize("dev", ["cpu", pytest.param("cuda",
                                                     marks=pytest.mark.cuda)])
def test_submit_takes_query_tensors(data, dev):
    """A query may be a tensor on the state's device (the serve CLI passes
    a row of its corpus): it serves exactly as the same query as numpy."""
    if dev == "cuda":
        _card()
    g = torch.Generator(device=dev).manual_seed(0)
    st_ = E.build(torch.from_numpy(data[:1024]).to(dev), CFG, g,
                  capacity=2048, track_epochs=True, device=dev)
    co = CardinalityCoalescer(st_, CFG, g, max_batch=8, cache_size=64)
    q = data[3] + 0.01
    first = co.submit(torch.from_numpy(q).to(dev), 4.0)
    co.flush()
    again = co.submit(q, 4.0)
    co.flush()
    assert again.provenance == "hit" and again.est == first.est
