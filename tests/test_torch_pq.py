"""The port's PQ datapath against the reference: ``core/pq.py`` function by
function, ``estimate_batch_stats`` with ``use_pq`` on a bridged reference
state with the reference's round keys (float, uint8 and packed ADC, banded
qualification, every exact/ADC routing), Alg. 8 ingest in and past
capacity, and the full-ADC-scan baseline.

Stated preconditions (float sums in two frameworks may differ in the last
bit): no point's two nearest centroids within 1e-5 of each other, no
candidate's ADC or exact d² within 1e-5·τ² of τ², no uint8 LUT entry at a
rounding tie, no hash value within 1e-5 of an integer."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (adc_f64, assert_no_adc_ties, assert_no_assign_ties,
                           assert_no_hash_ties, assert_no_q8_ties,
                           assert_no_tau_ties, jax_state_numpy,
                           reference_round_keys)
from repro.core import baselines as jbaselines, config as jconfig, \
    estimator as JE, pq as jpq, updates as jupdates
from repro_torch import bridge
from repro_torch.core import baselines, config, estimator as E, pq, updates

KW = dict(n_tables=2, n_funcs=8, ring_budget=512, central_budget=256,
          chunk=128, max_visit=2048, use_pq=True, pq_m=8, pq_kc=16,
          pq_iters=4)
NQ = 12            # 24 lanes: the reference's compacting schedule
D = 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _fit_both(x, kw, seed):
    """The reference's ``fit`` under its build key tree, and the port's
    with the same initial rows."""
    jcfg, cfg = jconfig.ProberConfig(**kw), config.ProberConfig(**kw)
    _, k2 = jax.random.split(jax.random.PRNGKey(seed))
    n = x.shape[0]
    rows = jax.random.choice(k2, n, (cfg.pq_kc,), replace=n < cfg.pq_kc)
    want = jpq.fit(jnp.asarray(x), jcfg, k2)
    got = pq.fit(_t(x), cfg, init_rows=_t(rows))
    return want, got


@pytest.mark.parametrize("d,m,kc,pack4,data", [
    pytest.param(16, 4, 16, False, "normal", id="16-4-16-False"),
    pytest.param(32, 8, 32, False, "normal", id="32-8-32-False"),
    pytest.param(32, 8, 16, True, "normal", id="32-8-16-True"),
    # the 1M configurations' codebook on chip_smoke.py's clustered corpus
    pytest.param(128, 32, 64, False, "surrogate", id="sift-pq-surrogate")])
def test_fit_matches_reference(d, m, kc, pack4, data):
    # data seed 1 meets the stated precondition in the three normal cases
    # (seeds 0 and 2 put one point's top-2 centroids within 1e-5 at M = 8,
    # Kc = 32); the surrogate at N = 4096, seed 0 meets it too
    if data == "normal":
        x = np.random.default_rng(1).standard_normal((2600, d)).astype(
            np.float32)
        iters, key = 6, 4
    else:
        x, iters, key = _surrogate(4096, 0), 8, 0
    n = x.shape[0]
    kw = dict(use_pq=True, pq_m=m, pq_kc=kc, pq_iters=iters, pq_pack4=pack4)
    want, got = _fit_both(x, kw, key)
    assert_no_assign_ties(want.centroids, x.reshape(n, m, d // m))
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=1e-5,
                               atol=1e-6)
    assert got.codes.dtype == torch.uint8
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_allclose(got.resid.numpy(), np.asarray(want.resid),
                               rtol=1e-5, atol=1e-6)
    assert int(got.n_valid) == int(want.n_valid)
    if pack4:
        np.testing.assert_array_equal(got.packed.numpy(),
                                      np.asarray(want.packed))
    else:
        assert got.packed is None and want.packed is None


def _surrogate(n, seed):
    """``chip_smoke.py``'s clustered corpus (data/vectors.py) at SIFT's
    width, as numpy."""
    from repro_torch.data import vectors
    return vectors.make_corpus(torch.Generator().manual_seed(seed), n,
                               128).numpy()


def test_assign_segment_sum_and_residual_match_reference():
    r = np.random.default_rng(2)
    xs = r.standard_normal((3000, 8, 4)).astype(np.float32)
    cents = r.standard_normal((8, 32, 4)).astype(np.float32)
    assert_no_assign_ties(cents, xs)
    codes = pq.assign(_t(cents), _t(xs))
    want = jpq.assign(jnp.asarray(cents), jnp.asarray(xs))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want))
    seg = r.integers(0, 300, 5000)
    data = r.standard_normal((5000, 3)).astype(np.float32)
    np.testing.assert_allclose(
        pq.segment_sum(_t(data), _t(seg), 310).numpy(),
        np.asarray(jax.ops.segment_sum(data, seg, num_segments=310)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        pq.reconstruction_residual(_t(cents), codes, _t(xs)).numpy(),
        np.asarray(jpq.reconstruction_residual(
            jnp.asarray(cents), want, jnp.asarray(xs))), rtol=1e-5)


def test_assign_chunking_keeps_every_argmin(monkeypatch):
    """assign works through the points in chunks (the reference's whole
    (N, M, Kc) temporary is 8 GiB at N = 1M); chunks of 7 rows give the
    same codes as one chunk."""
    r = np.random.default_rng(4)
    xs = torch.from_numpy(r.standard_normal((500, 4, 2)).astype(np.float32))
    cents = torch.from_numpy(r.standard_normal((4, 16, 2)).astype(np.float32))
    whole = pq.assign(cents, xs)
    monkeypatch.setattr(pq, "_ASSIGN_CHUNK", 7 * 4 * 16)
    assert torch.equal(pq.assign(cents, xs), whole)


def test_luts_quantization_and_packing_match_reference():
    x = np.random.default_rng(3).standard_normal((2000, 32)).astype(
        np.float32)
    want, got = _fit_both(x, dict(use_pq=True, pq_m=8, pq_kc=16,
                                  pq_iters=3), 0)
    qs = x[:5] + 0.01
    jluts = jax.vmap(lambda q: jpq.adc_table(want, q))(jnp.asarray(qs))
    luts = pq.adc_table(got, _t(qs))
    assert luts.shape == (5, 8, 16)
    np.testing.assert_allclose(luts.numpy(), np.asarray(jluts), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(pq.adc_table(got, _t(qs[1])).numpy(),
                               np.asarray(jluts[1]), rtol=1e-5, atol=1e-6)
    # quantization and thresholds on the same float LUTs: bit-equal
    taus_sq = np.linspace(2.0, 30.0, 5).astype(np.float32)
    qlut = pq.quantize_lut(_t(jluts))
    for i in range(5):
        jq = jpq.quantize_lut(jluts[i])
        np.testing.assert_array_equal(qlut.q8[i].numpy(), np.asarray(jq.q8))
        assert float(qlut.scale[i]) == float(jq.scale)
        assert float(qlut.offset[i]) == float(jq.offset)
        assert int(pq.quantized_threshold(qlut, 8, _t(taus_sq))[i]) == int(
            jpq.quantized_threshold(jq, 8, jnp.float32(taus_sq[i])))
    one = pq.quantize_lut(_t(jluts[0]))
    np.testing.assert_array_equal(one.q8.numpy(), qlut.q8[0].numpy())
    # packing
    packed = pq.pack_codes(got.codes)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jpq.pack_codes(want.codes)))
    np.testing.assert_array_equal(
        pq.unpack_codes(packed).numpy(),
        np.asarray(jpq.unpack_codes(jnp.asarray(packed.numpy()))))
    np.testing.assert_array_equal(pq.unpack_codes(packed).numpy(),
                                  got.codes.numpy().astype(np.int32))
    # Alg. 5 distance and growth
    np.testing.assert_allclose(
        pq.adc_distance(luts[0], got.codes).numpy(),
        np.asarray(jpq.adc_distance(jluts[0], want.codes.astype(jnp.int32))),
        rtol=1e-5)
    big, jbig = pq.grow(got, 4096), jpq.grow(want, 4096)
    np.testing.assert_array_equal(big.codes.numpy(), np.asarray(jbig.codes))
    np.testing.assert_array_equal(big.resid.numpy()[2000:], 0.0)
    assert big.codes.shape == (4096, 8) and big.resid.shape == (4096,)


# ---- the PQ estimator on a bridged reference state ----------------------

def _workload(x, nq, seed):
    """Queries near data points, τ between neighbouring sorted exact
    distances, targets spread over 1..300 (as in test_torch_prober)."""
    r = np.random.default_rng(seed)
    qs = (x[r.choice(len(x), nq, replace=False)]
          + 0.05 * r.standard_normal((nq, x.shape[1]))).astype(np.float32)
    taus = []
    for q, t in zip(qs.astype(np.float64),
                    np.geomspace(1, 300, nq).astype(int)):
        d = np.sort(np.sqrt(((x.astype(np.float64) - q) ** 2).sum(-1)))
        while d[t] - d[t - 1] < 1e-4 * d[t]:
            t += 1
        taus.append(0.5 * (d[t - 1] + d[t]))
    return qs, np.asarray(taus, np.float32)


@pytest.fixture(scope="module")
def pq_setup():
    x = np.random.default_rng(0).standard_normal((2600, D)).astype(
        np.float32)
    states = {}
    for pack4 in (False, True):
        jcfg = jconfig.ProberConfig(**KW, pq_pack4=pack4)
        jstate = JE.build(jnp.asarray(x[:2400]), jcfg, jax.random.PRNGKey(3),
                          capacity=4096)
        states[pack4] = (jstate, bridge.state_from_numpy(
            jax_state_numpy(jstate), "cpu"))
    jstate = states[False][0]
    qs, taus = _workload(x[:2400], NQ, 1)
    p = jstate.index.params
    assert_no_hash_ties(qs, p.a, p.b, p.w)
    assert_no_tau_ties(x, qs, taus, 2400)
    luts = np.asarray(jax.vmap(lambda q: jpq.adc_table(jstate.pq, q))(
        jnp.asarray(qs)))
    assert_no_adc_ties(luts, jstate.pq.codes, taus, 2400)
    assert_no_q8_ties(luts, taus, KW["pq_m"])
    return x, states, qs, taus


SETTINGS = {
    "exact-rings-2": dict(),
    "adc-everywhere": dict(pq_exact_rings=0, pq_exact_central=False),
    "adc-rings-exact-central": dict(pq_exact_rings=0),
    "adc-central-exact-rings": dict(pq_exact_central=False),
    "int8": dict(pq_int8_lut=True, pq_exact_rings=0),
    "int8-pack4-serving": dict(pq_int8_lut=True, pq_pack4=True,
                               pq_exact_rings=0, pq_exact_central=False),
    "pack4-float": dict(pq_pack4=True, pq_exact_rings=1),
    "banded": dict(pq_banded=True, pq_exact_rings=1),
    "monolithic-int8": dict(pq_int8_lut=True, lane_block=0),
}


@pytest.mark.parametrize("name", list(SETTINGS))
def test_pq_estimate_batch_stats_matches_reference(pq_setup, name):
    x, states, qs, taus = pq_setup
    kw = dict(KW, **SETTINGS[name])
    jstate, state = states[kw.get("pq_pack4", False)]
    jcfg, cfg = jconfig.ProberConfig(**kw), config.ProberConfig(**kw)
    key = jax.random.PRNGKey(7)
    want = JE.estimate_batch_stats(jstate, jnp.asarray(qs), jnp.asarray(taus),
                                   jcfg, key)
    rks = _t(reference_round_keys(key, NQ, 2))
    got = E.estimate_batch_stats(state, _t(qs), _t(taus), cfg, rks=rks)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6)
    assert np.asarray(want[0]).std() > 0          # non-degenerate workload
    assert (np.asarray(want[1]) > 2).any()        # ADC rings were probed
    # batch equals sequential
    for i in (0, NQ - 1):
        one = E.estimate(state, _t(qs[i]), float(taus[i]), cfg, rks=rks[i])
        assert float(one) == float(got[0][i])


def test_pq_update_in_and_past_capacity_matches_reference(pq_setup):
    x, _, _, _ = pq_setup
    kw = dict(KW, pq_pack4=True)
    jcfg, cfg = jconfig.ProberConfig(**kw), config.ProberConfig(**kw)
    jstate = JE.build(jnp.asarray(x[:1500]), jcfg, jax.random.PRNGKey(0),
                      capacity=2048)
    state = bridge.state_from_numpy(jax_state_numpy(jstate), "cpu")
    for lo, hi, cap in ((1500, 1800, 2048), (1800, 2600, 4096)):
        assert_no_assign_ties(jstate.pq.centroids,
                              x[lo:hi].reshape(hi - lo, 8, D // 8))
        jstate = JE.update(jstate, jnp.asarray(x[lo:hi]), jcfg)
        state = E.update(state, _t(x[lo:hi]), cfg)
        assert int(state.n_valid) == hi and state.capacity == cap
        g, w = bridge.state_to_numpy(state), jax_state_numpy(jstate)
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        for k in ("pq.codes", "pq.packed", "pq.counts", "pq.n_valid",
                  "codes", "order", "x"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        for k in ("pq.centroids", "pq.resid"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_update_pq_alone_matches_reference(pq_setup):
    x, _, _, _ = pq_setup
    want, got = _fit_both(x[:1000], dict(use_pq=True, pq_m=4, pq_kc=16,
                                         pq_iters=3), 1)
    assert_no_assign_ties(want.centroids, x[1000:1300].reshape(300, 4, 4))
    want = jupdates.update_pq(want, jnp.asarray(x[1000:1300]),
                              jnp.asarray(x[:1300]))
    got = updates.update_pq(got, _t(x[1000:1300]), _t(x[:1300]))
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got.resid.numpy(), np.asarray(want.resid),
                               rtol=1e-5, atol=1e-6)


def _check_scan(jp, q4):
    """The port's full ADC scan against the reference's on PQ index ``jp``
    (C = 512 rows, 400 live, 4 queries: the reference's Pallas scan runs in
    interpret mode)."""
    p = pq.PQIndex(*(_t(getattr(jp, k)) for k in
                     ("centroids", "codes", "counts", "resid", "n_valid")))
    luts = np.asarray(jax.vmap(lambda q: jpq.adc_table(jp, q))(
        jnp.asarray(q4)))
    # τ² midway between the ADC distances ranked 4/5, 41/42, 151/152 and
    # 301/302: those counts are the answer
    d = np.sort(adc_f64(luts, np.asarray(jp.codes)[:400]), axis=1)
    want_counts = np.array([4, 41, 151, 301])
    t4 = np.sqrt(0.5 * (d[np.arange(4), want_counts - 1]
                        + d[np.arange(4), want_counts])).astype(np.float32)
    assert_no_adc_ties(luts, jp.codes, t4, 400)
    want = jbaselines.adc_scan_estimate_batch(jp, jnp.asarray(q4),
                                              jnp.asarray(t4))
    got = baselines.adc_scan_estimate_batch(p, _t(q4), _t(t4))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), want_counts)


def test_adc_scan_estimate_batch_matches_reference(pq_setup):
    x, _, qs, _ = pq_setup
    jp = jpq.grow(jpq.fit(jnp.asarray(x[:400]), jconfig.ProberConfig(**KW),
                          jax.random.PRNGKey(2)), 512)
    _check_scan(jp, qs[:4])


def test_adc_scan_on_surrogate_at_sift_pq_shape_matches_reference():
    # serve_cfg(d=128)'s M = 32, Kc = 64 codebook on chip_smoke.py's
    # clustered corpus; tests/pq_surrogate_witness.py compares both
    # packages' codebooks there at larger N
    x = _surrogate(404, 1)
    jp = jpq.grow(jpq.fit(jnp.asarray(x[:400]), jconfig.ProberConfig(
        use_pq=True, pq_m=32, pq_kc=64, pq_iters=8), jax.random.PRNGKey(2)),
        512)
    _check_scan(jp, x[400:404])


def test_tie_rules_flag_exactly_the_boundary_cases():
    """The rules that decide which comparisons are exempt from parity
    (``pq.assign_ties``, ``adc_ties``, ``q8_ties``) flag a boundary case
    and nothing else."""
    cents = torch.tensor([[[0.0], [2.0], [5.0]]])           # M = 1, Kc = 3
    xs = torch.tensor([[[1.0]], [[0.4]], [[3.5 + 1e-7]]])   # tie, no, tie
    assert pq.assign_ties(cents, xs, 1e-5)[:, 0].tolist() == [True, False,
                                                              True]
    luts = torch.tensor([[[1.0, 3.0], [0.5, 2.0]]]).repeat(2, 1, 1)
    codes = torch.tensor([[1, 0], [0, 1]], dtype=torch.uint8)  # 3.5, 3.0
    taus = torch.tensor([3.5, 3.2]).sqrt()
    assert pq.adc_ties(luts, codes, taus, 1e-5).tolist() == [True, False]
    # lo = 0, scale = 1: entry 2.5 sits at a rounding half; τ² = M·lo + 7
    # puts the threshold on an integer
    q = torch.tensor([[[0.0, 255.0], [2.5, 7.0]], [[0.0, 255.0], [2.2, 7.0]],
                      [[0.0, 255.0], [2.2, 7.0]]])
    t = torch.tensor([7.3, 7.3, 7.0]).sqrt()
    assert pq.q8_ties(q, t, 2).tolist() == [True, False, True]


def test_bridge_round_trip_keeps_pq_dtypes(pq_setup):
    _, states, _, _ = pq_setup
    for jstate, _ in states.values():
        d = jax_state_numpy(jstate)
        back = bridge.state_to_numpy(bridge.state_from_numpy(d, "cpu"))
        assert set(back) == set(d)
        for k, v in d.items():
            assert back[k].dtype == v.dtype, k
            np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_port_pq_end_to_end_on_cpu_tracks_truth():
    """build(use_pq) → estimate → update with the port's own draws, under
    the repo's two PQ configurations at small size (M = 16, Kc = 16 for
    d = 32): finite estimates near the truth."""
    from repro_torch.data import vectors
    g = torch.Generator().manual_seed(1)
    x = vectors.make_corpus(g, 4000, 32)
    qs, taus, _ = vectors.paper_query_workload(g, x[:3000], 8, n_taus=4)
    t = taus[:, -1]
    for kw in (dict(n_tables=2, n_funcs=10, ring_budget=2048,
                    central_budget=2048, chunk=128, pq_m=16, pq_kc=16),
               dict(n_tables=1, n_funcs=12, ring_budget=1024,
                    central_budget=512, chunk=512, max_visit=2048, pq_m=16,
                    pq_kc=16, pq_int8_lut=True, pq_exact_rings=0,
                    pq_exact_central=False, pq_pack4=True)):
        cfg = config.ProberConfig(use_pq=True, **kw)
        state = E.build(x[:3000], cfg, g, capacity=4096, device="cpu")
        for n in (3000, 4000):
            if n == 4000:
                state = E.update(state, x[3000:], cfg)
            est = E.estimate_batch(state, qs, t, cfg, generator=g)
            truth = E.true_cardinality(state.x, qs, t, n_valid=n).float()
            assert torch.isfinite(est).all() and (est >= 0).all()
            qerr = torch.maximum(est.clamp_min(1) / truth.clamp_min(1),
                                 truth.clamp_min(1) / est.clamp_min(1))
            assert qerr.median() < 2.0, (kw, est, truth)
