"""The port's sampling and learned baselines against the reference's
``repro.core.baselines`` (the full-ADC scan is held in
``tests/test_torch_pq.py``).

``sampling_estimate``: draws differ between ``jax.random`` and a
``torch.Generator``, so the reference's own draws (the ids of
``jax.random.choice(replace=False)`` and the uniforms of the ``n_valid``
rule, from the same key) go into ``sampling_from_draws``, whose estimate
must equal the reference's exactly, under the precondition that no sampled
distance lies within 1e-5·τ² of τ². The port's own draws are checked for
their law (distinct ids in range, the live prefix).

The MLP: features within rtol 1e-6 (measured: 3.5e-7 at most over seeds
0–7); the forward pass within rtol 1e-6 plus an atol of 1e-6 of the
output's largest magnitude (near-zero outputs are differences of O(1)
terms; measured 9.2e-7 of it at most). Training from the reference's
initial weights: after 5 epochs every weight and prediction within 1e-5 of
its tensor's largest magnitude (measured 3.1e-6 and 5.2e-6); after the
default 400, the training loss within rtol 1e-2 and the log-space
predictions within 2e-2 of their largest magnitude (measured 4.4e-3 and
9.3e-3 over seeds 0–7: two frameworks' float orders, amplified by 400
steps through ReLU switching and the norm clip)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_parity import assert_no_tau_ties
from repro_torch import bridge
from repro_torch.core import baselines, pq
from repro_torch.data import vectors


def _jax():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.core import baselines as jb, config as jc, pq as jpq
    from repro.data import vectors as jv
    return SimpleNamespace(jax=jax, jnp=jnp, b=jb, config=jc, pq=jpq, v=jv)


def _t(a):
    return torch.from_numpy(np.array(a))


def _data(seed, n=600, d=16, nq=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    qs = x[rng.choice(n, nq, replace=False)] + 0.1 * rng.standard_normal(
        (nq, d)).astype(np.float32)
    d2 = ((x[None] - qs[:, None]) ** 2).sum(-1)
    # radii at the 2 %..30 % quantiles of each query's distances
    taus = np.sqrt(np.quantile(d2, rng.uniform(0.02, 0.3, nq), axis=1)
                   .diagonal()).astype(np.float32) * 1.0001
    return x, qs.astype(np.float32), taus


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n_samples", [6, 60, 300])
def test_sampling_equals_reference_given_its_ids(seed, n_samples):
    J = _jax()
    x, qs, taus = _data(seed)
    n = x.shape[0]
    xj = J.jnp.asarray(x)
    for i in range(qs.shape[0]):
        key = J.jax.random.PRNGKey(17 * seed + i)
        want = J.b.sampling_estimate(xj, J.jnp.asarray(qs[i]), taus[i], key,
                                     n_samples)
        ids = np.asarray(J.jax.random.choice(key, n, (n_samples,),
                                             replace=False))
        assert_no_tau_ties(x[ids], qs[i:i + 1], taus[i:i + 1])
        got = baselines.sampling_from_draws(_t(x), _t(qs[i:i + 1]),
                                            _t(taus[i:i + 1]),
                                            ids=_t(ids)[None])
        assert got.dtype == torch.float32
        assert float(got[0]) == float(want)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n_valid", [1, 250, 600])
def test_sampling_n_valid_equals_reference_given_its_uniforms(seed, n_valid):
    """The capacity-padded rule: rows ``min(int32(u·n_valid), n_valid−1)``
    from float32 uniforms, scale ``n_valid`` (rows past it are padding)."""
    J = _jax()
    x, qs, taus = _data(seed)
    x[n_valid:] = 1e6                       # padding no draw may reach
    xj = J.jnp.asarray(x)
    s = 200
    for i in range(qs.shape[0]):
        key = J.jax.random.PRNGKey(31 * seed + i)
        want = J.b.sampling_estimate(xj, J.jnp.asarray(qs[i]), taus[i], key,
                                     s, n_valid=J.jnp.int32(n_valid))
        u = np.asarray(J.jax.random.uniform(key, (s,)))
        rows = np.minimum((u * np.float32(n_valid)).astype(np.int32),
                          n_valid - 1)
        assert_no_tau_ties(x[rows], qs[i:i + 1], taus[i:i + 1])
        for nv in (n_valid, torch.tensor(n_valid, dtype=torch.int32)):
            got = baselines.sampling_from_draws(
                _t(x), _t(qs[i:i + 1]), _t(taus[i:i + 1]), u=_t(u)[None],
                n_valid=nv)
            assert float(got[0]) == float(want)


def test_sampling_batch_is_rowwise_reference():
    """(Q, d) queries with (Q,) taus: each row is the reference's estimate
    from that row's draws (``vmap`` over keys)."""
    J = _jax()
    x, qs, taus = _data(5, nq=8)
    keys = J.jax.random.split(J.jax.random.PRNGKey(9), len(qs))
    want = J.jax.vmap(lambda q, t, k: J.b.sampling_estimate(
        J.jnp.asarray(x), q, t, k, 50))(J.jnp.asarray(qs),
                                        J.jnp.asarray(taus), keys)
    ids = np.stack([np.asarray(J.jax.random.choice(k, x.shape[0], (50,),
                                                   replace=False))
                    for k in keys])
    got = baselines.sampling_from_draws(_t(x), _t(qs), _t(taus),
                                        ids=_t(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n_valid", [None, 450])
def test_sampling_ignores_the_order_of_draws_within_a_row(seed, n_valid):
    """The estimate counts hits a row, so the reference's draws given in
    any order within each row (as drawn, ascending, shuffled) give the
    reference's estimates bit for bit: the ids form, and the ``u, n_valid``
    form with its uniforms permuted."""
    J = _jax()
    x, qs, taus = _data(seed, nq=8)
    if n_valid is not None:
        x[n_valid:] = 1e6                   # padding no draw may reach
    xj = J.jnp.asarray(x)
    s = 60
    keys = [J.jax.random.PRNGKey(53 * seed + i) for i in range(len(qs))]
    nv = None if n_valid is None else J.jnp.int32(n_valid)
    want = np.array([J.b.sampling_estimate(xj, J.jnp.asarray(qs[i]), taus[i],
                                           k, s, n_valid=nv)
                     for i, k in enumerate(keys)], np.float32)
    if n_valid is None:
        draws = np.stack([np.asarray(J.jax.random.choice(
            k, x.shape[0], (s,), replace=False)) for k in keys])
        rows = draws
    else:
        draws = np.stack([np.asarray(J.jax.random.uniform(k, (s,)))
                          for k in keys])
        rows = np.minimum((draws * np.float32(n_valid)).astype(np.int32),
                          n_valid - 1)
    for i in range(len(qs)):
        assert_no_tau_ties(x[rows[i]], qs[i:i + 1], taus[i:i + 1])
    rng = np.random.default_rng(seed)
    for order in (draws, np.sort(draws, axis=1),
                  rng.permuted(draws, axis=1)):
        if n_valid is None:
            got = baselines.sampling_from_draws(_t(x), _t(qs), _t(taus),
                                                ids=_t(order))
        else:
            got = baselines.sampling_from_draws(_t(x), _t(qs), _t(taus),
                                                u=_t(order), n_valid=n_valid)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,nq,s", [(1000, 3, 10), (1000, 130, 1000),
                                    (50, 5, 50)])
def test_draw_sample_ids_law(n, nq, s):
    g = torch.Generator().manual_seed(n + s)
    ids = baselines.draw_sample_ids(g, n, nq, s)
    assert ids.shape == (nq, s) and ids.dtype == torch.int32
    assert int(ids.min()) >= 0 and int(ids.max()) < n
    for row in ids:
        assert torch.unique(row).numel() == s
    if s < n:
        # rows are independent draws
        assert not all(torch.equal(torch.sort(ids[0]).values,
                                   torch.sort(r).values) for r in ids[1:])
    with pytest.raises(ValueError):
        baselines.draw_sample_ids(g, n, 1, n + 1)


def test_sampling_estimate_with_generator():
    x, qs, taus = _data(2, n=2000, nq=12)
    g = torch.Generator().manual_seed(0)
    xt, qt, tt = _t(x), _t(qs), _t(taus)
    est = baselines.sampling_estimate(xt, qt, tt, g, 400)
    assert est.shape == (12,) and est.dtype == torch.float32
    # every estimate is a multiple of N / S
    np.testing.assert_allclose(est.numpy() / 5.0, np.round(est.numpy() / 5.0),
                               atol=1e-4)
    one = baselines.sampling_estimate(xt, qt[0], tt[0], g, 2000)
    truth = int((((xt - qt[0]) ** 2).sum(-1) <= tt[0] ** 2).sum())
    assert one.shape == () and float(one) == truth   # S = N: every row
    xp = torch.cat([xt, torch.full((500, 16), 1e6)])
    est = baselines.sampling_estimate(xp, qt, tt, g, 4000, n_valid=2000)
    assert est.shape == (12,) and (est <= 2000).all()
    rel = (est - torch.tensor([float((((xt - q) ** 2).sum(-1) <= t * t).sum())
                               for q, t in zip(qt, tt)])).abs() / 2000
    assert (rel < 0.06).all()


def _reference_init(J, x, key, n_refs=16, hidden=64):
    """The reference ``fit_mlp``'s initial model, step by step."""
    cfg = J.config.ProberConfig(pq_m=1, pq_kc=n_refs, pq_iters=8)
    refs = J.pq.fit(x, cfg, key).centroids[0]
    fdim = n_refs + 2
    k1, k2, k3 = J.jax.random.split(key, 3)
    normal = J.jax.random.normal
    return J.b.MLPEstimator(
        refs=refs,
        w1=normal(k1, (fdim, hidden)) * (1.0 / J.jnp.sqrt(fdim)),
        b1=J.jnp.zeros((hidden,)),
        w2=normal(k2, (hidden, hidden)) * (1.0 / J.jnp.sqrt(hidden)),
        b2=J.jnp.zeros((hidden,)),
        w3=normal(k3, (hidden, 1)) * (1.0 / J.jnp.sqrt(hidden)),
        b3=J.jnp.zeros((1,)))


def _mlp_case(J, seed):
    key = J.jax.random.PRNGKey(seed)
    x = J.v.make_corpus(key, 3000, 32)
    qs, taus, cards = J.v.paper_query_workload(J.jax.random.PRNGKey(seed + 10),
                                               x, 12, n_taus=6)
    return key, x, qs, taus, cards, _reference_init(J, x, key)


def _port(m_ref):
    return bridge.mlp_from_numpy({k: np.asarray(getattr(m_ref, k))
                                  for k in baselines.MLP_FIELDS}, "cpu")


def _flat(qs, taus):
    nt = taus.shape[1]
    return np.repeat(np.asarray(qs), nt, 0), np.asarray(taus).reshape(-1)


def _ref_fwd(J, m, fq, ft):
    return np.asarray(J.jax.vmap(lambda q, t: J.b._fwd(m, q, t))(
        J.jnp.asarray(fq), J.jnp.asarray(ft)))


@pytest.mark.parametrize("seed", range(4))
def test_mlp_features_and_forward_match_reference(seed):
    J = _jax()
    _, _, qs, taus, _, init = _mlp_case(J, seed)
    fq, ft = _flat(qs, taus)
    m = _port(init)
    want_f = np.asarray(J.jax.vmap(lambda q, t: J.b._features(init.refs, q, t))(
        J.jnp.asarray(fq), J.jnp.asarray(ft)))
    got_f = baselines.features(m.refs, _t(fq), _t(ft)).numpy()
    np.testing.assert_allclose(got_f, want_f, rtol=1e-6)
    want = _ref_fwd(J, init, fq, ft)
    got = m(_t(fq), _t(ft)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    est = baselines.mlp_estimate(m, _t(fq), _t(ft)).numpy()
    want_est = np.asarray(J.jax.vmap(lambda q, t: J.b.mlp_estimate(
        init, q, t))(J.jnp.asarray(fq), J.jnp.asarray(ft)))
    np.testing.assert_allclose(est, want_est, rtol=1e-5,
                               atol=1e-5 * np.abs(want_est).max())
    # one query alone (another matmul shape, another summation order)
    one = baselines.mlp_estimate(m, _t(fq[0]), float(ft[0]))
    assert one.shape == ()
    assert abs(float(one) - est[0]) <= 1e-5 * np.abs(want_est).max()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("epochs", [5, 400])
def test_train_matches_reference_fit(seed, epochs):
    """The port's training loop from the reference's initial weights
    against the reference's ``fit_mlp`` (tolerances in the module
    docstring)."""
    J = _jax()
    key, x, qs, taus, cards, init = _mlp_case(J, seed)
    want = J.b.fit_mlp(x, qs, taus, cards, key, epochs=epochs)
    m = baselines.train_mlp(_port(init), _t(qs), _t(taus), _t(cards),
                            epochs=epochs)
    got = bridge.mlp_to_numpy(m)
    np.testing.assert_array_equal(got["refs"], np.asarray(want.refs))
    fq, ft = _flat(qs, taus)
    pw = _ref_fwd(J, want, fq, ft)
    pg = m(_t(fq), _t(ft)).detach().numpy()
    if epochs == 5:
        for k in baselines.MLP_FIELDS[1:]:
            w = np.asarray(getattr(want, k))
            np.testing.assert_allclose(got[k], w, rtol=0,
                                       atol=1e-5 * np.abs(w).max())
        np.testing.assert_allclose(pg, pw, rtol=0, atol=1e-5 * np.abs(pw).max())
    else:
        y = np.log1p(np.asarray(cards).reshape(-1).astype(np.float32))
        lw, lg = np.mean((pw - y) ** 2), np.mean((pg - y) ** 2)
        assert abs(lg - lw) <= 1e-2 * lw, (lg, lw)
        np.testing.assert_allclose(pg, pw, rtol=0, atol=2e-2 * np.abs(pw).max())
        # training did something: the loss fell from the initial model's
        l0 = np.mean((_ref_fwd(J, init, fq, ft) - y) ** 2)
        assert lg < l0


def test_mlp_refs_replay_reference_refs():
    """``fit_mlp``'s steps from the reference's draws: the k-means
    references (``pq.fit`` at ``refs_config`` from the reference's initial
    rows) agree with the reference's within 1e-5 (the PQ fit's tolerance),
    and the model trained from them gives finite, non-negative
    estimates."""
    J = _jax()
    key, x, qs, taus, cards, init = _mlp_case(J, 1)
    rows = J.jax.random.choice(key, x.shape[0], (16,), replace=False)
    refs = pq.fit(_t(x), baselines.refs_config(16),
                  init_rows=_t(rows)).centroids[0]
    np.testing.assert_allclose(refs.numpy(), np.asarray(init.refs),
                               rtol=1e-5, atol=1e-5)
    m = baselines.train_mlp(baselines.init_mlp(
        refs, torch.Generator().manual_seed(0)), _t(qs), _t(taus),
        _t(cards), epochs=20)
    fq, ft = _flat(qs, taus)
    est = baselines.mlp_estimate(m, _t(fq), _t(ft))
    assert torch.isfinite(est).all() and (est >= 0).all()


def test_fit_mlp_with_generator_on_load():
    """The port's own draws: ``fit_mlp`` on a ``load``ed corpus, trained on
    60 % of the queries as ``benchmarks/common.py eval_mlp`` does, lowers
    the training loss; weights have the reference's shapes."""
    ds = vectors.load("sift", torch.Generator().manual_seed(3), n_queries=10,
                      scale=0.05, device="cpu")
    ntr = 6
    g = torch.Generator().manual_seed(4)
    m0 = baselines.fit_mlp(ds.x, ds.queries[:ntr], ds.taus[:ntr],
                           ds.cards[:ntr], g, epochs=0)
    m = baselines.fit_mlp(ds.x, ds.queries[:ntr], ds.taus[:ntr],
                          ds.cards[:ntr], torch.Generator().manual_seed(4))
    shapes = {k: tuple(getattr(m, k).shape) for k in baselines.MLP_FIELDS}
    assert shapes == {"refs": (16, 128), "w1": (18, 64), "b1": (64,),
                      "w2": (64, 64), "b2": (64,), "w3": (64, 1), "b3": (1,)}
    for k in baselines.MLP_FIELDS:
        if k != "refs":
            assert getattr(m, k).requires_grad
    assert not m.refs.requires_grad
    nt = ds.taus.shape[1]
    fq = ds.queries[:ntr].repeat_interleave(nt, 0)
    y = torch.log1p(ds.cards[:ntr].reshape(-1).float())
    with torch.no_grad():
        loss = lambda mm: float(((mm(fq, ds.taus[:ntr].reshape(-1)) - y) ** 2)
                                .mean())
        assert loss(m) < loss(m0)
    est = baselines.mlp_estimate(m, ds.queries[ntr:].repeat_interleave(nt, 0),
                                 ds.taus[ntr:].reshape(-1))
    assert torch.isfinite(est).all() and (est >= 0).all()


def test_mlp_bridge_round_trip():
    m = baselines.init_mlp(torch.randn(4, 8), torch.Generator().manual_seed(0),
                           hidden=5)
    back = bridge.mlp_from_numpy(bridge.mlp_to_numpy(m), "cpu")
    for k in baselines.MLP_FIELDS:
        assert torch.equal(getattr(back, k), getattr(m, k))
    with pytest.raises(KeyError):
        bridge.mlp_from_numpy({"refs": np.zeros((2, 2))}, "cpu")
