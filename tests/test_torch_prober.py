"""The port's prober (exact path) against the reference on a bridged-in
reference index, with the reference's own PRP round keys: per-lane
``probed_k`` and ``nvisited`` equal, estimates within rtol 1e-6, for both
lane schedules, and ``estimate`` equal to its batch row."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_no_hash_ties, assert_no_tau_ties,
                           jax_state_numpy, reference_round_keys)
from repro.core import config as jconfig, estimator as JE, lsh as jlsh, \
    prober as jprober
from repro_torch import bridge
from repro_torch.core import config, estimator as E, lsh, prober
from repro_torch.kernels import ref

KW = dict(n_tables=2, n_funcs=8, ring_budget=512, central_budget=256,
          chunk=128, max_visit=2048)
NQ = 12            # 24 lanes: above the reference's lane_tile, so its
                   # lane_block > 0 run takes the compacting schedule


def _workload(x, nq, seed):
    """Queries near data points; τ at the midpoint between neighbouring
    sorted distances (the paper protocol), targets spread over 1..400. A
    target whose two distances are closer than 1e-4 relative moves to the
    next rank, so that no d² lies at τ² (the stated precondition)."""
    r = np.random.default_rng(seed)
    qs = (x[r.choice(len(x), nq, replace=False)]
          + 0.05 * r.standard_normal((nq, x.shape[1]))).astype(np.float32)
    targets = np.geomspace(1, 400, nq).astype(int)
    taus = []
    for q, t in zip(qs.astype(np.float64), targets):
        d = np.sort(np.sqrt(((x.astype(np.float64) - q) ** 2).sum(-1)))
        while d[t] - d[t - 1] < 1e-4 * d[t]:
            t += 1
        taus.append(0.5 * (d[t - 1] + d[t]))
    return qs, np.asarray(taus, np.float32)


@pytest.fixture(scope="module", params=["plain", "capacity"])
def setup(request):
    x = np.random.default_rng(0).standard_normal((2048, 16)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jcfg = jconfig.ProberConfig(**KW)
    if request.param == "plain":
        jstate = JE.build(jnp.asarray(x), jcfg, key)
    else:
        jstate = JE.build(jnp.asarray(x[:1800]), jcfg, key, capacity=2048)
    state = bridge.state_from_numpy(jax_state_numpy(jstate), "cpu")
    n_valid = int(jstate.n_valid)
    qs, taus = _workload(x[:n_valid], NQ, 1)
    p = jstate.index.params
    assert_no_hash_ties(qs, p.a, p.b, p.w)
    assert_no_tau_ties(x, qs, taus, n_valid)
    return jstate, state, qs, taus


@pytest.mark.parametrize("lane_block", [0, 4])
def test_estimate_batch_stats_matches_reference(setup, lane_block):
    jstate, state, qs, taus = setup
    jcfg = jconfig.ProberConfig(**KW, lane_block=lane_block)
    cfg = config.ProberConfig(**KW, lane_block=lane_block)
    key = jax.random.PRNGKey(7)
    want = JE.estimate_batch_stats(jstate, jnp.asarray(qs), jnp.asarray(taus),
                                   jcfg, key)
    rks = torch.from_numpy(reference_round_keys(key, NQ, 2))
    got = E.estimate_batch_stats(state, torch.from_numpy(qs),
                                 torch.from_numpy(taus), cfg, rks=rks)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6)
    assert np.asarray(want[0]).std() > 0          # non-degenerate workload
    assert (np.asarray(want[1]) > 0).any()        # rings were probed


def test_estimate_equals_batch_row(setup):
    jstate, state, qs, taus = setup
    cfg = config.ProberConfig(**KW)
    rks = torch.from_numpy(reference_round_keys(jax.random.PRNGKey(7), NQ, 2))
    batch = E.estimate_batch(state, torch.from_numpy(qs),
                             torch.from_numpy(taus), cfg, rks=rks)
    for i in (0, NQ - 1):
        one = E.estimate(state, torch.from_numpy(qs[i]), float(taus[i]), cfg,
                         rks=rks[i])
        assert float(one) == float(batch[i])
    # and the reference's single-query entry point agrees with its batch
    jcfg = jconfig.ProberConfig(**KW)
    keys = jax.random.split(jax.random.PRNGKey(7), NQ)
    want = JE.estimate(jstate, jnp.asarray(qs[0]), jnp.float32(taus[0]),
                       jcfg, keys[0])
    np.testing.assert_allclose(float(batch[0]), float(want), rtol=1e-6)


def test_ring_cumsums_and_central_gather_bit_equal(setup):
    jstate, state, qs, taus = setup
    jix = jstate.index
    qcodes = lsh.hash_point(state.index.params, torch.from_numpy(qs), 2)
    view = prober.table_views(state.index)
    ham = lsh.hamming_to_buckets(view.bucket_codes, view.n_buckets, qcodes)
    cums = prober.ring_cumsums(view, ham, 8)
    tid = torch.arange(NQ * 2) % 2
    ids, valid, total = ref.gather_ring_from_cum(
        view, tid, cums[:, 0].contiguous(), 256)
    jviews = jprober.table_views(jix)
    for q in (0, 5):
        for t in range(2):
            jv = jax.tree_util.tree_map(lambda a: a[t], jviews)
            jham = jlsh.hamming_to_buckets(jv.bucket_codes, jv.n_buckets,
                                           jnp.asarray(qcodes[q, t].numpy()))
            jc = jprober.ring_cumsums(jv, jham, 8)
            lane = q * 2 + t
            np.testing.assert_array_equal(cums[lane].numpy(), np.asarray(jc))
            wids, wvalid, wtotal = jprober.gather_ring_from_cum(jv, jc[0], 256)
            np.testing.assert_array_equal(ids[lane].numpy(), np.asarray(wids))
            np.testing.assert_array_equal(valid[lane].numpy(),
                                          np.asarray(wvalid))
            assert int(total[lane]) == int(wtotal)
