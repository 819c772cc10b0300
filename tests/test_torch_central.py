"""The fused query hash (``ops.query_lanes``) and the central count of Alg.
3 (``ops.central_qualify``) against the reference.

On the CPU both wrappers run their plain versions: ``ref.query_lanes`` is
``ref.lsh_hash`` then ``ref.hamming_to_buckets``, held against the port's
``lsh.hash_point`` plus ``lsh.hamming_to_buckets`` and the reference's
``hash_point`` / ``hamming_to_buckets``; ``ref.central_qualify`` (plus the
torch scale of ``prober._count_central``) is held against the composition
it replaces (``gather_ring_from_cum`` over ring 0's size cumsum, then
``ref.qualify``) and the reference's own ``_count_central``, on a bridged
reference PQ index, plain and capacity-padded (with its sentinel bucket),
under exact, float, banded, uint8 and packed 4-bit qualification. Beside
the queries' own lanes, lanes carry codes below and above every bucket,
the sentinel bucket's code, a code between buckets, and the codes of the
first, the last and the largest bucket, which exceeds the budget. Counts
and hard sums are bit-equal to the old composition; against the reference,
counts are equal and estimates agree within rtol 1e-6, under the tie
preconditions of ``_torch_parity``.

The ``cuda``-marked tests hold both kernels against their plain versions
on the card and skip elsewhere (the machine with the card has no jax, so
this module imports it only where it is used)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_parity import (assert_no_adc_ties, assert_no_hash_ties,
                           assert_no_q8_ties, assert_no_tau_ties,
                           jax_state_numpy)
from repro_torch import bridge
from repro_torch.core import config, lsh, pq, prober
from repro_torch.kernels import ops, ref

# a central budget of 16 points: the largest central buckets exceed it
KW = dict(n_tables=2, n_funcs=8, ring_budget=512, central_budget=16,
          chunk=128, max_visit=2048, use_pq=True, pq_m=8, pq_kc=16,
          pq_iters=4)
NQ, NL, K, D = 12, 2, 8, 16
I32 = np.iinfo(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.core import config, estimator, lsh as jlsh, pq as jpq, \
        prober as jprober
    return SimpleNamespace(jax=jax, jnp=jnp, config=config, E=estimator,
                           lsh=jlsh, pq=jpq, prober=jprober)


def _workload(x, nq, seed):
    """Queries near data points, τ between neighbouring sorted exact
    distances (targets 1..300), moved off near-equal pairs."""
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


def _extra_codes(bcodes, nbk, sizes):
    """Codes of lanes beside the queries', per table: below and above every
    bucket, the sentinel's, one between two buckets, and those of the
    first, the last and the largest bucket."""
    out = []
    for t in range(bcodes.shape[0]):
        live = bcodes[t, :nbk[t]]
        between = live[nbk[t] // 2].copy()
        between[-1] += 1
        while (live == between).all(1).any():
            between[-1] += 1
        out += [(t, np.full(K, I32.min)), (t, live.max(0) + 1),
                (t, np.full(K, lsh.CODE_SENTINEL)), (t, between),
                (t, live[0]), (t, live[-1]),
                (t, live[int(np.argmax(sizes[t, :nbk[t]]))])]
    return out


@pytest.fixture(scope="module", params=["plain", "capacity"])
def setup(request):
    """A bridged reference PQ index, 12 queries, and the lanes' codes,
    tables and queries: the queries' own 24 lanes, then the extra ones."""
    J = _jax()
    jax, jnp = J.jax, J.jnp
    x = np.random.default_rng(0).standard_normal((2400, D)).astype(
        np.float32)
    jcfg = J.config.ProberConfig(**KW)
    if request.param == "plain":
        jstate = J.E.build(jnp.asarray(x), jcfg, jax.random.PRNGKey(3))
    else:
        jstate = J.E.build(jnp.asarray(x[:2000]), jcfg,
                           jax.random.PRNGKey(3), capacity=4096)
    n_valid = int(jstate.n_valid)
    state = bridge.state_from_numpy(jax_state_numpy(jstate), "cpu")
    qs, taus = _workload(x[:n_valid], NQ, 1)
    p = jstate.index.params
    assert_no_hash_ties(qs, p.a, p.b, p.w)
    assert_no_tau_ties(x, qs, taus, n_valid)
    luts = np.asarray(jax.vmap(lambda q: J.pq.adc_table(jstate.pq, q))(
        jnp.asarray(qs)))
    assert_no_adc_ties(luts, jstate.pq.codes, taus, n_valid)
    assert_no_q8_ties(luts, taus, KW["pq_m"])

    view = prober.table_views(state.index)
    qcodes = lsh.hash_point(state.index.params, _t(qs), NL).reshape(-1, K)
    extra = _extra_codes(view.bucket_codes.numpy(), view.n_buckets.numpy(),
                         view.bucket_sizes.numpy())
    codes = torch.cat([qcodes, _t(np.stack([c for _, c in extra]))
                       .to(torch.int32)]).contiguous()
    tid = torch.cat([torch.arange(NQ * NL) % NL,
                     torch.tensor([t for t, _ in extra])])
    lane_q = torch.cat([torch.arange(NQ * NL) // NL,
                        torch.arange(len(extra)) % NQ])
    return SimpleNamespace(J=J, jstate=jstate, state=state, qs=qs,
                           taus=taus, luts=luts, view=view, codes=codes,
                           tid=tid, lane_q=lane_q)


def test_query_lanes_matches_hash_and_hamming(setup):
    s = setup
    J, view, p = s.J, s.view, s.state.index.params
    ops.reset_launches()
    qcodes, ham = lsh.query_lanes(p, _t(s.qs), view.bucket_codes,
                                  view.n_buckets)
    got = ops.query_lanes(_t(s.qs), p.a, p.b, p.w, view.bucket_codes,
                          view.n_buckets)
    assert all(v == 0 for v in ops.LAUNCHES.values())   # plain versions ran
    assert qcodes.shape == (NQ, NL, K) and qcodes.dtype == torch.int32
    assert ham.shape == (NQ,) + tuple(view.bucket_codes.shape[:2])
    assert torch.equal(got[0], qcodes) and torch.equal(got[1], ham)
    want_codes = lsh.hash_point(p, _t(s.qs), NL)
    assert torch.equal(qcodes, want_codes)
    assert torch.equal(ham, lsh.hamming_to_buckets(
        view.bucket_codes, view.n_buckets, want_codes))
    # the reference (no hash value within the margin of an integer)
    jp = s.jstate.index.params
    jcodes = np.asarray(J.lsh.hash_point(jp, J.jnp.asarray(s.qs), NL))
    np.testing.assert_array_equal(qcodes.numpy(), jcodes)
    jix = s.jstate.index
    for q in range(NQ):
        for t in range(NL):
            want = J.lsh.hamming_to_buckets(jix.bucket_codes[t],
                                            jix.n_buckets[t], jcodes[q, t])
            np.testing.assert_array_equal(ham[q, t].numpy(),
                                          np.asarray(want))
    assert (ham == 0).any()                   # central buckets exist


def _lane_ham(view, codes, tid):
    """Each lane's Hamming distances to its table's buckets, K+1 on
    padding rows: (lanes, B)."""
    bc = view.bucket_codes[tid]
    dist = (bc != codes[:, None, :]).sum(-1, dtype=torch.int32)
    live = torch.arange(bc.shape[1], device=bc.device)[None, :] \
        < view.n_buckets[tid][:, None]
    return torch.where(live, dist, K + 1)


def test_each_lane_has_at_most_one_bucket_at_distance_0(setup):
    view, codes, tid = setup.view, setup.codes, setup.tid
    for t in range(NL):
        live = view.bucket_codes[t, :int(view.n_buckets[t])].numpy()
        # strictly increasing rows, lexicographic over signed int32
        diff = live[1:] != live[:-1]
        first = diff.argmax(1)
        assert diff.any(1).all()
        rows = np.arange(len(first))
        assert (live[:-1][rows, first] < live[1:][rows, first]).all()
    ham = _lane_ham(view, codes, tid)
    at0 = (ham == 0).sum(1)
    assert int(at0.max()) == 1 and (at0 == 0).any()
    _, _, total = ops.central_qualify(
        codes, tid, view.bucket_codes, view.n_buckets, view.bucket_starts,
        view.bucket_sizes, view.order, prober._make_qual(
            setup.state.x, _t(setup.qs), _t(setup.taus) ** 2, setup.lane_q,
            config.ProberConfig(**dict(KW, use_pq=False))), True, 16)
    want = torch.where(ham == 0, view.bucket_sizes[tid], 0).sum(1)
    assert torch.equal(total, want.to(torch.int32))


SETTINGS = {
    "exact": dict(use_pq=False),
    "float": dict(pq_exact_central=False),
    "banded": dict(pq_exact_central=False, pq_banded=True),
    "int8": dict(pq_exact_central=False, pq_int8_lut=True),
    "float-packed": dict(pq_exact_central=False, pq_pack4=True),
    "int8-packed": dict(pq_exact_central=False, pq_int8_lut=True,
                        pq_pack4=True),
}


def _qual(s, cfg):
    """The lanes' qualification inputs under ``cfg``, and whether the
    central count is exact."""
    J, jnp = s.J, s.J.jnp
    pq_args = {}
    if cfg.use_pq:
        qluts = [J.pq.quantize_lut(jnp.asarray(lt)) for lt in s.luts]
        stack = pq.QuantLUT(*(_t(np.stack([np.asarray(getattr(ql, f))
                                           for ql in qluts]))
                              for f in ("q8", "scale", "offset"))) \
            if cfg.pq_int8_lut else _t(s.luts)
        pq_args = dict(pq_codes=s.state.pq.codes, pq_luts=stack,
                       pq_resid=s.state.pq.resid,
                       pq_packed=pq.pack_codes(s.state.pq.codes)
                       if cfg.pq_pack4 else None)
    qual = prober._make_qual(s.state.x, _t(s.qs), _t(s.taus) ** 2,
                             s.lane_q, cfg, **pq_args)
    return qual, qual.codes is None or cfg.pq_exact_central


def _old_composition(view, codes, tid, qual, exact, budget):
    """The central count before ``central_qualify``: ring 0's size cumsum,
    ``gather_ring_from_cum`` over it, ``ref.qualify`` through the row
    kernels' wrappers and the same scale."""
    ham = _lane_ham(view, codes, tid)
    cum0 = torch.cumsum(torch.where(ham == 0, view.bucket_sizes[tid], 0),
                        -1, dtype=torch.int32)
    ids, valid, total = ref.gather_ring_from_cum(view, tid, cum0, budget)
    lanes = torch.arange(codes.shape[0])
    qualified = (ref.qualify(qual, ids, lanes, exact, rows=ops)
                 * valid).sum(-1)
    seen = valid.sum(-1, dtype=torch.int32)
    scale = torch.where(seen > 0, total / seen.clamp_min(1), 0.0)
    return qualified, seen, total, qualified * scale, ids, valid


def _reference_central(s, name, lane):
    """The reference's ``_count_central`` for one lane: (est, seen)."""
    J, jnp, jprober, jp = s.J, s.J.jnp, s.J.prober, s.jstate.pq
    t, q = int(s.tid[lane]), int(s.lane_q[lane])
    kw = dict(KW, **SETTINGS[name])
    cfg = config.ProberConfig(**kw)
    jv = J.jax.tree_util.tree_map(lambda a: a[t],
                                  jprober.table_views(s.jstate.index))
    jham = J.lsh.hamming_to_buckets(jv.bucket_codes, jv.n_buckets,
                                    jnp.asarray(s.codes[lane].numpy()))
    cum0 = jprober.ring_cumsums(jv, jham, K)[0]
    tsq = jnp.float32(s.taus[q]) ** 2
    jpacked = J.pq.pack_codes(jp.codes) if cfg.pq_pack4 else None
    if not cfg.use_pq or cfg.pq_exact_central:
        fn = jprober.make_exact_qualfn(s.jstate.x, jnp.asarray(s.qs[q]), tsq)
    elif cfg.pq_int8_lut:
        fn = jprober.make_adc_qualfn_q8(
            jp.codes, J.pq.quantize_lut(jnp.asarray(s.luts[q])), tsq,
            packed=jpacked)
    else:
        fn = jprober.make_adc_qualfn(jp.codes, jnp.asarray(s.luts[q]), tsq,
                                     resid=jp.resid, banded=cfg.pq_banded,
                                     packed=jpacked)
    est, seen = jprober._count_central(jv, cum0, fn,
                                       J.config.ProberConfig(**kw))
    return float(est), int(seen)


@pytest.mark.parametrize("name", list(SETTINGS))
def test_central_qualify_matches_old_composition_and_reference(setup, name):
    s = setup
    view, codes, tid = s.view, s.codes, s.tid
    cfg = config.ProberConfig(**dict(KW, **SETTINGS[name]))
    qual, exact = _qual(s, cfg)
    assert exact == (name == "exact")
    budget = cfg.central_budget
    ops.reset_launches()
    got = ops.central_qualify(codes, tid, view.bucket_codes, view.n_buckets,
                              view.bucket_starts, view.bucket_sizes,
                              view.order, qual, exact, budget)
    est, seen = prober._count_central(view, tid, codes, qual, exact, cfg)
    assert all(v == 0 for v in ops.LAUNCHES.values())   # plain versions ran
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32 \
        and got[2].dtype == torch.int32
    old = _old_composition(view, codes, tid, qual, exact, budget)
    for a, b in zip(got, old[:3]):
        assert torch.equal(a, b)
    assert torch.equal(seen, old[1]) and torch.equal(est, old[3])
    # what the lanes cover: a bucket over the budget, lanes with no bucket
    # (the extra lanes' below, above, sentinel and between codes), and
    # qualified points
    assert (got[2] > budget).any() and (got[1] == budget).any()
    n_extra = codes.shape[0] - NQ * NL
    assert (got[2][NQ * NL:].reshape(NL, -1)[:, :4] == 0).all()
    assert (got[2][NQ * NL:].reshape(NL, -1)[:, 4:] > 0).all()
    assert n_extra == 7 * NL and float(got[0].sum()) > 0
    # the reference, lane by lane
    for lane in range(codes.shape[0]):
        want_est, want_seen = _reference_central(s, name, lane)
        assert int(seen[lane]) == want_seen, lane
        np.testing.assert_allclose(float(est[lane]), want_est, rtol=1e-6)


def test_cpu_central_wrapper_checks_devices(setup):
    s = setup
    qual, _ = _qual(s, config.ProberConfig(**dict(KW, use_pq=False)))
    args = (s.codes, s.tid, s.view.bucket_codes, s.view.n_buckets,
            s.view.bucket_starts, s.view.bucket_sizes, s.view.order)
    meta = [t.to("meta") for t in args]
    with pytest.raises(ValueError, match="no kernel"):
        ops.central_qualify(*meta, ops.Qual(*(t.to("meta")
                                              for t in qual[:3])), True, 16)
    p = s.state.index.params
    with pytest.raises(ValueError, match="no kernel"):
        ops.query_lanes(*(t.to("meta") for t in (
            _t(s.qs), p.a, p.b, p.w, s.view.bucket_codes,
            s.view.n_buckets)))


# ---- on the card: the CUDA kernels against their plain versions ---------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,d,nl,k,nb", [
    (64, 128, 2, 10, 1 << 16),    # the main path's queries and tables
    (64, 128, 1, 12, 1 << 20),    # serve_cfg's table at B = 2^20
    (300, 64, 2, 10, 5000),       # queries staged in more than one chunk
    (5, 30, 3, 7, 1000),          # odd widths: 4-byte staging
    (1, 8, 1, 1, 1),
])
def test_cuda_query_lanes_matches_hash_and_hamming(nq, d, nl, k, nb):
    g = _card()
    dev = "cuda"
    qs = torch.randn((nq, d), generator=g, device=dev)
    a = torch.randn((d, nl * k), generator=g, device=dev)
    b = torch.rand(nl * k, generator=g, device=dev)
    w = 0.5 + torch.rand(nl * k, generator=g, device=dev)
    bc = torch.randint(-3, 4, (nl, nb, k), generator=g, device=dev,
                       dtype=torch.int32)
    nbk = torch.randint(max(nb // 2, 1), nb + 1, (nl,), generator=g,
                        device=dev, dtype=torch.int32)
    ops.reset_launches()
    qcodes, ham = ops.query_lanes(qs, a, b, w, bc, nbk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["query_lanes"] == 1
    want = ops.lsh_hash(qs, a, b, w).reshape(nq, nl, k)
    assert torch.equal(qcodes, want)
    assert torch.equal(ham, ops.hamming_to_buckets(bc, want, nbk))
    assert torch.equal(ham, ref.hamming_to_buckets(bc, want, nbk))
    # fewer worker blocks stride over the live tiles; more than the tiles
    # give each its own
    for workers in (1, 5, 64, 1 << 20):
        got = ops.query_lanes(qs, a, b, w, bc, nbk, workers=workers)
        assert torch.equal(got[0], qcodes) and torch.equal(got[1], ham)


def _card_index(g, n, capacity):
    """A real index on the card: clustered points, capacity-padded (with
    the sentinel bucket) when ``capacity`` is given."""
    from repro_torch.data import vectors
    cfg = config.ProberConfig(n_tables=2, n_funcs=10)
    x = vectors.make_corpus(g, n, 32)
    if capacity:
        x = torch.nn.functional.pad(x, (0, 0, 0, capacity - n))
    ix = lsh.build_index(x, cfg, g, n_valid=n if capacity else None)
    return x, ix


@pytest.mark.cuda
@pytest.mark.parametrize("capacity,kind,budget", [
    (None, "exact", 64), (1 << 15, "exact", 2048), (1 << 15, "float", 512),
    (1 << 15, "banded", 100), (None, "q8", 512), (1 << 15, "q8-packed", 300),
])
def test_cuda_central_qualify_matches_plain(capacity, kind, budget):
    g = _card()
    dev = "cuda"
    x, ix = _card_index(g, 20000, capacity)
    view = prober.table_views(ix)
    nl, _, k = ix.bucket_codes.shape
    # every live bucket's code, then codes that match no bucket
    codes, tid = [], []
    for t in range(nl):
        live = ix.bucket_codes[t, :int(ix.n_buckets[t])]
        codes += [live, live.min(0).values[None] - 1,
                  live.max(0).values[None] + 1,
                  torch.full((1, k), lsh.CODE_SENTINEL, device=dev,
                             dtype=torch.int32)]
        tid += [t] * (live.shape[0] + 3)
    codes = torch.cat(codes).contiguous()
    tid = torch.tensor(tid, device=dev)
    nql = codes.shape[0]
    qs = x[torch.randint(0, 20000, (nql,), generator=g, device=dev)] \
        + 0.3 * torch.randn((nql, x.shape[1]), generator=g, device=dev)
    tau_sq = 2 + 2 * torch.rand(nql, generator=g, device=dev)
    qual = ops.Qual(x, qs.contiguous(), tau_sq)
    if kind != "exact":
        m, kc = (8, 16) if "packed" in kind else (16, 64)
        pc = torch.randint(0, kc, (x.shape[0], m), generator=g, device=dev,
                           dtype=torch.uint8)
        lane_q = torch.randint(0, 7, (nql,), generator=g, device=dev,
                               dtype=torch.int32)
        qual = qual._replace(
            codes=pq.pack_codes(pc).contiguous() if "packed" in kind else pc,
            lane_q=lane_q)
        if kind.startswith("q8"):
            qual = qual._replace(
                luts=torch.randint(0, 256, (7, m, kc), generator=g,
                                   device=dev, dtype=torch.uint8),
                thresh=torch.randint(m * 100, m * 155, (nql,), generator=g,
                                     device=dev, dtype=torch.int32))
        else:
            qual = qual._replace(
                luts=torch.rand((7, m, kc), generator=g, device=dev) * 0.6,
                resid=torch.rand(x.shape[0], generator=g, device=dev)
                if kind == "banded" else None)
    exact = kind == "exact"
    args = (codes, tid, view.bucket_codes, view.n_buckets,
            view.bucket_starts, view.bucket_sizes, view.order, qual, exact,
            budget)
    ops.reset_launches()
    got = ops.central_qualify(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["central_qualify"] == 1
    plain = ref.central_qualify(*args)
    old = _old_composition(view, codes, tid, qual, exact, budget)
    assert torch.equal(got[1], plain[1]) and torch.equal(got[2], plain[2])
    assert torch.equal(got[1], old[1]) and torch.equal(got[2], old[2])
    # each live bucket found, with its size; the other codes match none
    sizes = torch.cat([torch.cat([ix.bucket_sizes[t, :int(ix.n_buckets[t])],
                                  ix.bucket_sizes.new_zeros(3)])
                       for t in range(nl)])
    assert torch.equal(got[2], sizes)
    if kind == "banded":
        torch.testing.assert_close(got[0], old[0], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got[0], plain[0], rtol=1e-6, atol=1e-6)
    elif exact:
        assert torch.equal(got[0], old[0])
        # against the plain sums, decisions may move only at d² ties
        ids, valid = old[4:]
        d2 = ((x[ids.long()].double() - qs[:, None].double()) ** 2).sum(-1)
        t2 = tau_sq[:, None].double()
        ties = (((d2 - t2).abs() <= 1e-5 * t2) & valid).sum(1)
        assert ((got[0] - plain[0]).abs() <= ties).all()
    else:
        assert torch.equal(got[0], old[0]) and torch.equal(got[0], plain[0])
    assert float(got[0].sum()) > 0


@pytest.mark.cuda
def test_cuda_central_wrapper_raises_on_what_the_kernel_does_not_take():
    g = _card()
    x, ix = _card_index(g, 2000, None)
    view = prober.table_views(ix)
    codes = ix.bucket_codes[0, :4].contiguous()
    tid = torch.zeros(4, dtype=torch.int64, device="cuda")
    qual = ops.Qual(x, x[:4].contiguous(), torch.ones(4, device="cuda"))
    args = [codes, tid, view.bucket_codes, view.n_buckets,
            view.bucket_starts, view.bucket_sizes, view.order]
    with pytest.raises(ValueError, match="qcodes"):
        ops.central_qualify(codes.long(), *args[1:], qual, True, 16)
    with pytest.raises(TypeError):
        ops.central_qualify(codes, tid.int(), *args[2:], qual, True, 16)
    with pytest.raises(ValueError, match="budget"):
        ops.central_qualify(*args, qual, True, 0)
    with pytest.raises(ValueError, match="PQ codes"):
        ops.central_qualify(*args, qual, False, 16)
    with pytest.raises(ValueError, match="shapes"):
        ops.central_qualify(*args, qual._replace(tau_sq=qual.tau_sq[:3]),
                            True, 16)
