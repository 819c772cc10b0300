"""The fused slab step (``ops.slab_qualify``) against the reference.

On the CPU the wrapper runs its plain version, ``ref.slab_qualify``, held
here against the reference's own pieces on a bridged reference index:
``prober._prp_eval``, ``ring_cumsums`` and the searchsorted / ``starts`` /
``order`` walk of its ``_slab_step``, then its qualfns
(``make_exact_qualfn``, ``make_adc_qualfn`` hard and banded,
``make_adc_qualfn_q8``; byte and packed codes), per lane. Lane states cover
rings 1..K, slabs past the first, PRP domains walked past the sample cap
and finished lanes (k = K+1, clamped to ring K); routing mixes exact near
rings (``pq_exact_rings = 2``) with ADC far rings. Sample counts and hard
weight sums are bit-equal, banded sums within rtol 1e-6, under the tie
preconditions of ``_torch_parity`` (no d² or ADC distance within 1e-5·τ²
of τ², no uint8 LUT entry or threshold at a rounding tie).

The ``cuda``-marked tests hold the CUDA kernel against its plain version on
the card at the main path's shapes and skip elsewhere (the machine with
the card has no jax, so this module imports it only where it is used)."""
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

KW = dict(n_tables=2, n_funcs=8, ring_budget=512, central_budget=256,
          chunk=128, max_visit=2048, use_pq=True, pq_m=8, pq_kc=16,
          pq_iters=4)
NQ, NL, K, D = 12, 2, 8, 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.core import config, estimator, pq as jpq, prober as jprober
    return SimpleNamespace(jax=jax, jnp=jnp, config=config, E=estimator,
                           pq=jpq, prober=jprober)


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


@pytest.fixture(scope="module")
def slab_setup():
    """A bridged reference PQ index, 12 queries, both packages' ring
    constants per lane, and one slab state per lane."""
    J = _jax()
    jax, jnp, jpq, jprober = J.jax, J.jnp, J.pq, J.prober
    x = np.random.default_rng(0).standard_normal((2600, D)).astype(
        np.float32)
    jcfg = J.config.ProberConfig(**KW)
    jstate = J.E.build(jnp.asarray(x[:2400]), jcfg, jax.random.PRNGKey(3),
                      capacity=4096)
    state = bridge.state_from_numpy(jax_state_numpy(jstate), "cpu")
    qs, taus = _workload(x[:2400], NQ, 1)
    p = jstate.index.params
    assert_no_hash_ties(qs, p.a, p.b, p.w)
    assert_no_tau_ties(x, qs, taus, 2400)
    luts = np.asarray(jax.vmap(lambda q: jpq.adc_table(jstate.pq, q))(
        jnp.asarray(qs)))
    assert_no_adc_ties(luts, jstate.pq.codes, taus, 2400)
    assert_no_q8_ties(luts, taus, KW["pq_m"])

    view = prober.table_views(state.index)
    qcodes = lsh.hash_point(state.index.params, _t(qs), NL)
    ham = lsh.hamming_to_buckets(view.bucket_codes, view.n_buckets, qcodes)
    lane = torch.arange(NQ * NL)
    qual = prober._make_qual(state.x, _t(qs), _t(taus) ** 2, lane // NL,
                             config.ProberConfig(**KW))
    jviews = jprober.table_views(jstate.index)
    keys = jax.random.split(jax.random.PRNGKey(7), NQ * NL)
    jctx = []
    for i in range(NQ * NL):
        q, t = divmod(i, NL)
        jv = jax.tree_util.tree_map(lambda a: a[t], jviews)
        central = jprober.make_exact_qualfn(jstate.x, jnp.asarray(qs[q]),
                                            jnp.float32(taus[q]) ** 2)
        ctx, _, _ = jprober._table_setup(
            jv, jnp.asarray(qcodes[q, t].numpy()), central, jcfg, keys[i])
        jctx.append((jv, ctx))
    rks = torch.stack([_t(c.rks).long() for _, c in jctx])
    ctx, _, _ = prober._table_setup(view, ham, qcodes, rks, lane % NL, qual,
                                    True, config.ProberConfig(**KW))
    for name in ("prings", "caps", "nbits", "totals_f"):
        np.testing.assert_array_equal(
            getattr(ctx, name).numpy(),
            np.stack([np.asarray(getattr(c, name)) for _, c in jctx]))

    # one slab state per lane, lanes in a shuffled order: rings 1..K+1
    # (K+1: a finished lane), slabs 0..4 (the domains are <= 512 = 4 slabs,
    # so slab 4 lies past every domain)
    r = np.random.default_rng(5)
    lanes = torch.from_numpy(r.permutation(NQ * NL))
    k = (1 + torch.arange(NQ * NL) % (K + 1)).to(torch.int32)
    ci = torch.from_numpy(r.integers(0, 5, NQ * NL)).to(torch.int32)
    ci[:3] = torch.tensor([0, 1, 4], dtype=torch.int32)
    slab = (k, ci, lanes, lanes % NL, ctx.rks[lanes], ctx.prings[lanes],
            ctx.caps[lanes], ctx.nbits[lanes], ctx.cums, view.bucket_starts,
            view.order)
    return J, jstate, state, qs, taus, luts, jctx, slab


def _reference_walk(J, jv, ctx, k, ci, chunk):
    """The reference ``_slab_step``'s candidate half for one lane (its
    ring ``k`` already clamped): ``(ids, ok)``."""
    jnp, jprober = J.jnp, J.prober
    row = k - 1
    p_ring = ctx.prings[row]
    idx = ci * chunk + jnp.arange(chunk, dtype=jnp.int32)
    p_slab = jprober._prp_eval(idx, ctx.rks, p_ring - 1, ctx.nbits[row])
    cum = ctx.cums[k]
    ok = (idx < p_ring) & (p_slab < ctx.caps[row])
    j = jnp.minimum(jnp.searchsorted(cum, p_slab, side="right")
                    .astype(jnp.int32), cum.shape[0] - 1)
    prev = jnp.where(j > 0, cum[jnp.maximum(j - 1, 0)], 0)
    pos = jv.bucket_starts[j] + (p_slab - prev)
    pos = jnp.clip(jnp.where(ok, pos, 0), 0, jv.order.shape[0] - 1)
    return jv.order[pos], ok


SETTINGS = {
    "exact": dict(use_pq=False),
    "float-mixed": dict(pq_exact_rings=2),
    "float-packed": dict(pq_pack4=True, pq_exact_rings=0),
    "banded-mixed": dict(pq_banded=True, pq_exact_rings=2),
    "int8-mixed": dict(pq_int8_lut=True, pq_exact_rings=2),
    "int8-packed": dict(pq_int8_lut=True, pq_pack4=True, pq_exact_rings=0),
}


@pytest.mark.parametrize("name", list(SETTINGS))
def test_slab_qualify_matches_reference(slab_setup, name):
    J, jstate, state, qs, taus, luts, jctx, slab = slab_setup
    jnp, jpq, jprober = J.jnp, J.pq, J.prober
    cfg = config.ProberConfig(**dict(KW, **SETTINGS[name]))
    jp = jstate.pq
    jpacked = jpq.pack_codes(jp.codes) if cfg.pq_pack4 else None
    lane_q = torch.arange(NQ * NL) // NL
    pq_args = {}
    if cfg.use_pq:
        qluts = [jpq.quantize_lut(jnp.asarray(lt)) for lt in luts]
        stack = pq.QuantLUT(*(_t(np.stack([np.asarray(getattr(ql, f))
                                           for ql in qluts]))
                              for f in ("q8", "scale", "offset"))) \
            if cfg.pq_int8_lut else _t(luts)
        pq_args = dict(pq_codes=state.pq.codes, pq_luts=stack,
                       pq_resid=state.pq.resid,
                       pq_packed=pq.pack_codes(state.pq.codes)
                       if cfg.pq_pack4 else None)
    qual = prober._make_qual(state.x, _t(qs), _t(taus) ** 2, lane_q, cfg,
                             **pq_args)
    ops.reset_launches()
    wq, w = ops.slab_qualify(*slab, qual, cfg.chunk)
    assert ops.LAUNCHES["slab_qualify"] == 0          # the plain version ran
    assert wq.dtype == torch.float32 and w.dtype == torch.int32
    ids, ok = ref.slab_candidates(*slab, cfg.chunk)
    k, ci, lanes = slab[:3]
    routes = set()
    for a in range(NQ * NL):
        lane = int(lanes[a])
        q = lane // NL
        kc = min(int(k[a]), K)
        jv, ctx = jctx[lane]
        want_ids, want_ok = _reference_walk(J, jv, ctx, kc, int(ci[a]),
                                            cfg.chunk)
        np.testing.assert_array_equal(ok[a].numpy(), np.asarray(want_ok))
        np.testing.assert_array_equal(ids[a].numpy()[ok[a].numpy()],
                                      np.asarray(want_ids)[np.asarray(want_ok)])
        tsq = jnp.float32(taus[q]) ** 2
        if not cfg.use_pq or kc <= cfg.pq_exact_rings:
            fn = jprober.make_exact_qualfn(jstate.x, jnp.asarray(qs[q]), tsq)
            routes.add("exact")
        elif cfg.pq_int8_lut:
            fn = jprober.make_adc_qualfn_q8(
                jp.codes, jpq.quantize_lut(jnp.asarray(luts[q])), tsq,
                packed=jpacked)
            routes.add("adc")
        else:
            fn = jprober.make_adc_qualfn(
                jp.codes, jnp.asarray(luts[q]), tsq, resid=jp.resid,
                banded=cfg.pq_banded, packed=jpacked)
            routes.add("adc")
        wt = fn(want_ids)
        assert int(w[a]) == int(jnp.sum(want_ok))
        want_wq = float(jnp.sum(wt * want_ok))
        if cfg.pq_banded and kc > cfg.pq_exact_rings:
            np.testing.assert_allclose(float(wq[a]), want_wq, rtol=1e-6)
        else:
            assert float(wq[a]) == want_wq, (a, kc)
    assert routes == ({"exact", "adc"} if cfg.use_pq and cfg.pq_exact_rings
                      else {"adc"} if cfg.use_pq else {"exact"})
    assert int(w.sum()) > 0 and float(wq.sum()) > 0  # candidates qualified
    assert (ci[w == 0] > 0).any()                    # and walked past caps


def test_cpu_slab_wrapper_takes_plain_version_and_checks_devices(slab_setup):
    _, _, state, qs, taus, _, _, slab = slab_setup
    qual = prober._make_qual(state.x, _t(qs), _t(taus) ** 2,
                             torch.arange(NQ * NL) // NL,
                             config.ProberConfig(**dict(KW, use_pq=False)))
    ops.reset_launches()
    got = ops.slab_qualify(*slab, qual, 128)
    want = ref.slab_qualify(*slab, qual, 128)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(v == 0 for v in ops.LAUNCHES.values())
    meta = [t.to("meta") for t in slab]
    with pytest.raises(ValueError, match="no kernel"):
        ops.slab_qualify(*meta, ops.Qual(*(t.to("meta") for t in qual[:3])),
                         128)


# ---- on the card: the CUDA kernel against its plain version -------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


def _card_slab(g, nq, nl, nb, d, chunk, budget=2048):
    """A synthetic CSR index of nb buckets per table (sizes 0 or 1) with
    random Hamming rings 0..K+1, its ring cumsums and constants, and one
    random slab state for each of the nq·nl lanes in shuffled order."""
    dev = "cuda"
    sizes = (torch.rand((nl, nb), generator=g, device=dev) < 0.6).int()
    starts = (torch.cumsum(sizes, 1) - sizes).int().contiguous()
    n_points = nb
    order = torch.stack([torch.randperm(n_points, generator=g, device=dev)
                         for _ in range(nl)]).int()
    ham = torch.randint(0, K + 2, (nq, nl, nb), generator=g, device=dev,
                        dtype=torch.int32)
    view = prober.TableView(order, torch.zeros((nl, nb, K), device=dev),
                            starts, sizes, torch.full((nl,), nb, device=dev))
    cums = prober.ring_cumsums(view, ham, K)
    del ham
    totals = cums[:, 1:, -1]
    caps = totals.clamp_max(budget)
    nbits = torch.where(caps <= 1, 0, prober._bit_length(
        (caps - 1).clamp_min(1)))
    prings = torch.ones_like(nbits) << nbits
    nql = nq * nl
    lanes = torch.randperm(nql, generator=g, device=dev)
    k = torch.randint(1, K + 2, (nql,), generator=g, device=dev,
                      dtype=torch.int32)
    ci = torch.randint(0, budget // chunk + 1, (nql,), generator=g,
                       device=dev, dtype=torch.int32)
    rks = torch.randint(0, 2 ** 32, (nql, 6), generator=g, device=dev)
    x = torch.randn((n_points, d), generator=g, device=dev)
    qs = x[torch.randint(0, n_points, (nql,), generator=g, device=dev)] \
        + 0.5 * torch.randn((nql, d), generator=g, device=dev)
    tau_sq = d * (1.6 + 0.8 * torch.rand(nql, generator=g, device=dev))
    slab = (k, ci, lanes, lanes % nl, rks[lanes].contiguous(),
            prings[lanes].contiguous(), caps[lanes].contiguous(),
            nbits[lanes].contiguous(), cums, starts, order)
    return slab, ops.Qual(x, qs.contiguous(), tau_sq.contiguous())


def _pq_qual(g, qual, nq, nl, m, kc, packed, q8, banded):
    dev = "cuda"
    n, d = qual.x.shape
    codes = torch.randint(0, kc, (n, m), generator=g, device=dev,
                          dtype=torch.uint8)
    if packed:
        codes = pq.pack_codes(codes).contiguous()
    lane_q = (torch.arange(nq * nl, device=dev) // nl).int()
    if q8:
        luts = torch.randint(0, 256, (nq, m, kc), generator=g, device=dev,
                             dtype=torch.uint8)
        thresh = torch.randint(m * 100, m * 155, (nq * nl,), generator=g,
                               device=dev, dtype=torch.int32)
        return qual._replace(codes=codes, luts=luts, lane_q=lane_q,
                             thresh=thresh, exact_rings=2)
    luts = torch.rand((nq, m, kc), generator=g, device=dev) * (4 * d / m)
    resid = 3 * torch.rand(n, generator=g, device=dev) if banded else None
    return qual._replace(codes=codes, luts=luts, lane_q=lane_q, resid=resid,
                         exact_rings=2)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nl,nb,d,chunk,pq_kind", [
    (64, 2, 1 << 14, 128, 128, None),        # exact path slab
    (16, 2, 1 << 20, 128, 128, None),        # B = 2^20 ring rows
    (64, 2, 1 << 14, 128, 128, "float"),     # prober_cfg PQ, mixed routing
    (64, 2, 1 << 14, 128, 128, "banded"),    # banded float ADC
    (64, 1, 1 << 16, 128, 512, "q8-packed"),  # serve_cfg: 4-block clusters
    (8, 2, 3000, 30, 200, "q8"),             # odd sizes: 2 blocks, byte rows
])
def test_cuda_slab_qualify_matches_plain(nq, nl, nb, d, chunk, pq_kind):
    g = _card()
    slab, qual = _card_slab(g, nq, nl, nb, d, chunk)
    if pq_kind:
        m, kc = (32, 64) if "packed" not in pq_kind else (32, 16)
        if d == 30:
            m, kc = 30, 64
        qual = _pq_qual(g, qual, nq, nl, m, kc, "packed" in pq_kind,
                        pq_kind.startswith("q8"), pq_kind == "banded")
    ops.reset_launches()
    wq, w = ops.slab_qualify(*slab, qual, chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["slab_qualify"] == 1
    # the same sums the slab path took before the fusion: the torch walk
    # and the row kernels (bit-equal d² and ADC sums)
    bw, bcount = ref.slab_qualify(*slab, qual, chunk, rows=ops)
    pw, pcount = ref.slab_qualify(*slab, qual, chunk)
    assert torch.equal(w, bcount) and torch.equal(w, pcount)
    assert int(w.sum()) > 0 and float(wq.sum()) > 0
    if pq_kind == "banded":
        torch.testing.assert_close(wq, bw, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(wq, pw, rtol=1e-6, atol=1e-6)
    else:
        assert torch.equal(wq, bw)
        # against the plain sums, hard decisions may move only at d² ties
        ids, ok = ref.slab_candidates(*slab, chunk)
        lanes = slab[2]
        d2 = ((qual.x[ids.long()].double()
               - qual.qs[lanes][:, None].double()) ** 2).sum(-1)
        t2 = qual.tau_sq[lanes][:, None].double()
        ties = (((d2 - t2).abs() <= 1e-5 * t2) & ok).sum(1)
        assert ((wq - pw).abs() <= ties).all()


@pytest.mark.cuda
def test_cuda_slab_wrapper_raises_on_what_the_kernel_does_not_take():
    g = _card()
    slab, qual = _card_slab(g, 2, 2, 512, 16, 128)
    bad = list(slab)
    bad[0] = bad[0].long()
    with pytest.raises(TypeError):
        ops.slab_qualify(*bad, qual, 128)
    bad = list(slab)
    bad[5] = bad[5][:, :3]
    with pytest.raises(ValueError):
        ops.slab_qualify(*bad, qual, 128)
    with pytest.raises(ValueError, match="chunk"):
        ops.slab_qualify(*slab, qual, 0)
    with pytest.raises(ValueError, match="shapes"):
        ops.slab_qualify(*slab, qual._replace(x=qual.x[:10]), 128)
