"""The port's distributed prober (``repro_torch.core.distributed``, the
pooled-stopping path of ``prober.estimate_batch`` and the sharded
``CardinalityCoalescer``) against the reference's ``repro.core.distributed``
and ``CardinalityCoalescer(mesh=...)``.

The reference runs once per module in a subprocess with four forced host
devices (as ``tests/test_sharding.py`` runs its 8-device tests): it builds,
updates and queries sharded states and writes them, the per-shard round
keys (``fold_in(key, shard)``, as ``estimate_sharded`` folds them) and its
estimates to an ``.npz``. The port then runs once as four gloo ranks on
the CPU (``distributed.run_ranks``), each loading its shard through the
bridge, and writes what it computed per rank; the tests compare the two.
JAX is imported only in the reference's subprocess.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_parity import (assert_no_adc_ties, assert_no_hash_ties,
                           assert_no_q8_ties, assert_no_tau_ties,
                           near_integer)
from repro_torch import bridge
from repro_torch.core import collectives, config, distributed as D
from repro_torch.core import estimator as E, lsh
from repro_torch.data import vectors
from repro_torch.kernels import ops
from repro_torch.serve.coalescer import CardinalityCoalescer

ROOT = Path(__file__).resolve().parents[1]
SHARDS = 4
KW = dict(n_tables=2, n_funcs=8, ring_budget=512, central_budget=256,
          chunk=128)
PQ_KW = dict(KW, max_visit=2048, use_pq=True, pq_m=8, pq_kc=16, pq_iters=4)
PQ_SETTINGS = {"float": dict(), "int8": dict(pq_int8_lut=True,
                                             pq_exact_rings=0)}
# the reference's test_8dev_distributed_estimator config
EPS0_KW = dict(n_tables=1, n_funcs=6, ring_budget=1024, central_budget=1024,
               chunk=128, eps=0.0, s1=1.0, max_visit=100000)
# the reference's test_8dev_sync_beats_local_on_skewed_shards config
SKEW_KW = dict(n_tables=1, n_funcs=8, n_regions=4, ring_budget=2048,
               central_budget=2048, chunk=64, s1=0.05, eps=0.12)
NQ = 12                     # 24 lanes: the reference's compacting schedule
N_BUILD, N_UP1, N_UP2 = 1600, 401, 1000     # up2 grows every shard
CAPACITY = 2048
N_PQ = 2400
ROUTES = ((10, 4, 0), (10, 4, 3), (7, 3, 5), (1, 4, 2), (0, 4, 1),
          (13, 4, 2601))
COAL_BATCH, COAL_INGEST = 16, 700
# requests of the coalescer stream: 12, flush, ingest, 20 (16 auto-flush)
COAL_FIRST, COAL_SECOND = 12, 20


def _data():
    return np.random.default_rng(5).standard_normal((6000, 16)).astype(
        np.float32)


def _workload(x, nq, seed):
    """Queries near data points, τ between neighbouring sorted exact
    distances, targets spread over 1..300 (as in test_torch_pq)."""
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


def _coalescer_stream():
    x = _data()
    qs, taus = _workload(x[:N_BUILD], COAL_FIRST + COAL_SECOND, 4)
    n = N_BUILD + N_UP1 + N_UP2
    return qs, taus, x[n:n + COAL_INGEST]


REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
sys.path.insert(0, sys.argv[2])
import test_torch_distributed as T
from _torch_parity import jax_state_numpy, reference_round_keys
from repro import compat
from repro.core import config as C, distributed as D, prober, pq as jpq
from repro.core import estimator as E
from repro.serve.engine import CardinalityCoalescer

S = T.SHARDS
mesh = compat.make_mesh((S,), ("data",))
out = {}

def put(tag, d):
    out.update({f"{tag}/{k}": np.asarray(v) for k, v in d.items()})

def shard_keys(key, nq, nl):
    return np.stack([reference_round_keys(jax.random.fold_in(key, s), nq, nl)
                     for s in range(S)])

def pooled_stats(st, qs, taus, cfg, key):
    # estimate_batch_pooled with with_stats, as estimate_sharded calls it
    spec = P(("data",))
    def f(st, q, t, k):
        st = jax.tree_util.tree_map(lambda a: a[0], st)
        k = jax.random.fold_in(k, jax.lax.axis_index("data"))
        keys = jax.random.split(k, q.shape[0])
        pq = {}
        if cfg.use_pq:
            luts = jax.vmap(lambda qq: jpq.build_query_lut(st.pq, qq, cfg))(q)
            pq = dict(pq_codes=st.pq.codes, pq_luts=luts,
                      pq_resid=st.pq.resid, pq_packed=st.pq.packed)
        return prober.estimate_batch(st.index, st.x, q, t, cfg, keys,
                                     axis_name=("data",), with_stats=True,
                                     **pq)
    g = jax.jit(compat.shard_map(f, mesh=mesh, in_specs=(spec, P(), P(), P()),
                                 out_specs=P(), check_vma=False))
    return [np.asarray(a) for a in g(st, qs, taus, key)]

def estimates(tag, st, qs, taus, cfg, key):
    out[f"{tag}/keys"] = shard_keys(key, qs.shape[0], cfg.n_tables)
    for mode in ("local", "sync"):
        out[f"{tag}/{mode}"] = np.asarray(D.estimate_sharded(
            st, jnp.asarray(qs), jnp.asarray(taus), cfg, key, mesh,
            mode=mode))
    e, pk, nv = pooled_stats(st, jnp.asarray(qs), jnp.asarray(taus), cfg, key)
    out[f"{tag}/stats_est"], out[f"{tag}/probed_k"] = e, pk
    out[f"{tag}/nvisited"] = nv

x = T._data()
cfg = C.ProberConfig(**T.KW)
st, params = D.build_sharded(jnp.asarray(x[:T.N_BUILD]), cfg,
                             jax.random.PRNGKey(0), mesh, capacity=T.CAPACITY)
put("build", jax_state_numpy(st))
out["build/w_global"] = np.asarray(params.w)
n1 = T.N_BUILD + T.N_UP1
st1, nv1 = D.update_sharded(st, x[T.N_BUILD:n1], cfg, mesh)
put("up1", jax_state_numpy(st1)); out["up1/nv"] = nv1
n2 = n1 + T.N_UP2
st2, nv2 = D.update_sharded(st1, x[n1:n2], cfg, mesh, n_valid=nv1)
put("up2", jax_state_numpy(st2)); out["up2/nv"] = nv2

for i, (n, s, off) in enumerate(T.ROUTES):
    for j, part in enumerate(D.route_round_robin(
            np.arange(2 * n, dtype=np.float32).reshape(n, 2), s, off)):
        out[f"route/{i}/{j}"] = part

qs, taus = T._workload(x[:n2], T.NQ, 1)
out["exact/qs"], out["exact/taus"] = qs, taus
estimates("exact", st2, qs, taus, cfg, jax.random.PRNGKey(7))

pcfg = C.ProberConfig(**T.PQ_KW)
pst, _ = D.build_sharded(jnp.asarray(x[:T.N_PQ]), pcfg, jax.random.PRNGKey(3),
                         mesh, capacity=4096)
put("pq_state", jax_state_numpy(pst))
qs, taus = T._workload(x[:T.N_PQ], T.NQ, 2)
out["pq/qs"], out["pq/taus"] = qs, taus
out["pq/luts"] = np.stack([np.asarray(jax.vmap(
    lambda q: jpq.adc_table(jax.tree_util.tree_map(lambda a: a[s], pst.pq),
                            q))(jnp.asarray(qs))) for s in range(S)])
for name, kw in T.PQ_SETTINGS.items():
    estimates(f"pq_{name}", pst, qs, taus,
              C.ProberConfig(**dict(T.PQ_KW, **kw)), jax.random.PRNGKey(9))

xs, qs, taus = T.vectors.skewed_shards(np.random.default_rng(0), S)
scfg = C.ProberConfig(**T.SKEW_KW)
sst, _ = D.build_sharded(jnp.asarray(xs), scfg, jax.random.PRNGKey(0), mesh)
put("skew_state", jax_state_numpy(sst))
out["skew/x"], out["skew/qs"], out["skew/taus"] = xs, qs, taus
estimates("skew", sst, qs, taus, scfg, jax.random.PRNGKey(0))

cqs, ctaus, cx = T._coalescer_stream()
ckey = jax.random.PRNGKey(21)
for mode in ("local", "sync"):
    co = CardinalityCoalescer(st, cfg, ckey, max_batch=T.COAL_BATCH,
                              mesh=mesh, mode=mode)
    reqs = [co.submit(cqs[i], ctaus[i]) for i in range(T.COAL_FIRST)]
    co.flush()
    co.ingest(cx)
    reqs += [co.submit(cqs[i], ctaus[i])
             for i in range(T.COAL_FIRST, T.COAL_FIRST + T.COAL_SECOND)]
    co.flush()
    out[f"coal_{mode}/est"] = np.asarray([r.est for r in reqs], np.float32)
    out[f"coal_{mode}/nv"] = np.asarray(co._n_valid)
    out[f"coal_{mode}/w"] = np.asarray(co.state.index.params.w[0])
    out[f"coal_{mode}/flushes"] = np.asarray(co._n_flushes)
# flush i pads its batch to p; each shard folds its index into fold_in(key, i)
for i, p in enumerate((16, 16, 4)):
    out[f"coal/keys/{i}"] = shard_keys(jax.random.fold_in(ckey, i), p,
                                       cfg.n_tables)
np.savez(sys.argv[1], **out)
print("reference done")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("reference") / "reference.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(path),
                        str(ROOT / "tests")], capture_output=True, text=True,
                       env=env, cwd=ROOT, timeout=240)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return dict(np.load(path))


def _sub(d, tag):
    p = f"{tag}/"
    return {k[len(p):]: v for k, v in d.items() if k.startswith(p)}


def _t(a):
    return torch.from_numpy(np.array(a))


class _Counter:
    """Counts the port's collectives (``collectives.COUNT``) and the
    ``ops.slab_qualify`` calls (the slab steps) while installed."""

    def __init__(self):
        self.reduces = self.steps = 0
        self._sq = ops.slab_qualify

    def __enter__(self):
        def slab_qualify(*a, **k):
            self.steps += 1
            return self._sq(*a, **k)
        self._calls0 = collectives.COUNT["calls"]
        ops.slab_qualify = slab_qualify
        return self

    def __exit__(self, *exc):
        ops.slab_qualify = self._sq
        self.reduces = collectives.COUNT["calls"] - self._calls0


def _estimate_case(out, tag, st, qs, taus, cfg, rks):
    """Both modes, and the pooled stats; the collectives of each."""
    with _Counter() as c:
        out[f"{tag}/local"] = D.estimate_sharded(st, qs, taus, cfg, rks,
                                                 mode="local").numpy()
    out[f"{tag}/local_reduces"] = c.reduces
    with _Counter() as c:
        out[f"{tag}/sync"] = D.estimate_sharded(st, qs, taus, cfg, rks,
                                                mode="sync").numpy()
    out[f"{tag}/sync_reduces"], out[f"{tag}/sync_steps"] = c.reduces, c.steps
    e, pk, nv = E.estimate_batch_pooled(st, qs, taus, cfg, rks,
                                        dist.group.WORLD, with_stats=True)
    out[f"{tag}/stats_est"], out[f"{tag}/probed_k"] = e.numpy(), pk.numpy()
    out[f"{tag}/nvisited"] = nv.numpy()
    with _Counter() as c:
        E.estimate_batch(st, qs, taus, cfg, rks=rks)
    out[f"{tag}/plain_reduces"] = c.reduces


def _save_state(out, tag, st):
    out.update({f"{tag}/{k}": v
                for k, v in bridge.state_to_numpy(st).items()})


def _coalesce(rank, cfg, state, keys, mode, out):
    cqs, ctaus, cx = _coalescer_stream()
    co = CardinalityCoalescer(
        state, cfg, max_batch=COAL_BATCH, group=dist.group.WORLD, mode=mode,
        round_keys=lambda i, n: _t(keys[i][rank]))
    reqs = [co.submit(cqs[i], ctaus[i]) for i in range(COAL_FIRST)]
    co.flush()
    co.ingest(cx)
    reqs += [co.submit(cqs[i], ctaus[i])
             for i in range(COAL_FIRST, COAL_FIRST + COAL_SECOND)]
    co.flush()
    out[f"coal_{mode}/est"] = np.asarray([r.est for r in reqs], np.float32)
    out[f"coal_{mode}/nv"] = np.asarray(co._n_valid)
    out[f"coal_{mode}/w"] = co.state.index.params.w.numpy()
    out[f"coal_{mode}/flushes"] = np.asarray(co._n_flushes)


def _port_rank(rank, ref_path, out_dir):
    """One rank of the port: every case, written to ``rank{r}.npz``."""
    torch.set_num_threads(1)
    ref = dict(np.load(ref_path))
    out = {}
    world = dist.group.WORLD
    x = _data()
    cfg = config.ProberConfig(**KW)

    # build with the reference's functions (W included); W pooled from the
    # reference's per-shard raw projections, and from the port's own
    ref_build = _sub(ref, "build")
    p = ref_build
    params = lsh.LSHParams(_t(p["params.a"][0]), _t(p["params.b"][0]),
                           _t(p["params.w"][0]))
    st = D.build_sharded(x[:N_BUILD], cfg, params=params, capacity=CAPACITY,
                         device="cpu")
    _save_state(out, "build", st)
    nvr = int(ref_build["n_valid"][rank])
    out["build/w_pooled_ref_raw"] = lsh.normalize_w(
        _t(ref_build["raw"][rank]), cfg.n_regions, nvr, group=world).numpy()
    x_local = _t(x[rank * N_BUILD // SHARDS:(rank + 1) * N_BUILD // SHARDS])
    out["build/w_pooled_port_raw"] = lsh.normalize_w(
        lsh.project_raw(params, x_local), cfg.n_regions, group=world).numpy()
    g = torch.Generator().manual_seed(100 + rank)
    own = D.build_sharded(x[:N_BUILD], cfg, g, capacity=CAPACITY,
                          device="cpu")
    w0 = own.index.params.w.clone()
    dist.broadcast(w0, 0)
    out["build/own_w_same"] = bool(torch.equal(w0, own.index.params.w))
    out["build/own_a_same"] = bool(torch.equal(
        own.index.params.a, D.build_sharded(
            None, cfg, torch.Generator().manual_seed(100),
            capacity=CAPACITY, device="cpu", x_local=x_local).index.params.a))

    # updates from the reference's build, in capacity and past it
    st = bridge.sharded_state_from_numpy(ref_build, rank, "cpu")
    n1 = N_BUILD + N_UP1
    st, nv = D.update_sharded(st, x[N_BUILD:n1], cfg)
    _save_state(out, "up1", st)
    out["up1/nv"] = nv
    st, nv = D.update_sharded(st, _t(x[n1:n1 + N_UP2]), cfg, n_valid=nv)
    _save_state(out, "up2", st)
    out["up2/nv"] = nv

    for i, (n, s, off) in enumerate(ROUTES):
        for j, part in enumerate(D.route_round_robin(
                np.arange(2 * n, dtype=np.float32).reshape(n, 2), s, off)):
            out[f"route/{i}/{j}"] = part

    st = bridge.sharded_state_from_numpy(_sub(ref, "up2"), rank, "cpu")
    _estimate_case(out, "exact", st, _t(ref["exact/qs"]),
                   _t(ref["exact/taus"]), cfg,
                   _t(ref["exact/keys"][rank]))
    pst = bridge.sharded_state_from_numpy(_sub(ref, "pq_state"), rank, "cpu")
    for name, kw in PQ_SETTINGS.items():
        _estimate_case(out, f"pq_{name}", pst, _t(ref["pq/qs"]),
                       _t(ref["pq/taus"]),
                       config.ProberConfig(**dict(PQ_KW, **kw)),
                       _t(ref[f"pq_{name}/keys"][rank]))
    sst = bridge.sharded_state_from_numpy(_sub(ref, "skew_state"), rank,
                                          "cpu")
    _estimate_case(out, "skew", sst, _t(ref["skew/qs"]), _t(ref["skew/taus"]),
                   config.ProberConfig(**SKEW_KW), _t(ref["skew/keys"][rank]))

    # eps = 0: the port's own build recovers the exact counts
    x0 = np.random.default_rng(1).standard_normal((4000, 32)).astype(
        np.float32)
    cfg0 = config.ProberConfig(**EPS0_KW)
    st0 = D.build_sharded(x0, cfg0, torch.Generator().manual_seed(rank),
                          device="cpu")
    qs0, taus0 = _t(x0[:3] + 0.01), torch.tensor([1.0, 3.0, 6.0])
    rks0 = D.shard_round_keys(0, 3, 1, "cpu")
    for mode in ("local", "sync"):
        out[f"eps0/{mode}"] = D.estimate_sharded(st0, qs0, taus0, cfg0, rks0,
                                                 mode=mode).numpy()

    # the trivial world of one rank: both modes equal estimate_batch
    one = dist.new_group([0])
    if rank == 0:
        st1 = D.build_sharded(x[:1000], cfg, torch.Generator().manual_seed(0),
                              group=one, capacity=4096, device="cpu")
        nv1 = None
        for i in range(1000, 2000, 250):
            st1, nv1 = D.update_sharded(st1, x[i:i + 250], cfg, group=one,
                                        n_valid=nv1)
        out["one/nv"] = nv1
        qs1, taus1 = _t(x[:4] + 0.01), torch.linspace(3.0, 6.0, 4)
        rks1 = D.shard_round_keys(0, 4, cfg.n_tables, "cpu", group=one)
        want = E.estimate_batch(st1, qs1, taus1, cfg, rks=rks1)
        out["one/want"] = want.numpy()
        for mode in ("local", "sync"):
            out[f"one/{mode}"] = D.estimate_sharded(
                st1, qs1, taus1, cfg, rks1, group=one, mode=mode).numpy()

    # the coalescer's sharded flushes and ingest, with the reference's keys
    keys = [ref[f"coal/keys/{i}"] for i in range(3)]
    cst = bridge.sharded_state_from_numpy(ref_build, rank, "cpu")
    for mode in ("local", "sync"):
        _coalesce(rank, cfg, cst, keys, mode, out)
    try:
        CardinalityCoalescer(cst, cfg, max_batch=8, cache_size=16,
                             group=world, round_keys=lambda i, n: None)
    except ValueError:
        out["coal/cache_refused"] = True
    co = CardinalityCoalescer(cst, cfg, max_batch=8, group=world,
                              round_keys=lambda i, n: _t(keys[2][rank]))
    co.submit(x[0], 2.0 + (rank == 1))          # rank 1 diverges
    try:
        co.flush()
    except RuntimeError as e:
        out["coal/diverged_raised"] = "different batches" in str(e)
    for case, rows in (("values", x[:5] + (rank == 1)),     # rank 1 diverges
                       ("size", x[:5 + (rank == 1)])):
        co = CardinalityCoalescer(cst, cfg, max_batch=8, group=world,
                                  round_keys=lambda i, n: None)
        try:
            co.ingest(rows)
            co.apply_ingest()
        except RuntimeError as e:
            out[f"coal/ingest_{case}_raised"] = \
                "ingested different chunks" in str(e)
        out[f"coal/ingest_{case}_nv"] = np.asarray(co._n_valid)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


@pytest.fixture(scope="module")
def port(ref, tmp_path_factory):
    d = tmp_path_factory.mktemp("port")
    ref_path = d / "reference.npz"
    np.savez(ref_path, **ref)
    D.run_ranks(_port_rank, SHARDS, args=(str(ref_path), str(d)),
                timeout=240)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(SHARDS)]


# ------------------------------------------------------------------ tests --

def _global_extremes(raws, nvs):
    live = np.concatenate([r[:n] for r, n in zip(raws, nvs)])
    return live.min(0), live.max(0)


def _assert_shards_equal(port, ref, tag, n_old):
    """Shard by shard, bit-equal except where two matmul orders may differ:
    the raw a·x of rows ingested here (allclose), and a width whose global
    extreme is such a row (allclose; bit-equal wherever the extremes are
    the same). Codes and CSR are then bit-equal, given that no hash value
    lies at the margin."""
    want = _sub(ref, tag)
    gots = [_sub(p, tag) for p in port]
    nvs = want["n_valid"]
    for s, got in enumerate(gots):
        w = {k: want[k][s] for k in bridge.KEYS}
        assert not near_integer(w["x"][:nvs[s]], w["params.a"],
                                w["params.b"], w["params.w"]).any(), \
            "precondition: no hash value at the margin"
        for k in w:
            assert got[k].dtype == w[k].dtype and got[k].shape == w[k].shape, k
        np.testing.assert_array_equal(got["raw"][:n_old[s]],
                                      w["raw"][:n_old[s]])
        np.testing.assert_allclose(got["raw"], w["raw"], rtol=1e-5, atol=1e-5)
        for k in w:
            if k not in ("raw", "params.w"):
                np.testing.assert_array_equal(got[k], w[k], err_msg=f"{s} {k}")
    lo_g, hi_g = _global_extremes([g["raw"] for g in gots], nvs)
    lo_w, hi_w = _global_extremes(want["raw"], nvs)
    same = (lo_g == lo_w) & (hi_g == hi_w)
    for g in gots:              # one W, bit-identical on every rank
        np.testing.assert_array_equal(g["params.w"], gots[0]["params.w"])
    np.testing.assert_array_equal(gots[0]["params.w"][same],
                                  want["params.w"][0][same])
    np.testing.assert_allclose(gots[0]["params.w"], want["params.w"][0],
                               rtol=1e-6)


def test_build_sharded_matches_reference(ref, port):
    """Per-shard codes, CSR arrays and ``n_valid`` bit-equal to the
    reference's shard build; W pooled from the reference's per-shard raw
    projections bit-equal to its global W, and from the port's own within
    a float32 ulp, bit-identical on every rank."""
    _assert_shards_equal(port, ref, "build", [0] * SHARDS)
    w = ref["build/w_global"]
    for p in port:
        np.testing.assert_array_equal(p["build/w_pooled_ref_raw"], w)
        np.testing.assert_array_equal(p["build/w_pooled_port_raw"],
                                      port[0]["build/w_pooled_port_raw"])
        np.testing.assert_allclose(p["build/w_pooled_port_raw"], w,
                                   rtol=1e-6)
        # drawn functions: broadcast from rank 0, whatever each rank drew
        assert p["build/own_w_same"] and p["build/own_a_same"]


@pytest.mark.parametrize("tag", ["build", "pq_state"])
def test_sharded_bridge_round_trip_keeps_dtypes(ref, tag):
    """A rank's shard out of the reference's stacked layout and the shards
    stacked back: every field, dtype and shape as the reference's."""
    want = {k: v for k, v in _sub(ref, tag).items() if k != "w_global"}
    shards = [bridge.sharded_state_from_numpy(want, s, "cpu")
              for s in range(SHARDS)]
    back = bridge.sharded_state_to_numpy(shards)
    assert set(back) == set(want)
    for k, v in want.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_route_round_robin_matches_reference(ref, port):
    for i, (n, s, off) in enumerate(ROUTES):
        for j in range(s):
            for p in port:
                np.testing.assert_array_equal(p[f"route/{i}/{j}"],
                                              ref[f"route/{i}/{j}"])


@pytest.mark.parametrize("tag", ["up1", "up2"],
                         ids=["in-capacity", "past-capacity"])
def test_update_sharded_matches_reference(ref, port, tag):
    """Round-robin ingest from the reference's build (the port continues
    its own first update): live counts, codes, CSR and one W on every rank;
    the rows the reference built keep their raw projections bit for bit."""
    for p in port:
        np.testing.assert_array_equal(p[f"{tag}/nv"], ref[f"{tag}/nv"])
    _assert_shards_equal(port, ref, tag, ref["build/n_valid"])
    cap = ref[f"{tag}/x"].shape[1]
    assert cap == (512 if tag == "up1" else 1024)
    assert ref[f"{tag}/nv"].tolist() == (
        [501, 500, 500, 500] if tag == "up1" else [751, 750, 750, 750])


def _preconditions(ref, tag, state_tag, n_live):
    qs, taus = ref[f"{tag}/qs"], ref[f"{tag}/taus"]
    st = _sub(ref, state_tag)
    assert_no_hash_ties(qs, st["params.a"][0], st["params.b"][0],
                        st["params.w"][0])
    xs = [st["x"][s][:st["n_valid"][s]] for s in range(SHARDS)]
    assert_no_tau_ties(np.concatenate(xs), qs, taus, n_live)
    return qs, taus, st


@pytest.mark.parametrize("case", ["exact", "pq_float", "pq_int8"])
@pytest.mark.parametrize("mode", ["local", "sync"])
def test_estimate_sharded_matches_reference(ref, port, case, mode):
    """Both modes on bridged sharded states with the reference's per-shard
    keys: estimates within rtol 1e-6, the same on every rank; in sync mode
    the pooled ``probed_k`` and ``nvisited`` bit-equal (integer sums,
    exact in float32), one collective at setup and one per slab step, and
    none without a group."""
    if case == "exact":
        _preconditions(ref, "exact", "up2", N_BUILD + N_UP1 + N_UP2)
    else:
        qs, taus, st = _preconditions(ref, "pq", "pq_state", N_PQ)
        for s in range(SHARDS):
            nv = int(st["n_valid"][s])
            assert_no_adc_ties(ref["pq/luts"][s], st["pq.codes"][s], taus, nv)
            assert_no_q8_ties(ref["pq/luts"][s], taus, PQ_KW["pq_m"])
    want = ref[f"{case}/{mode}"]
    assert want.std() > 0
    for p in port:
        np.testing.assert_allclose(p[f"{case}/{mode}"], want, rtol=1e-6)
        np.testing.assert_array_equal(p[f"{case}/{mode}"],
                                      port[0][f"{case}/{mode}"])
        assert p[f"{case}/plain_reduces"] == 0
        if mode == "local":
            assert p[f"{case}/local_reduces"] == 1
            continue
        np.testing.assert_array_equal(p[f"{case}/probed_k"],
                                      ref[f"{case}/probed_k"])
        np.testing.assert_array_equal(p[f"{case}/nvisited"],
                                      ref[f"{case}/nvisited"])
        np.testing.assert_array_equal(p[f"{case}/stats_est"], p[f"{case}/sync"])
        assert p[f"{case}/sync_reduces"] == 1 + p[f"{case}/sync_steps"] > 1
    np.testing.assert_array_equal(ref[f"{case}/stats_est"], ref[f"{case}/sync"])


def test_eps0_recovers_the_exact_count_in_both_modes(port):
    x0 = np.random.default_rng(1).standard_normal((4000, 32)).astype(
        np.float32)
    truth = E.true_cardinality(_t(x0), _t(x0[:3] + 0.01),
                               torch.tensor([1.0, 3.0, 6.0])).numpy()
    assert truth.min() >= 1 and truth.max() > 100
    for p in port:
        for mode in ("local", "sync"):
            np.testing.assert_allclose(p[f"eps0/{mode}"], truth, atol=1e-2)


def test_trivial_world_equals_estimate_batch(port):
    """One rank pools only with itself: build, updates and both modes are
    the plain path bit for bit (the reference's
    test_sharded_paths_on_trivial_mesh)."""
    p = port[0]
    assert p["one/nv"].tolist() == [2000]
    for mode in ("local", "sync"):
        assert torch.equal(_t(p[f"one/{mode}"]), _t(p["one/want"])), mode


def test_sync_is_no_worse_than_local_on_skewed_shards(ref, port):
    x, qs, taus = ref["skew/x"], ref["skew/qs"], ref["skew/taus"]
    truth = E.true_cardinality(_t(x), _t(qs), _t(taus)).numpy()

    def mean_qe(e):
        e, t = np.maximum(e, 1.0), np.maximum(truth, 1.0)
        return float(np.maximum(e / t, t / e).mean())

    for p in port:
        mq_l, mq_s = mean_qe(p["skew/local"]), mean_qe(p["skew/sync"])
        assert mq_s <= mq_l + 1e-6, (mq_s, mq_l)
    assert mean_qe(ref["skew/sync"]) == pytest.approx(mq_s, rel=1e-6)


@pytest.mark.parametrize("mode", ["local", "sync"])
def test_sharded_coalescer_matches_reference(ref, port, mode):
    """The coalescer's sharded flushes (three: 12 requests, an auto-flush
    of 16 after an ingest of 700 points, 4) and its round-robin ingest,
    against ``CardinalityCoalescer(mesh=...)`` with the reference's
    per-flush, per-shard keys."""
    want = ref[f"coal_{mode}/est"]
    assert want.std() > 0
    for p in port:
        np.testing.assert_allclose(p[f"coal_{mode}/est"], want, rtol=1e-6)
        np.testing.assert_array_equal(p[f"coal_{mode}/nv"],
                                      ref[f"coal_{mode}/nv"])
        assert int(p[f"coal_{mode}/flushes"]) == 3
        np.testing.assert_allclose(p[f"coal_{mode}/w"],
                                   ref[f"coal_{mode}/w"], rtol=1e-6)
        np.testing.assert_array_equal(p[f"coal_{mode}/w"],
                                      port[0][f"coal_{mode}/w"])
    assert ref[f"coal_{mode}/nv"].sum() == N_BUILD + COAL_INGEST


def test_sharded_coalescer_refuses_the_cache_and_diverged_ranks(port):
    for p in port:
        assert bool(p["coal/cache_refused"])
        assert bool(p["coal/diverged_raised"])


@pytest.mark.parametrize("case", ["values", "size"])
def test_sharded_coalescer_refuses_diverged_ingests(port, case):
    """Rank 1 ingests other rows (or one row more): every rank raises
    before the chunk reaches the index, which keeps its live counts."""
    for p in port:
        assert bool(p.get(f"coal/ingest_{case}_raised", False))
        assert p[f"coal/ingest_{case}_nv"].tolist() == \
            [N_BUILD // SHARDS] * SHARDS


def test_run_ranks_raises_a_rank_failure_with_its_traceback():
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        D.run_ranks(_failing_rank, 2, timeout=120)


def _failing_rank(rank):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def test_run_ranks_kills_ranks_past_the_timeout():
    with pytest.raises(TimeoutError):
        D.run_ranks(_hanging_rank, 2, timeout=8)


def _hanging_rank(rank):
    import time
    time.sleep(60)
