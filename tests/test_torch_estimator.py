"""The port's public API against the reference: ``update`` in and past
capacity, ``true_cardinality``, the bridge, the surrogate data, the device
contract, and the port's independence from JAX."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_state_numpy, near_integer
from repro.core import config as jconfig, estimator as JE
from repro_torch import bridge
from repro_torch.core import config, estimator as E
from repro_torch.data import vectors

KW = dict(n_tables=2, n_funcs=8, ring_budget=512, central_budget=256,
          chunk=128)
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def data():
    return np.random.default_rng(5).standard_normal((2600, 16)).astype(
        np.float32)


def _assert_states_equal(got: E.ProberState, want, n_old: int, n_live: int):
    """Bit-equal except where two matmul orders may differ: the raw a·x of
    the rows ingested now (allclose), and W of a function whose live
    min/max is such a row (allclose; bit-equal wherever the extremes are).
    Codes and CSR are then bit-equal, given that no hash value lies at the
    margin."""
    g = bridge.state_to_numpy(got)
    w = jax_state_numpy(want)
    assert set(g) == set(w)
    p = want.index.params
    near = near_integer(w["x"][:n_live], p.a, p.b, p.w)
    assert not near.any(), "precondition: no hash value at the margin"
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        assert g[k].shape == w[k].shape, k
    np.testing.assert_array_equal(g["raw"][:n_old], w["raw"][:n_old])
    np.testing.assert_allclose(g["raw"], w["raw"], rtol=1e-5, atol=1e-5)
    live_g, live_w = g["raw"][:n_live], w["raw"][:n_live]
    same_ext = (live_g.min(0) == live_w.min(0)) & \
        (live_g.max(0) == live_w.max(0))
    print(f"W: {int((g['params.w'] != w['params.w']).sum())} of "
          f"{len(same_ext)} widths differ; {int((~same_ext).sum())} have an "
          f"extreme among the new rows' projections")
    np.testing.assert_array_equal(g["params.w"][same_ext],
                                  w["params.w"][same_ext])
    np.testing.assert_allclose(g["params.w"], w["params.w"], rtol=1e-6)
    for k in w:
        if k not in ("raw", "params.w"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_update_in_and_past_capacity_matches_reference(data):
    jcfg, cfg = jconfig.ProberConfig(**KW), config.ProberConfig(**KW)
    jstate = JE.build(jnp.asarray(data[:1500]), jcfg, jax.random.PRNGKey(0),
                      capacity=2048)
    state = bridge.state_from_numpy(jax_state_numpy(jstate), "cpu")
    shapes = {k: v.shape for k, v in bridge.state_to_numpy(state).items()}

    jstate = JE.update(jstate, jnp.asarray(data[1500:1800]), jcfg)
    state = E.update(state, torch.from_numpy(data[1500:1800]), cfg)
    assert int(state.n_valid) == 1800 and state.capacity == 2048
    assert {k: v.shape for k, v in
            bridge.state_to_numpy(state).items()} == shapes
    _assert_states_equal(state, jstate, 1500, 1800)

    jstate = JE.update(jstate, jnp.asarray(data[1800:]), jcfg)
    state = E.update(state, torch.from_numpy(data[1800:]), cfg, n_valid=1800)
    assert int(state.n_valid) == 2600 and state.capacity == 4096
    _assert_states_equal(state, jstate, 1500, 2600)


def test_update_leaves_the_input_state_unchanged(data):
    cfg = config.ProberConfig(**KW)
    g = torch.Generator().manual_seed(0)
    state = E.build(torch.from_numpy(data[:1000]), cfg, g, capacity=2048,
                    device="cpu")
    before = {k: v.copy() for k, v in bridge.state_to_numpy(state).items()}
    E.update(state, torch.from_numpy(data[1000:1100]), cfg)
    for k, v in bridge.state_to_numpy(state).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)


def test_bridge_round_trip_keeps_dtypes(data):
    jstate = JE.build(jnp.asarray(data[:500]), jconfig.ProberConfig(**KW),
                      jax.random.PRNGKey(1), capacity=1024)
    d = jax_state_numpy(jstate)
    back = bridge.state_to_numpy(bridge.state_from_numpy(d, "cpu"))
    assert set(back) == set(bridge.KEYS)
    for k, v in d.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_true_cardinality_matches_reference(data):
    x = data[:2000]
    qs = data[:5] + 0.01
    taus = np.array([1.0, 3.0, 4.0, 5.0, 6.0], np.float32)
    got = E.true_cardinality(torch.from_numpy(x), torch.from_numpy(qs),
                             torch.from_numpy(taus), n_valid=1900)
    for i in range(5):
        want = JE.true_cardinality(jnp.asarray(x), jnp.asarray(qs[i]),
                                   taus[i], n_valid=1900)
        assert int(got[i]) == int(want)
    one = E.true_cardinality(torch.from_numpy(x), torch.from_numpy(qs[2]),
                             4.0)
    assert one.shape == () and int(one) == int(
        JE.true_cardinality(jnp.asarray(x), jnp.asarray(qs[2]), 4.0))


def test_paper_query_workload_hits_its_targets():
    g = torch.Generator().manual_seed(0)
    x = vectors.make_corpus(g, 3000, 24)
    assert x.shape == (3000, 24) and x.dtype == torch.float32
    qs, taus, cards = vectors.paper_query_workload(g, x, 6, n_taus=5)
    targets = np.unique(np.geomspace(1, 30, 5).astype(np.int64))
    assert taus.shape == cards.shape == (6, len(targets))
    np.testing.assert_array_equal(cards.numpy(),
                                  np.broadcast_to(targets, cards.shape))
    truth = E.true_cardinality(x, qs, taus[:, -1])
    np.testing.assert_array_equal(truth.numpy(), cards[:, -1].numpy())


def test_port_end_to_end_on_cpu_tracks_truth():
    """build → estimate_batch → update → estimate_batch with the port's own
    draws: estimates finite, non-negative and near the truth."""
    g = torch.Generator().manual_seed(1)
    cfg = config.ProberConfig(**KW)
    x = vectors.make_corpus(g, 4000, 16)
    state = E.build(x[:3000], cfg, g, capacity=4096, device="cpu")
    qs, taus, _ = vectors.paper_query_workload(g, x[:3000], 8, n_taus=4)
    t = taus[:, -1]
    for n in (3000, 4000):
        if n == 4000:
            state = E.update(state, x[3000:], cfg)
        est, probed_k, nvis = E.estimate_batch_stats(state, qs, t, cfg,
                                                     generator=g)
        truth = E.true_cardinality(state.x, qs, t, n_valid=n).float()
        assert torch.isfinite(est).all() and (est >= 0).all()
        qerr = torch.maximum(est.clamp_min(1) / truth.clamp_min(1),
                             truth.clamp_min(1) / est.clamp_min(1))
        assert qerr.median() < 2.0, (est, truth)
        assert probed_k.shape == (8, 2) and nvis.shape == (8,)


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        E.build(torch.zeros(10, 4), config.ProberConfig(),
                torch.Generator(), device="cuda")


def test_port_imports_no_jax_and_nothing_of_repro():
    modules = sorted(
        ".".join(p.relative_to(SRC).with_suffix("").parts)
        for p in (SRC / "repro_torch").rglob("*.py"))
    modules = [m.removesuffix(".__init__") for m in modules]
    script = ("import sys, importlib\nsys.modules['jax'] = None\n"
              f"for m in {modules!r}:\n    importlib.import_module(m)\n"
              "assert not any(k == 'repro' or k.startswith('repro.') "
              "for k in sys.modules)\nprint('ok')")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr
    files = list((SRC / "repro_torch").rglob("*.py"))
    files.append(SRC.parent / "chip_smoke.py")
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (f, n)
