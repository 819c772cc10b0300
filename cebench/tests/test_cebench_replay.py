"""The reference's update (Alg. 7/8) against the port's, element for
element, and the check's replay of a record on the reference: a reuse is
compared with its source, and is stale where an ingest since the source's
probe put a row in its ball or moved W."""
from __future__ import annotations

import json

import pytest
import torch

from cebench.tests._util import DATA, TINY, one_thread, tiny_root  # noqa: F401
from cebench.harness import core, data
from cebench.reference import prober as ref

CPU = torch.device("cpu")
SEED = 3


def _config(name: str) -> dict:
    return json.loads((DATA / f"{name}.json").read_text())


def _built(cfg: dict):
    """The port's state and the reference's index of the seed's corpus."""
    from repro_torch.core import estimator as E
    x, _ = core.make_corpus(cfg, SEED, CPU)
    state = E.build(x, core.prober_config(cfg),
                    generator=data.generator(SEED, "build", "cpu"),
                    capacity=cfg["capacity"], device="cpu")
    x_pad = torch.nn.functional.pad(x, (0, 0, 0, cfg["capacity"] - cfg["n"]))
    ri = ref.build(x_pad, cfg["n"], cfg["prober"],
                   data.generator(SEED, "build", "cpu"))
    return x, state, ri


def _rows(case: str, x: torch.Tensor) -> torch.Tensor:
    """In capacity, and past it: midpoints of corpus rows, inside every
    projection's range; ``w_moves``: held-out rows, one of them far past
    the corpus."""
    g = torch.Generator().manual_seed(7)
    if case == "w_moves":
        rows = data.heldout({"d": x.shape[1], "corpus": {
            "n_clusters": 8, "intrinsic_dim": 12, "noise": 0.05,
            "scale_sigma": 0.8}}, SEED, 0, 64, CPU)
        rows[5] = 4.0 * x[int(x.norm(dim=1).argmax())]
        return rows
    k = 300 if case == "in_capacity" else 1500
    i, j = torch.randint(0, x.shape[0], (2, k), generator=g)
    return 0.5 * (x[i] + x[j])


@pytest.mark.parametrize("case", ["in_capacity", "doubling", "w_moves"])
@pytest.mark.parametrize("config", ["tiny-exact", "tiny-pq"])
def test_the_references_update_is_the_ports(config, case):
    from repro_torch.core import estimator as E
    cfg = _config(config)
    pcfg = core.prober_config(cfg)
    x, state, ri = _built(cfg)
    _, _, later = _built(cfg)
    rows = _rows(case, x)
    w0 = state.index.params.w.clone()
    state = E.update(state, rows, pcfg)
    ri = ref.update(ri, rows, cfg["prober"])
    assert (not torch.equal(w0, state.index.params.w)) == (case == "w_moves")
    grown = 2 if case == "doubling" else 1
    assert state.capacity == ri.x.shape[0] == grown * cfg["capacity"]
    assert ri.n_valid == int(state.n_valid) == cfg["n"] + rows.shape[0]
    assert torch.equal(state.x, ri.x)
    mine, theirs = core.index_arrays(state), core.ref_arrays(ri)
    assert {k: core.count_diff(mine[k], theirs[k]) for k in mine} == \
        dict.fromkeys(mine, 0)
    # the layout left to a later relayout is the same
    later = ref.relayout(ref.update(later, rows, cfg["prober"],
                                    layout=False))
    assert all(core.count_diff(v, core.ref_arrays(later)[k]) == 0
               for k, v in theirs.items())
    # and so are the answers on the updated index, at the new rows too
    g = torch.Generator().manual_seed(4)
    qs = torch.cat([rows[:8], x[:8]])
    taus = torch.rand(16, generator=g) * 2.0 + 0.5
    rks = torch.randint(0, 2 ** 32, (16, pcfg.n_tables, 6), generator=g)
    got = E.estimate_batch_stats(state, qs, taus, pcfg, rks=rks)
    want = ref.estimate(ri, ri.x, qs, taus, rks, cfg["prober"])
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def root(tmp_path_factory, one_thread):
    return tiny_root(tmp_path_factory.mktemp("checkout"))


def _answers(ests, pk, nv):
    return (ests.cpu(), pk.cpu(), nv.cpu())


NONE = (torch.zeros(0), torch.zeros((0, 2), dtype=torch.int32),
        torch.zeros(0, dtype=torch.int32))


@pytest.mark.parametrize("case,stale,stats", [
    ("fresh", 0, 0), ("ingest_before_probe", 0, 0), ("lands_in_ball", 1, 0),
    ("moves_w", 1, 0), ("no_source", 0, 1), ("value_differs", 0, 1)])
def test_the_check_judges_each_reuse_by_its_source(root, monkeypatch, case,
                                                   stale, stats):
    """Pairs 0 and 1 probed, then pair 0 served again from that probe. An
    ingest of copies of pair 0's query lands in its ball in every table;
    one of ten times it moves W."""
    from repro_torch.core import estimator as E
    cell = core.load_cell(root, TINY[0])
    cfg = cell.config
    pcfg = core.prober_config(cfg)
    x, state, _ = _built(cfg)
    _, pool_q, pool_t, _ = core.make_inputs(cfg, cell.traffic, SEED, CPU)
    n_t = pool_t.shape[1]
    pairs = torch.tensor([0, 1])
    rks = torch.randint(0, 2 ** 32, (2, pcfg.n_tables, 6),
                        generator=torch.Generator().manual_seed(9))
    q = pool_q[0]
    rows = (10.0 if case == "moves_w" else 1.0) * q.expand(4, -1).clone()
    monkeypatch.setattr(data, "heldout",
                        lambda cfg, seed, first, n, dev: rows[first:first + n])
    ingest = core.Call(NONE, [("ingest", 0, 4)])
    calls = []
    if case == "ingest_before_probe":
        calls.append(ingest)
        state = E.update(state, rows, pcfg)
    w0 = state.index.params.w.clone()
    probe = _answers(*E.estimate_batch_stats(
        state, pool_q[pairs // n_t], pool_t[pairs // n_t, pairs % n_t],
        pcfg, rks=rks))
    calls.append(core.Call(probe, [("estimate", pairs, rks, None)]))
    served = (probe[0][:1] + (1.0 if case == "value_differs" else 0.0),
              torch.full((1, 2), -1, dtype=torch.int32),
              torch.full((1,), -1, dtype=torch.int32))
    reuse = [("reuse", torch.tensor([5 if case == "no_source" else 0]),
              None)]
    if case in ("lands_in_ball", "moves_w"):
        state = E.update(state, rows, pcfg)
        assert torch.equal(w0, state.index.params.w) == (case != "moves_w")
        calls.append(core.Call(served, [("ingest", 0, 4)] + reuse))
    else:
        calls.append(core.Call(served, reuse))
    x_pad = torch.nn.functional.pad(x, (0, 0, 0, cfg["capacity"] - cfg["n"]))
    compared, *_ = core.check(cell, SEED, core.index_arrays(state), x_pad,
                              pool_q, pool_t, calls, 0, CPU)
    assert compared == {"build_diff": 0, "stats_diff": stats, "est_gap": 0.0,
                        "stale_serves": stale}


def test_the_plan_driver_makes_the_calls_of_its_generator(root):
    """Each call of the plan driver estimates the generator's pairs of
    that call with its round keys, and its record names both again."""
    from repro_torch.core import estimator as E
    cell = core.load_cell(root, TINY[1])
    cfg, tr = cell.config, cell.traffic
    pcfg = core.prober_config(cfg)
    _, state, _ = _built(cfg)
    _, pool_q, pool_t, _ = core.make_inputs(cfg, tr, SEED, CPU)
    drv = cell.driver.open(state, cfg, pcfg, tr, pool_q, pool_t, SEED, CPU,
                           "window")
    gen = core.load_module(root / "cebench" / "generators"
                           / f"{tr['generator']}.py")
    traffic = gen.make(tr, pool_t.numel(), pcfg.n_tables, SEED, CPU)
    n_t = pool_t.shape[1]
    for i in range(3):
        _, c = core.timed_call(drv, i)
        pairs = traffic.pairs(i)
        want = E.estimate_batch_stats(
            state, pool_q[pairs // n_t], pool_t[pairs // n_t, pairs % n_t],
            pcfg, rks=traffic.round_keys(i))
        assert all(torch.equal(a, b) for a, b in zip(c.answers, want))
        (kind, p, k, slots), = c.record
        assert kind == "estimate" and slots is None
        assert torch.equal(core.field(p), pairs)
        assert torch.equal(core.field(k), traffic.round_keys(i))
    assert drv.state is state and drv.counters() == {}
