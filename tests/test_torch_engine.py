"""The port's LM serving path on the CPU: ``ServeEngine`` / ``Request``
(``repro_torch.serve.engine``), the planner's sharded mode and the
``launch.serve`` CLI.

Twins of the reference's engine tests (``test_infra.py``'s end-to-end run
and ``test_updates.py``'s three per-slot regressions) and of its serve
CLI test (``test_launchers.py``, here with ``--device cpu``); the reference's
engine against the port's on the same bridged params and requests; the
``kv_quant`` refusal; and the sharded ``SemanticPlanner`` on two gloo CPU
ranks, whose plans must be equal on every rank and whose estimates must be
bit-equal to ``distributed.estimate_sharded`` with the same round keys
(``tests/test_torch_distributed.py`` holds that to the reference). The
machine with the card has no jax, so this module imports it only inside
the test that uses it.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from _torch_parity import jax_params_numpy
from repro_torch import bridge, configs
from repro_torch.core import distributed as D
from repro_torch.core.config import ProberConfig
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.semantic import SemanticPlanner

# greedy tokens of the two engines must agree while the reference's top-2
# logit gap exceeds this: float32 weights, and both engines' bfloat16
# caches (K/V rounded at 2^-8 relative) move O(1) logits by ~1e-3 here
GAP_TOL = 0.05


def _smoke_engine(batch_slots=2, max_len=48, cfg=None):
    cfg = cfg or configs.get_smoke_config("qwen2-7b")
    params = T.init(cfg, torch.Generator().manual_seed(0), "cpu")
    return ServeEngine(cfg, params, batch_slots=batch_slots, max_len=max_len)


def test_serving_engine_end_to_end():
    eng = _smoke_engine()
    rng = np.random.default_rng(0)
    for rid in range(5):
        eng.submit(Request(rid=rid,
                           prompt=rng.integers(2, eng.cfg.vocab, size=6),
                           max_new=4))
    done = eng.run()
    assert len(done) == 5
    assert all(1 <= len(r.out) <= 4 for r in done)
    assert eng.stats["prefills"] == 5 and eng.stats["tokens"] == sum(
        len(r.out) - 1 for r in done)


def test_engine_per_slot_positions():
    """A slot admitted after a longer request keeps its own position."""
    eng = _smoke_engine()
    rng = np.random.default_rng(1)
    eng.submit(Request(rid=0, prompt=rng.integers(2, 50, size=20), max_new=6))
    eng.submit(Request(rid=1, prompt=rng.integers(2, 50, size=4), max_new=6))
    eng.step()
    pos = eng.cache["pos"].numpy()
    assert pos[0] == 21 and pos[1] == 5, pos
    done = eng.run()
    assert {r.rid for r in done} == {0, 1}
    assert all(len(r.out) == 6 for r in done)


def test_engine_short_slot_not_retired_by_long_neighbor():
    """The max_len retirement is per slot: the long request reaching the
    cache ceiling retires alone."""
    eng = _smoke_engine(max_len=24)
    rng = np.random.default_rng(2)
    eng.submit(Request(rid=0, prompt=rng.integers(2, 50, size=20),
                       max_new=16))
    eng.submit(Request(rid=1, prompt=rng.integers(2, 50, size=3),
                       max_new=16))
    done = eng.run()
    by_rid = {r.rid: r for r in done}
    assert set(by_rid) == {0, 1}
    assert len(by_rid[0].out) < 16
    assert len(by_rid[1].out) == 16


def test_engine_run_returns_midrun_and_preadmitted_requests():
    eng = _smoke_engine()
    rng = np.random.default_rng(3)
    eng.submit(Request(rid=0, prompt=rng.integers(2, 50, size=4), max_new=3))
    eng.step()                    # rid 0 admitted to a slot, queue now empty
    eng.submit(Request(rid=1, prompt=rng.integers(2, 50, size=4), max_new=3))
    done = eng.run()
    assert {r.rid for r in done} == {0, 1}
    assert all(r.done for r in done)
    assert eng.run(max_steps=4) == []


def test_engine_admits_in_place():
    """Admission copies a prefilled row into the slots' cache and decode
    writes into it: the K/V tensors are never reallocated."""
    eng = _smoke_engine()
    ptrs = [eng.cache[k].data_ptr() for k in ("k", "v")]
    rng = np.random.default_rng(4)
    for rid in range(3):
        eng.submit(Request(rid=rid, prompt=rng.integers(2, 50, size=5),
                           max_new=3))
    assert len(eng.run()) == 3
    assert [eng.cache[k].data_ptr() for k in ("k", "v")] == ptrs


def test_engine_refuses_kv_quant_and_other_families():
    with pytest.raises(ValueError, match="kv_quant"):
        _smoke_engine(cfg=configs.get_smoke_config("qwen1.5-32b"))
    cfg = configs.get_smoke_config("qwen2-7b")
    params = T.init(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="dense"):
        ServeEngine(configs.get_smoke_config("rwkv6-1.6b"), params)


def test_engine_matches_reference():
    """Both engines on the reference's params (float32 weights, the
    engines' own bfloat16 caches) and the same 5 requests through 2 slots:
    greedy tokens equal up to the first position where the reference's
    top-2 logit gap is within GAP_TOL (teacher-forced ``forward``)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs as rconfigs
    from repro.models import get_family
    from repro.serve.engine import Request as RRequest, ServeEngine as RServe
    rcfg = rconfigs.get_smoke_config("qwen2-7b").replace(dtype="float32")
    cfg = configs.get_smoke_config("qwen2-7b").replace(dtype="float32")
    fam = get_family(rcfg)
    params = fam.init(jax.random.PRNGKey(3), rcfg)
    model = bridge.lm_params_from_numpy(jax_params_numpy(params), cfg, "cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, cfg.vocab, size=6) for _ in range(5)]
    outs = []
    for eng, req in ((RServe(rcfg, params, batch_slots=2, max_len=32),
                      RRequest),
                     (ServeEngine(cfg, model, batch_slots=2, max_len=32),
                      Request)):
        for rid, p in enumerate(prompts):
            eng.submit(req(rid=rid, prompt=p, max_new=8))
        outs.append({r.rid: r.out for r in eng.run()})
    assert set(outs[0]) == set(outs[1]) == set(range(5))
    for rid, p in enumerate(prompts):
        ref, got = outs[0][rid], outs[1][rid]
        j = next((i for i, (a, b) in enumerate(zip(ref, got)) if a != b),
                 None)
        if j is None:
            assert ref == got
            continue
        toks = np.concatenate([p, ref[:j]])[None].astype(np.int32)
        logits = np.asarray(fam.forward(params, {"tokens": jnp.asarray(toks)},
                                        rcfg))[0, -1]
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] <= GAP_TOL, (rid, j, top2)


# ------------------------------------------------------ sharded planner ----

PKW = dict(n_tables=2, n_funcs=6, ring_budget=512, central_budget=512,
           chunk=128)
P_SEED, P_N, P_Q = 7, 4096, 6


def _planner_rank(rank, out):
    """One gloo CPU rank: the sharded planner in both modes against
    ``build_sharded`` + ``estimate_sharded`` with its round keys."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    cfg = ProberConfig(**PKW)
    x = np.random.default_rng(0).standard_normal((P_N, 16)).astype(
        np.float32)
    qs = x[:P_Q] + 0.01
    taus = np.linspace(2.5, 4.5, P_Q).astype(np.float32)
    rec = {}
    for mode in ("local", "sync"):
        pl = SemanticPlanner(x, cfg, torch.Generator().manual_seed(P_SEED),
                             max_calls=400, device="cpu",
                             group=dist.group.WORLD, mode=mode,
                             capacity=2 * P_N)
        plans = pl.plan_batch(list(qs), list(taus))      # flush 0: 6 -> 8
        single = pl.plan(qs[0], float(taus[0]))          # flush 1: 1
        st = D.build_sharded(torch.from_numpy(x), cfg,
                             torch.Generator().manual_seed(P_SEED),
                             capacity=2 * P_N, device="cpu")
        qp, tp = np.zeros((8, 16), np.float32), np.zeros(8, np.float32)
        qp[:P_Q], tp[:P_Q] = qs, taus
        want = D.estimate_sharded(
            st, torch.from_numpy(qp), torch.from_numpy(tp), cfg,
            D.shard_round_keys(P_SEED, 8, 2, "cpu", stream=0), mode=mode)
        want1 = D.estimate_sharded(
            st, torch.from_numpy(qs[:1]), torch.from_numpy(taus[:1]), cfg,
            D.shard_round_keys(P_SEED, 1, 2, "cpu", stream=1), mode=mode)
        rec[mode] = dict(plans=[dataclasses.astuple(p) for p in plans],
                         single=dataclasses.astuple(single),
                         want=want[:P_Q].tolist(), want1=float(want1[0]),
                         codes_equal=bool(torch.equal(pl.state.index.codes,
                                                      st.index.codes)))
    try:
        SemanticPlanner(x, cfg, torch.Generator(), device="cpu",
                        group=dist.group.WORLD, cache_size=8)
        rec["cache_refused"] = False
    except ValueError:
        rec["cache_refused"] = True
    with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
        json.dump(rec, fh)


def test_sharded_planner_matches_estimate_sharded(tmp_path):
    D.run_ranks(_planner_rank, 2, args=(str(tmp_path),), timeout=300)
    recs = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(2)]
    assert recs[0] == recs[1]                 # equal plans on every rank
    rec = recs[0]
    assert rec["cache_refused"]
    for mode in ("local", "sync"):
        m = rec[mode]
        assert m["codes_equal"]
        assert [p[0] for p in m["plans"]] == m["want"]     # bit-equal
        assert m["single"][0] == m["want1"]


# ------------------------------------------------------------ serve CLI ----

CLI_ARGS = ["--arch", "qwen2-7b", "--scale", "smoke", "--requests", "4",
            "--corpus", "1000", "--emb-dim", "32", "--max-calls", "16",
            "--slots", "2", "--max-len", "48", "--device", "cpu"]


def test_serve_cli_end_to_end():
    stats = {}
    served, refused = serve.main(CLI_ARGS, stats=stats)
    assert served >= 1
    assert refused >= 1          # the oversized operator must be refused
    assert all(1 <= n <= 4 for n in stats["new_tokens"])
    assert len(stats["new_tokens"]) == served


def test_serve_cli_sharded():
    """``--shards 2``: two gloo CPU ranks plan in lockstep; rank 0 serves.
    ``main`` raises unless the plans are equal on every rank."""
    stats = {}
    served, refused = serve.main(CLI_ARGS + ["--shards", "2", "--stopping",
                                             "sync"], stats=stats)
    assert served >= 1 and refused >= 1
    r0, r1 = stats["ranks"]
    assert r0["plans"] == r1["plans"]
    assert r1["served"] == 0 and "engine" not in r1   # rank 0 serves alone
    assert r0["plan_collectives"] == r1["plan_collectives"] > 0


def test_serve_cli_refuses_other_families_and_uneven_shards():
    with pytest.raises(ValueError, match="dense"):
        serve.main(CLI_ARGS[:1] + ["rwkv6-1.6b"] + CLI_ARGS[2:])
    with pytest.raises(ValueError, match="must divide"):
        serve.main(CLI_ARGS + ["--shards", "3"])
