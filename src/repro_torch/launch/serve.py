"""Serving CLI (port of ``repro/launch/serve.py``): model + engine +
estimator-backed semantic planner behind one CLI, the deployment shape of
the paper's motivating application (estimate the LLM calls of a semantic
operator before running it).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
      --scale smoke --requests 8 --corpus 4000 --device cpu

Initialises seeded random weights (no checkpoint is loaded), builds the
Dynamic Prober index over a seeded document-embedding corpus, then serves a
stream of semantic operators: estimate -> plan -> batched prefill/decode.
Each operator's exact ranking of the corpus (its radius and, when it runs,
its matches) is one ``ops.l2dist`` call: the CUDA kernel on the card.

``--shards P`` (P > 1) runs P ranks of one process group on this host
(``distributed.run_ranks``, gloo, every rank on ``--device``): each rank
rebuilds the same corpus from ``--seed``, holds one shard of the index and
plans every operator in lockstep with the ``--stopping`` mode; rank 0
alone holds the model and runs the engine. The plans must come out equal
on every rank.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import collectives, distributed as D
from repro_torch.core.config import ProberConfig
from repro_torch.kernels import ops
from repro_torch.models import get_family
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.semantic import SemanticPlanner


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=configs.ARCHS, default="qwen2-7b")
    ap.add_argument("--scale", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--corpus", type=int, default=4000)
    ap.add_argument("--emb-dim", type=int, default=64)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--max-calls", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shards", type=int, default=0,
                    help="shard the estimator corpus over this many ranks "
                         "(0 = one process; P > 1 spawns P gloo ranks on "
                         "--device)")
    ap.add_argument("--stopping", choices=["local", "sync"], default="local",
                    help="distributed stopping mode; only meaningful with "
                         "--shards > 1")
    ap.add_argument("--device", default="cuda",
                    help="where the model, index and kernels run "
                         "(default cuda)")
    return ap


# the planner's prober: two tables of eight functions, 1,024-sample budgets
PLANNER_CFG = ProberConfig(n_tables=2, n_funcs=8, ring_budget=1024,
                           central_budget=1024, chunk=128)


def draw_corpus(args: argparse.Namespace, dev: torch.device):
    """The document embeddings, (corpus, emb_dim) N(0, 1) from ``--seed``
    (the same on every rank), and the generator, which then draws the
    model's weights."""
    g = torch.Generator(device=dev).manual_seed(args.seed)
    return torch.randn((args.corpus, args.emb_dim), generator=g,
                       device=dev), g


def _clock(dev: torch.device) -> float:
    """Host seconds after the device's queued work (a CUDA sync)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def serve(args: argparse.Namespace, rank: int = 0, group=None) -> dict:
    """Serve ``args.requests`` operators; with a ``group`` this is rank
    ``rank`` of it (rank 0 holds the model and prints). Returns a record:
    ``served`` LLM calls, ``refused`` operators, ``plans`` (action,
    estimate, calls), ``queries`` (document, target count, radius), and
    the seconds and counts of each stage."""
    dev = ops.resolve_device(args.device)
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = (configs.get_smoke_config(args.arch) if args.scale == "smoke"
           else configs.get_config(args.arch))
    if cfg.family != "dense":
        raise ValueError("the engine drives dense-family models, not "
                         f"{cfg.family!r} ({cfg.name})")
    sharded = group is not None
    rec: dict = {"rank": rank, "device": str(dev)}
    corpus, g = draw_corpus(args, dev)
    engine = None
    if rank == 0:
        t0 = _clock(dev)
        params = get_family(cfg).init(cfg, g, dev)
        rec["init_s"] = _clock(dev) - t0
        rec["params"] = sum(p.numel() for p in params.parameters())
        rec["param_bytes"] = sum(p.numel() * p.element_size()
                                 for p in params.parameters())
        engine = ServeEngine(cfg, params, batch_slots=args.slots,
                             max_len=args.max_len)
    t0 = _clock(dev)
    planner = SemanticPlanner(
        corpus, PLANNER_CFG, torch.Generator(device=dev).manual_seed(args.seed),
        max_calls=args.max_calls, slot_budget=args.slots, device=dev,
        group=group, mode=args.stopping)
    rec["planner_build_s"] = _clock(dev) - t0
    where = f"{args.shards}-shard/{args.stopping}" if sharded else "1-device"
    say(f"serving {cfg.name} ({args.scale}) | corpus={args.corpus} docs "
        f"| estimator {where}")

    rng = np.random.default_rng(args.seed)
    served = refused = 0
    plans, queries, plan_s, plan_collectives = [], [], 0.0, 0
    t_start = time.perf_counter()
    for rid in range(args.requests):
        doc = int(rng.integers(0, args.corpus))
        q = corpus[doc]
        d2 = ops.l2dist(corpus, q[None].contiguous())[:, 0]
        target = int(rng.choice([2, 8, 32, args.max_calls * 4]))
        d2_sorted, order = torch.sort(d2)
        tau = float(torch.sqrt(d2_sorted[min(target, args.corpus - 1)]))
        queries.append([doc, target, tau])
        c0, t0 = collectives.COUNT["calls"], time.perf_counter()
        plan = planner.plan(q, tau)
        plan_s += time.perf_counter() - t0
        plan_collectives += collectives.COUNT["calls"] - c0
        plans.append([plan.action, plan.est_matches, plan.llm_calls])
        if plan.action != "execute":
            refused += 1
            say(f"req {rid}: est={plan.est_matches:8.1f} -> {plan.action} "
                f"({plan.reason})")
            continue
        # every rank draws the prompts, so the ranks' streams stay equal
        matches = order[:max(plan.llm_calls, 1)].cpu().numpy()
        prompts = [rng.integers(2, cfg.vocab, size=8) for _ in matches]
        if engine is None:
            continue
        for doc, prompt in zip(matches, prompts):
            engine.submit(Request(rid=int(doc), prompt=prompt, max_new=4))
        done = engine.run()
        served += len(done)
        rec.setdefault("new_tokens", []).extend(len(r.out) for r in done)
        say(f"req {rid}: est={plan.est_matches:8.1f} -> {len(done)} LLM "
            f"calls ({plan.n_batches} batches x {plan.batch_slots} slots)")
    dt = _clock(dev) - t_start
    say(f"\n{served} LLM calls served, {refused} operators refused "
        f"by the planner, {dt:.1f}s total")
    rec.update(served=served, refused=refused, plans=plans,
               queries=queries, wall_s=dt,
               plan_s=plan_s, n_plans=len(plans),
               plan_collectives=plan_collectives)
    if engine is not None:
        rec["engine"] = dict(engine.stats)
    return rec


def _rank_main(rank: int, argd: dict, out: str) -> None:
    """One rank of a ``--shards`` run (spawned by ``run_ranks``): serve in
    lockstep and write the rank's record to ``out/rank<r>.json``."""
    import torch.distributed as dist
    args = argparse.Namespace(**argd)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.shards))
    ops.reset_launches()
    collectives.reset()
    rec = serve(args, rank, dist.group.WORLD)
    rec["launches"] = dict(ops.LAUNCHES)
    rec["collectives"] = dict(collectives.COUNT)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
        json.dump(rec, fh)


def _serve_sharded(args: argparse.Namespace) -> dict:
    """Run the ``--shards`` ranks; raise unless every rank planned the
    same. Returns rank 0's record with every rank's under ``ranks``."""
    with tempfile.TemporaryDirectory() as out:
        D.run_ranks(_rank_main, args.shards, args=(vars(args), out),
                    backend="gloo")
        recs = []
        for r in range(args.shards):
            with open(os.path.join(out, f"rank{r}.json")) as fh:
                recs.append(json.load(fh))
    for r in recs[1:]:
        if r["plans"] != recs[0]["plans"]:
            raise RuntimeError(f"rank {r['rank']} planned {r['plans']}, "
                               f"rank 0 {recs[0]['plans']}")
    return {**recs[0], "ranks": recs}


def main(argv=None, stats: dict | None = None) -> tuple[int, int]:
    """Returns ``(LLM calls served, operators refused)`` (rank 0's with
    ``--shards``); fills ``stats``, when given, with the run's record
    (see :func:`serve`)."""
    args = _parser().parse_args(argv)
    if args.shards > 1:
        if args.corpus % args.shards:
            raise ValueError(f"--shards {args.shards} must divide --corpus "
                             f"{args.corpus}")
        rec = _serve_sharded(args)
    else:
        rec = serve(args)
    if stats is not None:
        stats.update(rec)
    return rec["served"], rec["refused"]


if __name__ == "__main__":
    main()
