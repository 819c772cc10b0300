"""End-to-end semantic-operator serving on the PyTorch port, with
CE-planned LLM batches, as ``serve_semantic.py`` does on the JAX package.

A semantic operator must know HOW MANY corpus items match
``similarity(q) <= tau`` BEFORE calling the LLM on each match (the paper's
§1). On a reduced qwen2-family model:

  1. corpus of document embeddings -> Dynamic Prober index
  2. an operator arrives (query embedding, tau)
  3. the planner estimates its matches -> an execution plan (or refusal)
  4. the matching docs (an exact pass over the planned candidates) are
     batched through the serving engine (prefill + decode with KV slots)
  5. repeated operator traffic: the planner's estimate cache serves
     zipfian repeat plans without re-probing, and a corpus update
     invalidates exactly the entries whose probed buckets changed

  PYTHONPATH=src python examples/torch_serve_semantic.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.config import ProberConfig
from repro_torch.kernels import ops
from repro_torch.models import get_family
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.semantic import SemanticPlanner


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--docs", type=int, default=4000)
    ap.add_argument("--emb-dim", type=int, default=64)
    ap.add_argument("--repeats", type=int, default=200)
    ap.add_argument("--new-docs", type=int, default=1000)
    args = ap.parse_args(argv)
    dev = ops.resolve_device(args.device)
    g = torch.Generator(device=dev).manual_seed(0)

    # --- 1. document corpus (synthetic embeddings for an encoder's) -----
    corpus = torch.randn((args.docs, args.emb_dim), generator=g, device=dev)
    cfg = ProberConfig(n_tables=2, n_funcs=8, ring_budget=1024,
                       central_budget=1024, chunk=128)
    # cache_size switches on the workload-aware estimate cache: repeated
    # operator (q, tau) plans are served without re-running the probe
    planner = SemanticPlanner(corpus, cfg, g, max_calls=64, slot_budget=4,
                              capacity=8192, cache_size=256, reuse_tol=0.0,
                              device=dev)
    print(f"indexed {args.docs} docs")

    # --- 2. a tiny LLM behind the serving engine ------------------------
    mcfg = configs.get_smoke_config("qwen2-7b")
    model = get_family(mcfg).init(
        mcfg, torch.Generator(device=dev).manual_seed(1), dev)
    engine = ServeEngine(mcfg, model, batch_slots=4, max_len=64)

    # --- 3. semantic operators with varying selectivity -----------------
    actions = {}
    rng = np.random.default_rng(0)
    for name, q, tau in [("narrow", corpus[7], 4.0),
                         ("medium", corpus[7], 8.5),
                         ("too-broad", corpus[7], 50.0)]:
        t0 = time.perf_counter()
        plan = planner.plan(q, tau)
        t_plan = 1e3 * (time.perf_counter() - t0)
        actions[name] = plan.action
        print(f"\noperator[{name}] tau={tau}: est={plan.est_matches:.1f} "
              f"action={plan.action} ({t_plan:.1f} ms to plan)  "
              f"{plan.reason}")
        if plan.action != "execute" or plan.llm_calls == 0:
            continue
        # exact match set, capped by the planned call budget
        d2 = ((corpus - q[None]) ** 2).sum(-1)
        matches = torch.argsort(d2)[:plan.llm_calls].tolist()
        for doc_id in matches:
            prompt = rng.integers(2, mcfg.vocab, size=8)   # stub tokens
            engine.submit(Request(rid=int(doc_id), prompt=prompt, max_new=6))
        t0 = time.perf_counter()
        done = engine.run()
        dt = time.perf_counter() - t0
        print(f"  executed {len(done)} LLM calls in {dt:.2f}s "
              f"({plan.n_batches} planned batches x {plan.batch_slots} "
              "slots)")

    # --- 4. repeated operator traffic hits the estimate cache -----------
    rng = np.random.default_rng(1)
    heads = [(corpus[i], float(t)) for i in (7, 21, 99) for t in (6.0, 8.5)]
    ranks = 1.0 / np.arange(1, len(heads) + 1) ** 0.99
    t0 = time.perf_counter()
    for r in rng.choice(len(heads), size=args.repeats,
                        p=ranks / ranks.sum()):
        planner.plan(*heads[r])
    dt = time.perf_counter() - t0
    stats = planner.cache_stats
    print(f"\n{args.repeats} repeat plans in {dt:.2f}s "
          f"({args.repeats / dt:.0f} plans/s): hit-rate "
          f"{stats['hits'] / max(stats['lookups'], 1):.2f} "
          f"(hits={stats['hits']} misses={stats['misses']} "
          f"evicts={stats['evicts']})")

    # --- 5. corpus grows; the planner absorbs it by §5 updates ----------
    # the update invalidates exactly the cached plans whose probed buckets
    # the new docs landed in (epoch check): no plan reflects a stale corpus
    planner.update_corpus(torch.randn((args.new_docs, args.emb_dim),
                                      generator=g, device=dev))
    plan = planner.plan(corpus[7], 8.5)
    stats = planner.cache_stats
    print(f"\nafter +{args.new_docs} docs: est={plan.est_matches:.1f} "
          f"action={plan.action} (stale-refreshes so far: "
          f"{stats['stale']})")
    return {"actions": actions, "stats": stats,
            "after_update": plan.action}


if __name__ == "__main__":
    main()
