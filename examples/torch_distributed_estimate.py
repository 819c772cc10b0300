"""Distributed Dynamic Prober on the PyTorch port over 8 ranks: the corpus
is partitioned, every rank probes its shard, and the cardinality is the sum
of the local estimates (``local``) or comes from pooled stopping
(``sync``), as ``distributed_estimate.py`` does on an 8-device JAX mesh.

The ranks are spawned processes of one gloo group (``run_ranks``); on one
card they share it (NCCL would need a card a rank).

  PYTHONPATH=src python examples/torch_distributed_estimate.py [--device cpu]
"""
import argparse
import json
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.core import distributed as D, estimator as E
from repro_torch.core.config import ProberConfig
from repro_torch.kernels import ops

TARGETS = (10, 100, 500, 2000)


def rank_main(rank: int, n: int, dim: int, device: str, out: str) -> None:
    """One rank: the same corpus from the seed on every rank, its row
    block indexed, the estimates of both modes; rank 0 writes them."""
    torch.set_num_threads(1)
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((n, dim), generator=g, device=dev)
    cfg = ProberConfig(n_tables=2, n_funcs=8, ring_budget=1024,
                       central_budget=1024, chunk=128)
    state = D.build_sharded(x, cfg, generator=torch.Generator(
        device=dev).manual_seed(1 + rank), device=dev)
    qs = x[:1] + 0.01
    d2 = torch.sort(((x - qs[0][None]) ** 2).sum(-1)).values
    taus = torch.sqrt(d2[list(TARGETS)]) + 1e-6
    rows = []
    for mode in ("local", "sync"):
        rks = D.shard_round_keys(2, len(TARGETS), cfg.n_tables, dev)
        ests = D.estimate_sharded(state, qs.repeat(len(TARGETS), 1), taus,
                                  cfg, rks, mode=mode)
        for i, t in enumerate(TARGETS):
            true = float(E.true_cardinality(x, qs[0], taus[i]))
            rows.append({"mode": mode, "target": t,
                         "estimate": float(ests[i]), "true": true})
    if dist.get_rank() == 0:
        with open(out, "w") as fh:
            json.dump(rows, fh)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--n", type=int, default=16000)
    ap.add_argument("--dim", type=int, default=64)
    args = ap.parse_args(argv)
    ops.resolve_device(args.device)          # no card: raises here
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rows.json")
        D.run_ranks(rank_main, args.ranks,
                    args=(args.n, args.dim, args.device, out))
        with open(out) as fh:
            rows = json.load(fh)
    print(f"sharded index: {args.ranks} local partitions of "
          f"{args.n // args.ranks}")
    for r in rows:
        print(f"[{r['mode']}] target={r['target']:5d} "
              f"estimate={r['estimate']:8.1f} true={r['true']:6.0f}")
    return rows


if __name__ == "__main__":
    main()
