"""Quickstart on the PyTorch port: build the Dynamic Prober, estimate
cardinalities, compare to ground truth, then apply a dynamic update (paper
Alg. 1–9), as ``quickstart.py`` does on the JAX package.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core import estimator as E
from repro_torch.core.config import ProberConfig
from repro_torch.data import vectors
from repro_torch.kernels import ops


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=0.2,
                    help="fraction of the sift surrogate's 40k points")
    ap.add_argument("--new-points", type=int, default=1024)
    args = ap.parse_args(argv)
    dev = ops.resolve_device(args.device)
    g = torch.Generator(device=dev).manual_seed(0)
    ds = vectors.load("sift", n_queries=4, scale=args.scale, device=dev)
    print(f"corpus: {tuple(ds.x.shape)}")

    cfg = ProberConfig(n_tables=2, n_funcs=10, ring_budget=2048,
                       central_budget=2048, chunk=128, eps=0.01)
    state = E.build(ds.x, cfg, g, device=dev)
    print(f"built LSH index: {int(state.index.n_buckets[0])} buckets/table")

    print(f"{'tau':>8} {'true':>6} {'estimate':>9} {'q-error':>8}")
    qerrs = []
    for t in range(0, ds.taus.shape[1], 2):
        tau, true = ds.taus[0, t], float(ds.cards[0, t])
        est = float(E.estimate(state, ds.queries[0], tau, cfg, generator=g))
        q = max(max(est, 1) / max(true, 1), max(true, 1) / max(est, 1))
        qerrs.append(q)
        print(f"{float(tau):8.2f} {true:6.0f} {est:9.1f} {q:8.2f}")

    # dynamic update (paper §5): append fresh points, estimates stay
    # calibrated (state.x is capacity-padded after it: truth by n_valid)
    n_new = args.new_points
    new_points = torch.randn((n_new, ds.x.shape[1]), generator=g,
                             device=dev) * 0.1 + ds.x[:n_new]
    state = E.update(state, new_points, cfg)
    est = float(E.estimate(state, ds.queries[0], ds.taus[0, 6], cfg,
                           generator=g))
    true = float(E.true_cardinality(state.x, ds.queries[0], ds.taus[0, 6],
                                    n_valid=int(state.n_valid)))
    print(f"after +{n_new} points: estimate={est:.1f} true={true:.0f}")
    return {"qerrors": qerrs, "after_update": (est, true),
            "n_valid": int(state.n_valid)}


if __name__ == "__main__":
    main()
