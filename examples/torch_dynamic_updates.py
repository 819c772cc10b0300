"""Paper §5 walkthrough on the PyTorch port: build on 10% of the data,
stream the rest in as capacity-padded updates (every in-capacity update
keeps every shape), and compare accuracy and time with a from-scratch
rebuild, as ``dynamic_updates.py`` does on the JAX package.

  PYTHONPATH=src python examples/torch_dynamic_updates.py [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.core import estimator as E, updates
from repro_torch.core.config import ProberConfig
from repro_torch.data import vectors
from repro_torch.kernels import ops


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=0.15,
                    help="fraction of the glove surrogate's 40k points")
    ap.add_argument("--chunk", type=int, default=1024,
                    help="points per streamed update")
    args = ap.parse_args(argv)
    dev = ops.resolve_device(args.device)
    g = torch.Generator(device=dev).manual_seed(0)
    ds = vectors.load("glove", n_queries=4, scale=args.scale, device=dev)
    n = ds.x.shape[0]
    n0 = int(n * 0.1) // 4 * 4
    cfg = ProberConfig(n_tables=2, n_funcs=10, ring_budget=2048,
                       central_budget=2048, chunk=128)

    t0 = time.perf_counter()
    # capacity-padded build: spare rows keep every in-capacity update's
    # shapes until the capacity doubles
    state = E.build(ds.x[:n0], cfg, g, capacity=updates.next_pow2(n),
                    device=dev)
    _sync(dev)
    print(f"initial build on {n0} pts (capacity {state.x.shape[0]}): "
          f"{time.perf_counter() - t0:.2f}s")

    step = args.chunk
    t0 = time.perf_counter()
    state = E.update(state, ds.x[n0:n0 + step], cfg)       # Alg. 7/8
    _sync(dev)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(n0 + step, n, step):
        state = E.update(state, ds.x[i:i + step], cfg)
    _sync(dev)
    t_rest = time.perf_counter() - t0
    n_rest = n - n0 - step
    print(f"first chunk:               {t_first:.2f}s")
    print(f"stream {n_rest} pts:          {t_rest:.2f}s "
          f"({n_rest / max(t_rest, 1e-9):,.0f} pts/s amortized)")
    assert int(state.n_valid) == n

    t0 = time.perf_counter()
    static = E.build(ds.x, cfg, g, device=dev)
    _sync(dev)
    print(f"from-scratch rebuild:      {time.perf_counter() - t0:.2f}s")

    def mean_qerr(st) -> float:
        errs = []
        for qi in range(ds.queries.shape[0]):
            for t in range(0, ds.taus.shape[1], 2):
                est = float(E.estimate(st, ds.queries[qi], ds.taus[qi, t],
                                       cfg, generator=g))
                c = max(float(ds.cards[qi, t]), 1.0)
                errs.append(max(max(est, 1) / c, c / max(est, 1)))
        return sum(errs) / len(errs)

    q_upd, q_static = mean_qerr(state), mean_qerr(static)
    print(f"mean Q-error  updated framework: {q_upd:.2f}")
    print(f"mean Q-error  static build:      {q_static:.2f}")
    print("=> updates preserve accuracy (paper Fig. 7) without rebuilds")
    return {"qerr_updated": q_upd, "qerr_static": q_static,
            "n_valid": int(state.n_valid), "n": n}


if __name__ == "__main__":
    main()
