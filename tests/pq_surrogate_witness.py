"""The reference's PQ codebook against the port's on the corpus that
``chip_smoke.py`` makes (``repro_torch/data/vectors.py``), at SIFT's width
and the PQ shape of ``benchmarks/common.py`` ``serve_cfg(d=128)`` (M = 32,
Kc = 64, 8 Lloyd iterations), at sizes the JAX package runs on the CPU.

Each package fits its own codebook from its own draws on the same corpus
(the reference under ``jax.random.PRNGKey(seed)``, the port under a
``torch.Generator``), and both are read the same way: the squared
quantisation residual ||x − q(x)||² against τ² of 64 paper-protocol
queries (one target per query, round robin over the grid, as in
``chip_smoke.py``), the q-error of the full ADC scan
(``baselines.adc_scan_estimate_batch``) and of the ``serve_cfg`` estimate
(``estimator.estimate_batch``). A third row runs the port's scan on the
reference's own codebook: its counts must equal the reference's for every
query without an ADC distance within 1e-5·τ² of τ².

Run from the repository root (CPU, a few minutes, ~3 GiB at the largest
size):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/pq_surrogate_witness.py \\
        [--sizes 10000 65536] [--seeds 0 1]
"""
from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import baselines as jbaselines, config as jconfig, \
    estimator as JE, pq as jpq
from repro_torch.core import baselines, config, estimator as E, pq
from repro_torch.data import vectors

NQ, DIM = 64, 128
SERVE_KW = dict(n_tables=1, n_funcs=12, ring_budget=1024, central_budget=512,
                chunk=512, max_visit=2048, use_pq=True, pq_m=32, pq_kc=64,
                pq_iters=8, pq_exact_rings=0, pq_exact_central=False,
                pq_int8_lut=True)


def q_errors(est, truth) -> np.ndarray:
    e = np.maximum(np.asarray(est, np.float64), 1.0)
    t = np.maximum(np.asarray(truth, np.float64), 1.0)
    return np.maximum(e / t, t / e)


def stats(a) -> str:
    a = np.asarray(a, np.float64)
    return f"median {np.median(a):9.3f} mean {a.mean():9.3f}"


def witness(n: int, seed: int) -> None:
    g = torch.Generator().manual_seed(seed)
    x = vectors.make_corpus(g, n, DIM)
    qs, taus, cards = vectors.paper_query_workload(g, x, NQ)
    pick = torch.arange(NQ) % taus.shape[1]
    taus, cards = taus[torch.arange(NQ), pick], cards[torch.arange(NQ), pick]
    t2 = taus.double() ** 2
    xj, qj, tj = jnp.asarray(x.numpy()), jnp.asarray(qs.numpy()), \
        jnp.asarray(taus.numpy())
    jcfg, cfg = jconfig.ProberConfig(**SERVE_KW), config.ProberConfig(**SERVE_KW)
    print(f"N={n} seed={seed}: tau^2 over {NQ} queries {stats(t2)}, "
          f"true counts {stats(cards)}")

    t0 = time.perf_counter()
    jp = jpq.fit(xj, jcfg, jax.random.PRNGKey(seed))
    j_scan = np.asarray(jbaselines.adc_scan_estimate_batch(jp, qj, tj))
    j_state = JE.build(xj, jcfg, jax.random.PRNGKey(seed + 100))
    j_est = np.asarray(JE.estimate_batch(j_state, qj, tj, jcfg,
                                         jax.random.PRNGKey(seed + 200)))
    t_ref = time.perf_counter() - t0

    t0 = time.perf_counter()
    p = pq.fit(x, cfg, torch.Generator().manual_seed(seed + 300))
    p_scan = baselines.adc_scan_estimate_batch(p, qs, taus).numpy()
    gs = torch.Generator().manual_seed(seed + 400)
    state = E.build(x, cfg, gs, device="cpu")
    p_est = E.estimate_batch(state, qs, taus, cfg, generator=gs).numpy()
    t_port = time.perf_counter() - t0

    for name, resid, scan, est in (
            ("reference", np.asarray(jp.resid), j_scan, j_est),
            ("port", p.resid.numpy(), p_scan, p_est)):
        r2 = resid.astype(np.float64) ** 2
        print(f"  {name:9s} resid^2 {stats(r2)} | median resid^2 / median "
              f"tau^2 {np.median(r2) / float(t2.median()):.3f} | scan "
              f"q-error {stats(q_errors(scan, cards))} | serve_cfg estimate "
              f"q-error {stats(q_errors(est, cards))}")
    # the port's scan on the reference's own codebook
    jp_t = pq.PQIndex(*(torch.from_numpy(np.array(getattr(jp, k))) for k in
                        ("centroids", "codes", "counts", "resid", "n_valid")))
    on_ref = baselines.adc_scan_estimate_batch(jp_t, qs, taus).numpy()
    tied = pq.adc_ties(pq.adc_table(jp_t, qs), jp_t.codes, taus, 1e-5).numpy()
    differ = on_ref != j_scan
    print(f"  port scan on the reference codebook: {int(differ.sum())} of "
          f"{NQ} counts differ from the reference's ({int(tied.sum())} "
          f"queries at an ADC tie; {int((differ & ~tied).sum())} differ "
          f"outside ties) | wall: reference {t_ref:.1f} s, port "
          f"{t_port:.1f} s (CPU)")
    if (differ & ~tied).any():
        raise SystemExit("the port's scan departs from the reference's")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[10_000, 65_536])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    args = ap.parse_args(argv)
    for seed in args.seeds:
        for n in args.sizes:
            witness(n, seed)


if __name__ == "__main__":
    main()
