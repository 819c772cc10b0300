#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed S]

Phases, in order; each raises on failure:

1. Device: require CUDA; print the card's name and ``nvidia-smi``'s
   name and power limit.
2. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc, one
   process per source, in parallel); print seconds and ptxas lines.
3. Each kernel wrapper against its plain PyTorch version at the main path's
   shapes, with the stated tolerances; CUDA-event times of the kernel, the
   plain version and (for ``l2dist``) ``torch.cdist``, beside the bound.
4. The main path at SIFT1M scale (N = 1,000,000, d = 128): ``build`` at
   capacity 2^20, 64 paper-protocol queries through
   ``estimate_batch_stats``, an in-capacity ``update`` of 16,384 points, an
   ``update`` past capacity (growth to 2^21), an estimate after each, all
   held against ``true_cardinality``. Kernel launch counts are zeroed just
   before and read just after.
5. Where the time goes: ``torch.profiler`` over one ``estimate_batch`` and
   one ``update``.
6. Small-input agreement: the same index, queries and round keys through
   the CPU path (plain versions) and the GPU path (kernels).

Ends with a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. Exits non-zero, printing no result, without CUDA or without the
package beside it.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# benchmarks/common.py prober_cfg (exact path): the repo's benchmark config
CFG_KW = dict(n_tables=2, n_funcs=10, ring_budget=2048, central_budget=2048,
              chunk=128, eps=0.01)
N, DIM, CAPACITY, NQ = 1_000_000, 128, 2 ** 20, 64
N_INGEST, N_GROW = 16_384, 40_000
HBM_BYTES_S = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet
FP32_FLOP_S = 67e12            # H100 SXM fp32 outside the tensor cores
MARGIN = 1e-5
REPLACES = {"lsh_hash": "src/repro/kernels/lsh_hash.py:46",
            "hamming_to_buckets": "src/repro/kernels/hamming.py:32",
            "l2dist": "src/repro/kernels/l2dist.py:41",
            "l2dist_rows": "src/repro/kernels/l2dist.py:41"}
SOURCES = {"lsh_hash": "lsh_hash.cu", "hamming_to_buckets": "hamming.cu",
           "l2dist": "l2dist.cu", "l2dist_rows": "l2dist.cu"}


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_S, flops / FP32_FLOP_S
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def cuda_ms(torch, fn, iters: int = 20) -> float:
    """Mean CUDA-event time of ``fn`` over ``iters`` launches, warmed up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device(torch) -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    log(f"device: {name} (count {torch.cuda.device_count()})")
    log(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
        else f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    return name


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.load()
    log(f"build: {built.seconds:.3f} s nvcc, {time.perf_counter() - t0:.3f} s "
        f"in all -> {built.path.name}")
    for line in built.ptxas:
        log(f"  {line}")


def near_integer(torch, x, a, b, w):
    v = (x.double() @ a.double() + (b * w).double()) / w.double()
    return (v - torch.round(v)).abs() < MARGIN


def phase_kernels(torch, x, qs, taus, index, cfg) -> dict:
    """Every kernel against its plain version at the main path's shapes."""
    from repro_torch.core import lsh
    from repro_torch.kernels import ops, ref
    res = {}
    p = index.params
    dev = x.device

    # lsh_hash: the query hash (64 x 128 -> 20) and the 1M corpus
    for tag, xx in (("queries", qs), ("corpus", x)):
        got = ops.lsh_hash(xx, p.a, p.b, p.w)
        want = ref.lsh_hash(xx, p.a, p.b, p.w)
        near = near_integer(torch, xx, p.a, p.b, p.w)
        flips = int((got != want).sum())
        bad = int(((got != want) & ~near).sum())
        log(f"lsh_hash[{tag} {tuple(xx.shape)}]: {flips} codes differ, "
            f"{int(near.sum())} values within {MARGIN} of an integer")
        if bad:
            raise AssertionError(f"lsh_hash: {bad} codes differ outside "
                                 "the margin")
    n, d, f = qs.shape[0], qs.shape[1], p.a.shape[1]
    res["lsh_hash"] = dict(
        max_abs_err=float((ops.lsh_hash(qs, p.a, p.b, p.w)
                           - ref.lsh_hash(qs, p.a, p.b, p.w)).abs().max()),
        ms=cuda_ms(torch, lambda: ops.lsh_hash(qs, p.a, p.b, p.w)),
        plain_ms=cuda_ms(torch, lambda: ref.lsh_hash(qs, p.a, p.b, p.w)),
        bound=bound_ms(4 * (n * d + d * f + 2 * f + n * f), 2 * n * d * f),
        library_ms=None)
    log(f"lsh_hash[corpus] kernel {cuda_ms(torch, lambda: ops.lsh_hash(x, p.a, p.b, p.w)):.4f} ms, "
        f"bound {bound_ms(4 * (x.shape[0] * (d + f) + d * f), 2 * x.shape[0] * d * f)[0]:.4f} ms")

    # hamming_to_buckets: (Q, L, B) = (64, 2, 2^20)
    qcodes = lsh.hash_point(p, qs, cfg.n_tables)
    bc, nb = index.bucket_codes, index.n_buckets
    got = ops.hamming_to_buckets(bc, qcodes, nb)
    want = ref.hamming_to_buckets(bc, qcodes, nb)
    if not torch.equal(got, want):
        raise AssertionError("hamming_to_buckets differs from its plain version")
    nl, nbk, k = bc.shape
    res["hamming_to_buckets"] = dict(
        max_abs_err=float((got - want).abs().max()),
        ms=cuda_ms(torch, lambda: ops.hamming_to_buckets(bc, qcodes, nb)),
        plain_ms=cuda_ms(torch, lambda: ref.hamming_to_buckets(bc, qcodes, nb),
                         iters=5),
        # codes are read only for the live bucket rows (the rest are masked)
        bound=bound_ms(4 * (int(nb.sum()) * k + NQ * nl * k + nl
                            + NQ * nl * nbk),
                       2 * NQ * int(nb.sum()) * k),
        library_ms=None)
    del got, want
    log(f"hamming_to_buckets{tuple(qcodes.shape[:2]) + (nbk,)}: exact")

    # l2dist_rows: one slab (128 lanes x 128 candidates) and one central
    # pass (128 lanes x 2048), lane i holding query i // L
    g = torch.Generator(device=dev).manual_seed(1)
    lane_q = torch.arange(NQ * cfg.n_tables, device=dev) // cfg.n_tables
    qs_l, tsq_l = qs[lane_q].contiguous(), (taus * taus)[lane_q]
    for c in (cfg.chunk, cfg.central_budget):
        ids = torch.randint(0, x.shape[0], (qs_l.shape[0], c), generator=g,
                            device=dev, dtype=torch.int32)
        got = ops.l2dist_rows(x, ids, qs_l)
        want = ref.l2dist_rows(x, ids, qs_l)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        dec = (got <= tsq_l[:, None]) != (want <= tsq_l[:, None])
        at_margin = (want - tsq_l[:, None]).abs() <= MARGIN * tsq_l[:, None]
        log(f"l2dist_rows{tuple(ids.shape) + (d,)}: {int(dec.sum())} "
            f"decisions differ, {int(at_margin.sum())} candidates within "
            f"{MARGIN} tau^2 of tau^2")
        if (dec & ~at_margin).any():
            raise AssertionError("l2dist_rows decision differs off the margin")
        if c == cfg.chunk:
            r = ids.shape[0]
            res["l2dist_rows"] = dict(
                max_abs_err=float((got - want).abs().max()),
                ms=cuda_ms(torch, lambda: ops.l2dist_rows(x, ids, qs_l)),
                plain_ms=cuda_ms(torch, lambda: ref.l2dist_rows(x, ids, qs_l)),
                bound=bound_ms(4 * (r * c + r * c * d + r * d + r * c),
                               2 * r * c * d),
                library_ms=None)

    # l2dist: true_cardinality / query-workload shape, 1M x 64
    got = ops.l2dist(x, qs)
    want = ref.l2dist(x, qs)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    nx = x.shape[0]
    res["l2dist"] = dict(
        max_abs_err=float((got - want).abs().max()),
        ms=cuda_ms(torch, lambda: ops.l2dist(x, qs)),
        plain_ms=cuda_ms(torch, lambda: ref.l2dist(x, qs), iters=3),
        bound=bound_ms(4 * (nx * d + NQ * d + nx * NQ), 2 * nx * NQ * d),
        library_ms=cuda_ms(torch, lambda: torch.cdist(x, qs) ** 2))
    del got, want
    for name, r in res.items():
        log(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), library "
            f"{r['library_ms']}, max_abs_err {r['max_abs_err']}")
    return res


def q_errors(torch, est, truth):
    e, t = est.double().clamp_min(1.0), truth.double().clamp_min(1.0)
    return torch.maximum(e / t, t / e)


def summarize(torch, tag, est, truth):
    if not torch.isfinite(est).all() or (est < 0).any():
        raise AssertionError(f"{tag}: non-finite or negative estimate")
    qe = q_errors(torch, est, truth)
    log(f"{tag}: q-error mean {float(qe.mean()):.4f} median "
        f"{float(qe.median()):.4f} p95 {float(torch.quantile(qe, 0.95)):.4f} "
        f"max {float(qe.max()):.4f}")


def phase_main_path(torch, corpus, cfg, seed) -> dict:
    """The port's main path at SIFT1M scale; returns the launch counts."""
    from repro_torch.core import estimator as E
    from repro_torch.data import vectors
    from repro_torch.kernels import ops
    dev = corpus.device
    g = torch.Generator(device=dev).manual_seed(seed + 1)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def expect_live(state, n):
        if int(state.n_valid) != n:
            raise AssertionError(f"n_valid {int(state.n_valid)} != {n}")
        log(f"n_valid {n}, capacity {state.capacity}")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    state, t_build = timed(lambda: E.build(corpus[:N], cfg, g,
                                           capacity=CAPACITY, device=dev))
    expect_live(state, N)
    log(f"build: {t_build:.3f} s (N {N}, capacity {CAPACITY}, buckets "
        f"{state.index.n_buckets.tolist()})")
    (qs, taus_grid, _), t_wl = timed(
        lambda: vectors.paper_query_workload(g, corpus[:N], NQ))
    taus = taus_grid[torch.arange(NQ, device=dev),
                     torch.arange(NQ, device=dev) % taus_grid.shape[1]]
    log(f"query workload: {t_wl:.3f} s, {taus_grid.shape[1]} targets, "
        "one per query round robin")
    rks = E.draw_round_keys(g, NQ, cfg.n_tables, dev)

    for rnd in ("first", "second"):
        out, t_est = timed(lambda: E.estimate_batch_stats(state, qs, taus,
                                                          cfg, rks=rks))
        log(f"estimate_batch_stats ({rnd} call, Q={NQ}): {t_est * 1e3:.3f} ms")
        if rnd == "second" and not all(torch.equal(a, b)
                                       for a, b in zip(first, out)):
            raise AssertionError("estimate_batch_stats is not deterministic")
        first = out
    est, probed_k, nvis = first
    truth = E.true_cardinality(state.x, qs, taus, n_valid=N)
    summarize(torch, "estimate @ N", est, truth)
    log(f"  probed_k mean {float(probed_k.float().mean()):.3f}, nvisited "
        f"mean {float(nvis.float().mean()):.1f}")

    state, t_up = timed(lambda: E.update(state, corpus[N:N + N_INGEST], cfg))
    expect_live(state, N + N_INGEST)
    if state.capacity != CAPACITY:
        raise AssertionError("in-capacity update changed the capacity")
    log(f"update (in capacity, {N_INGEST} points): {t_up:.3f} s = "
        f"{N_INGEST / t_up:.1f} points/s")
    est, t_est = timed(lambda: E.estimate_batch(state, qs, taus, cfg,
                                                generator=g))
    truth = E.true_cardinality(state.x, qs, taus, n_valid=N + N_INGEST)
    log(f"estimate_batch after ingest: {t_est * 1e3:.3f} ms")
    summarize(torch, "estimate @ N+ingest", est, truth)

    n_all = N + N_INGEST + N_GROW
    state, t_grow = timed(lambda: E.update(state, corpus[N + N_INGEST:n_all],
                                           cfg))
    expect_live(state, n_all)
    log(f"update (past capacity, {N_GROW} points): {t_grow:.3f} s, capacity "
        f"{CAPACITY} -> {state.capacity}")
    est, t_est = timed(lambda: E.estimate_batch(state, qs, taus, cfg,
                                                generator=g))
    truth = E.true_cardinality(state.x, qs, taus, n_valid=n_all)
    log(f"estimate_batch after growth: {t_est * 1e3:.3f} ms")
    summarize(torch, "estimate @ grown", est, truth)
    counts = dict(ops.LAUNCHES)
    nl, nk, nb = cfg.n_tables, cfg.n_funcs, state.capacity
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2 ** 30:.3f}"
        f" GiB (ring cumsums alone: {NQ * nl * (nk + 1) * nb * 4 / 2 ** 30:.3f}"
        f" GiB at B = {nb})")
    log(f"main-path launches: {json.dumps(counts)}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    return counts, state, qs, taus


def phase_profile(torch, state, qs, taus, cfg, seed):
    """Where the time goes: torch.profiler over one estimate_batch and one
    in-capacity update of the grown state; device time by operator and the
    device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import estimator as E
    g = torch.Generator(device=qs.device).manual_seed(seed + 3)
    extra = torch.randn((N_INGEST, DIM), generator=g, device=qs.device)
    for tag, fn in (("estimate_batch", lambda: E.estimate_batch(
                        state, qs, taus, cfg, generator=g)),
                    ("update", lambda: E.update(state, extra, cfg))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # kernels (device rows) give the busy time; operators (host rows)
        # carry the device time of the kernels they launched
        ka = prof.key_averages()
        dev_t = [(_device_us(e), e.count, e.key) for e in ka]
        busy = sum(t for (t, _, _), e in zip(dev_t, ka)
                   if e.device_type == DeviceType.CUDA)
        by_op = sorted(((t, c, k) for (t, c, k), e in zip(dev_t, ka)
                        if e.device_type == DeviceType.CPU and t > 0),
                       reverse=True)
        if busy <= 0:
            log(f"profile[{tag}]: the profiler saw no device time; device "
                "busy share not measured")
            continue
        log(f"profile[{tag}]: wall {wall_us:.1f} us, device busy "
            f"{busy:.1f} us = {busy / wall_us:.4f} of wall (idle "
            f"{1 - busy / wall_us:.4f}); device time by operator:")
        for t, c, k in by_op[:10]:
            log(f"  {t:12.1f} us {c:6d} calls  {k}")
        # the port's own kernels are launched through ctypes, so they have
        # no operator row: list their device rows
        names = ("lsh_hash_kernel", "hamming_kernel", "l2dist_kernel",
                 "l2dist_rows_kernel")
        for (t, c, k), e in zip(dev_t, ka):
            label = [n for n in names if f"::{n}(" in k]
            if e.device_type == DeviceType.CUDA and label:
                log(f"  {t:12.1f} us {c:6d} calls  {label[0]}")


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def phase_small_agreement(torch, cfg, seed):
    """The same index, queries and round keys on the CPU (plain versions)
    and on the GPU (kernels): equal ring depths and sample counts, equal
    estimates to rtol 1e-5. Queries whose hash values or distances sit
    within the float margin of a boundary are left out beforehand, since
    there the two sides may legitimately decide differently."""
    from repro_torch import bridge
    from repro_torch.core import estimator as E
    from repro_torch.data import vectors
    g = torch.Generator().manual_seed(seed + 2)
    x = vectors.make_corpus(g, 8192, 32)
    cpu = E.build(x, cfg, g, capacity=2 ** 14, device="cpu")
    gpu = bridge.state_from_numpy(bridge.state_to_numpy(cpu), "cuda")
    qs, taus, _ = vectors.paper_query_workload(g, x, 48, n_taus=6)
    taus = taus[torch.arange(48), torch.arange(48) % taus.shape[1]]
    p = cpu.index.params
    ok_hash = ~near_integer(torch, qs, p.a, p.b, p.w).any(1)
    d2 = ((x.double()[None] - qs.double()[:, None]) ** 2).sum(-1)
    t2 = (taus.double() ** 2)[:, None]
    ok_tau = ~((d2 - t2).abs() <= MARGIN * t2).any(1)
    keep = torch.nonzero(ok_hash & ok_tau).squeeze(1)[:16]
    if keep.numel() < 8:
        raise AssertionError("too few tie-free queries for the agreement")
    qs, taus = qs[keep], taus[keep]
    rks = E.draw_round_keys(g, len(keep), cfg.n_tables, "cpu")
    want = E.estimate_batch_stats(cpu, qs, taus, cfg, rks=rks)
    got = E.estimate_batch_stats(gpu, qs, taus, cfg, rks=rks)
    for name, a, b in zip(("ests", "probed_k", "nvisited"), got, want):
        if name == "ests":
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
        elif not torch.equal(a.cpu(), b):
            raise AssertionError(f"CPU and GPU paths differ in {name}")
    log(f"small-input agreement: {len(keep)} queries, CPU and GPU paths "
        f"agree (max |diff| {float((got[0].cpu() - want[0]).abs().max())})")
    summarize(torch, "estimate @ N=8192 (same config)", got[0].cpu(),
              E.true_cardinality(x, qs, taus))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    name = phase_device(torch)
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit("chip_smoke: src/repro_torch not found beside "
                         "chip_smoke.py")
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()
    from repro_torch.core import lsh
    from repro_torch.core.config import ProberConfig
    from repro_torch.data import vectors
    phase_build()
    cfg = ProberConfig(**CFG_KW)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    corpus = vectors.make_corpus(g, N + N_INGEST + N_GROW, DIM)
    x = corpus[:N]
    qs0, taus0, _ = vectors.paper_query_workload(g, x, NQ)
    taus0 = taus0[torch.arange(NQ, device=dev),
                  torch.arange(NQ, device=dev) % taus0.shape[1]]
    x_pad = torch.nn.functional.pad(x, (0, 0, 0, CAPACITY - N))
    index = lsh.build_index(x_pad, cfg, g, n_valid=N)
    res = phase_kernels(torch, x, qs0, taus0, index, cfg)
    del index, x_pad
    torch.cuda.empty_cache()
    counts, state, qs, taus = phase_main_path(torch, corpus, cfg, args.seed)
    phase_profile(torch, state, qs, taus, cfg, args.seed)
    del state
    phase_small_agreement(torch, cfg, args.seed)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    kernels = [dict(name=k, route="cuda",
                    source=f"src/repro_torch/kernels/csrc/{SOURCES[k]}",
                    replaces=REPLACES[k], launches=counts[k],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
                    bound_by=r["bound"][1], library_ms=r["library_ms"])
               for k, r in res.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
