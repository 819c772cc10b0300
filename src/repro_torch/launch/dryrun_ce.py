"""Dry run of the paper's technique itself at production scale (port of
``repro/launch/dryrun_ce.py``): the distributed Dynamic Prober over a
1.05-billion-point corpus spread over the single-pod mesh's 256 ranks
(4,096,000 points each), answering a 64-query batch.

The reference lowers ``estimate_sharded`` abstractly, so its while-loops
give a worst-case bound. The port's estimator has data-dependent host
control (the slab loop's stopping rule, the bucket caps read on the host,
the sorts and the CSR build), which fake tensors cannot run. So the port
builds rank 0's shard for real on ``--device``, as rank 0 of a fake
256-rank group (``launch/mesh.fake_world``: each collective completes
without sending anything, so the pooled values are rank 0's own), and runs
``estimate_sharded`` on it three times: a warm-up, one timed by CUDA
events, and one under the counting modes of ``utils/cost.py``. The figures
are rank 0's, MEASURED on its data, not the reference's bound.

FLOPs and bytes are ``cost.py``'s aten figures plus, on the card, the
hand-written kernels' ``ops.WORK`` (which no dispatch mode sees; on the CPU
their plain versions run as aten ops and are counted there). ``ops.WORK``
counts each kernel call at the most its shapes allow (every lane draws its
whole chunk); the slab loop's launch is counted at the chunks its lanes'
steps drew, which the counted call reports. ``model_flops`` is the reference's: the brute-force cost the
estimator replaces, 2·N·d·Q over the global corpus.

  python -m repro_torch.launch.dryrun_ce [--mode sync] [--device cpu \\
      --n-per-shard 4096 --dim 32 --queries 16]
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.core import distributed as D, prober
from repro_torch.core.config import ProberConfig
from repro_torch.data import vectors
from repro_torch.kernels import ops
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.utils import cost, roofline

CE_CONFIG = ProberConfig(n_tables=2, n_funcs=12, ring_budget=8192,
                         central_budget=8192, chunk=512, max_visit=32768)


def estimate_cell(n_per_shard: int, dim: int, n_queries: int,
                  cfg: ProberConfig = CE_CONFIG, mode: str = "local",
                  device="cuda", seed: int = 0, group=None) -> dict:
    """Rank 0's shard of ``n_per_shard`` × ``dim`` points (``make_corpus``
    from ``seed`` on ``device``), its index, and one ``estimate_sharded``
    of ``n_queries`` queries drawn from it (τ at each query's median
    target cardinality) over ``group`` (the default group: a fake one).
    Returns the measurements: ``cost.measure``'s record, ``wall_ms`` (CUDA
    events; None on the CPU), ``device_peak_bytes`` (the allocator's peak
    over the estimates; None on the CPU), ``slab_steps`` (the counted
    estimate's lane-steps and longest lane, ``prober.slab_steps``),
    ``work`` (the kernels' ``ops.WORK``, the slab loop's from the steps
    its lanes took) and ``launches``."""
    dev = ops.resolve_device(device)
    group = dist.group.WORLD if group is None else group
    world = dist.get_world_size(group)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = vectors.make_corpus(g, n_per_shard, dim)
    qs, taus, _ = vectors.paper_query_workload(g, x, n_queries)
    taus = taus[:, taus.shape[1] // 2].contiguous()
    state = D.build_sharded(None, cfg, generator=g, group=group,
                            capacity=n_per_shard * world, device=dev,
                            x_local=x)
    del x
    rks = D.shard_round_keys(seed, n_queries, cfg.n_tables, dev, group)

    def run(steps=None):
        return D.estimate_sharded(state, qs, taus, cfg, rks, group, mode,
                                  steps)

    cuda = dev.type == "cuda"
    run()                                   # warm-up: loads the kernels
    wall_ms = peak = None
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize(dev)
        wall_ms = start.elapsed_time(end)
        peak = torch.cuda.max_memory_allocated(dev)
    ops.reset_work()
    ops.reset_launches()
    steps = []
    est, rec = cost.measure(lambda: run(steps), state, qs, taus, rks)
    if cuda:
        torch.cuda.synchronize(dev)
    steps = prober.slab_steps(steps)
    work = {k: dict(v) for k, v in ops.WORK.items() if v["calls"]}
    if "slab_loop" in work and not cfg.use_pq:
        # ops.WORK counts the loop at its bound (every lane drawing to its
        # visit budget); count the chunks its lanes' steps drew, as the host
        # loop's steps are counted, each at the exact route's cost
        n = steps["lane_steps"]
        nbytes, flops = ops.slab_qualify_work(n, dim, n * cfg.chunk, n)
        work["slab_loop"].update(bytes=nbytes, flops=flops)
    rec.update(wall_ms=wall_ms, device_peak_bytes=peak, slab_steps=steps,
               work=work,
               launches={k: v for k, v in ops.LAUNCHES.items() if v},
               estimates_finite=bool(torch.isfinite(est).all()),
               n_estimates=int(est.numel()))
    return rec


def record(rec: dict, n_per_shard: int, dim: int, n_queries: int,
           chips: int, mode: str, device: torch.device) -> dict:
    """The reference's record from :func:`estimate_cell`'s, with the
    measured figures beside it."""
    n_global = n_per_shard * chips
    cuda = device.type == "cuda"
    kflops = sum(w["flops"] for w in rec["work"].values()) if cuda else 0
    kbytes = sum(w["bytes"] for w in rec["work"].values()) if cuda else 0
    brute = 2.0 * n_global * dim * n_queries
    rf = roofline.make(rec["flops"] + kflops, rec["bytes"] + kbytes,
                       float(rec["collectives"]["total"]), chips, brute)
    return {
        "arch": "dynamic-prober-ce", "shape": f"{n_global}pts_{n_queries}q",
        "mesh": "single", "chips": chips, "mode": mode,
        "trace_s": round(rec["trace_s"], 3),
        "memory": {"argument_size_in_bytes": rec["argument_bytes"],
                   "peak_memory_in_bytes": rec["peak_bytes"],
                   "temp_size_in_bytes": max(
                       rec["peak_bytes"] - rec["argument_bytes"], 0)},
        "collectives": rec["collectives"],
        "top_collectives": rec["top_collectives"],
        "roofline": rf.to_dict(),
        "cost_raw": {"aten_flops": rec["flops"], "aten_bytes": rec["bytes"],
                     "kernel_flops": kflops, "kernel_bytes": kbytes},
        "kernels": rec["work"], "launches": rec["launches"],
        "wall_ms": rec["wall_ms"],
        "device_peak_bytes": rec["device_peak_bytes"],
        "slab_steps": rec["slab_steps"],
        "estimates_finite": rec["estimates_finite"],
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "note": "rank 0's figures, measured on its shard (not the "
                "reference's worst-case bound); the fake group pools rank "
                "0's values alone; peak_memory_in_bytes is traced "
                "(MemTracker), device_peak_bytes the allocator's; "
                "model_flops = exact brute-force cost the estimator "
                "replaces",
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-per-shard", type=int, default=4_096_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--mode", choices=["local", "sync"], default="local")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    dev = ops.resolve_device(args.device)
    t0 = time.perf_counter()
    with fake_world(256):
        mesh = make_production_mesh(device=dev.type)
        chips = mesh.size()
        print(f"corpus: {args.n_per_shard * chips / 1e9:.2f}B x {args.dim} "
              f"over {chips} ranks (rank 0's shard on {dev})", flush=True)
        # CE has no tensor-parallel dim: the corpus spreads over both mesh
        # axes, the world group
        rec = estimate_cell(args.n_per_shard, args.dim, args.queries,
                            mode=args.mode, device=dev, seed=args.seed)
    out = record(rec, args.n_per_shard, args.dim, args.queries, chips,
                 args.mode, dev)
    out["total_s"] = round(time.perf_counter() - t0, 1)
    path = Path(args.out_dir)
    path.mkdir(parents=True, exist_ok=True)
    (path / f"ce_estimator__single__{args.mode}.json").write_text(
        json.dumps(out, indent=1))
    r = out["roofline"]
    wall = "not measured" if out["wall_ms"] is None else \
        f"{out['wall_ms']:.3f} ms"
    dpeak = "not measured" if out["device_peak_bytes"] is None else \
        f"{out['device_peak_bytes'] / 2 ** 30:.2f} GiB"
    print(f"OK CE dry-run ({args.mode}): trace={out['trace_s']:.2f}s "
          f"t=({r['t_compute_s']:.2e},{r['t_memory_s']:.2e},"
          f"{r['t_collective_s']:.2e})s dominant={r['dominant']} "
          f"wall={wall} device_peak={dpeak} "
          f"peak(traced)={out['memory']['peak_memory_in_bytes'] / 2 ** 30:.2f}GiB "
          f"args={out['memory']['argument_size_in_bytes'] / 2 ** 30:.2f}GiB "
          f"slab_steps={out['slab_steps']} "
          f"collectives={out['collectives']}", flush=True)
    print(f"brute-force equivalent would cost "
          f"{r['model_flops'] / (chips * roofline.PEAK_FLOPS):.2e}s of pure "
          "compute")
    return out


if __name__ == "__main__":
    main()
