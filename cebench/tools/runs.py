"""Runs a cell several times, one process a run, one after another, and
prints each run's result line and the spread of every metric:

    python3 cebench/tools/runs.py --workload <cell> --seconds <s>
        [--trace 0|1] [--out <file>.jsonl] --seeds 11 12 13

The spread is (Q3 - Q1) / median, the quartiles of
``statistics.quantiles(values, n=4)``. With ``--out``, every run's
result, exit code, seconds and the end of its standard error are appended
to that file. Used to measure spreads and to rehearse; the benchmark's
own runs do not use it.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args()
    vals: dict = {}
    bad = 0
    for seed in args.seeds:
        cmd = [sys.executable, "cebench/run.py", "--workload", args.workload,
               "--seed", str(seed), "--seconds", str(args.seconds),
               "--trace", str(args.trace)]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        took = time.perf_counter() - t0
        lines = p.stdout.strip().splitlines()
        res = None
        if p.returncode == 0 and lines:
            try:
                res = json.loads(lines[-1])
            except json.JSONDecodeError:
                res = None
        rec = {"workload": args.workload, "seed": seed, "rc": p.returncode,
               "seconds": took, "result": res,
               "records": lines[:-1][-4:], "stderr": p.stderr[-3000:]}
        if args.out:
            with open(ROOT / args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if res is None or not res.get("correct"):
            bad += 1
            print(f"seed {seed}: rc {p.returncode}, {took:.1f} s\n"
                  f"{p.stderr[-3000:]}", flush=True)
        if res is None:
            continue
        print(f"seed {seed}: {took:.1f} s {json.dumps(res)}", flush=True)
        for k, v in res["metrics"].items():
            vals.setdefault(k, []).append(v["value"])
    for k, v in vals.items():
        line = f"{k}: median {statistics.median(v):.6g} over {len(v)}"
        if len(v) >= 2:
            q1, med, q3 = statistics.quantiles(v, n=4)
            line += f", spread {(q3 - q1) / med:.4%}"
        print(line + f", values {[round(x, 6) for x in v]}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
