"""The control of the comparison that decides ``correct``, and the readings
its limits are set from. Not part of the benchmark's runs:

    python3 cebench/control.py --workload <cell> --seconds 3 --seeds 1 2 3

For each seed it runs the cell as the benchmark does, in this process, once
as configured (the "sound" reading) and once with the program's float32
matrix products in TF32 (the control: the nearest precision below the
float32 that the configuration states), and prints the numbers compared
with their limits. The control has to come out not correct.

On the CPU, where TF32 does not exist, :func:`tf32` rounds the inputs of
the LSH projection to TF32's 10-bit mantissa instead, which is what TF32
does to a matrix product's inputs.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def round_tf32(t):
    """float32 values rounded to TF32 (10 mantissa bits, to nearest)."""
    import torch
    i = t.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def tf32(device):
    """The program's matrix products in TF32 while inside."""
    import torch
    if torch.device(device).type == "cuda":
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old
        return
    from repro_torch.core import lsh
    plain = lsh.project_raw

    def projected(params, x):
        return round_tf32(x) @ round_tf32(params.a)
    lsh.project_raw = projected
    try:
        yield
    finally:
        lsh.project_raw = plain


def readings(root: Path, workload: str, seeds, seconds: float, modes,
             device=None):
    """{mode: [(seed, correct, compared)]} for modes "sound" and "tf32"."""
    import torch
    from cebench.harness import core
    out = {m: [] for m in modes}
    dev = device or "cuda"
    for seed in seeds:
        for mode in modes:
            ctx = tf32(dev) if mode == "tf32" else contextlib.nullcontext()
            with ctx:
                r = core.run_cell(root, workload, seed, seconds, False,
                                  device=device, log=lambda *a, **k: None)
            out[mode].append((seed, r["correct"], r["compared"]))
            print(json.dumps({"mode": mode, "seed": seed,
                              "correct": r["correct"],
                              "compared": r["compared"]}), flush=True)
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    res = readings(ROOT, args.workload, args.seeds, args.seconds,
                   ["sound", "tf32"])
    for mode, rows in res.items():
        keys = rows[0][2].keys()
        agg = {k: (max if mode == "sound" else min)(
            r[2][k]["value"] for r in rows) for k in keys}
        print(f"{mode}: {'largest' if mode == 'sound' else 'smallest'} "
              f"readings over {len(rows)} seeds {json.dumps(agg)}; "
              f"correct {[r[1] for r in rows]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main())
