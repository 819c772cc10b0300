"""Where a traced call's launches, syncs and device idle go, by the
program's own spans:

    python3 cebench/tools/spans.py --workload <cell> --seed <n>
        [--calls 6] [--rounds 2] [--out <file>.json] [--device cpu]

One process: the cell's set-up as a run makes it (``core.set_up``:
inputs from the seed, the build, the warm calls), then ``--rounds``
rounds, each of ``--calls`` traced calls (``core.traced_calls``) with the
program's spans and tally on, then as many with them off (the program's
spans made no-ops and its tally skipped; the harness's own spans stay),
in turns. Prints one JSON object (and writes it to ``--out``): for each
round and side the traced calls' seconds, the profiler's summary
(``trace.summarize``), the program's spans (``Summary.program_spans``),
the counters' differences (the lane-steps of the tally and the launches
of both slab kernels a call among them) and the split of the launches,
syncs and idle seconds by span; and what a span costs with no profiler
running, gated and not. Used to find where a call's time goes; the
benchmark's own runs do not use it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from cebench.harness import core, trace  # noqa: E402

# (enclosing span, its part): the parts of a traced call that the split
# gives, outermost last; each part is what the span holds less the part
# before it
PARTS = (("prober.slab_step", "in slab steps"),
         ("prober.slab_block", "in slab blocks, outside their steps"),
         ("estimator.estimate_batch", "in the estimate, outside the blocks"))


@contextlib.contextmanager
def spans_off():
    """The program's spans as no-ops and its tally skipped."""
    from repro_torch.core import estimator, prober
    off = contextlib.nullcontext()
    saved = [(m, a, getattr(m, a)) for m, a in (
        (prober, "span"), (estimator, "span"), (prober, "_tracing"))]
    prober.span = estimator.span = lambda name: off
    prober._tracing = lambda: False
    try:
        yield
    finally:
        for m, a, v in saved:
            setattr(m, a, v)


def traced(drv, first: int, calls: int, dev):
    """``calls`` calls under the profiler, as a traced run makes them
    (``core.traced_calls``): ``(events, seconds a call, counter
    differences)``."""
    lat, _, prof, counts = core.traced_calls(drv, first, calls, dev)
    return trace.collect(prof), lat, counts


def split(spans: dict, key: str, total) -> dict:
    """``total`` (the traced calls' launches, syncs or idle seconds) in
    the parts of :data:`PARTS` and the rest, which sum to it."""
    out, inner = {}, 0
    for name, part in PARTS:
        held = spans.get(name, {}).get(key, 0)
        out[part] = held - inner
        inner = held
    out["outside the estimate (the harness's)"] = total - inner
    return out


def reduce(evs, lat, counts) -> dict:
    s = trace.summarize(evs)
    spans = s.program_spans
    n = s.batches
    step = spans.get("prober.slab_step", {})
    idle = s.window_s - s.busy_s
    per_step = {}
    if step.get("calls"):
        per_step = {k: step[k] / step["calls"]
                    for k in ("launches", "syncs", "host_s", "idle_s")}
    rings = (spans.get("prober.ring_cumsums", {}).get("device_s"),
             s.span_device_s.get(trace.SPAN_RINGS))
    return {
        "calls": n, "call_s": lat, "mean_call_s": sum(lat) / len(lat),
        "window_s": s.window_s, "busy_s": s.busy_s,
        "launches": s.launches, "syncs": s.syncs,
        "counters": counts,
        "lane_steps_per_call": counts.get("kept_lane_steps", 0) / n,
        "slab_launches_per_call": (counts.get("slab_loops", 0)
                                   + counts.get("slab_steps", 0)) / n,
        "per_step": per_step,
        "launches_split": split(spans, "launches", s.launches),
        "syncs_split": split(spans, "syncs", s.syncs),
        "idle_s_split": split(spans, "idle_s", idle),
        "ring_device_s": {"prober.ring_cumsums": rings[0],
                          trace.SPAN_RINGS: rings[1]},
        "spans": spans, "idle_gaps": s.idle_gaps,
        "device_ops": s.device_ops}


def gate_cost(uses: int = 100_000) -> dict:
    """Microseconds a use (enter and exit) with no profiler running: the
    program's gated span, and a bare ``record_function``."""
    from repro_torch.utils.spans import span
    out = {}
    for what, make in (("gated span", span),
                       ("record_function", torch.profiler.record_function)):
        t0 = time.perf_counter()
        for _ in range(uses):
            with make("cebench.gate"):
                pass
        out[what] = 1e6 * (time.perf_counter() - t0) / uses
    return out


def main(argv=None, root: Path | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="cebench/tools/spans.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    root = root or ROOT
    dev = torch.device(args.device)
    drv = core.set_up(core.load_cell(root, args.workload), args.seed,
                      dev).driver
    rounds = []
    first = 0
    for r in range(args.rounds):
        rec = {}
        for side in (("on", "off") if r % 2 == 0 else ("off", "on")):
            with spans_off() if side == "off" else contextlib.nullcontext():
                rec[side] = reduce(*traced(drv, first, args.calls, dev))
            first += args.calls
        rounds.append(rec)
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(dev)
           if dev.type == "cuda" else "cpu",
           "card": core.smi_line() if dev.type == "cuda" else None,
           "gate_us": gate_cost(), "rounds": rounds}
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text, flush=True)
    return out


if __name__ == "__main__":
    torch.set_num_threads(2)      # as cebench/run.py
    main()
