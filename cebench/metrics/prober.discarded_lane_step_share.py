"""The share (%) of the traced calls' lane-steps whose slab step the
prober's merge discards: the lane was done earlier in its block of
``lane_block`` steps, but runs the block's steps to its end. Read from the
program's own tally (``prober.read_tally``), which counts only while a
profiler runs: the counts taken when this reader is loaded are
subtracted, and the reading is None unless the difference sums exactly
the traced calls (``calls`` against ``summary.batches``). Nothing where
the program keeps no tally. The harness's ``MetricCtx`` is to carry these
counts, taken around the traced calls, when it gains program counters;
this reader then reads them there."""
from cebench.harness import program

_BEFORE = program.tally()


def read(ctx):
    t = program.traced_tally(_BEFORE, ctx)
    if t is None:
        return None
    steps = t["discarded_lane_steps"] + t["kept_lane_steps"]
    return 100.0 * t["discarded_lane_steps"] / steps if steps else None
