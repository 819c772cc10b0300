"""Slab candidates a traced call: those the ``slab_qualify`` kernel drew
for lanes still active, qualified exactly or by ADC, and those of lanes
already done earlier in their block, which the prober's merge discards.
Read from the program's own tally (``prober.read_tally``), which counts
only while a profiler runs: the counts taken when this reader is loaded
are subtracted, and the reading is None unless the difference sums
exactly the traced calls (``calls`` against ``summary.batches``), so a
profiled call outside the window, or a load after the window, reads
nothing rather than a wrong count. Nothing where the program keeps no
tally. The harness's ``MetricCtx`` is to carry these counts, taken around
the traced calls, when it gains program counters; this reader then reads
them there."""
from cebench.harness import program

_BEFORE = program.tally()


def read(ctx):
    t = program.traced_tally(_BEFORE, ctx)
    if t is None:
        return None
    n = t["exact"] + t["adc"] + t["discarded"]
    return n / ctx.summary.batches if n else None
