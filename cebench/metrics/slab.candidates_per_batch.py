"""Slab candidates a traced call: those the ``slab_qualify`` kernel drew
for lanes still active, qualified exactly or by ADC, and those of lanes
already done earlier in their block, which the prober's merge discards.
Read from the program's own tally (``prober.read_tally``) as
``ctx.counters`` carries it, taken around the traced calls; nothing where
the program keeps no tally, or it did not move by exactly the traced
calls' estimates."""


def read(ctx):
    t = ctx.counters
    if t is None or ctx.summary is None:
        return None
    n = t["exact"] + t["adc"] + t["discarded"]
    return n / ctx.summary.batches if n else None
