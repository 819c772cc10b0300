"""Device milliseconds of Alg. 7's ingest a thousand points: the device
time of the work launched inside the program's ``coalescer.ingest`` spans
of the traced calls (row writes, hashing, the tables laid out again, a
capacity growth), over the rows the coalescer's ``ingest_stats`` counted
in them (``ctx.counters``). Nothing where the program makes no such span
or keeps no such count, or the traced calls ingested nothing."""


def read(ctx):
    s, c = ctx.summary, ctx.counters
    sp = None if s is None else s.program_spans.get("coalescer.ingest")
    rows = None if c is None else c.get("ingest_rows")
    if not sp or not rows:
        return None
    return 1e3 * sp["device_s"] / (rows / 1e3)
