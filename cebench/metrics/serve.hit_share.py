"""The share (%) of the traced flushes' requests that the estimate cache
answered: the coalescer's ``cache_stats`` hits ÷ lookups as the driver's
counters moved over the traced calls (``ctx.counters``). Nothing where
the counters were not kept or no request was looked up."""


def read(ctx):
    c = ctx.counters
    if c is None or not c.get("cache_lookups"):
        return None
    return 100.0 * c["cache_hits"] / c["cache_lookups"]
