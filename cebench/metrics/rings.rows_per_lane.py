"""Bucket rows a lane's rings were built over, in the traced calls: the
program's tally of ring rows (``prober.read_tally``'s ``ring_rows``, each
call's lanes times the rows its cumsums span) as ``ctx.counters`` carries
it, over the traced calls' lanes, each call one estimate of ``batch``
pairs on every table. Nothing where the program keeps no such count (a
program that builds rings over the whole bucket axis), or its tally did
not move by exactly the traced calls' estimates."""


def read(ctx):
    t = ctx.counters
    if t is None or "ring_rows" not in t or not t.get("calls"):
        return None
    lanes = t["calls"] * ctx.batch * ctx.config["prober"]["n_tables"]
    return t["ring_rows"] / lanes
