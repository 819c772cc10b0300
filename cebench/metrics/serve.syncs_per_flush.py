"""Runtime calls that make the host wait for the device (synchronise,
blocking copies) inside the program's ``coalescer.flush`` spans of the
traced calls, a flush: the cache lookup's copies of ``hit``, ``stale``
and the estimates, the miss batch's estimate and the copies of its
answers. Nothing where the program makes no such span."""


def read(ctx):
    s = ctx.summary
    sp = None if s is None else s.program_spans.get("coalescer.flush")
    if not sp or not sp["calls"]:
        return None
    return sp["syncs"] / sp["calls"]
