"""Milliseconds a flush in which nothing ran on the device, inside the
program's ``coalescer.flush`` spans of the traced calls: the host's part
of a flush (padding, the cache's host copies, building answers), which a
leaner host path would cut. Nothing where the program makes no such
span."""


def read(ctx):
    s = ctx.summary
    sp = None if s is None else s.program_spans.get("coalescer.flush")
    if not sp or not sp["calls"]:
        return None
    return 1e3 * sp["idle_s"] / sp["calls"]
