"""Kernel-launch runtime calls (``cudaLaunch*``, ``cuLaunch*``) the
profiler saw over the traced calls, a call: the host slab loop's cost in
launches. Counts the harness's own few a call (the batch's gathers and the
three copies of the answers) with them."""


def read(ctx):
    s = ctx.summary
    if s is None or s.launches == 0:
        return None
    return s.launches / s.batches
