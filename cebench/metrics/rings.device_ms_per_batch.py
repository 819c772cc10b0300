"""Device milliseconds, a call, of the kernels launched inside the
harness's span around ``prober.ring_cumsums`` (in ``_table_setup``)."""
from cebench.harness import trace


def read(ctx):
    s = ctx.summary
    if s is None:
        return None
    t = s.span_device_s.get(trace.SPAN_RINGS, 0.0)
    return 1e3 * t / s.batches if t > 0 else None
