"""Device milliseconds, a call, of the kernels launched inside the
harness's span around ``pq.build_query_lut`` (Alg. 4: the batch's float
LUTs, which the ADC route of ``slab_qualify`` reads); nothing where no
call builds a LUT."""
from cebench.harness import trace


def read(ctx):
    s = ctx.summary
    if s is None:
        return None
    t = s.span_device_s.get(trace.SPAN_LUTS, 0.0)
    return 1e3 * t / s.batches if t > 0 else None
