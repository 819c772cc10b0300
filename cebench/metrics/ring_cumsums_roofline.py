"""The ring cumsums' share (%) of their byte bound at the published HBM
bandwidth: each query's Hamming distance to each live bucket row and the
live rows' sizes read once, K+1 int32 cumsum entries a (query, live row)
written once, over the device time of the kernels in the span around
``prober.ring_cumsums``. Rows past ``n_buckets`` pad the capacity and
count for nothing."""
from cebench.harness import roofline, trace


def read(ctx):
    s = ctx.summary
    if s is None:
        return None
    nbytes = roofline.ring_cumsums_bytes(ctx.batch, ctx.live_buckets,
                                         ctx.config["prober"]["n_funcs"])
    return roofline.share_pct(nbytes * s.batches, 0,
                              s.span_device_s.get(trace.SPAN_RINGS, 0.0))
