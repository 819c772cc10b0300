"""``query_lanes``' share (%) of its roofline (``hamming.cu``: the batch's
hash and its Hamming distances to the bucket rows): the frozen work
formula over the live bucket rows, over the profiler's device time of
``query_lanes_kernel``."""
from cebench.harness import roofline, trace


def read(ctx):
    s = ctx.summary
    if s is None:
        return None
    p, c = ctx.config["prober"], ctx.config
    nbytes, flops = roofline.query_lanes_work(
        ctx.batch, c["d"], p["n_tables"], p["n_funcs"], ctx.live_buckets)
    return roofline.share_pct(nbytes * s.batches, flops * s.batches,
                              trace.kernel_seconds(s, "query_lanes_kernel"))
