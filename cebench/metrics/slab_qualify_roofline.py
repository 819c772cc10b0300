"""``slab_qualify``'s share (%) of its roofline (``slab.cu``): the frozen
work formula for the ring steps' candidates of the traced calls, as the
reference that follows those calls counts them (qualified exactly: the
row; by ADC: the code row), each lane's query row or LUT once, over the
profiler's device time of ``slab_qualify_kernel``."""
from cebench.harness import roofline, trace


def read(ctx):
    s = ctx.summary
    if s is None:
        return None
    p, c, t = ctx.config["prober"], ctx.config, ctx.slab
    m, kc = (p["pq_m"], p["pq_kc"]) if p["use_pq"] else (0, 0)
    nbytes, flops = roofline.slab_qualify_work(
        t["lanes"], c["d"], t["exact_rows"], t["exact_lanes"],
        t["adc_rows"], t["adc_lanes"], cb=m, lut_bytes=4 * m * kc, m=m)
    return roofline.share_pct(nbytes, flops,
                              trace.kernel_seconds(s, "slab_qualify_kernel"))
