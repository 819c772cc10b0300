"""The share (%) of the traced calls' lane-steps whose slab step the
prober's merge discards: the lane was done earlier in its block of
``lane_block`` steps, but runs the block's steps to its end. Read from the
program's own tally (``prober.read_tally``) as ``ctx.counters`` carries
it, taken around the traced calls; nothing where the program keeps no
tally, or it did not move by exactly the traced calls' estimates."""


def read(ctx):
    t = ctx.counters
    if t is None:
        return None
    steps = t["discarded_lane_steps"] + t["kept_lane_steps"]
    return 100.0 * t["discarded_lane_steps"] / steps if steps else None
