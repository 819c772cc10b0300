"""Runtime calls that make the host wait for the device (stream, device
and event synchronise, blocking copies) over the traced calls, a call:
each is a point where the slab loop stalls the host until the card
drains. The three copies of the answers are among them."""


def read(ctx):
    s = ctx.summary
    if s is None or s.syncs == 0:
        return None
    return s.syncs / s.batches
