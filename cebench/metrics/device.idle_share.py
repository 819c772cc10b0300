"""The share (%) of the traced calls' wall time in which nothing ran on
the device: 1 - the union of the device's kernel, copy and set intervals
over the window from the first traced call to the last answer."""


def read(ctx):
    s = ctx.summary
    if s is None or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
