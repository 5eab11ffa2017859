"""Percent of the traced sub-window in which no operation ran on the
device: 1 - (union of its kernel, copy and set intervals) / window."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
