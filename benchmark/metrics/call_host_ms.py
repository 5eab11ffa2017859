"""Median call ms of the window less the device's busy ms per call in the
traced sub-window: the host's share of a call."""

import numpy as np


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    call_ms = float(np.percentile([(b - a) * 1e3 for a, b, _ in ctx.steps], 50))
    return call_ms - 1e3 * ctx.trace.busy_s / ctx.trace_steps
