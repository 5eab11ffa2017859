"""Median, over every call of the window, of one call with its closures'
values on the host, in ms."""

import numpy as np


def read(ctx):
    return float(np.percentile([(b - a) * 1e3 for a, b, _ in ctx.steps], 50))
