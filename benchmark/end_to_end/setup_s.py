"""Seconds from the process's start to the window's: imports, the inputs
made from the seed, and one step of the cell's traffic (which builds or
loads the port's kernels)."""


def read(ctx):
    return ctx.setup_s
