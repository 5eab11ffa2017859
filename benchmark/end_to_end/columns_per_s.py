"""Columns whose outputs reached the host in the window, over the window's
seconds (from its start to the end of its last step)."""


def read(ctx):
    return sum(done for _, _, done in ctx.steps) / ctx.window_s
