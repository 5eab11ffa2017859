"""Host ms of the Planck route per chunk, synchronized before and after
(traced sub-window)."""


def read(ctx):
    t = ctx.clocks.get(("trace", "planck"))
    return 1e3 * sum(t) / len(t) if t else None
