"""Host ms of ``make_batched_problem`` per chunk, the window's mean (host
clock around the call)."""


def read(ctx):
    t = ctx.clocks.get(("window", "entry"))
    return 1e3 * sum(t) / len(t) if t else None
