"""Device kernels per call (traced sub-window)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return ctx.trace.kernel_count() / ctx.trace_steps
