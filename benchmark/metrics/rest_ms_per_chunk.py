"""Device ms per chunk outside the eigen and boundary-value stage kernels:
the plain tensor code (traced sub-window)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.busy_s <= 0:
        return None
    stages = sum(tr.stage_seconds(ctx.stage_kernels[s]) or 0.0 for s in ("eig", "bvp"))
    return 1e3 * (tr.busy_s - stages) / ctx.trace_steps
