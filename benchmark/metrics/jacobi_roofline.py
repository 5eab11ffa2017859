"""Kernel 4's share of its roofline: the frozen work of the traced steps'
eigendecompositions under a gradient (the eigen stage's Jacobi) at the
cell's shapes (`yardstick/work_grad.py`) against H100 peaks, over the
device time of the kernels named under `benchmark/stages/jacobi/`."""

from yardstick import work, work_grad


def read(ctx):
    if ctx.trace is None or "jacobi" not in ctx.shapes:
        return None
    seconds = ctx.trace.stage_seconds(ctx.stage_kernels["jacobi"])
    if not seconds:
        return None
    flops, nbytes = work_grad.stage_work("jacobi", ctx.shapes, ctx.dtype)
    return work.roofline_pct(flops * ctx.trace_steps, nbytes * ctx.trace_steps, seconds, ctx.dtype)
