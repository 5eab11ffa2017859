"""Kernel 3's share of its roofline: the frozen work of the traced steps'
transposed boundary-value solves (the backward of the fused BVP solve) at
the cell's shapes (`yardstick/work_grad.py`) against H100 peaks, over the
device time of the kernels named under `benchmark/stages/blocktri/`."""

from yardstick import work, work_grad


def read(ctx):
    if ctx.trace is None or "blocktri" not in ctx.shapes:
        return None
    seconds = ctx.trace.stage_seconds(ctx.stage_kernels["blocktri"])
    if not seconds:
        return None
    flops, nbytes = work_grad.stage_work("blocktri", ctx.shapes, ctx.dtype)
    return work.roofline_pct(flops * ctx.trace_steps, nbytes * ctx.trace_steps, seconds, ctx.dtype)
