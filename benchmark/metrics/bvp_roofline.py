"""The bvp stage's kernels' share of their roofline: the frozen work of the
traced steps at the cell's shapes (`yardstick/work.py`) against H100
peaks, over the device time of the kernels named under
`benchmark/stages/bvp/`."""

from yardstick import work


def read(ctx):
    if ctx.trace is None:
        return None
    seconds = ctx.trace.stage_seconds(ctx.stage_kernels["bvp"])
    if not seconds:
        return None
    flops, nbytes = work.stage_work("bvp", ctx.shapes, ctx.dtype)
    return work.roofline_pct(flops * ctx.trace_steps, nbytes * ctx.trace_steps, seconds, ctx.dtype)
