"""Host-blocking CUDA runtime calls inside the Planck route per chunk
(traced sub-window; the route's own synchronizations at its ends are not
in its span)."""

from yardstick.trace import SYNC_CALLS


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.spans("bench.planck"):
        return None
    return tr.calls_within(SYNC_CALLS, "bench.planck") / ctx.trace_steps
