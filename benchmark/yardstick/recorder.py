"""What the port records about itself in the traced sub-window: its spans
and counters (``pythonic_disort_torch.utils.profiling``), which it
records only while a profiler runs.

Every reader returns None where there is nothing to read: an untraced
run, a span or counter that did not run, a device extent on the CPU, or a
port without the recorder.
"""

from __future__ import annotations


def record():
    """The port's ``recorded()``, or None where the port has no recorder."""
    try:
        from pythonic_disort_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    return recorded() if recorded is not None else None


def host_ms(ctx, name):
    """Host ms a traced step in the spans named ``name``, from the trace."""
    spans = ctx.trace.spans(name) if ctx.trace is not None else []
    return 1e-3 * sum(b - a for a, b in spans) / ctx.trace_steps if spans else None


def device_ms(ctx, *names):
    """Device ms a traced step in the spans ``names``: the sum of their
    extents on the device's stream; None where none was timed there."""
    rec = record() if ctx.trace is not None else None
    if rec is None:
        return None
    ms = [rec["spans"][n]["device_ms"] for n in names if n in rec["spans"]]
    ms = [x for x in ms if x is not None]
    return sum(ms) / ctx.trace_steps if ms else None


def counter(ctx, name):
    """Counter ``name`` a traced step, where the port's entry span ran
    (0 where it ran and counted nothing)."""
    rec = record() if ctx.trace is not None else None
    if rec is None or "disort.entry" not in rec["spans"]:
        return None
    return rec["counters"].get(name, 0) / ctx.trace_steps


def build_seconds():
    """Seconds the process spent loading the port's kernels (building those
    not built), set-up included; None where no kernel was loaded."""
    rec = record()
    if not rec or not rec["builds"]:
        return None
    return sum(b["seconds"] for b in rec["builds"].values())
