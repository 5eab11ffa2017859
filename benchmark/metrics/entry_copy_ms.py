"""Host ms a chunk in the port's ``disort.entry.copy`` spans: each copy of
a host array to the problem's device inside ``make_batched_problem``
(traced sub-window)."""

from yardstick import recorder


def read(ctx):
    return recorder.host_ms(ctx, "disort.entry.copy")
