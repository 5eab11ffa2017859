"""Host ms a chunk in the Planck route's panel rule (``disort.planck.rule``:
the host Gauss-Legendre nodes and weights of each band integral and their
copy to the device; traced sub-window)."""

from yardstick import recorder


def read(ctx):
    return recorder.host_ms(ctx, "disort.planck.rule")
