"""Device ms a chunk of the beam's pole guard (``disort.solve.pole``:
each solve's least |1 - k mu0| over its eigenvalues, the move of mu0 off
the resonance where it is below the dtype's gap, and the beam's Legendre
table rebuilt at the moved mu0), the extent on the device's stream
(traced sub-window).  None where the guard did not run (a port without
it)."""

from yardstick import recorder


def read(ctx):
    return recorder.device_ms(ctx, "disort.solve.pole")
